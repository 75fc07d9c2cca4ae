"""The JAX package's checkpoint directory, read and written by the port
(cwfa_tpu_torch.engine.checkpoints), on the small rig on the CPU.

- A directory written by ``cwfa_tpu``'s ``CWFATrainer.save_checkpoints``
  loads into the port, and the port's ``XLFMReconstructor`` gives JAX's
  volume within 1e-4 * max(1, |ref|) (f32, deterministic).
- A directory written by the port loads into ``CWFATrainer.load_checkpoints``,
  and JAX's volume matches the port's to the same bound.
- Discovery (highest epoch, ``max_epoch``, step 0, an orphaned temp file, a
  missing step keeping its weights) as in ``cwfa_tpu``.
- Mean caches both ways; ``force_last_step_NF`` (one more flow step in the
  file convention, no LRNN) and ``force_all_steps_NF`` against JAX.

The deterministic-init leaves (BatchNorm / LayerNorm affine and
statistics, PReLU alphas) are randomized so that a wrong mapping shows.
"""

import dataclasses
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.data.views import make_view_indices
from cwfa_tpu.engine import checkpoints as jckpt
from cwfa_tpu.engine.inference import XLFMReconstructor as JRecon
from cwfa_tpu.engine.trainer import CWFATrainer
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.engine import checkpoints as ckpt
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.jax_params import (export_jax_params,
                                              load_jax_params)
from cwfa_tpu_torch.models.cwfa_model import CWFAModel

from test_torch_port_layers import randomize_fixed_leaves

ND, VIEW, IMG = 8, 32, 96
SMALL = dict(n_depths=ND, volume_side_size=VIEW, n_lenslets=4,
             INN_max_down_steps=3, INN_n_blocks=2, INN_internal_chans=4,
             INN_cond_chans=2)
STATS = (12.0, 5.0, 11.0, 4.0, 1.5, 0.5)
COORDS = np.array([[24, 24], [24, 72], [72, 24], [72, 72]])
VIDX = make_view_indices(COORDS, (IMG, IMG), (VIEW, VIEW))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _caches(nf, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, max(1, ND // 2 ** (k + 1)), VIEW, VIEW)
            .astype(np.float32) for k in range(nf + 1)]


def _frames(seed=3, n=2):
    return (np.random.RandomState(seed).rand(n, IMG, IMG) * 100).astype(
        np.float32)


def _jax_trainer(path, seed=0, **flags):
    """A JAX trainer with random weights (fixed-init leaves randomized),
    the rig's statistics and one mean-cache set, writing to ``path``."""
    cfg = JConfig(**SMALL, **flags).decode_lrs()
    tr = CWFATrainer(JModel.build(cfg), JStats(*STATS), VIDX,
                     output_path=str(path), seed=seed)
    rng = np.random.RandomState(seed)
    tr.params = jax.tree_util.tree_map(
        jnp.asarray, randomize_fixed_leaves(_np(tr.params), rng))
    tr.mstate = jax.tree_util.tree_map(
        jnp.asarray, randomize_fixed_leaves(_np(tr.mstate), rng))
    tr.mean_caches = {0: [jnp.asarray(c)
                          for c in _caches(tr.model.n_flow_steps, seed)]}
    return tr


def _jax_volume(model, params, mstate, caches, frames):
    recon = JRecon(model, params, mstate, JStats(*STATS), VIDX,
                   [jnp.asarray(c) for c in caches], deterministic=True)
    return np.asarray(recon(frames))


def _port_volume(model, stats, caches, frames):
    recon = XLFMReconstructor(model, stats, VIDX, caches, device="cpu",
                              deterministic=True)
    return recon(frames).numpy()


def _close(got, want):
    assert got.shape == want.shape
    bound = 1e-4 * np.maximum(1.0, np.abs(want))
    err = np.abs(got - want)
    assert (err <= bound).all(), float(err.max())


def _port_model(seed=9, **flags):
    return CWFAModel.build(CWFAConfig(**SMALL, **flags).decode_lrs(),
                           torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("flags", [{}, {"force_last_step_NF": 1},
                                   {"force_all_steps_NF": 1}],
                         ids=["default", "force_last_step_NF",
                              "force_all_steps_NF"])
def test_jax_checkpoint_serves_through_the_port(tmp_path, flags):
    tr = _jax_trainer(tmp_path / "ck", **flags)
    tr.save_checkpoints(epoch=3)
    nf = tr.model.n_flow_steps
    model = _port_model(**flags)
    assert model.n_flow_steps == nf
    stats, loaded = ckpt.load_model_checkpoints(model, str(tmp_path / "ck"))
    assert loaded == list(range(1, SMALL["INN_max_down_steps"] + 1))
    assert stats.astuple() == STATS
    # every flow step and cond net from its file; the LRNN too unless the
    # last step is a flow (then no file carries it)
    params, mstate = export_jax_params(model)
    want_p, want_s = _np(tr.params), _np(tr.mstate)
    for k in range(nf):
        for got, want in ((params["flow"][k], want_p["flow"][k]),
                          (params["cond"][k], want_p["cond"][k])):
            for g, w in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(g, w)
    lrnn_same = all(np.array_equal(g, w) for g, w in zip(
        jax.tree_util.tree_leaves((params["lrnn"], mstate)),
        jax.tree_util.tree_leaves((want_p["lrnn"], want_s))))
    assert lrnn_same == (not flags.get("force_last_step_NF"))
    caches = ckpt.load_mean_caches(str(tmp_path / "ck"))[0]
    for c, w in zip(caches, tr.mean_caches[0]):
        np.testing.assert_array_equal(c, np.asarray(w))
    frames = _frames()
    _close(_port_volume(model, stats, caches, frames),
           _jax_volume(tr.model, tr.params, tr.mstate, caches, frames))


@pytest.mark.parametrize("flags", [{}, {"force_last_step_NF": 1}],
                         ids=["default", "force_last_step_NF"])
def test_port_checkpoint_loads_into_jax(tmp_path, flags):
    model = _port_model(seed=4, **flags)
    rng = np.random.RandomState(4)
    params, mstate = export_jax_params(model)
    load_jax_params(model, randomize_fixed_leaves(params, rng),
                    randomize_fixed_leaves(mstate, rng))
    path = str(tmp_path / "ck")
    files = ckpt.save_model_checkpoints(model, path, epoch=7,
                                        stats=DatasetStatistics(*STATS))
    caches = _caches(model.n_flow_steps, seed=4)
    files += ckpt.save_mean_caches(path, {0: caches})
    assert sorted(os.listdir(path)) == sorted(os.path.basename(f)
                                              for f in files)
    tr = CWFATrainer(JModel.build(JConfig(**SMALL, **flags).decode_lrs()),
                     None, VIDX)
    assert tr.load_checkpoints(path) == [1, 2, 3]
    assert tr.stats.astuple() == STATS
    payload, cfg, _ = jckpt.load_step_checkpoint(
        os.path.join(path, "model_step_2__ep_7.msgpack"))
    assert cfg.INN_down_steps == 2 and payload["epoch"] == 7
    assert dataclasses.asdict(cfg)["n_depths"] == ND
    # flow steps and cond nets from their files; the LRNN and its
    # BatchNorm statistics too, unless the last step is a flow
    want_p, want_s = export_jax_params(model)
    got_p, got_s = _np(tr.params), _np(tr.mstate)
    pairs = [(got_p["flow"], want_p["flow"]), (got_p["cond"], want_p["cond"])]
    if not flags:
        pairs += [(got_p["lrnn"], want_p["lrnn"]), (got_s, want_s)]
    for got, want in pairs:
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(want))
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for c, w in zip(tr.mean_caches[0], caches):
        np.testing.assert_array_equal(np.asarray(c), w)
    frames = _frames(seed=5)
    _close(_jax_volume(tr.model, tr.params, tr.mstate, caches, frames),
           _port_volume(model, DatasetStatistics(*STATS), caches, frames))


def test_discovery_matches_jax(tmp_path):
    """Highest epoch per step, the max_epoch cap, step 0 and orphaned temp
    files ignored, on a directory the port wrote."""
    model = _port_model()
    path = str(tmp_path)
    stats = DatasetStatistics(*STATS)
    for ep in (2, 10, 5):
        ckpt.save_model_checkpoints(model, path, epoch=ep, stats=stats)
    cfg = model.cfg
    ckpt.save_step_checkpoint(path, 0, 50, cfg)
    with open(os.path.join(path, ".model_step_1__ep_99.msgpack.tmp"),
              "wb") as f:
        f.write(b"partial")
    for max_epoch in (None, 6, 1):
        got = ckpt.discover_checkpoints(path, max_epoch=max_epoch)
        assert got == jckpt.discover_checkpoints(path, max_epoch=max_epoch)
    assert {s: e for s, (e, _) in ckpt.discover_checkpoints(path).items()} \
        == {1: 10, 2: 10, 3: 10}
    assert {s: e for s, (e, _) in
            ckpt.discover_checkpoints(path, max_epoch=6).items()} == {
        1: 5, 2: 5, 3: 5}
    assert ckpt.discover_checkpoints(path, max_epoch=1) == {}


def test_missing_step_keeps_its_weights(tmp_path):
    """A directory without step 2's file: the port's flow step and cond
    net 1 keep the weights they had, as JAX keeps its init."""
    tr = _jax_trainer(tmp_path / "ck")
    tr.save_checkpoints(epoch=1)
    os.remove(tmp_path / "ck" / "model_step_2__ep_1.msgpack")
    model = _port_model(seed=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, loaded = ckpt.load_model_checkpoints(model, str(tmp_path / "ck"))
    assert loaded == [1, 3]
    after = model.state_dict()
    for key in before:
        if key.endswith("num_batches_tracked"):
            continue                         # 0 on both sides
        same = torch.equal(before[key], after[key])
        assert same == key.startswith(("flow.1.", "cond.1.")), key


def test_a_file_that_does_not_fit_raises(tmp_path):
    tr = _jax_trainer(tmp_path / "ck")
    tr.save_checkpoints(epoch=1)
    wide = CWFAModel.build(
        CWFAConfig(**{**SMALL, "INN_internal_chans": 8}).decode_lrs(),
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_model_checkpoints(wide, str(tmp_path / "ck"))


def test_mean_caches_both_ways(tmp_path):
    tr = _jax_trainer(tmp_path / "j")
    tr.mean_caches[2] = [c + 1 for c in tr.mean_caches[0]]
    tr.save_mean_caches()
    got = ckpt.load_mean_caches(str(tmp_path / "j"))
    assert list(got) == [0, 2]
    for di in (0, 2):
        assert len(got[di]) == len(tr.mean_caches[di])
        for g, w in zip(got[di], tr.mean_caches[di]):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))
    port_dir = tmp_path / "p"
    ckpt.save_mean_caches(str(port_dir), got)
    tr2 = CWFATrainer(tr.model, None, VIDX)
    assert sorted(tr2.load_mean_caches(str(port_dir))) == [0, 2]
    for di in (0, 2):
        for g, w in zip(tr2.mean_caches[di], got[di]):
            np.testing.assert_array_equal(np.asarray(g), w)
    # the port writes the bytes the JAX trainer writes
    for di in (0, 2):
        name = f"mean_vols_cache_ds_{di}.msgpack"
        with open(tmp_path / "j" / name, "rb") as a, \
                open(port_dir / name, "rb") as b:
            assert a.read() == b.read()
    shutil.rmtree(port_dir)
