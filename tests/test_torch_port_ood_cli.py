"""The port's OOD finetune (``engine/ood.finetune_on_novel``) and OOD CLI
(``python -m cwfa_tpu_torch.cli.ood``, ``main(argv, device="cpu")``)
against the JAX package's on the CPU.

- ``finetune_on_novel`` after ``detect_ood(trainer, dataset, tag="train")``
  with ``reuse_caches=True``, steps 3 (the LRNN), 2 and 1, two epochs each,
  against JAX's: per-stage losses within 1e-4 * max(1, |ref|), every
  parameter after within 1e-3 * max|ref| of its group (Lion steps by the
  sign of its momentum, so a momentum within roundoff of 0 may step the
  other way), and the NLLs before and after within 1e-4 * max(1, |ref|).
- Its caches: the stage-handoff cache always dropped; with
  ``reuse_caches=True`` detect -> finetune -> re-score uploads each volume
  once; with False the ``"train"`` views, GT pyramids and NLLs dropped and
  the other tags' kept.
- ``cli.ood.main`` against JAX's ``cli.ood.main`` on the same tree and a
  checkpoint directory written by the JAX trainer: the report's keys,
  scores and flags, ``finetune_losses`` and ``scores_after_finetune``
  within the bounds above, and the PNG of the score distribution (the
  numpy drawing of ``utils/plots.distributions_image``).
- ``CWFA_DISTRIBUTED=auto`` without torchrun's variables exits naming them;
  without
  ``device="cpu"`` it raises here (no card).

One synthetic fish of 3 frames (JAX's ``make_synthetic_dataset``), 16
depths at 32^2, two flow steps of two 8-wide blocks, f32, batch 2 (a full
and a ragged mini-batch).  Both packages draw nothing: the LRNN's drop
rates and ``add_noise`` 0, the cond nets' Dropout3d off, and no guard noise
or 1e-3 noise in the GT pyramids (the JAX trainer's ``pyramid_fn`` rebuilt
here without its two draws, the port's scorer given no generator).  The
JAX trainer uploads float16 volumes rounded to bfloat16 (a fault of its own,
ROADMAP C); here it uploads them as stored, as the port does.  The UNet is
256 channels wide at 32^2, so the module runs torch on one thread.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import cwfa_tpu.models.cond_net as jcond_net
from cwfa_tpu import data as jdata
from cwfa_tpu.cli import ood as jcli
from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.engine.ood import detect_ood as jdetect_ood
from cwfa_tpu.engine.ood import finetune_on_novel as jfinetune
from cwfa_tpu.engine.trainer import CWFATrainer as JTrainer
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

from cwfa_tpu_torch.cli import ood as tcli
from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.dataset import ConcatXLFMDataset, load_xlfm_data
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.engine import trainer as ttrainer
from cwfa_tpu_torch.engine.jax_params import (export_jax_params,
                                              load_jax_params)
from cwfa_tpu_torch.engine.ood import PyramidScorer, detect_ood, \
    finetune_on_novel
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.models.cond_net import CondNetwork
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.utils import plots

from test_torch_port_layers import randomize_fixed_leaves

N_DEPTHS, VOL_SIDE, IMG, NLENS, VIEW = 16, 32, 96, 4, 32
CFG = dict(n_depths=N_DEPTHS, volume_side_size=VIEW, n_lenslets=NLENS,
           INN_max_down_steps=3, INN_n_blocks=2, INN_internal_chans=8,
           INN_cond_chans=4, epochs=3, use_half_precision=0, batch_size=2,
           add_noise=0)
STEPS = (1, 2, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(mp):
    """Both packages draw nothing in training and scoring."""
    real = jcond_net.cond_network

    def cond_network(params, x, *, train=False, rng=None, **kw):
        return real(params, x, train=train, rng=None,
                    **{**kw, "dropout3d_rate": 0.0})

    class QuietScorer(PyramidScorer):
        def __init__(self, *args, generator=None, **kw):
            super().__init__(*args, generator=None, **kw)

    mp.setattr(jcond_net, "cond_network", cond_network)
    mp.setattr(JTrainer, "_wire_dtype", staticmethod(lambda v: v))
    mp.setattr(jcli, "CWFATrainer", QuietJTrainer)
    mp.setattr(jcli, "CWFAModel", _ZeroDropJModel)
    mp.setattr(ttrainer, "PyramidScorer", QuietScorer)
    mp.setattr(CondNetwork, "dropout3d_rate", 0.0)
    mp.setattr(tcli, "CWFAModel", _ZeroDropModel)


@pytest.fixture
def quiet(monkeypatch):
    _quiet(monkeypatch)


def _zero_drop(spec):
    unet = dataclasses.replace(spec.unet, drop_out=0.0)
    return dataclasses.replace(spec, unet=unet, convnext_drop=0.0,
                               unet_drop=0.0)


class _ZeroDropJModel:
    @staticmethod
    def build(cfg):
        jm = JModel.build(cfg)
        return dataclasses.replace(jm, lrnn_spec=_zero_drop(jm.lrnn_spec))


class _ZeroDropModel:
    @staticmethod
    def build(cfg, generator):
        model = CWFAModel.build(cfg, generator)
        model.lrnn.spec = _zero_drop(model.lrnn.spec)
        model.lrnn.unet.spec = model.lrnn.spec.unet
        return model


class QuietJTrainer(JTrainer):
    """The JAX trainer with ``pyramid_fn`` (``trainer.py:234-255``) less its
    guard noise and 1e-3 noise."""

    def _build_jitted(self):
        super()._build_jitted()
        model, s = self.model, self.stats

        @jax.jit
        def pyramid_fn(params, vol_raw, key):
            v = (vol_raw.astype(jnp.float32) - s.mean_vols) / s.std_vols
            nlls, cache, priors, ljs = model.forward_pyramid(
                params, v, per_sample=True)
            sent = lambda u: jnp.nan_to_num(jnp.stack(u), nan=1e15,
                                            posinf=1e15, neginf=1e15)
            return sent(nlls), cache, sent(priors), jnp.stack(ljs)
        self._pyramid = pyramid_fn


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_ood")
    info = jdata.make_synthetic_dataset(str(root / "data"), n_fish=1,
                                        n_frames=3, n_depths=N_DEPTHS,
                                        vol_side=VOL_SIDE, img_size=IMG,
                                        n_lenslets=NLENS, view_size=VIEW)
    fish = info["fish_dirs"][0] + "/SLNet_preprocessed"
    kw = dict(vol_shape=(VOL_SIDE, VOL_SIDE, N_DEPTHS), img_shape=(IMG, IMG),
              images_to_use=[0, 1, 2], n_depths_to_fill=N_DEPTHS,
              ds_id="fish_0")
    tds = ConcatXLFMDataset(load_xlfm_data(fish, info["lenslet_file"], **kw))
    return {"root": root, "fish": fish, "tds": tds,
            "kw": kw, "lenslet_file": info["lenslet_file"],
            "stats": tds.get_statistics(),
            "vidx": make_view_indices(tds.datasets[0].lenslet_coords,
                                      (IMG, IMG), (VIEW, VIEW))}


def _jax_trainer(data, path=None):
    jm = _ZeroDropJModel.build(JConfig(**CFG).decode_lrs())
    jt = QuietJTrainer(jm, JStats(*data["stats"].astuple()), data["vidx"],
                       output_path=path)
    rng = np.random.RandomState(0)
    jt.params = jax.tree_util.tree_map(
        jnp.asarray, randomize_fixed_leaves(jt.params, rng))
    jt.mstate = jax.tree_util.tree_map(
        jnp.asarray, randomize_fixed_leaves(jt.mstate, rng))
    return jt


def _port_trainer(data, jt=None):
    model = _ZeroDropModel.build(CWFAConfig(**CFG).decode_lrs(),
                                 torch.Generator().manual_seed(0))
    if jt is not None:
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, jt.params),
                        jax.tree_util.tree_map(np.asarray, jt.mstate))
    return CWFATrainer(model, data["stats"], data["vidx"], device="cpu")


def _jds(data):
    return jdata.ConcatXLFMDataset(jdata.load_xlfm_data(
        data["fish"], data["lenslet_file"], **data["kw"]))


def _bound(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), (err, want)


@pytest.fixture(scope="module")
def finetuned(data, request):
    """Both trainers: the same weights, mean caches and GT pyramids; detect
    (tag "train"), finetune of STEPS with reuse_caches, re-score."""
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    _quiet(mp)
    jt = _jax_trainer(data)
    jds = _jds(data)
    jbefore = jdetect_ood(jt, jds, tag="train")
    tt = _port_trainer(data, jt)
    tds = data["tds"]
    tt.mean_caches = {0: [torch.from_numpy(np.array(c))
                          for c in jt.mean_caches[0]]}
    for ix, levels in jt.gt_cache["train"].items():
        tt.gt_cache.put(("train", tds.cache_tag, ix),
                        [torch.from_numpy(np.array(lvl)) for lvl in levels])
    tbefore = detect_ood(tt, tds, tag="train")
    jloss = jfinetune(jt, jds, optimize_steps=STEPS, epochs_per_step=2,
                      reuse_caches=True)
    tloss = finetune_on_novel(tt, tds, optimize_steps=STEPS,
                              epochs_per_step=2, reuse_caches=True)
    jafter = jdetect_ood(jt, jds, tag="train")
    tafter = detect_ood(tt, tds, tag="train")
    return jt, tt, (jbefore, jloss, jafter), (tbefore, tloss, tafter)


def test_finetune_losses_match_jax(finetuned):
    _, _, (_, jloss, _), (_, tloss, _) = finetuned
    assert sorted(tloss) == sorted(jloss) == list(STEPS)
    for s in STEPS:
        assert len(tloss[s]) == 2 and all(np.isfinite(tloss[s]))
        _bound(tloss[s], jloss[s], 1e-4)


def test_finetune_parameters_match_jax(finetuned):
    jt, tt, _, _ = finetuned
    got = export_jax_params(tt.model)[0]
    for group in ("lrnn", "flow", "cond"):
        g = jax.tree_util.tree_leaves(got[group])
        w = [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jt.params[group])]
        assert len(g) == len(w)
        scale = max(float(np.abs(x).max()) for x in w)
        worst = max(float(np.abs(np.asarray(a) - b).max())
                    for a, b in zip(g, w))
        assert worst <= 1e-3 * scale, (group, worst, scale)


def test_scores_before_and_after_match_jax(finetuned):
    _, tt, (jb, _, ja), (tb, _, ta) = finetuned
    _bound(tb.nll_per_frame, jb.nll_per_frame, 1e-4)
    _bound(ta.nll_per_frame, ja.nll_per_frame, 1e-4)
    assert not np.allclose(ta.scores, tb.scores)
    # the GT pyramids came across from JAX: nothing uploaded
    assert tt.transfer_log["volume_uploads"] == 0


def test_finetune_caches(data):
    tt = _port_trainer(data)
    tds = data["tds"]
    first = detect_ood(tt, tds, tag="train")
    assert tt.transfer_log["volume_uploads"] == 3
    # a stage input of the right shape left from before: step 1 (flow
    # step 0) would train on it if it were kept
    stale = torch.zeros(1, N_DEPTHS // 2, VIEW, VIEW)
    tt.upsampled_cache.put((tds.cache_tag, 0), stale)
    losses = finetune_on_novel(tt, tds, optimize_steps=(1,),
                               epochs_per_step=1, reuse_caches=True)
    assert list(losses) == [1] and np.isfinite(losses[1]).all()
    again = detect_ood(tt, tds, tag="train")
    assert tt.transfer_log["volume_uploads"] == 3
    assert not np.allclose(again.scores, first.scores)
    # dropped; and the finest stage captures nothing
    assert not tt.upsampled_cache.entries

    other = f"ood:{tds.cache_tag}"
    detect_ood(tt, tds)
    tt.upsampled_cache.put((tds.cache_tag, 0), torch.zeros(1, 4, 2, 2))
    assert finetune_on_novel(tt, tds, optimize_steps=(),
                             reuse_caches=False) == {}
    assert not tt.upsampled_cache.entries
    for cache in (tt.gt_cache.entries, tt.nll_cache,
                  tt.views_cache.entries):
        assert not [k for k in cache if k[0] == "train"]
    assert [k for k in tt.gt_cache.entries if k[0] == other]
    assert [k for k in tt.nll_cache if k[0] == other]


@pytest.fixture(scope="module")
def checkpoint(data):
    """A checkpoint directory written by the JAX trainer (its mean caches
    included)."""
    path = str(data["root"] / "ckpt")
    jt = _jax_trainer(data, path)
    jt.ensure_mean_caches(_jds(data))
    jt.save_checkpoints(0)
    return path


def _cli_argv(data, ckpt, report, *extra):
    argv = []
    for k, v in CFG.items():
        if k != "n_lenslets":            # from the lenslet file
            argv += [f"--{k}", str(v)]
    return argv + [
        "--main_data_path", str(data["root"] / "data"), "--lenslet_file",
        data["lenslet_file"], "--img_size", str(IMG), "--max_samples", "3",
        "--cross_validation_nFold", "0",
        "--pretrain_models_path", ckpt, "--report", str(report),
        "--step_LL_ths_to_use=-1e30", "--fine_tune_optimize_steps",
        *map(str, STEPS), *extra]


@pytest.fixture(scope="module")
def cli_reports(data, checkpoint, request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    _quiet(mp)
    out = data["root"] / "reports"
    out.mkdir()
    extra = ("--finetune", "1", "--create_dist_plots", "1")
    treport = tcli.main(_cli_argv(data, checkpoint, out / "port.json",
                                  *extra), device="cpu")
    jreport = jcli.main(_cli_argv(data, checkpoint, out / "jax.json",
                                  *extra))
    return out, treport, jreport


def test_cli_report_matches_jax(cli_reports):
    out, treport, jreport = cli_reports
    with open(out / "port.json") as f:
        assert json.load(f) == treport
    assert sorted(treport) == sorted(jreport) == [
        "finetune_losses", "is_ood", "scores", "scores_after_finetune",
        "step", "threshold"]
    assert treport["threshold"] == jreport["threshold"] == -1e30
    assert treport["step"] == jreport["step"] == 0
    assert treport["is_ood"] == jreport["is_ood"] == [1, 1, 1]
    _bound(treport["scores"], jreport["scores"], 1e-4)
    assert sorted(treport["finetune_losses"]) == ["1", "2", "3"]
    for s, losses in jreport["finetune_losses"].items():
        _bound(treport["finetune_losses"][s], losses, 1e-4)
    _bound(treport["scores_after_finetune"],
           jreport["scores_after_finetune"], 1e-4)
    assert not np.allclose(treport["scores_after_finetune"],
                           treport["scores"])


def test_cli_writes_the_distribution_png(cli_reports):
    from PIL import Image
    out, treport, _ = cli_reports
    with open(out / "port_dist.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert (out / "jax_dist.png").exists()
    # the PNG holds the numpy drawing of the scores beside the in-
    # distribution ones (all of them where every frame is flagged)
    scores = np.asarray(treport["scores"])
    flagged = np.asarray(treport["is_ood"], bool)
    in_dist = scores[~flagged] if (~flagged).any() else scores
    want = plots.distributions_image(scores, in_dist)
    assert want.shape == (480, 640, 3) and (want != 255).any()
    with Image.open(out / "port_dist.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), want)


def test_cli_without_finetune_writes_scores_only(data, checkpoint, quiet,
                                                 tmp_path):
    report = tcli.main(_cli_argv(data, checkpoint, tmp_path / "r.json"),
                       device="cpu")
    assert sorted(report) == ["is_ood", "scores", "step", "threshold"]
    assert not (tmp_path / "r_dist.png").exists()


def test_cli_exits_and_raises(data, checkpoint, tmp_path, monkeypatch):
    argv = _cli_argv(data, checkpoint, tmp_path / "r.json")
    monkeypatch.setenv("CWFA_DISTRIBUTED", "auto")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        tcli.main(argv, device="cpu")
    monkeypatch.delenv("CWFA_DISTRIBUTED")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(argv)
