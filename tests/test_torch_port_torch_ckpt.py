"""The reference's PyTorch checkpoints in the port (``engine/torch_convert``,
``engine/torch_export``, ``CWFATrainer.load_torch_checkpoints``,
``cli/export_torch``) against the JAX package's, on the CPU, on a small rig
(8 depths at 32^2, three pyramid steps of two 4-wide blocks) in f32.

- A set written by JAX's ``export_torch_checkpoints``, with two entries of a
  channel and of a spatial permutation swapped in the files (``perm_inv``
  fixed to match), loads into the port with those permutations, and the
  port's deterministic volume matches JAX's ``load_torch_checkpoints`` +
  reconstruct within 1e-4 * max(1, |ref|) (JAX at ``highest`` precision);
  without the swap it differs.  Both ``disable_low_res_input`` settings.
- The port's writer read by JAX's reader, and JAX's writer by the port's:
  parameters, BatchNorm statistics and permutations equal to the bit.
- Both export CLIs on one JAX-written msgpack directory (Lion momenta made
  random) write identical state dicts key by key, identical ``args``,
  statistics and Lion states.
- A missing step exits in both CLIs; a checkpoint of another
  ``INN_n_blocks`` or ``INN_use_perm`` raises in both readers.
- The port discovers only torch files before it picks the highest epoch,
  and its msgpack loader only msgpack files.

The deterministic-init leaves (BatchNorm / LayerNorm affine and
statistics, PReLU alphas) are randomized so that a wrong mapping shows.  The
rig's UNet is 256 channels wide at 32^2, above the 32,768-element grain
where this CPU's multithreaded elementwise ops are not steady, so the module
runs torch on one thread.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.cli import export_torch as jexport_cli
from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.engine import torch_convert as jtc
from cwfa_tpu.engine import torch_export as jte
from cwfa_tpu.engine.trainer import CWFATrainer as JTrainer
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

from cwfa_tpu_torch.cli import export_torch as export_cli
from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.engine import checkpoints as ckpt
from cwfa_tpu_torch.engine import torch_convert as tc
from cwfa_tpu_torch.engine.jax_params import (export_jax_params,
                                              load_jax_params)
from cwfa_tpu_torch.engine.torch_export import export_torch_checkpoints
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.models.cwfa_model import CWFAModel

from test_torch_port_checkpoints import (SMALL, STATS, VIDX, _caches,
                                         _close, _frames, _jax_trainer,
                                         _jax_volume, _np, _port_volume)
from test_torch_port_layers import randomize_fixed_leaves

LOW_RES = pytest.mark.parametrize("disable_low_res_input", [0, 1],
                                  ids=["low_res_input", "no_low_res_input"])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _port_model(seed=9, **flags):
    return CWFAModel.build(CWFAConfig(**SMALL, **flags).decode_lrs(),
                           torch.Generator().manual_seed(seed))


def _alter_perms(path, step=1):
    """Swap two entries of block 0's channel permutation (module 3) and
    block 1's spatial one (module 5) in the torch file of ``step``, with
    perm_inv fixed to match."""
    (fname,) = [os.path.join(path, f) for f in os.listdir(path)
                if f.startswith(f"model_step_{step}__ep_")]
    payload = torch.load(fname, weights_only=False)
    sd = payload["INN_state_dict"]
    for mi in (3, 5):
        perm = sd[f"module_list.{mi}.perm"].clone()
        perm[[0, 1]] = perm[[1, 0]]
        sd[f"module_list.{mi}.perm"] = perm
        sd[f"module_list.{mi}.perm_inv"] = torch.argsort(perm)
    torch.save(payload, fname)


def _state_dict(tree):
    return {k: v for k, v in zip(
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_leaves_with_path(tree)],
        jax.tree_util.tree_leaves(tree))}


def _equal_trees(got, want):
    got, want = _state_dict(_np(got)), _state_dict(_np(want))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def _jax_files(path, disable_low_res_input, stats=True, epoch=4, seed=1):
    """A JAX trainer with random weights written by JAX's
    ``export_torch_checkpoints``; returns the trainer."""
    src = _jax_trainer(path / "run", seed=seed,
                       disable_low_res_input=disable_low_res_input)
    jte.export_torch_checkpoints(str(path / "torch"), src.cfg, src.model,
                                 src.params, src.mstate,
                                 stats=src.stats if stats else None,
                                 epoch=epoch)
    return src


def _file_perms(path, model):
    """Each flow step's (perm, inv) pairs as JAX's reader takes them."""
    out = []
    for k, spec in enumerate(model.step_specs):
        (fname,) = [os.path.join(path, f) for f in os.listdir(path)
                    if f.startswith(f"model_step_{k + 1}__ep_")]
        sd = jtc.load_torch_state_dict(fname)["INN_state_dict"]
        out.append(jtc.convert_graph_inn(sd, spec.n_blocks,
                                         spec.use_final_perm)[1])
    return out


@LOW_RES
def test_jax_reference_files_with_altered_perms_reconstruct_as_jax(
        tmp_path, disable_low_res_input):
    src = _jax_files(tmp_path, disable_low_res_input)
    out = str(tmp_path / "torch")
    _alter_perms(out)
    flags = {"disable_low_res_input": disable_low_res_input}
    ptr = CWFATrainer(_port_model(**flags), None, VIDX, device="cpu")
    assert ptr.load_torch_checkpoints(out) == [1, 2, 3]
    assert ptr.stats.astuple() == STATS

    # JAX's reference: the source weights under the file's permutations
    ref_model = dataclasses.replace(src.model, step_specs=tuple(
        jtc.apply_perm_overrides(spec, perms) for spec, perms in
        zip(src.model.step_specs, _file_perms(out, src.model))))
    for k in range(ptr.model.n_flow_steps):
        for got, want in zip(ptr.model.step_specs[k].perms,
                             ref_model.step_specs[k].perms):
            assert got[:-2] == want[:-2]      # kind and replayed axis
            for a, b in zip(got[-2:], want[-2:]):
                np.testing.assert_array_equal(a, b)
        for i, entry in enumerate(ptr.model.step_specs[k].perms):
            np.testing.assert_array_equal(
                getattr(ptr.model.flow[k], f"perm_fwd_{i}").numpy(),
                entry[-2])
            np.testing.assert_array_equal(
                getattr(ptr.model.flow[k], f"perm_inv_{i}").numpy(),
                entry[-1])
    for i, kind in ((0, "channel"), (1, "spatial")):
        got = ptr.model.step_specs[0].perms[i]
        assert got[0] == kind
        assert not np.array_equal(got[-2],
                                  src.model.step_specs[0].perms[i][-2])

    caches, frames = _caches(ptr.model.n_flow_steps), _frames()
    want = _jax_volume(ref_model, src.params, src.mstate, caches, frames)
    _close(_port_volume(ptr.model, ptr.stats, caches, frames), want)
    # the altered permutations matter: the replayed ones give another volume
    plain = _jax_volume(src.model, src.params, src.mstate, caches, frames)
    assert np.abs(plain - want).max() > 1e-2 * np.abs(want).max()

    if not disable_low_res_input:
        # JAX's own load gives the same volume; not without the low-res
        # input, where JAX's reader takes the input subnet's unused variant
        # (a reference fault, ROADMAP C)
        jtr = JTrainer(JModel.build(JConfig(**SMALL, **flags).decode_lrs()),
                       None, VIDX, seed=2)
        assert jtr.load_torch_checkpoints(out) == [1, 2, 3]
        _close(_jax_volume(jtr.model, jtr.params, jtr.mstate, caches, frames),
               want)


def test_torch_files_are_discovered_before_the_highest_epoch_is_picked(
        tmp_path):
    """A ``.msgpack`` file of a later epoch beside the torch set hides no
    step from the port (the JAX trainer filters after picking, ROADMAP C);
    ``max_test_load_epoch`` caps the torch files' epochs."""
    model = _port_model()
    export_torch_checkpoints(str(tmp_path), model, epoch=4)
    (tmp_path / "model_step_2__ep_9.msgpack").write_bytes(b"")
    tr = CWFATrainer(_port_model(seed=1), None, VIDX, device="cpu")
    assert tr.load_torch_checkpoints(str(tmp_path)) == [1, 2, 3]
    _equal_trees(export_jax_params(tr.model)[0], export_jax_params(model)[0])
    capped = CWFAConfig(**SMALL, max_test_load_epoch=3).decode_lrs()
    tr = CWFATrainer(CWFAModel.build(capped, torch.Generator().manual_seed(1)),
                     None, VIDX, device="cpu")
    version = tr._params_version
    assert tr.load_torch_checkpoints(str(tmp_path)) == []
    assert tr._params_version == version + 1


def _randomized_port_model(flags, seed):
    model = _port_model(seed=seed, **flags)
    rng = np.random.RandomState(seed)
    params, state = export_jax_params(model)
    load_jax_params(model, randomize_fixed_leaves(params, rng),
                    randomize_fixed_leaves(state, rng))
    return model


def _equal_bn_stats(got, want, count0=False):
    for side in ("down", "up"):
        for a, b in zip(got["unet"][side], want["unet"][side]):
            for tag in ("bn1", "bn2"):
                for f in ("mean", "var"):
                    np.testing.assert_array_equal(np.asarray(a[tag][f]),
                                                  np.asarray(b[tag][f]))
                if count0:
                    assert int(a[tag]["count"]) == 0


@LOW_RES
def test_port_writer_read_by_jax_and_jax_writer_by_port(tmp_path,
                                                        disable_low_res_input):
    flags = {"disable_low_res_input": disable_low_res_input}
    model = _randomized_port_model(flags, seed=3)
    params, state = export_jax_params(model)
    export_torch_checkpoints(str(tmp_path / "port"), model,
                             stats=DatasetStatistics(*STATS), epoch=2)
    nf = model.n_flow_steps
    for k, spec in enumerate(model.step_specs):
        sd = jtc.load_torch_state_dict(
            str(tmp_path / "port" / f"model_step_{k + 1}__ep_2"))
        flow, perms = jtc.convert_graph_inn(
            sd["INN_state_dict"], spec.n_blocks, spec.use_final_perm)
        flow["input_block"]["subnet"] = jtc.convert_subnet(
            sd["INN_state_dict"], "module_list.2.subnet",
            first=not disable_low_res_input)
        _equal_trees(flow, params["flow"][k])
        _equal_trees(jtc.convert_cond_network(sd["condition_state_dict"]),
                     params["cond"][k])
        for (perm, inv), entry in zip(perms, spec.perms):
            np.testing.assert_array_equal(perm, entry[-2])
            np.testing.assert_array_equal(inv, entry[-1])
    sd = jtc.load_torch_state_dict(
        str(tmp_path / "port" / f"model_step_{nf + 1}__ep_2"))
    lp, ls = jtc.convert_lrnn(sd["condition_state_dict"])
    _equal_trees(lp, params["lrnn"])
    _equal_bn_stats(ls, state["lrnn"])
    assert [float(t) for t in sd["training_statistics"]] == list(STATS)

    src = _jax_files(tmp_path, disable_low_res_input, stats=False, seed=4)
    back = CWFATrainer(_port_model(seed=4, **flags), None, VIDX,
                       device="cpu")
    assert back.load_torch_checkpoints(str(tmp_path / "torch")) == [1, 2, 3]
    assert back.stats is None
    bp, bs = export_jax_params(back.model)
    _equal_trees(bp, src.params)
    _equal_bn_stats(bs["lrnn"], src.mstate["lrnn"], count0=True)


def _random_momenta(opt, rng):
    return jax.tree_util.tree_map(
        lambda x: (jnp.asarray(rng.randn(*np.shape(x)).astype(np.float32))
                   if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
                   else x), opt)


@pytest.fixture(scope="module")
def msgpack_dir(tmp_path_factory):
    """A JAX trainer's msgpack checkpoint directory, epochs 3 and 6, with
    random Lion momenta."""
    root = tmp_path_factory.mktemp("msgpack")
    tr = _jax_trainer(root / "ck", seed=6)
    rng = np.random.RandomState(6)
    tr.opt_flow = [_random_momenta(o, rng) for o in tr.opt_flow]
    tr.opt_lrnn = _random_momenta(tr.opt_lrnn, rng)
    tr.save_checkpoints(epoch=3)
    tr.save_checkpoints(epoch=6)
    return str(root / "ck")


def test_both_export_clis_write_identical_files(msgpack_dir, tmp_path,
                                                capsys):
    jexport_cli.main(["--pretrain_models_path", msgpack_dir,
                      "--output_path", str(tmp_path / "jax")])
    written = export_cli.main(["--pretrain_models_path", msgpack_dir,
                               "--output_path", str(tmp_path / "port")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == (f"exported 3 reference checkpoints (epoch 6) to "
                         f"{tmp_path / 'port'}")
    assert lines[-4:-1] == written
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        f"model_step_{s}__ep_6" for s in (1, 2, 3)]
    for name in names:
        want = torch.load(tmp_path / "jax" / name, weights_only=False)
        got = torch.load(tmp_path / "port" / name, weights_only=False)
        assert set(got) == set(want)
        assert got["epoch"] == want["epoch"] == 6
        assert vars(got["args"]) == vars(want["args"])
        assert [float(t) for t in got["training_statistics"]] == \
            [float(t) for t in want["training_statistics"]]
        for key in ("INN_state_dict", "condition_state_dict"):
            if want[key] is None:
                assert got[key] is None
                continue
            assert list(got[key]) == list(want[key])
            for k, v in want[key].items():
                assert got[key][k].dtype == v.dtype, k
                assert torch.equal(got[key][k], v), k
        go, wo = got["optimizer_state_dict"], want["optimizer_state_dict"]
        assert go["param_groups"] == wo["param_groups"]
        assert go["param_names"] == wo["param_names"]
        assert sorted(go["state"]) == sorted(wo["state"])
        for i, st in wo["state"].items():
            assert torch.equal(go["state"][i]["exp_avg"], st["exp_avg"])
        # random momenta (the unused subnet halves' are zeros)
        assert any(bool(st["exp_avg"].any()) for st in wo["state"].values())


def test_msgpack_loader_reads_past_reference_files(msgpack_dir, tmp_path):
    """The reference's torch files of a later epoch beside a msgpack set
    leave the port's msgpack loader reading the msgpack files."""
    src = tmp_path / "mixed"
    src.mkdir()
    for f in os.listdir(msgpack_dir):
        os.symlink(os.path.join(msgpack_dir, f), src / f)
    export_cli.main(["--pretrain_models_path", str(src),
                     "--output_path", str(src)])
    assert sum(f.endswith("__ep_6") for f in os.listdir(src)) == 3
    want, got = _port_model(seed=1), _port_model(seed=2)
    assert ckpt.load_model_checkpoints(want, msgpack_dir)[1] == [1, 2, 3]
    assert ckpt.load_model_checkpoints(got, str(src))[1] == [1, 2, 3]
    _equal_trees(export_jax_params(got)[0], export_jax_params(want)[0])


def test_missing_step_exits_in_both_clis(msgpack_dir, tmp_path):
    src = tmp_path / "partial"
    src.mkdir()
    for f in os.listdir(msgpack_dir):
        if f.endswith(".msgpack") and not f.startswith("model_step_2_"):
            os.symlink(os.path.join(msgpack_dir, f), src / f)
    for main in (jexport_cli.main, export_cli.main):
        with pytest.raises(SystemExit, match=r"steps \[2\]"):
            main(["--pretrain_models_path", str(src),
                  "--output_path", str(tmp_path / "out")])
    with pytest.raises(SystemExit, match="no .msgpack"):
        export_cli.main(["--pretrain_models_path", str(tmp_path / "out"),
                         "--output_path", str(tmp_path / "out2")])


@pytest.mark.parametrize("flags", [{"INN_n_blocks": 3}, {"INN_use_perm": 0}],
                         ids=["n_blocks", "use_perm"])
def test_mismatched_architecture_raises_in_both_readers(tmp_path, flags):
    src = _jax_trainer(tmp_path / "unused", seed=7)
    out = str(tmp_path / "torch")
    jte.export_torch_checkpoints(out, src.cfg, src.model, src.params,
                                 src.mstate, epoch=0)
    other = {**SMALL, **flags}
    jtr = JTrainer(JModel.build(JConfig(**other).decode_lrs()), None, VIDX)
    with pytest.raises((AssertionError, ValueError)):
        jtr.load_torch_checkpoints(out)
    model = CWFAModel.build(CWFAConfig(**other).decode_lrs(),
                            torch.Generator().manual_seed(0))
    ptr = CWFATrainer(model, None, VIDX, device="cpu")
    with pytest.raises(ValueError, match="INN_n_blocks"):
        ptr.load_torch_checkpoints(out)
    # the permutation overrides alone: a count mismatch raises in both
    spec, jspec = model.step_specs[0], jtr.model.step_specs[0]
    perms = [(e[-2], e[-1]) for e in spec.perms][:-1]
    for fn, s in ((tc.apply_perm_overrides, spec),
                  (jtc.apply_perm_overrides, jspec)):
        with pytest.raises(ValueError, match="permutation buffers"):
            fn(s, perms)
