"""Reconstruction and serving with image rows over the ``space`` mesh axis
(``XLFMReconstructor(mesh=make_mesh(1, 2))``, ``cli.serve
--mesh_space_axis 2``) on the CPU, on two gloo ranks
(``tests/_torch_port_dist_worker.py``), in two spawns:

1. ``space_recon``, on the small rig (32 rows, 16 a rank; its step 1 holds
   an axis-2 ``PermuteDim``, so rows cross ranks):
   - deterministic f32 with JAX's weights: the batch of 2 on both ranks
     within 1e-4 of max|ref| of JAX's ``XLFMReconstructor(mesh=make_mesh(1,
     2))``;
   - the default stochastic mode with every draw on (the LRNN's Dropout2d
     and ``drop_path`` at their rates, BatchNorm on the statistics of the
     whole batch and image, z at T 0.7, 2 samples) against one process from
     the same seed within 1e-5 of max|ref|;
   - a 36-row rig (18 rows a rank, not a multiple of the UNet's 4): every
     rank computes all rows, equal to one process, and says so once;
   - ``serve_directory`` on the space group where a read fails once (rank
     1's first read of every file, rank 0's of one file): only rank 0
     reads, both ranks submit the same pages, the failed file is served on
     the next poll, and the volumes equal direct calls within 1e-5 of max.
2. ``clis``: ``cli.serve --mesh_space_axis 2`` with ``--no_int8`` and with
   the int8 UNet (calibrated on each rank and checked equal) against one
   process within 1e-5 of max; one rank of the space group writes.  Then
   ``cli.train --mesh_space_axis 2`` (fold 0 of two fish: 2 frames of one
   to train on, the other's to test; 16 depths at 32^2, 3 epochs: the LRNN
   and both flow stages, one optimizer step each; 16 rows a rank) exits 0
   on both ranks, rank 0 writes the run directory, its epoch losses and
   every Lion momentum equal one process's within 1e-5, and every
   parameter within 6 lr (Lion steps by a sign, which roundoff may flip
   near 0: JAX's bound), the evaluation as far as those flips carry.

Single-process: ``space_rows``' fallback rule.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.engine.inference import XLFMReconstructor as JReconstructor
from cwfa_tpu.parallel import make_mesh

from cwfa_tpu_torch.cli import serve
from cwfa_tpu_torch.data.tiff import read_tiff_stack, write_tiff_stack
from cwfa_tpu_torch.engine import checkpoints
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.parallel import mesh as M
from cwfa_tpu_torch.rig import flagship, lenslet_coords

from _torch_port_dist_worker import side36_rig, start_ranks
from test_torch_port_layers import randomize_fixed_leaves

STOCH = {"INN_z_temperature": 0.7, "INN_n_samples": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, bound):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bound * float(np.abs(want).max()), err


def _has_row_permutation(model) -> bool:
    return any(e[0] == "spatial" and e[1] == 2
               for s in model.step_specs for e in s.perms)


@pytest.fixture(scope="module")
def recon_ranks(tmp_path_factory):
    """Starts the ranks of spawn 1, then builds what they are held to."""
    from __graft_entry__ import _flagship
    cfg, jmodel, params, mstate, stats, vidx, img = _flagship(small=True)
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    mstate = randomize_fixed_leaves(mstate, rng)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(jmodel.n_flow_steps + 1)]
    caches36 = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), 36, 36)
                .astype(np.float32) for k in range(jmodel.n_flow_steps + 1)]
    frames = (rng.rand(2, img, img) * 1000).astype(np.float32)
    serve_dir = tmp_path_factory.mktemp("space_reads")
    (serve_dir / "frames").mkdir()
    cams = np.random.RandomState(9).randint(100, 600, (3, img, img))
    for i, cam in enumerate(cams.astype(np.uint16)):
        write_tiff_stack(str(serve_dir / "frames" / f"cam_{i}.tif"), cam)
    wait = start_ranks("space_recon", n=2, params=params, mstate=mstate,
                       caches=caches, frames=frames, stoch_kw=STOCH,
                       caches36=caches36, serve_dir=str(serve_dir))
    tree = jax.tree_util.tree_map(jnp.asarray, (params, mstate))
    jax_mesh = np.asarray(JReconstructor(
        jmodel, *tree, stats, vidx, caches, mesh=make_mesh(1, 2),
        deterministic=True, use_pallas=True)(frames))
    scfg, smodel, sstats, svidx, _ = flagship(
        True, "cpu", torch.Generator().manual_seed(3))
    assert _has_row_permutation(smodel)
    smodel.cfg = dataclasses.replace(scfg, **STOCH)
    one = XLFMReconstructor(smodel, sstats, svidx, caches,
                            device="cpu")(frames).numpy()
    model36, stats36, vidx36 = side36_rig()
    one36 = XLFMReconstructor(model36, stats36, vidx36, caches36,
                              device="cpu", deterministic=True)(frames).numpy()
    return wait(240), {"jax": jax_mesh, "one": one, "one36": one36,
                       "served": serve_dir / "served"}


def test_deterministic_rows_match_jax_space_mesh(recon_ranks):
    ranks, want = recon_ranks
    assert [r["rows"] for r in ranks] == [(0, 16), (16, 32)]
    for r in ranks:
        assert r["det"].shape == (2, 16, 32, 32)
        _close(r["det"], want["jax"], 1e-4)


def test_stochastic_two_space_ranks_equal_one(recon_ranks):
    ranks, want = recon_ranks
    for r in ranks:
        _close(r["stoch"], want["one"], 1e-5)
    np.testing.assert_array_equal(ranks[0]["stoch"], ranks[1]["stoch"])


def test_rows_that_do_not_split_fall_back_to_all_rows(recon_ranks):
    ranks, want = recon_ranks
    for r in ranks:
        for vol in r["fallback"]:
            _close(vol, want["one36"], 1e-6)
        assert r["fallback_said"].count(
            "36 rows do not split into 2 shards of a multiple of 4") == 1


def test_serve_reads_on_one_rank_of_a_space_group(recon_ranks):
    """A read that fails on one rank and not on the other cannot send the
    space group's calls apart: rank 0 reads every file (cam_1 twice: its
    first read failed and was retried on the next poll), rank 1 reads none,
    both serve the 3 frames in the same 2 calls, and rank 0 writes them."""
    ranks, want = recon_ranks
    assert ranks[0]["serve"]["reads"] == [
        "cam_0.tif", "cam_1.tif", "cam_2.tif", "cam_1.tif"]
    assert ranks[1]["serve"]["reads"] == []
    for r in ranks:
        assert (r["serve"]["summary"]["frames"],
                r["serve"]["summary"]["batches"]) == (3, 2)
    names = [f"XLFM_stack_cam_{i}.tif" for i in range(3)]
    assert sorted(os.listdir(want["served"])) == names
    for i, n in enumerate(names):
        _close(read_tiff_stack(str(want["served"] / n), dtype=None),
               ranks[0]["serve"]["direct"][i], 1e-5)


class _Mesh:
    mesh_dim_names = ("data", "space")

    def __init__(self, n_space):
        self.n = n_space

    def size(self, i):
        return (1, self.n)[i]


@pytest.mark.parametrize("total, n, multiple, splits", [
    (32, 2, 4, True), (32, 4, 4, True), (36, 2, 4, False), (33, 2, 1, False),
    (32, 4, 16, False), (32, 1, 4, False)])
def test_space_rows_rule(total, n, multiple, splits, monkeypatch):
    """Rows split where ``total`` splits into n shards of a multiple of
    ``multiple`` rows (one space rank: no split), else None."""
    monkeypatch.setattr(M, "space_group", lambda mesh: "group")
    monkeypatch.setattr(M, "space_rank", lambda mesh: n - 1)
    rs = M.space_rows(_Mesh(n), total, multiple)
    assert (rs is not None) == splits
    if splits:
        assert (rs.start, rs.stop, rs.sum_group) == (
            total - total // n, total, "group")


ND, VIEW, IMG, NL = 16, 32, 128, 4


@pytest.fixture(scope="module")
def serve_rig(tmp_path_factory):
    """The small rig (3 pyramid steps; step 1's PermuteDim over rows) as a
    checkpoint directory of the port's writer, its lenslets and 3 frames."""
    root = tmp_path_factory.mktemp("space_serve")
    cfg, model, stats, _, img = flagship(True, "cpu",
                                         torch.Generator().manual_seed(6))
    assert (cfg.n_depths, cfg.volume_side_size, img) == (ND, VIEW, IMG)
    assert _has_row_permutation(model)
    ckpt = root / "ckpt"
    checkpoints.save_model_checkpoints(model, str(ckpt), epoch=0,
                                       stats=stats)
    rng = np.random.RandomState(8)
    checkpoints.save_mean_caches(str(ckpt), {0: [
        rng.randn(1, ND // 2 ** (k + 1), VIEW, VIEW).astype(np.float32)
        for k in range(model.n_flow_steps + 1)]})
    lenslets = root / "lenslets.txt"
    lenslets.write_text("".join(
        f"{x - 50}\t{y - 50}\n" for x, y in lenslet_coords(NL, VIEW, IMG)))
    in_dir = root / "frames"
    in_dir.mkdir()
    for i in range(3):
        write_tiff_stack(str(in_dir / f"cam_{i}.tif"),
                         rng.randint(100, 600, (IMG, IMG)).astype(np.uint16))
    base = ["--pretrain_models_path", str(ckpt), "--lenslet_file",
            str(lenslets), "--img_size", str(IMG), "--n_depths", str(ND),
            "--volume_side_size", str(VIEW), "--INN_max_down_steps", "3",
            "--INN_n_blocks", "2", "--INN_internal_chans", "8",
            "--INN_cond_chans", "4", "--in_dir", str(in_dir),
            "--use_half_precision", "0", "--batch", "2"]
    return root, base


SERVE_RUNS = {"f32": ["--no_int8"], "int8": []}
TRAIN_SMALL = ["--n_depths", str(ND), "--volume_side_size", str(VIEW),
               "--INN_max_down_steps", "3", "--INN_n_blocks", "2",
               "--INN_internal_chans", "8", "--INN_cond_chans", "4",
               "--use_half_precision", "0", "--img_size", "96",
               "--epochs", "3", "--eval_every", "3", "--max_samples", "2",
               "--batch_size", "2",
               "--cross_validation_nFold", "0", "--save_tiff_volumes", "0"]


@pytest.fixture(scope="module")
def clis(serve_rig):
    """The ``clis`` spawn: the two serve runs, then the training CLI on a
    one-fish tree, each on two ranks with ``--mesh_space_axis 2``; the
    one-process runs meanwhile."""
    from cwfa_tpu import data as jdata
    from cwfa_tpu_torch.cli import train
    root, base = serve_rig
    info = jdata.make_synthetic_dataset(str(root / "train_data"), n_fish=2,
                                        n_frames=2, n_depths=ND, vol_side=VIEW,
                                        img_size=96, n_lenslets=NL,
                                        view_size=VIEW)
    targv = ["--main_data_path", str(root / "train_data"), "--lenslet_file",
             info["lenslet_file"], *TRAIN_SMALL]
    wait = start_ranks("clis", n=2, module="cwfa_tpu_torch.cli.serve",
                       argvs=[base + flags + ["--out_dir", str(root / tag),
                                              "--mesh_space_axis", "2"]
                              for tag, flags in SERVE_RUNS.items()]
                       + [("cwfa_tpu_torch.cli.train", targv + [
                           "--output_testing_path", str(root / "train_two")
                           + "/", "--mesh_space_axis", "2"])])
    ones = {tag: serve.main(base + flags + ["--out_dir",
                                            str(root / f"one_{tag}")],
                            device="cpu")
            for tag, flags in SERVE_RUNS.items()}
    ones["train"] = train.main(targv + ["--output_testing_path",
                                        str(root / "train_one") + "/"],
                               device="cpu")
    return wait(300), ones


def test_serve_on_a_space_mesh_writes_what_one_writes(serve_rig, clis):
    root, _ = serve_rig
    runs = SERVE_RUNS
    ranks, ones = clis
    for i, tag in enumerate(runs):
        assert ones[tag]["frames"] == 3
        assert [r[i]["frames"] for r in ranks] == [3, 3]
        assert [r[i]["rank"] for r in ranks] == [0, 1]
        names = sorted(os.listdir(root / f"one_{tag}"))
        assert names == sorted(os.listdir(root / tag)) == [
            f"XLFM_stack_cam_{i}.tif" for i in range(3)]
        for n in names:
            want = read_tiff_stack(str(root / f"one_{tag}" / n), dtype=None)
            _close(read_tiff_stack(str(root / tag / n), dtype=None), want,
                   1e-5)


def test_train_cli_on_a_space_mesh_trains_what_one_trains(serve_rig, clis):
    """``cli.train --mesh_space_axis 2`` on two ranks: both exit 0, rank 0
    alone writes, its epoch losses (the event file) and every Lion momentum
    in its checkpoints equal the one-process run's within 1e-5 (of each
    array's largest), every parameter and BatchNorm statistic within 6 lr,
    and both ranks hold the evaluation of one process (the gathered
    volumes and NLLs), as far as a flipped Lion sign carries: within 1e-3
    of max."""
    from cwfa_tpu_torch.config import CWFAConfig
    from cwfa_tpu.utils.tb_writer import read_event_file
    from cwfa_tpu_torch.engine.checkpoints import load_step_checkpoint
    root, _ = serve_rig
    ranks, ones = clis
    one = ones["train"]
    for r in ranks:
        res = r[2]
        assert sorted(res) == sorted(one) == ["test", "train", "val"]
        for tag in one:
            _close(np.asarray(res[tag]["volumes_pred"]),
                   np.asarray(one[tag]["volumes_pred"]), 1e-3)
            np.testing.assert_allclose(res[tag]["nll"], one[tag]["nll"],
                                       rtol=1e-3)
    (two_dir,) = list((root / "train_two").iterdir())
    (one_dir,) = list((root / "train_one").iterdir())

    def losses(run_dir):
        (events,) = run_dir.glob("events.out.tfevents.*")
        return [e["value"] for e in read_event_file(str(events))
                if e["tag"] == "fine_tune/loss/train"]
    assert len(losses(one_dir)) == 3
    np.testing.assert_allclose(losses(two_dir), losses(one_dir), rtol=1e-5)
    names = sorted(n for n in os.listdir(one_dir) if n.endswith(".msgpack"))
    assert names == sorted(n for n in os.listdir(two_dir)
                           if n.endswith(".msgpack"))
    assert {f"model_step_{s}__ep_2.msgpack" for s in (1, 2, 3)} <= set(names)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        elif isinstance(tree, (np.ndarray, torch.Tensor)):
            yield prefix, np.asarray(torch.as_tensor(tree).float())
    cfg = CWFAConfig().decode_lrs()
    lr = max(cfg.learning_rate, cfg.learning_rate_cond,
             cfg.learning_rate_first_step)
    for n in names:
        if n.startswith("mean_vols"):
            continue
        a = dict(leaves(load_step_checkpoint(str(one_dir / n))[0]))
        b = dict(leaves(load_step_checkpoint(str(two_dir / n))[0]))
        assert a.keys() == b.keys() and a, n
        for k in a:
            atol = 1e-5 * float(np.abs(a[k]).max())
            if not k.startswith("/optimizer_state_dict/"):
                atol = max(atol, 6 * lr)
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=atol,
                                       err_msg=f"{n}{k}")
