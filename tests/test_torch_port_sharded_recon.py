"""Data-parallel reconstruction in the port (``XLFMReconstructor(mesh=...)``,
``cli.serve --mesh_data_axis``) on the CPU, on two gloo ranks
(``tests/_torch_port_dist_worker.py``):

- deterministic, f32, on the small rig with JAX's weights: the batch of 4
  gathered on both ranks within 1e-4 of max|ref| of JAX's
  ``XLFMReconstructor(mesh=make_mesh(2, 1))``;
- the stochastic default mode with every draw on (the LRNN's dropout and
  ``drop_path`` at their rates, BatchNorm on batch statistics, z at T 0.7,
  2 samples): two ranks x 2 frames against one process x 4 frames from the
  same seed, within 1e-5 of max|ref| (the global batch's draws and
  BatchNorm statistics; only the order of the sums differs);
- the serve CLI with ``--mesh_data_axis 2 --batch 4`` writes the volumes
  that one process at ``--batch 2`` writes (each rank calls the model on 2
  frames), equal to the bit, with and without the int8 UNet (calibrated on
  each rank on the same frames and checked equal);
- ``cli.train --mesh_space_axis 2`` in one process exits naming the mesh
  it asks for and the world size (it trains on two ranks in
  ``tests/test_torch_port_space_recon.py``).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.data.views import make_view_indices
from cwfa_tpu.engine.inference import XLFMReconstructor as JReconstructor
from cwfa_tpu.engine.trainer import CWFATrainer as JTrainer
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel
from cwfa_tpu.parallel import make_mesh

from cwfa_tpu_torch.cli import serve
from cwfa_tpu_torch.data.tiff import read_tiff_stack, write_tiff_stack
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.rig import flagship

from _torch_port_dist_worker import run_ranks, start_ranks
from test_torch_port_layers import randomize_fixed_leaves


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


@pytest.fixture(scope="module")
def rig():
    from __graft_entry__ import _flagship
    cfg, jmodel, params, mstate, stats, vidx, img = _flagship(small=True)
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    mstate = randomize_fixed_leaves(mstate, rng)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(jmodel.n_flow_steps + 1)]
    frames = (rng.rand(4, img, img) * 1000).astype(np.float32)
    return cfg, jmodel, params, mstate, stats, vidx, caches, frames


def test_deterministic_matches_jax_mesh(rig):
    cfg, jmodel, params, mstate, stats, vidx, caches, frames = rig
    wait = start_ranks("recon", n=2, cfg_kw={}, seed=0, params=params,
                       mstate=mstate, caches=caches, frames=frames,
                       deterministic=True, temperature=0.0, n_samples=1)
    tree = jax.tree_util.tree_map(jnp.asarray, (params, mstate))
    want = np.asarray(JReconstructor(
        jmodel, *tree, stats, vidx, caches, mesh=make_mesh(2, 1),
        deterministic=True, use_pallas=True)(frames))
    for r in wait(120):
        assert r["vol"].shape == (4, 16, 32, 32)
        _close(r["vol"], want, 1e-4)


def test_stochastic_two_ranks_equal_one(rig):
    *_, caches, frames = rig
    kw = {"INN_z_temperature": 0.7, "INN_n_samples": 2}
    wait = start_ranks("recon", n=2, cfg_kw=kw, seed=3, params=None,
                       mstate=None, caches=caches, frames=frames,
                       deterministic=False, temperature=0.7, n_samples=2)
    import dataclasses
    cfg, model, stats, vidx, _ = flagship(True, "cpu",
                                          torch.Generator().manual_seed(3))
    model.cfg = dataclasses.replace(cfg, **kw)
    one = XLFMReconstructor(model, stats, vidx, caches,
                            device="cpu")(frames).numpy()
    ranks = wait(120)
    for r in ranks:
        _close(r["vol"], one, 1e-5)
    np.testing.assert_array_equal(ranks[0]["vol"], ranks[1]["vol"])


ND, VIEW, IMG, NL = 8, 32, 96, 4
COORDS = np.array([[52, 52], [52, 76], [76, 52], [76, 76]])


@pytest.fixture(scope="module")
def serve_rig(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_serve")
    cfg = JConfig(n_depths=ND, volume_side_size=VIEW, n_lenslets=NL,
                  INN_max_down_steps=2, INN_n_blocks=2, INN_internal_chans=4,
                  INN_cond_chans=2).decode_lrs()
    vidx = make_view_indices(COORDS, (IMG, IMG), (VIEW, VIEW))
    ckpt = str(root / "ckpt")
    tr = JTrainer(JModel.build(cfg), JStats(300.0, 80.0, 300.0, 80.0, 2.0,
                                            0.7), vidx, output_path=ckpt)
    rng = np.random.RandomState(0)
    np_tree = jax.tree_util.tree_map(np.asarray, (tr.params, tr.mstate))
    tr.params = jax.tree_util.tree_map(
        jnp.asarray, randomize_fixed_leaves(np_tree[0], rng))
    tr.mstate = jax.tree_util.tree_map(
        jnp.asarray, randomize_fixed_leaves(np_tree[1], rng))
    tr.mean_caches = {0: [jnp.asarray(rng.randn(
        1, ND // 2 ** (k + 1), VIEW, VIEW).astype(np.float32))
        for k in range(tr.model.n_flow_steps + 1)]}
    tr.save_checkpoints(epoch=2)
    lenslets = root / "lenslets.txt"
    lenslets.write_text("".join(f"{x - 50}\t{y - 50}\n" for x, y in COORDS))
    in_dir = root / "frames"
    in_dir.mkdir()
    for i in range(5):
        write_tiff_stack(str(in_dir / f"cam_{i}.tif"),
                         rng.randint(100, 600, (IMG, IMG)).astype(np.uint16))
    base = ["--pretrain_models_path", ckpt, "--lenslet_file", str(lenslets),
            "--img_size", str(IMG), "--n_depths", str(ND),
            "--volume_side_size", str(VIEW), "--INN_max_down_steps", "2",
            "--INN_n_blocks", "2", "--INN_internal_chans", "4",
            "--INN_cond_chans", "2", "--in_dir", str(in_dir),
            "--use_half_precision", "0"]
    return root, base


@pytest.mark.parametrize("int8", [False, True], ids=["no_int8", "int8"])
def test_serve_cli_on_two_ranks_writes_what_one_writes(serve_rig, int8):
    root, base = serve_rig
    flags = [] if int8 else ["--no_int8"]
    tag = "int8" if int8 else "f32"
    two, one = root / f"two_{tag}", root / f"one_{tag}"
    wait = start_ranks("cli", n=2, module="cwfa_tpu_torch.cli.serve",
                       argv=base + flags + ["--batch", "4", "--out_dir",
                                            str(two), "--mesh_data_axis",
                                            "2"])
    out = serve.main(base + flags + ["--batch", "2", "--out_dir", str(one)],
                     device="cpu")
    ranks = wait(120)
    assert out["frames"] == 5
    assert [r["frames"] for r in ranks] == [3, 2]
    assert [r["rank"] for r in ranks] == [0, 1]
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(two)) == [
        f"XLFM_stack_cam_{i}.tif" for i in range(5)]
    for n in names:
        np.testing.assert_array_equal(
            read_tiff_stack(str(two / n), dtype=None),
            read_tiff_stack(str(one / n), dtype=None), err_msg=n)


def test_space_axis_exits_naming_the_next_slice(serve_rig):
    from cwfa_tpu_torch.cli import train
    root, _ = serve_rig
    with pytest.raises(SystemExit, match="--mesh_data_axis 1 "
                       "--mesh_space_axis 2 asks for a mesh of 2 devices.*"
                       "world size of 1"):
        train.main(["--main_data_path", str(root), "--output_testing_path",
                    str(root / "t"), "--mesh_space_axis", "2"], device="cpu")
    assert not os.path.exists(root / "t")


def test_serve_limit_counts_served_frames_on_two_ranks(serve_rig):
    """``--limit 3`` over a directory with an unreadable file among the
    first three: one process and two ranks both serve the first three
    readable frames (the ranks are handed more files where one failed)."""
    root, base = serve_rig
    in_dir = root / "frames_with_bad"
    in_dir.mkdir()
    for i in range(5):
        (in_dir / f"cam_{i}.tif").write_bytes(
            (root / "frames" / f"cam_{i}.tif").read_bytes())
    (in_dir / "cam_1x.tif").write_bytes(b"not a tiff")
    flags = ["--no_int8", "--limit", "3", "--in_dir", str(in_dir)]
    two, one = root / "two_limit", root / "one_limit"
    wait = start_ranks("cli", n=2, module="cwfa_tpu_torch.cli.serve",
                       argv=base + flags + ["--batch", "4", "--out_dir",
                                            str(two), "--mesh_data_axis",
                                            "2"])
    out = serve.main(base + flags + ["--batch", "2", "--out_dir", str(one)],
                     device="cpu")
    ranks = wait(120)
    assert out["frames"] == sum(r["frames"] for r in ranks) == 3
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(two)) == [
        f"XLFM_stack_cam_{i}.tif" for i in range(3)]
    for n in names:
        want = read_tiff_stack(str(one / n), dtype=None)
        _close(read_tiff_stack(str(two / n), dtype=None), want, 1e-5)
