"""The serving entry point of the port (cwfa_tpu_torch.cli.serve) against
the JAX package's (cwfa_tpu.cli.serve) on the CPU: one checkpoint
directory written by cwfa_tpu's trainer, one lenslet file and five uint16
camera frames go through both.

- f32 (``--use_half_precision 0 --no_int8``): every volume within 1e-4 of
  max|JAX|;
- the default int8 UNet: ||port int8 - JAX f32|| / ||JAX f32 - mean|| <
  0.05, the bound of tests/test_inference.py;
- a wrong-shaped frame is skipped; mesh flags above 1 exit; without a card
  the CLI raises; the flags are the JAX CLI's;
- ``warmup``, ``throughput`` and ``latency_ms`` give positive numbers.

Small rig of tests/test_serve_cli.py: 8 depths, 32^2 volumes, 96^2 frames,
4 lenslets, 2 steps x 2 blocks, 4 wide.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.cli import serve as jserve
from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.data.tiff import read_tiff_stack as jread
from cwfa_tpu.data.views import make_view_indices
from cwfa_tpu.engine.trainer import CWFATrainer
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

from cwfa_tpu_torch.cli import serve
from cwfa_tpu_torch.cli.train import build_parser as port_train_parser
from cwfa_tpu_torch.data.tiff import read_tiff_stack, write_tiff_stack

from test_torch_port_layers import randomize_fixed_leaves

ND, VIEW, IMG, NL = 8, 32, 96, 4
COORDS = np.array([[52, 52], [52, 76], [76, 52], [76, 76]])
N_FRAMES = 5


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_serve_cli")
    cfg = JConfig(n_depths=ND, volume_side_size=VIEW, n_lenslets=NL,
                  INN_max_down_steps=2, INN_n_blocks=2, INN_internal_chans=4,
                  INN_cond_chans=2).decode_lrs()
    vidx = make_view_indices(COORDS, (IMG, IMG), (VIEW, VIEW))
    ckpt = str(root / "ckpt")
    tr = CWFATrainer(JModel.build(cfg), JStats(300.0, 80.0, 300.0, 80.0,
                                               2.0, 0.7),
                     vidx, output_path=ckpt)
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
    for i in range(N_FRAMES):
        write_tiff_stack(str(in_dir / f"cam_{i}.tif"),
                         rng.randint(100, 600, (IMG, IMG)).astype(np.uint16))
    base = ["--pretrain_models_path", ckpt, "--lenslet_file", str(lenslets),
            "--img_size", str(IMG), "--n_depths", str(ND),
            "--volume_side_size", str(VIEW), "--INN_max_down_steps", "2",
            "--INN_n_blocks", "2", "--INN_internal_chans", "4",
            "--INN_cond_chans", "2", "--in_dir", str(in_dir),
            "--batch", "2", "--use_half_precision", "0"]
    jax_out = root / "jax_f32"
    jserve.main(base + ["--no_int8", "--out_dir", str(jax_out)])
    return {"root": root, "base": base, "jax_out": jax_out}


def _volumes(out_dir):
    names = sorted(os.listdir(out_dir))
    return names, {n: read_tiff_stack(str(out_dir / n), dtype=None)
                   for n in names}


def test_f32_volumes_match_the_jax_cli(rig, capsys):
    out_dir = rig["root"] / "port_f32"
    out = serve.main(rig["base"] + ["--no_int8", "--out_dir", str(out_dir)],
                     device="cpu")
    assert out["frames"] == N_FRAMES and out["batches"] == 3
    assert out["padded_frames"] == 1
    assert out["feed_bytes"] == N_FRAMES * IMG * IMG * 2     # uint16 wire
    assert '"frames": 5' in capsys.readouterr().out
    names, got = _volumes(out_dir)
    want_names, want = _volumes(rig["jax_out"])
    assert names == want_names == [f"XLFM_stack_cam_{i}.tif"
                                   for i in range(N_FRAMES)]
    for n in names:
        assert got[n].shape == (ND, VIEW, VIEW) and got[n].dtype == np.float32
        assert np.isfinite(got[n]).all()
        np.testing.assert_array_equal(want[n], jread(
            str(rig["jax_out"] / n)))
        err = np.abs(got[n] - want[n]).max()
        assert err <= 1e-4 * np.abs(want[n]).max(), (n, err)


def test_int8_unet_within_the_norm_bound_of_f32(rig):
    out_dir = rig["root"] / "port_int8"
    out = serve.main(rig["base"] + ["--out_dir", str(out_dir)], device="cpu")
    assert out["frames"] == N_FRAMES
    names, got = _volumes(out_dir)
    _, want = _volumes(rig["jax_out"])
    g = np.stack([got[n] for n in names]).astype(np.float64)
    w = np.stack([want[n] for n in names]).astype(np.float64)
    rel = np.linalg.norm(g - w) / np.linalg.norm(w - w.mean())
    assert 0 < rel < 0.05, rel


def test_wrong_shaped_frame_is_skipped(rig, capsys):
    in2 = rig["root"] / "frames_bad"
    in2.mkdir()
    rng = np.random.RandomState(3)
    for i in range(2):
        write_tiff_stack(str(in2 / f"cam_{i}.tif"),
                         rng.randint(100, 600, (IMG, IMG)).astype(np.uint16))
    write_tiff_stack(str(in2 / "thumb.tif"),
                     rng.randint(100, 600, (16, 16)).astype(np.uint16))
    args = list(rig["base"])
    args[args.index("--in_dir") + 1] = str(in2)
    out_dir = rig["root"] / "vols_bad"
    out = serve.main(args + ["--no_int8", "--out_dir", str(out_dir)],
                     device="cpu")
    assert out["frames"] == 2
    assert sorted(os.listdir(out_dir)) == ["XLFM_stack_cam_0.tif",
                                           "XLFM_stack_cam_1.tif"]
    assert "skipped 'thumb.tif'" in capsys.readouterr().out


@pytest.mark.parametrize("flag, why", [
    ("--mesh_data_axis", "mesh of 2 devices.*world size of 1"),
    ("--mesh_space_axis", "--mesh_space_axis 2 asks for a mesh of 2 devices"
                          ".*world size of 1")])
def test_mesh_flags_exit(rig, flag, why):
    """A data or space mesh without its processes exits naming both
    sizes."""
    with pytest.raises(SystemExit, match=why):
        serve.main(rig["base"] + ["--out_dir", str(rig["root"] / "m"),
                                  flag, "2"], device="cpu")


def test_checkpoint_dir_is_required(rig):
    args = list(rig["base"])
    i = args.index("--pretrain_models_path")
    del args[i:i + 2]
    with pytest.raises(SystemExit, match="pretrain_models_path"):
        serve.main(args + ["--out_dir", str(rig["root"] / "x")], device="cpu")


def test_raises_without_a_card(rig):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(rig["base"] + ["--out_dir", str(rig["root"] / "c")])


def test_flags_are_the_jax_clis():
    from cwfa_tpu.cli.train import build_parser as jax_train_parser

    def flags(p):
        return {a.dest: (a.default, a.nargs, a.type)
                for a in p._actions if a.dest != "help"}

    assert flags(port_train_parser()) == flags(jax_train_parser())
    assert flags(serve.build_parser()) == flags(jserve.build_parser())


def test_timers_give_positive_numbers(rig):
    args = serve.build_parser().parse_args(
        rig["base"] + ["--no_int8", "--out_dir", str(rig["root"] / "t")])
    recon, img_shape = serve.build_reconstructor(args, "cpu")
    recon.warmup(2, img_shape)
    frames = np.random.RandomState(4).rand(2, IMG, IMG).astype(np.float32)
    fps = recon.throughput(frames, n_repeats=2)
    p50, best = recon.latency_ms(frames[:1], n=3)
    assert fps > 0 and 0 < best <= p50
    with pytest.raises(ValueError, match="one frame"):
        recon.latency_ms(frames)
