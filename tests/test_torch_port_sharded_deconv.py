"""Depth-sharded Richardson–Lucy in the port (``ops.deconv.
xlfm_deconvolve_sharded`` and ``cli.deconvolve --mesh_depth_axis``) on the
CPU, on two gloo ranks (``tests/_torch_port_dist_worker.py``):

- against JAX's ``xlfm_deconvolve_sharded`` on ``make_mesh(n_data=1,
  n_space=2)`` (conftest gives JAX 8 virtual devices) and against the
  port's one-process ``xlfm_deconvolve``: within 1e-4 of max|ref|, each
  rank's block the matching depths of the whole, the image estimate the
  same on both ranks; two frames at intensities 300x apart, so the ratio
  clamp's median stays per frame;
- the CLI on two ranks writes the JAX CLI's files (``--mesh_depth_axis 2``
  on JAX's virtual mesh) within the same bound; a ``--mesh_depth_axis``
  that does not divide ``--n_depths`` exits with JAX's message.
"""

import ast
import contextlib
import io
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.cli import deconvolve as jcli
from cwfa_tpu.ops.deconv import xlfm_deconvolve_sharded as jsharded
from cwfa_tpu.ops.fft_conv import precompute_otf as jprecompute
from cwfa_tpu.ops.fft_conv import xlfm_forward_project
from cwfa_tpu.parallel import make_mesh

from cwfa_tpu_torch.cli import deconvolve as tcli
from cwfa_tpu_torch.data.synthetic import make_synthetic_dataset
from cwfa_tpu_torch.data.tiff import read_tiff_stack
from cwfa_tpu_torch.ops.deconv import xlfm_deconvolve
from cwfa_tpu_torch.ops.fft_conv import precompute_otf

from _torch_port_dist_worker import run_ranks

D, S, P, N_IT = 8, 16, 32, 3


def _close(got, want, bound=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bound * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def rl(tmp_path_factory):
    rng = np.random.RandomState(3)
    psf = np.abs(rng.rand(1, D, P, P)).astype(np.float32)
    psf /= psf.sum(axis=(-2, -1), keepdims=True)
    otf, full_hw = jprecompute(jnp.asarray(psf), (S, S))
    vol = np.abs(rng.rand(2, D, S, S)).astype(np.float32)
    vol[1] *= 300.0
    vol[1, :, 6:, :] = 0.0
    img = np.asarray(xlfm_forward_project(jnp.asarray(vol), otf, full_hw,
                                          psf_hw=(P, P)))
    path = str(tmp_path_factory.mktemp("rl") / "inputs.npz")
    np.savez(path, psf=psf, img=img)
    ranks = run_ranks("deconv", n=2, data=path, n_iter=N_IT, obj_hw=(S, S),
                      roi_depths=6)
    want, _ = jsharded(make_mesh(n_data=1, n_space=2), otf, jnp.asarray(img),
                       n_iter=N_IT, obj_hw=(S, S), roi_depths=6)
    totf, tfull = precompute_otf(torch.from_numpy(psf), (S, S))
    one, one_est = xlfm_deconvolve(totf, torch.from_numpy(img.copy()),
                                   n_iter=N_IT,
                                   obj_hw=(S, S), roi_depths=6,
                                   full_hw=tfull)
    return ranks, np.asarray(want), one.numpy(), one_est.numpy()


def test_two_ranks_match_jax_sharded(rl):
    ranks, want, _, _ = rl
    for r in ranks:
        _close(r["vol"], want)


def test_two_ranks_match_one_process(rl):
    ranks, _, one, one_est = rl
    for rank, r in enumerate(ranks):
        _close(r["vol"], one)
        _close(r["local"], one[:, rank * D // 2:(rank + 1) * D // 2],
               bound=1e-4 * np.abs(one).max()
               / np.abs(one[:, rank * D // 2:(rank + 1) * D // 2]).max())
        _close(r["est"], one_est)
    # the ROI mask by global depth: depths 0 and 7 are outside 6 of 8
    assert not ranks[0]["local"][:, 0].any()
    assert not ranks[1]["local"][:, -1].any()


@pytest.fixture(scope="module")
def fish(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_deconv_cli")
    info = make_synthetic_dataset(str(root / "data"), n_fish=1, n_frames=3,
                                  n_depths=D, vol_side=24, img_size=64,
                                  n_lenslets=4, view_size=24, device="cpu")
    return {"dir": info["fish_dirs"][0] + "/SLNet_preprocessed",
            "psf": info["psf_file"], "lenslets": info["lenslet_file"]}


def _argv(fish, posfix, *extra):
    return ["--data_folder", fish["dir"], "--psf_file", fish["psf"],
            "--lenslet_file", fish["lenslets"], "--images_to_use", "0", "2",
            "--n_it", str(N_IT), "--n_depths", str(D), "--vol_xy_size", "24",
            "--img_size", "64", "--posfix", posfix, *extra]


def test_cli_on_two_ranks_writes_the_jax_files(fish):
    tdir, = {r for r in run_ranks(
        "cli", n=2, module="cwfa_tpu_torch.cli.deconvolve",
        argv=_argv(fish, "_port_sharded", "--mesh_depth_axis", "2"))}
    with contextlib.redirect_stdout(io.StringIO()):
        jdir = jcli.main(_argv(fish, "_jax_sharded", "--mesh_depth_axis",
                               "2"))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "XLFM_stack_000.tif", "XLFM_stack_002.tif", "arguments.txt",
        "preview_MIP.tif"]
    for name in ("XLFM_stack_000.tif", "XLFM_stack_002.tif",
                 "preview_MIP.tif"):
        _close(read_tiff_stack(os.path.join(tdir, name)),
               read_tiff_stack(os.path.join(jdir, name)))
    with open(os.path.join(tdir, "arguments.txt")) as f:
        args = ast.literal_eval(f.read())
    assert args["mesh_depth_axis"] == 2


def test_cli_depth_axis_must_divide(fish):
    with pytest.raises(SystemExit, match="--mesh_depth_axis 3 must divide "
                                         "--n_depths 8"):
        tcli.main(_argv(fish, "_bad", "--mesh_depth_axis", "3"),
                  device="cpu")
