"""The port's deconvolution CLI (``python -m cwfa_tpu_torch.cli.deconvolve``,
``main(argv, device="cpu")``) against the JAX package's
(``cwfa_tpu.cli.deconvolve.main``) on the CPU, on a tiny synthetic fish
(8 depths at 24^2, 64^2 frames, 3 RL iterations): the same output tree
(``XLFM_stack_<date><posfix>/XLFM_stack_NNN.tif``, ``preview_MIP.tif``,
``arguments.txt`` with the same keys and values), volumes and MIP within
1e-4 * max|ref|; with ``--bkg_file`` and ``--dark_current``, and with
``--n_split_fourier 3`` (a ragged depth chunk).  The background case runs
on the same frames raised by a pedestal of 16, which a background of 13
(two noisy frames whose mean is 13, with a margin of 1000 that the center
crop must drop) and a dark current of 3 take off again: most pixels of the
synthetic frames are 0, and a background above them would leave RL a
negative frame and a negative clamp limit, where any two computations
part.  Each run has its own ``--posfix``, as the directory name is stamped
to the second.  The frames
come through the dataset path where the stream cannot start, and a decode
failure mid-stream propagates.  ``--mesh_depth_axis 2`` in one process
exits naming the mesh's size and the world size; without ``device="cpu"``
it raises here (no card)."""

import ast
import contextlib
import io
import os

import numpy as np
import pytest

from cwfa_tpu.cli import deconvolve as jcli

from cwfa_tpu_torch.cli import deconvolve as tcli
from cwfa_tpu_torch.data import native_tiff
from cwfa_tpu_torch.data.synthetic import make_synthetic_dataset
from cwfa_tpu_torch.data.tiff import read_tiff_stack, write_tiff_stack

N_DEPTHS, VOL, IMG = 8, 24, 64


@pytest.fixture(scope="module")
def fish(tmp_path_factory):
    root = tmp_path_factory.mktemp("deconv_cli")
    info = make_synthetic_dataset(str(root / "data"), n_fish=1, n_frames=3,
                                  n_depths=N_DEPTHS, vol_side=VOL,
                                  img_size=IMG, n_lenslets=4, view_size=24,
                                  device="cpu")
    fish = info["fish_dirs"][0] + "/SLNet_preprocessed"
    ped = root / "pedestal"
    (ped / "XLFM_image").mkdir(parents=True)
    write_tiff_stack(str(ped / "XLFM_image" / "XLFM_image_stack.tif"),
                     read_tiff_stack(os.path.join(
                         fish, "XLFM_image", "XLFM_image_stack.tif")) + 16)
    noise = np.random.RandomState(3).randint(-8, 9, (IMG, IMG)) / 8.0
    bkg = np.full((2, IMG + 6, IMG + 6), 1000, np.float32)
    bkg[:, 3:-3, 3:-3] = 13 + np.stack([noise, -noise])
    write_tiff_stack(str(root / "bkg.tif"), bkg)
    return {"dir": fish, "pedestal": str(ped), "psf": info["psf_file"],
            "lenslets": info["lenslet_file"], "bkg": str(root / "bkg.tif")}


def _argv(fish, posfix, *extra, folder="dir"):
    return ["--data_folder", fish[folder], "--psf_file", fish["psf"],
            "--lenslet_file", fish["lenslets"], "--images_to_use", "0", "2",
            "--n_it", "3", "--n_depths", str(N_DEPTHS), "--vol_xy_size",
            str(VOL), "--img_size", str(IMG), "--posfix", posfix, *extra]


def _close(got, want, bound=1e-4):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bound * float(np.abs(want).max()), err


def _run_both(fish, name, *extra, folder="dir"):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tdir = tcli.main(_argv(fish, f"_port_{name}", *extra, folder=folder),
                         device="cpu")
    jdir = jcli.main(_argv(fish, f"_jax_{name}", *extra, folder=folder))
    return tdir, jdir, out.getvalue()


def _check_same(tdir, jdir):
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == [
        "XLFM_stack_000.tif", "XLFM_stack_002.tif", "arguments.txt",
        "preview_MIP.tif"]
    for n in names[:2]:
        vol = read_tiff_stack(os.path.join(tdir, n))
        assert vol.shape == (N_DEPTHS, VOL, VOL) and np.isfinite(vol).all()
        _close(vol, read_tiff_stack(os.path.join(jdir, n)))
    _close(read_tiff_stack(os.path.join(tdir, "preview_MIP.tif")),
           read_tiff_stack(os.path.join(jdir, "preview_MIP.tif")))
    targs, jargs = (ast.literal_eval(open(os.path.join(d, "arguments.txt"))
                                     .read()) for d in (tdir, jdir))
    assert sorted(targs) == sorted(jargs)
    assert {k: v for k, v in targs.items() if k != "posfix"} == \
        {k: v for k, v in jargs.items() if k != "posfix"}


@pytest.mark.parametrize("name,extra,folder", [
    ("plain", (), "dir"),
    ("bkg", ("--bkg_file", "BKG", "--dark_current", "3"), "pedestal"),
    ("split", ("--n_split_fourier", "3"), "dir"),
])
def test_cli_matches_jax(fish, name, extra, folder):
    extra = tuple(fish["bkg"] if e == "BKG" else e for e in extra)
    tdir, jdir, text = _run_both(fish, name, *extra, folder=folder)
    assert os.path.basename(tdir).startswith("XLFM_stack_")
    assert tdir.endswith(f"_port_{name}")
    _check_same(tdir, jdir)
    assert text.splitlines()[-1] == f"Output path: {tdir}"
    assert f"deconvolved frame 2 -> {tdir}/XLFM_stack_002.tif" in text


def test_cli_background_is_taken_off(fish):
    """The pedestal's frames less the background and the dark current are
    the plain frames (to float32 rounding at 16), so the volumes agree;
    without the dark current they do not."""
    with contextlib.redirect_stdout(io.StringIO()):
        plain = tcli.main(_argv(fish, "_ref"), device="cpu")
        taken = tcli.main(_argv(fish, "_taken", "--bkg_file", fish["bkg"],
                                "--dark_current", "3", folder="pedestal"),
                          device="cpu")
        short = tcli.main(_argv(fish, "_short", "--bkg_file", fish["bkg"],
                                folder="pedestal"), device="cpu")
    va, vb, vc = (read_tiff_stack(os.path.join(d, "XLFM_stack_000.tif"))
                  for d in (plain, taken, short))
    _close(vb, va, 1e-3)
    assert not np.allclose(vc, va, rtol=0.1)


def test_cli_falls_back_to_the_dataset(fish, monkeypatch):
    def no_stream(*a, **k):
        raise OSError("stream cannot start")
    with contextlib.redirect_stdout(io.StringIO()):
        streamed = tcli.main(_argv(fish, "_stream"), device="cpu")
        monkeypatch.setattr(native_tiff, "PrefetchingTiffReader", no_stream)
        loaded = tcli.main(_argv(fish, "_dataset"), device="cpu")
    for n in ("XLFM_stack_000.tif", "XLFM_stack_002.tif"):
        np.testing.assert_array_equal(
            read_tiff_stack(os.path.join(loaded, n)),
            read_tiff_stack(os.path.join(streamed, n)))


def test_cli_mid_stream_failure_propagates(fish, monkeypatch):
    class Failing:
        def __init__(self, path, pages):
            self.first = pages[0]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def __iter__(self):
            yield self.first, read_tiff_stack(
                os.path.join(fish["dir"], "XLFM_image",
                             "XLFM_image_stack.tif"), pages=[0])[0]
            raise ValueError("native tiff prefetch failed: decode error")

    monkeypatch.setattr(native_tiff, "PrefetchingTiffReader", Failing)
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(ValueError, match="decode error"):
        tcli.main(_argv(fish, "_midstream"), device="cpu")


def test_cli_mesh_flag_exits_and_no_card_raises(fish):
    with pytest.raises(SystemExit, match="mesh of 2 devices.*world size of 1"):
        tcli.main(_argv(fish, "_mesh", "--mesh_depth_axis", "2"),
                  device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(_argv(fish, "_card"))
