"""The port's PSF loading (``cwfa_tpu_torch/data/psf.py``) and synthetic
data (``cwfa_tpu_torch/data/synthetic.py``) against the JAX package's on the
CPU: ``load_psf`` from a TIFF, an old-style ``.mat``, an ``.h5`` and a
MATLAB v7.3 ``.mat`` equal to the bit, with every depth subsampling
(interleaved, centred, a list); an h5-backed file without h5py raises an
error naming the format; ``load_psf_otf`` within 1e-5 * max|ref|; the three
numpy generators equal to the bit; ``make_synthetic_dataset`` writes the
same tree, lenslet file, PSF, volumes and neuron CSVs to the bit and camera
images within 1e-5 * max|ref| (projected through ``torch.fft`` here,
``jnp.fft`` there)."""

import os
import sys

import numpy as np
import pytest
import torch

from cwfa_tpu.data import psf as jpsf
from cwfa_tpu.data import synthetic as jsyn

from cwfa_tpu_torch.data import psf as tpsf
from cwfa_tpu_torch.data import synthetic as tsyn
from cwfa_tpu_torch.data.tiff import read_tiff_stack, write_tiff_stack


@pytest.fixture(scope="module")
def psf_np():
    rng = np.random.RandomState(7)
    psf = np.abs(rng.rand(10, 24, 26)).astype(np.float32)
    psf[:, 0, :] *= 3.0                  # rows and columns distinguishable
    psf[4] = 0                           # a zero plane: its sum stays 1
    return psf


def _write(kind, psf, path):
    """``psf`` (D, H, W) in the file format ``kind``."""
    if kind == "tif":
        write_tiff_stack(path, psf)
    elif kind == "mat":
        from scipy.io import savemat
        savemat(path, {"PSF": np.transpose(psf, (1, 2, 0))})  # (H, W, D)
    elif kind == "h5":
        import h5py
        with h5py.File(path, "w") as f:
            f["PSF"] = psf
    else:                                # MATLAB v7.3: HDF5 + a userblock
        import h5py
        with h5py.File(path, "w", userblock_size=512) as f:
            f["PSF"] = np.transpose(psf, (0, 2, 1))
        with open(path, "r+b") as f:
            f.write(b"MATLAB 7.3 MAT-file" + b" " * 97 + b"\x00" * 8
                    + b"\x00\x02IM")


_SUFFIX = {"tif": ".tif", "mat": ".mat", "h5": ".h5", "v73": ".mat"}


@pytest.mark.parametrize("kind", ["tif", "mat", "h5", "v73"])
@pytest.mark.parametrize("depths", [-1, 4, [0, 3, 9]])
def test_load_psf_matches_jax(psf_np, tmp_path, kind, depths):
    if kind in ("h5", "v73"):
        pytest.importorskip("h5py")
    path = str(tmp_path / f"psf{_SUFFIX[kind]}")
    _write(kind, psf_np, path)
    got = tpsf.load_psf(path, depths)
    want = jpsf.load_psf(path, depths)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[-2:] == (24, 24)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,interleaved", [(4, True), (4, False),
                                           (7, False), (10, True)])
def test_depth_subsampling(psf_np, n, interleaved):
    got = tpsf.load_psf(psf_np, n, interleaved=interleaved)
    want = jpsf.load_psf(psf_np, n, interleaved=interleaved)
    assert got.shape == (1, n, 24, 24)
    np.testing.assert_array_equal(got, want)
    sums = got.sum(axis=(-2, -1))
    assert np.all((np.abs(sums - 1) < 1e-5) | (sums == 0))


@pytest.mark.parametrize("kind", ["h5", "v73"])
def test_h5_formats_without_h5py_name_the_format(psf_np, tmp_path,
                                                  monkeypatch, kind):
    pytest.importorskip("h5py")
    path = str(tmp_path / f"psf{_SUFFIX[kind]}")
    _write(kind, psf_np, path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    what = "HDF5" if kind == "h5" else "MATLAB v7.3"
    with pytest.raises(ImportError, match=what):
        tpsf.load_psf(path)


def test_load_psf_otf_matches_jax(psf_np, tmp_path):
    path = str(tmp_path / "psf.tif")
    write_tiff_stack(path, psf_np)
    otf, psf_hw, full_hw = tpsf.load_psf_otf(path, (32, 32, 10),
                                             device="cpu")
    jotf, jpsf_hw, jfull_hw = jpsf.load_psf_otf(path, (32, 32, 10))
    assert (tuple(psf_hw), full_hw) == (tuple(jpsf_hw), jfull_hw) \
        == ((24, 24), (60, 60))
    assert otf.dtype == torch.complex64 and otf.device.type == "cpu"
    want = np.asarray(jotf)
    assert float(np.abs(otf.numpy() - want).max()) \
        <= 1e-5 * float(np.abs(want).max())


def test_synthetic_generators_equal_to_the_bit():
    c = tsyn.synthetic_lenslet_coords(9, 192, 64, seed=3)
    np.testing.assert_array_equal(
        c, jsyn.synthetic_lenslet_coords(9, 192, 64, seed=3))
    for got, want in zip(tsyn.synthetic_volume_sequence(3, 8, 24, seed=5),
                         jsyn.synthetic_volume_sequence(3, 8, 24, seed=5)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsyn.synthetic_psf(6, 40, c[:4] // 5, 16, seed=2),
        jsyn.synthetic_psf(6, 40, c[:4] // 5, 16, seed=2))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_make_synthetic_dataset_matches_jax(tmp_path):
    kw = dict(n_fish=2, n_frames=2, n_depths=6, vol_side=16, img_size=48,
              n_lenslets=4, view_size=16, seed=1)
    got = tsyn.make_synthetic_dataset(str(tmp_path / "port"), device="cpu",
                                      **kw)
    want = jsyn.make_synthetic_dataset(str(tmp_path / "jax"), **kw)
    troot, jroot = got["root"], want["root"]
    assert _tree(troot) == _tree(jroot) and len(_tree(troot)) == 10
    np.testing.assert_array_equal(got["coords"], want["coords"])
    np.testing.assert_array_equal(got["psf"], want["psf"])
    for rel in _tree(troot):
        a, b = os.path.join(troot, rel), os.path.join(jroot, rel)
        if rel.endswith(("XLFM_image_stack.tif")):
            ta, tb = read_tiff_stack(a), read_tiff_stack(b)
            assert ta.shape == tb.shape == (2, 48, 48)
            assert float(np.abs(ta - tb).max()) \
                <= 1e-5 * float(np.abs(tb).max())
        elif rel.endswith(".tif"):
            np.testing.assert_array_equal(read_tiff_stack(a),
                                          read_tiff_stack(b))
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), rel
    assert [os.path.relpath(p, troot) for p in got["fish_dirs"]] == \
        [os.path.relpath(p, jroot) for p in want["fish_dirs"]]
