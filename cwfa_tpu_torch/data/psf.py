"""PSF loading and OTF precomputation (counterpart of
``cwfa_tpu/data/psf.py``).

Reference: utils.py:553-627 (load_PSF / load_PSF_OTF): load a (D, P, P')
PSF stack from .mat / .h5 / .tif, square it, subsample depths (interleaved
linspace), normalize each depth plane to unit sum, then precompute the rFFT
OTF at fullSize = vol + psf on the device.

h5py is optional (the card's host has none): ``.h5`` files and MATLAB v7.3
``.mat`` files (which are HDF5) import it where they are read, and without
it raise an ImportError that names the format.
"""

from __future__ import annotations

import numpy as np
import torch

from cwfa_tpu_torch.data.dataset import _pad_to_square_img
from cwfa_tpu_torch.data.tiff import read_tiff_stack
from cwfa_tpu_torch.ops.fft_conv import precompute_otf


def _pad_to_square(psf: np.ndarray) -> np.ndarray:
    """reference pad_img_to_min applied to the PSF (utils.py:574): crops the
    larger trailing dim symmetrically down to the smaller one, as the
    camera-frame path does."""
    return _pad_to_square_img(psf)


def _read_h5_psf(path: str, what: str) -> np.ndarray:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading the PSF {path!r} ({what}) needs h5py, "
                          "which is not installed") from e
    with h5py.File(path, "r") as f:
        return np.asarray(f["PSF"][:], np.float32)


def load_psf(source, depths_to_use=-1, interleaved: bool = True) -> np.ndarray:
    """Load a PSF as (1, D, P, P) float32, depth-subsampled and per-depth
    sum-normalized (utils.py:553-591).

    source: path to .tif/.mat/.h5 or a (D, H, W) / (1, D, H, W) array.
    depths_to_use: -1 = all; int n = n interleaved (or centered) depths;
      or an explicit index list."""
    if isinstance(source, str):
        if source.endswith(".mat"):
            try:
                from scipy.io import loadmat
                psf = np.transpose(loadmat(source)["PSF"], (2, 0, 1))
            except (NotImplementedError, ValueError):
                # MATLAB v7.3 .mat files are HDF5.  MATLAB stores arrays
                # column-major, so an (H, W, D) array reads back as
                # (D, W, H): undo that to match the loadmat path's (D, H, W)
                psf = np.transpose(
                    _read_h5_psf(source, "MATLAB v7.3 .mat"), (0, 2, 1))
        elif source.endswith((".h5", ".hdf5")):
            # plain HDF5 written row-major: (D, H, W) as it is
            psf = _read_h5_psf(source, "HDF5")
        else:
            psf = read_tiff_stack(source)
    else:
        psf = np.asarray(source, np.float32)
    if psf.ndim == 4:
        psf = psf[0]
    psf = _pad_to_square(psf)[None]  # (1, D, P, P)

    if isinstance(depths_to_use, int):
        if depths_to_use == -1:
            depths = list(range(psf.shape[1]))
        else:
            n = depths_to_use
            if interleaved:
                depths = np.linspace(0, psf.shape[1], n + 2).astype(
                    np.int64)[1:-1]
            else:
                # the reference's window (utils.py:585): one off the center,
                # and n >= D - 1 indexes out of bounds, as there
                c = psf.shape[1] // 2
                depths = list(range(c - n // 2 + 1, c - n // 2 + 1 + n))
    else:
        depths = list(depths_to_use)
    psf = psf[:, depths]
    sums = psf.sum(axis=(-2, -1), keepdims=True)
    sums[sums == 0] = 1.0
    return (psf / sums).astype(np.float32)


def load_psf_otf(source, vol_size, device="cuda", depths: slice | None = None):
    """PSF -> OTF on ``device`` (reference load_PSF_OTF, utils.py:593-627).

    vol_size: (S, S, D) in the reference's (x, y, depths) order.
    depths: only these of the D depths (a rank's share of depth-sharded
    deconvolution); the PSF is cut on the host, before its upload.
    Returns (otf complex64 (1, D, F0, F1r), psf_hw, full_hw)."""
    psf = load_psf(source, vol_size[-1])
    if depths is not None:
        psf = np.ascontiguousarray(psf[:, depths])
    psf_hw = psf.shape[-2:]
    otf, full_hw = precompute_otf(torch.from_numpy(psf).to(device),
                                  tuple(vol_size[:2]))
    return otf, psf_hw, full_hw
