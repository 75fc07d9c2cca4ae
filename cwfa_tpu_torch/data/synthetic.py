"""Synthetic XLFM data (counterpart of ``cwfa_tpu/data/synthetic.py``).

A physically structured generator that exercises the whole pipeline
without the zebrafish dataset: gaussian-blob "neuron" volumes with temporal
activity, a multi-lenslet synthetic PSF, and camera images formed through
the image-formation model (``ops.fft_conv.xlfm_forward_project``).  Written
in the reference's on-disk layout (XLFMDataset.py:85-122):

    <root>/<fish>/SLNet_preprocessed/XLFM_image/XLFM_image_stack.tif
    <root>/<fish>/SLNet_preprocessed/XLFM_stack/XLFM_stack_NNN.tif
    <root>/lenslet_centers_python.txt        (tab-separated x<TAB>y rows)
    <root>/<fish>/SLNet_preprocessed/Neural_activity_coordinates.csv

The three generators are numpy, equal to the bit to the JAX package's; the
images are projected on the device ``make_synthetic_dataset`` is given.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cwfa_tpu_torch.data.tiff import write_tiff_stack
from cwfa_tpu_torch.ops.fft_conv import precompute_otf, xlfm_forward_project


def synthetic_lenslet_coords(n_lenslets: int, img_size: int, view_size: int,
                             seed: int = 0) -> np.ndarray:
    """Lenslet centers on a jittered grid, valid for view extraction
    (coords are FILE coords — the dataset adds the +50 offset)."""
    rng = np.random.RandomState(seed)
    g = int(np.ceil(np.sqrt(n_lenslets)))
    half = view_size // 2
    lo, hi = half, img_size - half - 50
    xs = np.linspace(lo, max(hi, lo + 1), g).astype(np.int64)
    coords = [(x, y) for x in xs for y in xs][:n_lenslets]
    coords = np.array(coords) + rng.randint(-4, 5, size=(len(coords), 2))
    return np.clip(coords - 50, 0, img_size - 1)  # file stores coords-offset


def synthetic_volume_sequence(n_frames, n_depths, side, n_blobs=12, seed=0):
    """(N, D, S, S) float32 volumes: static gaussian blobs whose amplitudes
    follow smooth per-blob temporal traces (calcium-like)."""
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.meshgrid(np.arange(n_depths), np.arange(side),
                             np.arange(side), indexing="ij")
    centers = np.stack([
        rng.uniform(n_depths * 0.2, n_depths * 0.8, n_blobs),
        rng.uniform(side * 0.2, side * 0.8, n_blobs),
        rng.uniform(side * 0.2, side * 0.8, n_blobs)], 1)
    sig = np.stack([rng.uniform(1.0, max(n_depths / 12, 1.5), n_blobs),
                    rng.uniform(side / 40 + 1, side / 16 + 2, n_blobs),
                    rng.uniform(side / 40 + 1, side / 16 + 2, n_blobs)], 1)
    blobs = np.zeros((n_blobs, n_depths, side, side), np.float32)
    for i in range(n_blobs):
        blobs[i] = np.exp(-(((zz - centers[i, 0]) / sig[i, 0]) ** 2
                            + ((yy - centers[i, 1]) / sig[i, 1]) ** 2
                            + ((xx - centers[i, 2]) / sig[i, 2]) ** 2) / 2)
    t = np.arange(n_frames)[:, None]
    phases = rng.uniform(0, 2 * np.pi, n_blobs)
    freqs = rng.uniform(0.05, 0.3, n_blobs)
    traces = 0.55 + 0.45 * np.sin(t * freqs + phases)      # (N, n_blobs)
    vols = np.einsum("nb,bdhw->ndhw", traces.astype(np.float32), blobs)
    vols *= 1000.0 / max(vols.max(), 1e-6)
    return vols.astype(np.float32), centers, traces


def synthetic_psf(n_depths, psf_size, lenslet_coords_file_frame, view_size,
                  seed=0):
    """(1, D, P, P) PSF: per lenslet, a defocus-dependent gaussian spot whose
    lateral offset encodes depth parallax — qualitatively an XLFM PSF."""
    rng = np.random.RandomState(seed)
    coords = np.asarray(lenslet_coords_file_frame) + 50  # dataset-frame coords
    psf = np.zeros((n_depths, psf_size, psf_size), np.float32)
    yy, xx = np.meshgrid(np.arange(psf_size), np.arange(psf_size),
                         indexing="ij")
    center = psf_size / 2.0
    tilt = rng.uniform(-0.25, 0.25, size=(len(coords), 2))
    for d in range(n_depths):
        dz = d - n_depths / 2.0
        sigma = 1.2 + 0.12 * abs(dz)
        for li, (cy, cx) in enumerate(coords):
            oy = (cy - center) / center * dz * 0.8 + tilt[li, 0] * dz
            ox = (cx - center) / center * dz * 0.8 + tilt[li, 1] * dz
            psf[d] += np.exp(-(((yy - (cy + oy)) ** 2 + (xx - (cx + ox)) ** 2)
                               / (2 * sigma * sigma))).astype(np.float32)
    sums = psf.sum(axis=(-2, -1), keepdims=True)
    sums[sums == 0] = 1
    return (psf / sums)[None].astype(np.float32)


def make_synthetic_dataset(root: str, n_fish: int = 2, n_frames: int = 4,
                           n_depths: int = 16, vol_side: int = 64,
                           img_size: int = 192, n_lenslets: int = 9,
                           view_size: int = 64, seed: int = 0,
                           write_psf: bool = True, device="cuda"):
    """Generate a complete miniature dataset tree, the camera images
    projected on ``device``; returns its paths dict."""
    os.makedirs(root, exist_ok=True)
    coords = synthetic_lenslet_coords(n_lenslets, img_size, view_size, seed)
    lenslet_file = os.path.join(root, "lenslet_centers_python.txt")
    with open(lenslet_file, "w") as f:
        for x, y in coords:
            f.write(f"{x}\t{y}\n")

    psf = synthetic_psf(n_depths, img_size, coords, view_size, seed)
    psf_file = os.path.join(root, "PSF_synthetic.tif")
    if write_psf:
        write_tiff_stack(psf_file, psf[0])
    otf, full_hw = precompute_otf(torch.from_numpy(psf).to(device),
                                  (vol_side, vol_side))

    fish_dirs = []
    for fi in range(n_fish):
        vols, centers, traces = synthetic_volume_sequence(
            n_frames, n_depths, vol_side, seed=seed + 17 * fi)
        # one frame at a time: at the flagship's scale the batch of all
        # frames' canvases would not fit on the device
        imgs = np.concatenate([
            xlfm_forward_project(
                torch.from_numpy(vols[n:n + 1]).to(device), otf, full_hw,
                psf_hw=(img_size, img_size),
                depth_chunk=12 if img_size >= 1024 else None)[:, 0]
            .cpu().numpy()
            for n in range(n_frames)])
        imgs *= 5000.0 / max(imgs.max(), 1e-9)

        fish = os.path.join(root, f"fish_{fi}", "SLNet_preprocessed")
        os.makedirs(os.path.join(fish, "XLFM_image"), exist_ok=True)
        os.makedirs(os.path.join(fish, "XLFM_stack"), exist_ok=True)
        write_tiff_stack(os.path.join(fish, "XLFM_image",
                                      "XLFM_image_stack.tif"),
                         imgs.astype(np.float32))
        for n in range(n_frames):
            # volume TIFF pages are depth planes (the reference reads
            # (D, H, W) and permutes, XLFMDataset.py:244-247)
            write_tiff_stack(
                os.path.join(fish, "XLFM_stack", f"XLFM_stack_{n:03d}.tif"),
                vols[n])
        with open(os.path.join(fish, "Neural_activity_coordinates.csv"),
                  "w") as f:
            f.write("patch_n,coord_x,coord_y,coord_z,corr_coeff,is_gt\n")
            for i, c in enumerate(centers):
                f.write(f"{i},{c[2]:.1f},{c[1]:.1f},"
                        f"{c[0] - n_depths // 2:.1f},1.0,1\n")
        fish_dirs.append(os.path.dirname(fish))
    return {"root": root, "lenslet_file": lenslet_file, "psf_file": psf_file,
            "fish_dirs": fish_dirs, "coords": coords, "psf": psf}
