"""Maximum-intensity projections and composite images for logging, on the
host in numpy (a copy of ``cwfa_tpu/utils/projections.py:13-83``).

Reference: utils.py:281-327 (volume_2_projections), 396-417
(composite_projection), 223-263 (create_image_piramid).
"""

from __future__ import annotations

import numpy as np


def _nearest_resize(img: np.ndarray, out_hw) -> np.ndarray:
    """Nearest-neighbor resize of the trailing 2 dims."""
    h, w = img.shape[-2:]
    ri = (np.arange(out_hw[0]) * h // out_hw[0]).clip(0, h - 1)
    ci = (np.arange(out_hw[1]) * w // out_hw[1]).clip(0, w - 1)
    return img[..., ri[:, None], ci[None, :]]


def volume_2_projections(vol: np.ndarray, scaling_factors=(1, 1, 2),
                         border_thickness: int = 2,
                         add_scale_bars: bool = False) -> np.ndarray:
    """(B, D, H, W) volume -> tiled MIP image: z-projection with x/y
    projections along the borders (reference utils.py:281-327, with
    depths-in-channel input layout)."""
    vol = np.abs(np.asarray(vol, np.float32))
    b, d, h, w = vol.shape
    ds = d * scaling_factors[2]
    x_proj = vol.max(axis=2)                   # (B, D, W)
    y_proj = vol.max(axis=3)                   # (B, D, H)
    z_proj = vol.max(axis=1)                   # (B, H, W)
    out = np.full((b, h + ds + border_thickness, w + ds + border_thickness),
                  z_proj.min(), np.float32)
    out[:, :h, :w] = z_proj
    out[:, h + border_thickness:, :w] = _nearest_resize(
        np.transpose(x_proj, (0, 1, 2)), (ds, w))
    out[:, :h, w + border_thickness:] = _nearest_resize(
        np.transpose(y_proj, (0, 2, 1)), (h, ds))
    if add_scale_bars:
        out[:, h:h + border_thickness, :] = 1.0
        out[:, :, w:w + border_thickness] = 1.0
    return out


def composite_projection(tensor: np.ndarray) -> np.ndarray:
    """(D, H, W[, C]) -> composite of xy/xz/yz MIPs (utils.py:396-417)."""
    xy = tensor.max(axis=0)
    xz = tensor.max(axis=1)
    yz = np.transpose(tensor.max(axis=2), (1, 0) + tuple(range(2, tensor.ndim - 1)))
    yz = np.pad(yz, ((xz.shape[0], 0),) + ((0, 0),) * (yz.ndim - 1))
    top = np.vstack((xy, xz))
    return np.hstack((top, yz))


def create_image_pyramid(images, norm=np.max) -> np.ndarray:
    """Stack pyramid-level projections into one composite: level 0 top-left,
    finer levels in a right-hand column (utils.py:223-263)."""
    images = [np.asarray(im, np.float32).copy() for im in images]
    for img in images:
        border = img.max()
        img[0, :] = img[-1, :] = border
        img[:, 0] = img[:, -1] = border
    rows, cols = images[0].shape
    rows2, cols2 = images[1].shape if len(images) > 1 else (0, 0)
    comp = np.zeros((4 * rows + rows2, 4 * cols + cols2), np.float32)
    lead = images[0] - (images[0].min() if norm is not None else 0)
    if norm is not None:
        d = norm(lead)
        lead = lead / (d if d != 0 else 1)
    comp[:rows, :cols] = lead
    i_row = 0
    for ix, p in enumerate(images[1:]):
        nr, nc = p.shape
        if norm is not None:
            p = p - p.min()
            d = norm(p)
            p = p / (d if d != 0 else 1)
        else:
            p = p / 2 ** (ix + 1)
        comp[i_row:i_row + nr, cols:cols + nc] = p
        i_row += nr
    return comp[:max(i_row, rows), :cols + cols2]
