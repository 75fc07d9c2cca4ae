"""Lenslet view extraction — the networks' condition input.

Counterpart of ``cwfa_tpu/data/views.py``.  Reference: XLFMDataset.py:212-242
(extract_views): crop lenslet-centered view patches out of the camera image
into (B, n_lenslets, vh, vw).

Edge semantics reproduced exactly: window rows are
``[max(c-half, 0), c+half)`` (python slicing truncates past the image), the
(possibly shorter) patch is written at the END of the view window
(``stacked_views[..., -h:, -w:] = patch``), leaving zeros at the start.
"""

from __future__ import annotations

import numpy as np
import torch


def make_view_indices(lenslet_coords: np.ndarray, img_hw, view_hw):
    """Precompute gather rows/cols + validity masks (numpy; a copy of
    ``cwfa_tpu.data.views.make_view_indices``).

    lenslet_coords: (n_lenslets, 2) int array of (row, col) centers, already
      including the +50 offset the dataset applies (XLFMDataset.py:74).
    Returns dict of numpy arrays: rows/cols (n, view) int32, row_mask/col_mask
      (n, view) float32.
    """
    coords = np.asarray(lenslet_coords, np.int64)
    n = coords.shape[0]
    out = {}
    for axis, (size, vsize) in enumerate(zip(img_hw, view_hw)):
        half = vsize // 2
        idx = np.zeros((n, vsize), np.int32)
        mask = np.zeros((n, vsize), np.float32)
        for l in range(n):
            c = int(coords[l, axis])
            lo = max(c - half, 0)
            hi = min(c + half, size)
            h = max(hi - lo, 0)
            r = np.arange(vsize)
            src = hi - vsize + r          # out slot r <- img index hi-vsize+r
            valid = (r >= vsize - h) & (src >= 0) & (src < size)
            idx[l] = np.clip(src, 0, size - 1)
            mask[l] = valid.astype(np.float32)
        out["rows" if axis == 0 else "cols"] = idx
        out["row_mask" if axis == 0 else "col_mask"] = mask
    return out


def extract_views(image: torch.Tensor, indices: dict) -> torch.Tensor:
    """image: (B, H, W) or (B, 1, H, W) -> views (B, n_lenslets, vh, vw).

    The index tables are contiguous ranges by construction (clipped crop
    windows), so each view is one static slice copied into the end of its
    zero-filled window."""
    if image.dim() == 4:
        image = image[:, 0]
    rows = np.asarray(indices["rows"])
    cols = np.asarray(indices["cols"])
    rmask = np.asarray(indices["row_mask"])
    cmask = np.asarray(indices["col_mask"])
    n, vh, vw = rows.shape[0], rows.shape[1], cols.shape[1]
    views = image.new_zeros((image.shape[0], n, vh, vw))
    for l in range(n):
        rvalid = np.nonzero(rmask[l])[0]
        cvalid = np.nonzero(cmask[l])[0]
        if len(rvalid) == 0 or len(cvalid) == 0:
            continue
        r_lo, r_hi = int(rows[l, rvalid[0]]), int(rows[l, rvalid[-1]]) + 1
        c_lo, c_hi = int(cols[l, cvalid[0]]), int(cols[l, cvalid[-1]]) + 1
        views[:, l, vh - (r_hi - r_lo):, vw - (c_hi - c_lo):] = \
            image[:, r_lo:r_hi, c_lo:c_hi]
    return views
