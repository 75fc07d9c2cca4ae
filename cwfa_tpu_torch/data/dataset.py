"""XLFM dataset loading (host side): what serving needs so far.

Counterpart of ``cwfa_tpu/data/dataset.py``; only ``read_lenslet_centers``
(``dataset.py:28-36``) is ported.  The datasets themselves
(``XLFMDataset``, ``ConcatXLFMDataset``, ``load_xlfm_data``) come with
training.
"""

from __future__ import annotations

import numpy as np


def read_lenslet_centers(filename: str) -> np.ndarray:
    """Tab-separated x<TAB>y rows (reference utils.py:27-40) as an
    (n_lenslets, 2) int64 array; lines with fewer than two fields are
    skipped."""
    rows = []
    with open(filename) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                rows.append((int(parts[0]), int(parts[1])))
    return np.array(rows, np.int64)
