"""The flagship rig: the configuration, synthetic lenslet grid and statistics
that ``__graft_entry__._flagship`` builds for the JAX package, with the
port's own torch init.  ``chip_smoke.py`` and the port's tests build from it.
"""

from __future__ import annotations

import numpy as np
import torch

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.models.cwfa_model import CWFAModel


def lenslet_coords(n_lenslets: int, side: int, img: int) -> np.ndarray:
    """The rig's synthetic lenslet centers: a square grid of ``side``-wide
    views spread over an ``img``-wide frame, the first ``n_lenslets`` of
    it, as (row, col) int64 rows (the +50 of the dataset included)."""
    g = int(np.ceil(np.sqrt(n_lenslets)))
    half = side // 2
    xs = np.linspace(half, img - half, g).astype(np.int64)
    return np.array([(x, y) for x in xs for y in xs][:n_lenslets])


def flagship(small: bool, device, generator: torch.Generator):
    """Returns (cfg, model, stats, view_indices, img_side).

    small=False: ``CWFAConfig()`` — 512x512x96 volumes, 29 lenslet views of
    512^2 cut from 2160^2 frames, 4 CAT steps of 4 blocks with 64-wide
    towers.  small=True: 16 depths, 32^2, 4 lenslets, 2 steps of 2 blocks.
    The model is initialized on the CPU from ``generator`` (a CPU generator)
    and then moved to ``device``."""
    if small:
        cfg = CWFAConfig(n_depths=16, volume_side_size=32, n_lenslets=4,
                         INN_max_down_steps=3, INN_n_blocks=2,
                         INN_internal_chans=8, INN_cond_chans=4).decode_lrs()
        img = 128
    else:
        cfg = CWFAConfig().decode_lrs()
        img = 2160
    model = CWFAModel.build(cfg, generator).to(device)
    stats = DatasetStatistics(100.0, 50.0, 100.0, 50.0, 10.0, 5.0)
    side = cfg.volume_side_size
    coords = lenslet_coords(cfg.n_lenslets, side, img)
    vidx = make_view_indices(coords, (img, img), (side, side))
    return cfg, model, stats, vidx, img
