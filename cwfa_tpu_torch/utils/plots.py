"""Matplotlib figure helpers for logging (a copy of
``cwfa_tpu/utils/plots.py``).  Matplotlib is imported inside each function:
hosts without it (the card's has none) run everything else, and a caller
catches the ImportError.

Reference: CWFA.py:198-221 (plot_distributions), utils.py:330-377
(imshow2D/imshow3D/save_image)."""

from __future__ import annotations

import numpy as np


def plot_distributions(x1, x2, n_std: float = 5.0):
    """Clamped twin histogram of two arrays; returns a matplotlib figure
    (reference plot_distributions, CWFA.py:198-221)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def clamp(v):
        v = np.asarray(v, np.float64).reshape(-1).copy()
        if n_std != 0:
            s, m = v.std(), v.mean()
            v = np.clip(v, m - n_std * s, m + n_std * s)
        return v

    fig = plt.figure()
    v1, v2 = clamp(x1), clamp(x2)
    plt.hist([v1, v2], color=["red", "blue"], bins=256, alpha=0.5)
    plt.axvline(float(np.mean(x1)), color="red", linestyle="--",
                label="x1 mean", linewidth=0.75)
    plt.axvline(float(np.mean(x2)), color="blue", linestyle="--",
                label="x2 mean", linewidth=0.75)
    plt.legend()
    return fig


def figure_to_array(fig) -> np.ndarray:
    """Rasterize a matplotlib figure to (H, W, 3) uint8 for the TB writer."""
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return buf.reshape(h, w, 4)[..., :3].copy()


def save_projection_png(path: str, vol: np.ndarray, color_map: str = "inferno"):
    """MIP composite to PNG (reference imshow3D + savefig)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from cwfa_tpu_torch.utils.projections import volume_2_projections

    img = volume_2_projections(np.asarray(vol)[None])[0]
    plt.figure(figsize=(8, 8))
    plt.imshow(img / max(img.max(), 1e-9), cmap=color_map)
    plt.axis("off")
    plt.tight_layout()
    plt.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close()
