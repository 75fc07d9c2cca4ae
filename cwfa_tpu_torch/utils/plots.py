"""Matplotlib figure helpers for logging (a copy of
``cwfa_tpu/utils/plots.py``).  Matplotlib is imported inside each function:
hosts without it (the card's has none) run everything else, and a caller
catches the ImportError.  ``distributions_image`` draws the twin histogram
of ``plot_distributions`` in numpy alone, so its PNG is the same on every
host.

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

    fig = plt.figure()
    v1, v2 = _clamped(x1, n_std), _clamped(x2, n_std)
    plt.hist([v1, v2], color=["red", "blue"], bins=256, alpha=0.5)
    plt.axvline(float(np.mean(x1)), color="red", linestyle="--",
                label="x1 mean", linewidth=0.75)
    plt.axvline(float(np.mean(x2)), color="blue", linestyle="--",
                label="x2 mean", linewidth=0.75)
    plt.legend()
    return fig


def _clamped(v, n_std: float) -> np.ndarray:
    v = np.asarray(v, np.float64).reshape(-1).copy()
    if n_std != 0 and v.size:
        s, m = v.std(), v.mean()
        v = np.clip(v, m - n_std * s, m + n_std * s)
    return v


def distributions_image(x1, x2, n_std: float = 5.0) -> np.ndarray:
    """The twin histogram of ``plot_distributions`` as (480, 640, 3) uint8
    pixels, drawn without matplotlib: the two clamped arrays in 256 bins on
    shared edges, each a half-transparent column chart (red, blue) on
    white, scaled to the tallest bin, with each array's mean as a dashed
    line of its colour."""
    bins, height, width = 256, 480, 640
    v1, v2 = _clamped(x1, n_std), _clamped(x2, n_std)
    both = np.concatenate([v1, v2])
    edges = np.histogram_bin_edges(both if both.size else [0.0, 1.0], bins)
    h1 = np.histogram(v1, edges)[0]
    h2 = np.histogram(v2, edges)[0]
    top = max(int(h1.max(initial=0)), int(h2.max(initial=0)), 1)
    img = np.full((height, width, 3), 255.0)
    col = np.minimum((np.arange(width) * bins) // width, bins - 1)
    rows = np.arange(height)[:, None]
    lo, hi = edges[0], edges[-1]
    for hist, colour, x in ((h1, (255, 0, 0), x1), (h2, (0, 0, 255), x2)):
        bar = height - np.round(hist[col] / top * (height - 1))
        covered = rows >= bar[None, :]
        img[covered] = 0.5 * img[covered] + 0.5 * np.asarray(colour)
        if np.size(x):
            m = float(np.mean(x))
            c = int(np.clip((m - lo) / max(hi - lo, 1e-30) * (width - 1),
                            0, width - 1))
            dashes = (np.arange(height) // 8) % 2 == 0
            img[dashes, c] = colour
    return img.astype(np.uint8)


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
