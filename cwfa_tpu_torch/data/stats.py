"""Dataset statistics and normalization.

A verbatim copy of ``cwfa_tpu/data/stats.py`` (numpy only).

Reference: XLFMDataset.py:315-395 (ConcatDataset.get_statistics /
standarize), utils.py:84-102 (fast_quantile histogram quantile),
utils.py:187-220 (load_XLFM_data thresholding).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DatasetStatistics:
    """Scalar normalization stats in the reference's 6-tuple order
    (mean_imgs, std_imgs, mean_imgs_s, std_imgs_s, mean_vols, std_vols)."""
    mean_imgs: float
    std_imgs: float
    mean_imgs_s: float
    std_imgs_s: float
    mean_vols: float
    std_vols: float

    def astuple(self):
        return (self.mean_imgs, self.std_imgs, self.mean_imgs_s,
                self.std_imgs_s, self.mean_vols, self.std_vols)

    @classmethod
    def compute(cls, images: np.ndarray, vols: np.ndarray,
                images_sparse: np.ndarray | None = None):
        """images: (N, H, W); vols: (N, D, H, W).  std uses the unbiased
        (ddof=1) estimator like torch.Tensor.std.  Accumulates in f64
        (volumes are stored f16 — naive np.mean would accumulate a
        float16 mean in float16)."""
        images = np.asarray(images, np.float64)
        vols = np.asarray(vols, np.float64)
        ims = (np.asarray(images_sparse, np.float64)
               if images_sparse is not None else images)
        return cls(
            mean_imgs=float(np.mean(images)),
            std_imgs=float(np.std(images, ddof=1)),
            mean_imgs_s=float(np.mean(ims)),
            std_imgs_s=float(np.std(ims, ddof=1)),
            mean_vols=float(np.mean(vols)),
            std_vols=float(np.std(vols, ddof=1)),
        )


def standardize(x, mean, std):
    return (x - mean) / std


def unstandardize(x, mean, std):
    return x * std + mean


def fast_quantile(x: np.ndarray, quant: float = 0.95) -> float:
    """Histogram-based quantile exactly as the reference computes it
    (utils.py:84-102): 10000 bins, cumulative count excluding bin 0, returns
    the left edge of the first bin at/after the quantile mass."""
    h, ranges = np.histogram(x, bins=10000)
    quant_numel = h[1:].sum() * quant
    cumulative = 0
    n_bin = 1
    for n_bin in range(1, len(h)):
        if cumulative >= quant_numel:
            break
        cumulative += h[n_bin]
    return float(ranges[n_bin])


def clip_volume_quantile(vols: np.ndarray, upper_quantile: float) -> np.ndarray:
    """Volume quantile clipping (utils.py:213-216)."""
    if upper_quantile != 1:
        ths = fast_quantile(vols, upper_quantile)
        vols = np.minimum(vols, ths)
    return vols


def threshold_images(images: np.ndarray, low_frac: float) -> np.ndarray:
    """Zero image pixels below low_frac*max (utils.py:217-218)."""
    ths = images.max() * low_frac
    out = images.copy()
    out[out < ths] = 0
    return out
