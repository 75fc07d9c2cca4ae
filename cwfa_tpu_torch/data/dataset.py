"""XLFM dataset loading (host side, numpy), counterpart of
``cwfa_tpu/data/dataset.py``.

Reference: XLFMDataset.py:57-248 (XLFMDatasetFull), 251-405
(ConcatDataset), utils.py:128-220 (load_process_volume / load_XLFM_data).
TIFF loading order and hygiene match the JAX package: NaN/Inf cleared,
images clamped to [0, 50000], padded-to-square then center-cropped to the
camera frame, volumes center depth-windowed and center-cropped spatially,
stored float16.

Three faults of the reference (ROADMAP C) are not carried over:

- the NaN/Inf scrub is followed by a clip to float16's finite range, so a
  finite voxel above 65504 cannot become +inf in ``vols``;
- every in-place mutation (``standardize``, ``add_random_shot_noise_to_
  dataset``, ``normalize_datasets``) bumps the dataset's ``version``;
- every dataset object has a ``uid`` of its own (never reused, unlike
  ``id()``); ``ConcatXLFMDataset.cache_tag`` = (uid, the members' uids and
  versions) is what the trainer keys its per-frame caches on.
"""

from __future__ import annotations

import glob
import itertools
import os
import re
import warnings

import numpy as np

from cwfa_tpu_torch.data.stats import (DatasetStatistics, clip_volume_quantile,
                                       threshold_images)
from cwfa_tpu_torch.data.tiff import count_tiff_pages, read_tiff_stack

F16_MAX = float(np.finfo(np.float16).max)
_uids = itertools.count()


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


def _pad_to_square_img(img: np.ndarray) -> np.ndarray:
    """reference pad_img_to_min (XLFMDataset.py:15-25): crops the larger
    dimension symmetrically down to the smaller one (an odd difference
    crops one pixel extra, as the reference's floor division does)."""
    h, w = img.shape[-2:]
    m = min(h, w)
    ch = -((m - h) // 2)
    cw = -((m - w) // 2)
    return img[..., ch:h - ch or None, cw:w - cw or None]


def _center_crop_img(img: np.ndarray, target_hw) -> np.ndarray:
    """reference center_crop (XLFMDataset.py:27-40), zero-padding a
    dimension smaller than the target."""
    h, w = img.shape[-2:]
    th, tw = target_hw
    sy, sx = max((h - th) // 2, 0), max((w - tw) // 2, 0)
    ch, cw = min(h, th), min(w, tw)
    if ch == th and cw == tw:
        return img[..., sy:sy + th, sx:sx + tw]
    out = np.zeros(img.shape[:-2] + (th, tw), img.dtype)
    dy, dx = max((th - h) // 2, 0), max((tw - w) // 2, 0)
    out[..., dy:dy + ch, dx:dx + cw] = img[..., sy:sy + ch, sx:sx + cw]
    return out


def _center_crop_vol_spatial(vol: np.ndarray, side_hw) -> np.ndarray:
    """reference crop_volume_center (utils.py:105-126) on (D, H, W),
    zero-padding a dimension smaller than the target."""
    _, h, w = vol.shape
    th, tw = side_hw
    ch, cw = min(h, th), min(w, tw)
    y0 = min(max(h // 2 - th // 2, 0), h - ch)
    x0 = min(max(w // 2 - tw // 2, 0), w - cw)
    if ch == th and cw == tw:
        return vol[:, y0:y0 + th, x0:x0 + tw]
    out = np.zeros((vol.shape[0], th, tw), vol.dtype)
    dy, dx = max((th - h) // 2, 0), max((tw - w) // 2, 0)
    out[:, dy:dy + ch, dx:dx + cw] = vol[:, y0:y0 + ch, x0:x0 + cw]
    return out


def _frame_volume_file(data_path: str, img_ix: int) -> str:
    """The volume TIFF of frame ``img_ix``: ``XLFM_stack/*NNN.tif`` whose
    whole trailing number is the frame index."""
    for m in sorted(glob.glob(os.path.join(data_path, "XLFM_stack",
                                           f"*{img_ix:03d}.tif"))):
        g = re.search(r"(\d+)\.tif$", os.path.basename(m))
        if g and int(g.group(1)) == img_ix:
            return m
    raise FileNotFoundError(f"volume for frame {img_ix} not found under "
                            f"{os.path.join(data_path, 'XLFM_stack', '*.tif')}")


class XLFMDataset:
    """One fish's frames: camera images + (optionally) GT volumes.

    Layout: <data_path>/XLFM_image/XLFM_image_stack.tif (N pages) and
    <data_path>/XLFM_stack/*NNN.tif per-frame depth stacks."""

    def __init__(self, data_path: str, lenslet_coords_path: str, img_shape,
                 n_depths_to_fill: int = 120, images_to_use=None,
                 lenslets_offset: int = 50, load_vols: bool = True,
                 ds_id: str = ""):
        self.uid = next(_uids)
        self.version = 0
        self.data_path = data_path
        self.dataset_id = ds_id
        self.lenslet_coords = (read_lenslet_centers(lenslet_coords_path)
                               + lenslets_offset)
        self.n_lenslets = len(self.lenslet_coords)
        self.img_shape = tuple(img_shape)
        self.load_vols = load_vols

        imgs_path = os.path.join(data_path, "XLFM_image",
                                 "XLFM_image_stack.tif")
        if images_to_use is not None:
            # out-of-range pages dropped here, so that image rows and the
            # volume lookup below stay aligned
            n_avail = count_tiff_pages(imgs_path)
            kept = [p for p in images_to_use if 0 <= p < n_avail]
            if len(kept) != len(images_to_use):
                warnings.warn(f"frames {sorted(set(images_to_use) - set(kept))}"
                              f" out of range (stack has {n_avail} pages): "
                              "skipped")
            images_to_use = kept
        imgs = read_tiff_stack(imgs_path, pages=images_to_use)
        imgs = np.clip(np.nan_to_num(imgs), 0, 50000)
        self.n_images = imgs.shape[0]
        if images_to_use is None:
            images_to_use = list(range(self.n_images))
        self.images_to_use = list(images_to_use)

        self.stacked_views = np.zeros((self.n_images,) + self.img_shape,
                                      np.float32)
        for i in range(self.n_images):
            self.stacked_views[i] = _center_crop_img(
                _pad_to_square_img(imgs[i]), self.img_shape)

        if load_vols:
            files = [_frame_volume_file(data_path, ix)
                     for ix in self.images_to_use]
            first = read_tiff_stack(files[0])          # (D, H, W)
            d_use = min(n_depths_to_fill, first.shape[0])
            # float16, the reference's storage dtype (XLFMDataset.py:78)
            self.vols = np.zeros((self.n_images, d_use) + first.shape[1:],
                                 np.float16)
            for i in range(self.n_images):
                vol = first if i == 0 else read_tiff_stack(files[i])
                vol = np.where(np.isfinite(vol), vol, 0)
                # inside float16's finite range: the reference's f16 store
                # turns a finite voxel above 65504 into +inf
                vol = np.clip(vol, -F16_MAX, F16_MAX)
                lo = vol.shape[0] // 2 - d_use // 2
                self.vols[i] = vol[lo:lo + d_use]
        else:
            self.vols = np.zeros((1,), np.float32)

    def __len__(self):
        return self.n_images

    def __getitem__(self, index):
        views = self.stacked_views[index][None]
        if not self.load_vols:
            return views
        return views, self.vols[index], index

    def standardize(self, stats: DatasetStatistics):
        """In place: (views - mean) / std, (vols - mean) / std."""
        self.stacked_views = ((self.stacked_views - stats.mean_imgs)
                              / stats.std_imgs)
        self.vols = (self.vols - stats.mean_vols) / stats.std_vols
        self.version += 1

    def get_max(self):
        """(max_imgs, max_imgs_sparse, max_vols) (XLFMDataset.py:176-180);
        no sparse channel, so the sparse max is the image max."""
        m = float(self.stacked_views.max())
        return m, m, float(self.vols.max())

    def add_random_shot_noise_to_dataset(self, signal_power_range=(32 ** 2,
                                                                   32 ** 2),
                                         rng=None):
        """Poisson shot noise on the camera frames, in place (the JAX
        package's reading of XLFMDataset.py:397-405): per frame a signal
        power from ``signal_power_range``, the frame scaled to it, Poisson
        counts, scaled back.  Frames of non-positive mean are left as they
        are."""
        rng = np.random.default_rng(rng)
        lo, hi = float(signal_power_range[0]), float(signal_power_range[-1])
        for i in range(self.n_images):
            frame = self.stacked_views[i]
            mean = float(frame.mean())
            if mean <= 0:
                continue
            power = rng.uniform(lo, hi) if hi > lo else lo
            scaled = np.clip(frame, 0, None) * (power / mean)
            noisy = rng.poisson(scaled).astype(self.stacked_views.dtype)
            self.stacked_views[i] = noisy * (mean / power)
        self.version += 1


class ConcatXLFMDataset:
    """Several fish with global statistics (reference ConcatDataset,
    XLFMDataset.py:251-405)."""

    def __init__(self, *datasets: XLFMDataset):
        self.uid = next(_uids)
        self.datasets = list(datasets)

    @property
    def cache_tag(self):
        """Changes whenever a member is mutated in place; never shared by
        two dataset objects."""
        return (self.uid,) + tuple((d.uid, d.version) for d in self.datasets)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def locate(self, index):
        """(dataset index, local index) of a global index."""
        if index < 0:
            index += len(self)
        if index < 0:
            raise IndexError(index)
        for di, d in enumerate(self.datasets):
            if index < len(d):
                return di, index
            index -= len(d)
        raise IndexError(index)

    def __getitem__(self, index):
        di, li = self.locate(index)
        return self.datasets[di][li]

    def get_statistics(self) -> DatasetStatistics:
        """Global mean / std (ddof=1) over all fish, streamed per dataset in
        f64."""
        def moments(arrs):
            n = s = s2 = 0.0
            for a in arrs:
                a = a.astype(np.float64, copy=False)
                n += a.size
                s += float(a.sum())
                s2 += float(np.square(a).sum())
            mean = s / n
            var = max(s2 - n * mean * mean, 0.0) / (n - 1)
            return mean, float(np.sqrt(var))
        mi, si = moments(d.stacked_views for d in self.datasets)
        mv, sv = moments(d.vols for d in self.datasets)
        return DatasetStatistics(mean_imgs=mi, std_imgs=si, mean_imgs_s=mi,
                                 std_imgs_s=si, mean_vols=mv, std_vols=sv)

    def mean_volume(self, dataset_ix: int) -> np.ndarray:
        """Per-fish mean of the GT volumes (CWFA.py:645), accumulated in
        f32; (1, D, H, W)."""
        return self.datasets[dataset_ix].vols.astype(np.float32).mean(
            0, keepdims=True)

    def add_random_shot_noise_to_dataset(self, signal_power_range=(32 ** 2,
                                                                   32 ** 2),
                                         rng=None):
        rng = np.random.default_rng(rng)
        for d in self.datasets:
            d.add_random_shot_noise_to_dataset(signal_power_range, rng=rng)

    def get_max(self):
        maxes = [d.get_max() for d in self.datasets]
        return [max(m[i] for m in maxes) for i in range(3)]

    def normalize_datasets(self):
        """Rescale every fish to the global max (XLFMDataset.py:362-382),
        in place."""
        mx = self.get_max()
        for d in self.datasets:
            d.stacked_views = (d.stacked_views
                               / (float(d.stacked_views.max()) or 1.0)
                               * mx[0]).astype(d.stacked_views.dtype)
            d.vols = (d.vols / (float(d.vols.max()) or 1.0) * mx[2]
                      ).astype(d.vols.dtype)
            d.version += 1

    def standarize_datasets(self, stats: DatasetStatistics | None = None):
        """Standardize every fish with shared statistics
        (XLFMDataset.py:384-395); computes them when not given."""
        if stats is None:
            stats = self.get_statistics()
        for d in self.datasets:
            d.standardize(stats)
        return stats


def apply_volume_norm(vols: np.ndarray, norm, volume_ths) -> np.ndarray:
    """The reference's volume normalization (``--volume_norm_func``,
    utils.py:128-184): 'std' standardizes the stack by its own mean / std
    (ddof=1); 'max' divides by the stack max and zeroes voxels below the
    threshold (the lower bound of a 2-tuple); None thresholds two-sided
    (zero below ths[0], clip at ths[1]) or, for a scalar, zeroes voxels at
    or below ths * max."""
    if norm == "std":
        mean = float(vols.mean())
        std = float(vols.std(ddof=1)) or 1.0
        return (vols - mean) / std
    if norm == "max":
        mx = float(vols.max()) or 1.0
        out = vols / mx
        ths = (float(volume_ths[0]) if hasattr(volume_ths, "__len__")
               else float(volume_ths))
        out[out < ths] = 0
        return out
    if norm is not None:
        raise ValueError(f"unknown volume_norm_func {norm!r} "
                         "(expected None, 'std' or 'max')")
    if hasattr(volume_ths, "__len__") and len(volume_ths) == 2:
        vols[vols < volume_ths[0]] = 0
        vols[vols >= volume_ths[1]] = volume_ths[1]
    elif not hasattr(volume_ths, "__len__"):
        vols[vols <= float(volume_ths) * vols.max()] = 0
    return vols


def load_xlfm_data(dataset_path, lenslet_coords_file, vol_shape, img_shape,
                   images_to_use, n_depths_to_fill, ds_id="",
                   volume_ths=(0.0, 20000), volume_quantiles=(0, 0.99999),
                   img_ths=(0.01, 1), norm=None) -> XLFMDataset:
    """Dataset + hygiene thresholds (reference load_XLFM_data,
    utils.py:187-220): volumes center-cropped to vol_shape, thresholded,
    quantile-clipped; images zeroed below a fraction of their max."""
    ds = XLFMDataset(dataset_path, lenslet_coords_file, img_shape=img_shape,
                     images_to_use=images_to_use,
                     n_depths_to_fill=n_depths_to_fill, ds_id=ds_id)
    side = (vol_shape[0], vol_shape[1])
    if ds.vols.ndim == 4 and ds.vols.shape[-2:] != side:
        ds.vols = np.stack([_center_crop_vol_spatial(v, side)
                            for v in ds.vols])
    ds.vols = apply_volume_norm(ds.vols, norm, volume_ths)
    if volume_quantiles[1] != 1:
        ds.vols = clip_volume_quantile(ds.vols, volume_quantiles[1])
    ds.stacked_views = threshold_images(ds.stacked_views, img_ths[0])
    return ds
