"""Evaluation metrics: per-step PSNR / MAPE and the neural-activity
correlation, on the host in numpy (a copy of ``cwfa_tpu/engine/metrics.py:
14-233``, which the port does not import).

Reference: CWFA.py:98-132 (compute_INN_step_performance), 240-379
(corr_coeff_3D), utils.py:419-446 (trace filtering/normalization).
"""

from __future__ import annotations

import numpy as np


def _psnr_np(a, b, pixel_max=1.0):
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return 0.0 if a.sum() == 0 else 100.0
    return 20.0 * np.log10(pixel_max / np.sqrt(mse))


def compute_step_performance(gt_volume, pred_volume, step, mean, std,
                             ths: float = 0.05):
    """Un-normalize by /2^step then *std - mean (the reference's exact
    un-normalization, CWFA.py:110-117 — note the minus), then PSNR and the
    masked-MAE 'MAPE' (CWFA.py:124-128)."""
    gt_raw = np.asarray(gt_volume, np.float64) / (2 ** step) * std - mean
    pred_raw = np.asarray(pred_volume, np.float64) / (2 ** step) * std - mean
    p = pred_raw.copy()
    if ths != 0:
        p[p < np.abs(p).max() * ths] = 0
        masked = float(np.mean(np.abs(gt_raw - p))) * 100.0
    else:
        masked = 0.0
    return _psnr_np(gt_raw, pred_raw), masked, gt_raw, pred_raw


def read_neural_coordinates(filename) -> list:
    """Load (x, y, z) neuron coordinates from the per-fish CSV, keeping rows
    with is_gt == 1 (reference read_neural_coordinates_from_file,
    CWFA.py:223-238)."""
    import csv
    coords = []
    files = [filename] if isinstance(filename, str) else list(filename)
    for fn in files:
        with open(fn) as f:
            for row in csv.DictReader(f):
                try:
                    if int(float(row.get("is_gt", 0))) == 1:
                        coords.append([float(row["coord_x"]),
                                       float(row["coord_y"]),
                                       float(row["coord_z"])])
                except (KeyError, ValueError):
                    continue
    return coords


def filter_trace(data, kernel_size: int = 10):
    """Moving-average filter (reference filter_data, utils.py:419-427)."""
    if kernel_size == 0:
        return np.asarray(data, np.float64)
    kernel = np.ones(kernel_size) / kernel_size
    return np.convolve(np.asarray(data, np.float64), kernel, mode="same")


def norm_trace(data, filter_width: int = 10):
    """Normalize a temporal trace to [0,1]; returns (trace, minmax range)
    (reference norm_data, utils.py:429-446)."""
    d = filter_trace(data, filter_width)
    lo, hi = d.min(), d.max()
    rng = hi - lo
    denom = hi if hi != 0 else 1.0
    return (d - lo) / denom, rng


class RoiTraceAccumulator:
    """Streaming collector for the neural-activity correlation metric.

    The reference accumulates EVERY reconstructed and GT volume in RAM and
    hands the full (T, D, H, W) stacks to corr_coeff_3D (CWFA.py:1095-1117)
    — ~200 MB per frame pair at flagship scale, fatal at its 250-frame test
    split.  Only three things about the stacks are actually consumed:

    - the per-coordinate ROI mean at each time step (a (T,)-trace),
    - the global stack maxima (stacks are normalized by them),
    - the median of the nonzero GT voxels (the adaptive inclusion
      threshold, CWFA.py:300-303).

    Traces and maxima stream exactly.  The nonzero-voxel median streams
    through a bounded uniform reservoir sample (Algorithm R, vectorized):
    exact until ``reservoir_cap`` values have been seen, then an unbiased
    uniform sample of the whole stream — documented approximation; the
    median only gates coord inclusion."""

    def __init__(self, coords, r12: int = 5, r3: int = 3,
                 start_plane_offset: int = -12,
                 reservoir_cap: int = 4_000_000, seed: int = 0):
        self.coords = [tuple(c) for c in coords]
        self.r12, self.r3 = r12, r3
        self.start_plane_offset = start_plane_offset
        self.gt_traces = [[] for _ in self.coords]
        self.pr_traces = [[] for _ in self.coords]
        self.gt_max = 0.0
        self.pr_max = 0.0
        self.empty_roi = [False] * len(self.coords)
        self.n_frames = 0
        self._depth = 0
        self._cap = int(reservoir_cap)
        self._res = np.empty(0, np.float64)
        self._n_seen = 0
        self._rng = np.random.RandomState(seed)

    def _roi_slices(self, shape, coord):
        x, y, z = coord
        zc = int(z) + shape[0] // 2 + self.start_plane_offset
        xs = slice(max(0, int(x) - self.r12), min(shape[2], int(x) + self.r12))
        ys = slice(max(0, int(y) - self.r12), min(shape[1], int(y) + self.r12))
        zs = slice(max(0, zc - self.r3), min(shape[0], zc + self.r3))
        return zs, ys, xs, zc

    def add(self, gt_vol, pred_vol):
        """One frame: gt_vol/pred_vol (D, H, W)."""
        gt_vol = np.asarray(gt_vol, np.float64)
        pred_vol = np.asarray(pred_vol, np.float64)
        self._depth = gt_vol.shape[0]
        self.gt_max = max(self.gt_max, float(gt_vol.max()))
        self.pr_max = max(self.pr_max, float(pred_vol.max()))
        nz = gt_vol[gt_vol > 0].ravel()
        if nz.size:
            # vectorized Algorithm R: the first `cap` values fill the
            # reservoir verbatim (exact — everything seen is kept); every
            # later value at global position t enters with prob cap/t into
            # a uniform slot.  Duplicate slots keep the LAST (highest-t)
            # write under numpy fancy assignment, matching the sequential
            # algorithm's overwrite order, so the sample stays uniform over
            # the whole stream — no per-frame replacement cap, no
            # first-frame raster bias.
            if self._n_seen < self._cap:
                take = nz[:self._cap - self._n_seen]
                self._res = np.concatenate([self._res, take])
                rest = nz[take.size:]
                base = self._n_seen + take.size
            else:
                rest = nz
                base = self._n_seen
            if rest.size:
                t = base + np.arange(1, rest.size + 1, dtype=np.float64)
                idx = np.flatnonzero(
                    self._rng.random_sample(rest.size) < self._cap / t)
                if idx.size:
                    slots = self._rng.randint(0, self._cap, size=idx.size)
                    self._res[slots] = rest[idx]
            self._n_seen += nz.size
        for ix, coord in enumerate(self.coords):
            zs, ys, xs, _ = self._roi_slices(gt_vol.shape, coord)
            roi = gt_vol[zs, ys, xs]
            if roi.size == 0:
                self.empty_roi[ix] = True
                continue
            self.gt_traces[ix].append(float(roi.mean()))
            self.pr_traces[ix].append(float(pred_vol[zs, ys, xs].mean()))
        self.n_frames += 1

    def finalize(self, minmax_ths: float = 50.0, filter_width: int = 10):
        """The reference's scoring loop with adaptive threshold halving
        (CWFA.py:276-335) on the accumulated traces.  Returns
        (corr_coeffs, records) exactly like ``corr_coeff_3d``.

        Parity quirk replayed deliberately: the reference's retry loop
        never resets ``all_corr_coeffs`` between threshold halvings
        (CWFA.py:277,322-335), so coords that already passed are appended
        again on each retry and the mean double-counts them; we keep the
        same behavior (and the same early-coord record duplication) so CC
        numbers and CSVs match the reference's."""
        gmax = max(self.gt_max, 1e-12)
        pmax = max(self.pr_max, 1e-12)
        d_shape_med = (float(np.median(self._res)) / gmax
                       if self._res.size else 0.0)
        all_cc: list = []
        records: list = []
        required = int(len(self.coords) * 0.2)
        n_div = 0
        while len(all_cc) <= required and n_div < 5:
            img_ths = d_shape_med * minmax_ths
            for ix, (x, y, z) in enumerate(self.coords):
                if self.empty_roi[ix] or not self.gt_traces[ix]:
                    all_cc.append(0.0)
                    continue
                gt_raw = np.asarray(self.gt_traces[ix]) / gmax
                pr_raw = np.asarray(self.pr_traces[ix]) / pmax
                fw = min(filter_width, gt_raw.shape[0])
                gt_sig, rng = norm_trace(gt_raw, fw)
                if rng < img_ths:
                    continue
                pr_sig, _ = norm_trace(pr_raw, fw)
                if gt_sig.max() == 0 or pr_sig.max() == 0:
                    cc = 0.0
                elif np.std(gt_sig) == 0 or np.std(pr_sig) == 0:
                    cc = 0.0
                else:
                    cc = float(np.corrcoef(gt_sig, pr_sig)[0, 1])
                all_cc.append(cc)
                zc = int(z) + self._depth // 2 + self.start_plane_offset
                for is_gt, sig in ((1, gt_sig), (0, pr_sig)):
                    rec = {"patch_n": ix, "coord_x": x, "coord_y": y,
                           "coord_z": zc, "corr_coeff": cc, "is_gt": is_gt}
                    rec.update({f"t{t}": float(sig[t])
                                for t in range(len(sig))})
                    records.append(rec)
            if len(all_cc) <= required:
                minmax_ths /= 2
                n_div += 1
        return all_cc, records


def corr_coeff_3d(stack_gt, pred_3d, coords, r12: int = 5, r3: int = 3,
                  start_plane_offset: int = -12, minmax_ths: float = 50.0,
                  filter_width: int = 10):
    """Pearson correlation of GT-vs-predicted temporal traces in ROI patches
    around neuron coordinates, with the reference's adaptive threshold
    halving (CWFA.py:276-335).

    stack_gt/pred_3d: (T, D, H, W); coords: list of (x, y, z).
    Returns (corr_coeffs list, records list of dicts).

    In-memory wrapper over :class:`RoiTraceAccumulator` (which the batched
    evaluator streams frame-by-frame)."""
    stack_gt = np.asarray(stack_gt, np.float64)
    pred_3d = np.asarray(pred_3d, np.float64)
    acc = RoiTraceAccumulator(coords, r12=r12, r3=r3,
                              start_plane_offset=start_plane_offset)
    for t in range(stack_gt.shape[0]):
        acc.add(stack_gt[t], pred_3d[t])
    return acc.finalize(minmax_ths=minmax_ths, filter_width=filter_width)
