"""Richardson–Lucy XLFM deconvolution on ``torch.fft`` (cuFFT on a card);
counterpart of ``cwfa_tpu/ops/deconv.py:112-325``.

Reference: utils.py:630-738 (XLFMDeconv).  Per iteration:

  ImgEst  = sum_d relu(fftshift(irfft2(rfft2(pad(Obj)) * OTF)))
  Ratio   = clamp(ImgExp / (ImgEst + 1e-8), 0, median_nonzero(Ratio) * mult)
  Obj     = crop( pad(Obj) * fftshift(irfft2(rfft2(Ratio) * conj(OTF))) )

and finally depths outside the ROI are zeroed (utils.py:736-737).

The JAX package's fused loop becomes a Python loop over iterations and
depth slabs that never waits for the device: the median is a sort and a
gather, the NaN freeze a ``torch.where``, and no value comes back to the
host, so a card runs the loop as one stream of launches.

``xlfm_deconvolve_sharded`` splits the depths over the ranks of a process
group (one process per device): each depth's FFTs are independent, and the
depth sum of the forward projection is one all-reduce of its spectrum an
iteration, where JAX's ``lax.psum`` sits (``cwfa_tpu/ops/deconv.py:382``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cwfa_tpu_torch.ops.fft_conv import (_pad_center, fftshift2d_real,
                                         rfft2_padded, shifted_crop)


def _median_nonzero_batch(x: torch.Tensor) -> torch.Tensor:
    """Per-sample torch ``t[t != 0].median()`` over the leading batch axis,
    (B, ...) -> (B,): the lower-middle element (index (n-1)//2) of the
    sorted nonzero values, 0 where a sample has none.  One sort with the
    zeros mapped to +inf and a gather, so it needs no host round trip
    (``_median_nonzero_sort`` / ``_median_nonzero_batch``,
    ``cwfa_tpu/ops/deconv.py:48-100``)."""
    flat = x.reshape(x.shape[0], -1)
    nz = flat != 0
    cnt = nz.sum(dim=1)
    srt = torch.sort(torch.where(nz, flat, torch.inf), dim=1).values
    idx = (cnt - 1).clamp(min=0) // 2
    val = srt.gather(1, idx[:, None])[:, 0]
    return torch.where(cnt > 0, val, torch.zeros_like(val))


def xlfm_deconvolve(otf: torch.Tensor, img: torch.Tensor, n_iter: int,
                    obj_hw=(512, 512), roi_depths: int = 90,
                    depth_chunk: int | None = None,
                    update_median_limit_multiplier: float = 10.0,
                    full_hw=None, init_obj=None, fourier_sum: bool = True):
    """RL-deconvolve an XLFM camera image into a depth volume, on the
    device ``otf`` lies on.

    otf: (1, D, F0, F1r) complex rFFT of the padded PSF (precompute_otf).
    img: (B, 1, I, I) raw camera image (background already removed).
    depth_chunk: depths per slab of the FFTs (the reference's
    n_split_fourier); the last slab is shorter when it does not divide D.
    init_obj: resume from a previous call's volume instead of the ones
    init; chaining n1- then n2-iteration calls equals one n1 + n2 call when
    roi_depths == D on the intermediate calls.
    full_hw: the canvas precompute_otf transformed on (its width's parity
    is ambiguous from the rFFT bin count; pass it when it may be odd).
    fourier_sum: sum the forward projection over depth in the Fourier
    domain, so one single-plane inverse transform replaces one per depth
    slab; the relu then follows the depth sum (JAX's choice; each
    per-depth plane is nonnegative up to FFT roundoff).  False keeps the
    reference's relu per depth before the sum.
    Each frame is its own run: the ratio clamp takes the frame's median,
    and a frame whose ratio holds a NaN keeps its volume from then on (the
    reference stops its loop there) while its batch-mates go on.
    Returns (volume (B, D, obj_hw), img_est (B, 1, F0, F1))."""
    return _richardson_lucy(otf, img, n_iter, obj_hw, roi_depths, depth_chunk,
                            update_median_limit_multiplier, full_hw, init_obj,
                            fourier_sum)


def xlfm_deconvolve_sharded(otf: torch.Tensor, img: torch.Tensor,
                            n_iter: int, obj_hw=(512, 512),
                            roi_depths: int = 90,
                            update_median_limit_multiplier: float = 10.0,
                            full_hw=None, group=None):
    """``xlfm_deconvolve`` with the depths split over the ranks of
    ``group`` (default: every process), in contiguous blocks: rank r holds
    ``otf``, its (1, D/N, F0, F1r) slice of the OTF (depths r D/N ..
    (r + 1) D/N - 1; ``data.psf.load_psf_otf(..., depths=)``), and every
    rank the same ``img``.  Each iteration sums the forward projection's
    spectrum over the local depths, then over the ranks by one all-reduce
    of a complex (B, 1, F0, F1r) tensor; the ROI mask takes global depth
    indices and the NaN freeze is per frame, as on one device.  The depth
    slabs of ``depth_chunk`` do not apply (each rank transforms its depths
    at once).  Returns (this rank's volume (B, D/N, obj_hw), img_est (B, 1,
    F0, F1), the same on every rank); ``gather_depths`` joins the volume."""
    return _richardson_lucy(otf, img, n_iter, obj_hw, roi_depths, None,
                            update_median_limit_multiplier, full_hw, None,
                            True, group=group, sharded=True)


def gather_depths(vol: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' depth blocks (B, D/N, H, W) joined in rank order into the
    (B, D, H, W) volume, on every rank."""
    from cwfa_tpu_torch.parallel.distributed import gather_rows
    return gather_rows(vol.transpose(0, 1).contiguous(),
                       group).transpose(0, 1).contiguous()


def _all_reduce_spectrum(spec: torch.Tensor, group):
    # as real pairs: every backend sums a real tensor
    pairs = torch.view_as_real(spec)
    dist.all_reduce(pairs, group=group)
    return spec


def _richardson_lucy(otf, img, n_iter, obj_hw, roi_depths, depth_chunk,
                     update_median_limit_multiplier, full_hw, init_obj,
                     fourier_sum, group=None, sharded=False):
    d0, n_depths = 0, otf.shape[1]
    if sharded and dist.is_initialized():
        n_ranks = dist.get_world_size(group)
        d0 = dist.get_rank(group) * otf.shape[1]
        n_depths = otf.shape[1] * n_ranks
    if full_hw is None:
        full_hw = (otf.shape[2], (otf.shape[3] - 1) * 2)
    full_hw = tuple(full_hw)
    obj_hw = tuple(obj_hw)
    dev = otf.device
    b = img.shape[0]

    img_exp = _pad_center(img.to(dev, torch.float32), full_hw)
    d_local = otf.shape[1]
    if init_obj is None:
        obj = torch.ones((b, d_local) + obj_hw, dtype=torch.float32,
                         device=dev)
    else:
        if tuple(init_obj.shape) != (b, d_local) + obj_hw:
            raise ValueError(f"init_obj of shape {tuple(init_obj.shape)}, "
                             f"expected {(b, d_local) + obj_hw}")
        obj = init_obj.to(dev, torch.float32)

    pad_hw = ((full_hw[0] - obj_hw[0]) // 2, (full_hw[1] - obj_hw[1]) // 2)
    chunk = d_local if depth_chunk is None else min(depth_chunk, d_local)
    slabs = [slice(j, j + chunk) for j in range(0, d_local, chunk)]

    img_est = torch.zeros_like(img_exp)
    for _ in range(n_iter):
        if fourier_sum:
            spec = None
            for sl in slabs:
                part = (rfft2_padded(obj[:, sl], full_hw)
                        .mul_(otf[:, sl]).sum(dim=1, keepdim=True))
                spec = part if spec is None else spec + part
            if sharded:
                spec = _all_reduce_spectrum(spec, group)
            img_est = torch.relu(fftshift2d_real(
                torch.fft.irfft2(spec, s=full_hw)))
        else:
            est = None
            for sl in slabs:
                plane = torch.fft.irfft2(
                    rfft2_padded(obj[:, sl], full_hw).mul_(otf[:, sl]),
                    s=full_hw)
                part = torch.relu(plane).sum(dim=1, keepdim=True)
                est = part if est is None else est + part
            # the roll commutes with the per-depth relu and the depth sum
            img_est = fftshift2d_real(est)
        ratio = img_exp / (img_est + 1e-8)
        limit = (_median_nonzero_batch(ratio).reshape(-1, 1, 1, 1)
                 * update_median_limit_multiplier)
        ratio = torch.minimum(torch.clamp(ratio, min=0.0), limit)
        ratio_fft = torch.fft.rfft2(ratio)
        # back-projection: the update reads the correction only inside the
        # object window, so each slab's inverse is cropped before the
        # multiply and the full-canvas correction is never rolled
        new_obj = torch.empty_like(obj)
        for sl in slabs:
            corr = torch.fft.irfft2(ratio_fft * otf[:, sl].conj(), s=full_hw)
            new_obj[:, sl] = obj[:, sl] * shifted_crop(corr, pad_hw, obj_hw)
        bad = torch.isnan(ratio).flatten(1).any(dim=1).reshape(-1, 1, 1, 1)
        obj = torch.where(bad, obj, new_obj)

    # zero depths outside the ROI (utils.py:736-737)
    lo = n_depths // 2 - roi_depths // 2
    hi = n_depths // 2 + roi_depths // 2
    d_idx = torch.arange(d0, d0 + d_local, device=dev).reshape(1, -1, 1, 1)
    keep = (d_idx >= lo) & (d_idx < hi)
    return torch.where(keep, obj, torch.zeros_like(obj)), img_est
