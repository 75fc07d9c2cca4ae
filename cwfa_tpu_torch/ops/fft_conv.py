"""Batched FFT convolution for the XLFM image-formation model, on
``torch.fft`` (cuFFT on a card, complex64 spectra); counterpart of
``cwfa_tpu/ops/fft_conv.py``.

Reference: utils.py:449-550 (roll_n / batch_fftshift2d_real, fft_conv,
fft_conv_split) and utils.py:593-627 (load_PSF_OTF).

Convention: volumes are (B, D, S, S); PSFs (1, D, P, P); the padded FFT
canvas is fullSize = S + P per spatial dim (linear-convolution support),
rounded up to a 5-smooth size of the same parity by default, and the
reference's ``batch_fftshift2d_real`` (roll by n//2, +1 when odd: for odd n
that is ``ifftshift``, not ``torch.fft.fftshift``) recenters the result.

The JAX package's carrier of spectra as (re, im) pairs and its matmul DFT
serve TPU runtimes without an FFT; here a spectrum is a complex tensor.
Every function computes on the device its inputs lie on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fftshift2d_real(x: torch.Tensor) -> torch.Tensor:
    """Reference batch_fftshift2d_real (utils.py:465-477): roll every spatial
    dim (2:) by n//2 (+1 for odd sizes)."""
    dims = tuple(range(2, x.ndim))
    shifts = tuple(x.shape[d] // 2 + x.shape[d] % 2 for d in dims)
    return torch.roll(x, shifts, dims)


def shifted_crop(x: torch.Tensor, start_hw, size_hw) -> torch.Tensor:
    """``fftshift2d_real(x)[..., h0:h0 + h, w0:w0 + w]`` of a 4-D ``x``
    without rolling the whole canvas: the window's rows and columns are
    gathered from where the roll takes them."""
    out = x
    for dim, start, size in ((2, start_hw[0], size_hw[0]),
                             (3, start_hw[1], size_hw[1])):
        n = x.shape[dim]
        shift = n // 2 + n % 2
        src = (torch.arange(start, start + size, device=x.device) - shift) % n
        out = out.index_select(dim, src)
    return out


def _pad_center(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Symmetric floor/ceil zero-pad of the trailing two dims to target_hw
    (reference fft_conv padding, utils.py:492-498)."""
    dh = target_hw[0] - x.shape[-2]
    dw = target_hw[1] - x.shape[-1]
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


def rfft2_padded(x: torch.Tensor, full_hw) -> torch.Tensor:
    """``rfft2`` of ``x`` in f32, zero-padded to the canvas ``full_hw``."""
    return torch.fft.rfft2(_pad_center(x.float(), full_hw))


def fft_conv(a: torch.Tensor, b_fft: torch.Tensor, full_hw) -> torch.Tensor:
    """Convolution with a precomputed rFFT kernel: pad a to full_hw, multiply
    spectra, inverse transform, recenter (utils.py:480-510, B_precomputed
    branch)."""
    out = torch.fft.irfft2(rfft2_padded(a, full_hw) * b_fft, s=tuple(full_hw))
    return fftshift2d_real(out)


def _next_smooth_same_parity(n: int) -> int:
    """Smallest integer >= n with the same parity as n whose prime factors
    are all in {2, 3, 5}.

    A canvas with a large prime factor puts an FFT on a slow path (the
    reference CLI's canvas 600 + 2160 = 2760 = 2^3*3*5*23).  Growing the
    linear-convolution canvas is exact only by an even amount: every
    offset downstream (the ``_pad_center`` floor halves, the fftshift roll,
    the center crops) moves by exactly (m - n)/2 when n -> m with
    m = n (mod 2), so the composed pad -> conv -> roll -> crop map is
    unchanged.  Even canvases round 2760 -> 2880; odd ones land on the
    sparser 3^a * 5^b grid."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 2


def precompute_otf(psf: torch.Tensor, obj_hw, *, smooth: bool = True,
                   depth_chunk: int = 24):
    """OTF = rfft2 of the PSF zero-padded to fullSize = obj + psf
    (reference load_PSF_OTF via fft_conv's B branch, utils.py:503-510,617).

    psf: (1, D, P, P) with per-depth sum normalized, on the device the OTF
    is wanted on.  smooth: round the canvas up to a 5-smooth size of the
    same parity (exact, see ``_next_smooth_same_parity``); False keeps the
    reference's obj + psf canvas.  depth_chunk: PSF depths transformed per
    FFT call, written into the preallocated OTF (one OTF in memory, not two
    while chunks are joined).  Returns (OTF complex64 (1, D, F0, F1//2+1),
    full_hw)."""
    p_hw = psf.shape[-2:]
    full_hw = (obj_hw[0] + p_hw[0], obj_hw[1] + p_hw[1])
    if smooth:
        full_hw = (_next_smooth_same_parity(full_hw[0]),
                   _next_smooth_same_parity(full_hw[1]))
    d = psf.shape[1]
    otf = torch.empty((psf.shape[0], d, full_hw[0], full_hw[1] // 2 + 1),
                      dtype=torch.complex64, device=psf.device)
    for j in range(0, d, depth_chunk):
        otf[:, j:j + depth_chunk] = rfft2_padded(psf[:, j:j + depth_chunk],
                                                 full_hw)
    return otf, full_hw


def _project_chunk(vol_chunk, otf_chunk, full_hw):
    """sum_d relu(irfft2(rfft2(pad(vol_d)) * OTF_d)), before the recentering
    roll (the roll commutes with the relu and the depth sum)."""
    img = torch.fft.irfft2(rfft2_padded(vol_chunk, full_hw) * otf_chunk,
                           s=tuple(full_hw))
    return torch.relu(img).sum(dim=1, keepdim=True)


def xlfm_forward_project(vol: torch.Tensor, otf: torch.Tensor, full_hw,
                         psf_hw=None, depth_chunk: int | None = None):
    """Image formation: sum over depths of PSF-convolved planes
    (reference fft_conv_split, utils.py:513-550; XLFMDeconv forward pass,
    utils.py:694-700).

    vol: (B, D, S, S) non-padded object volume.  depth_chunk: depths
    transformed at a time (a ragged last chunk is transformed as it is).
    Returns (B, 1, psf_hw) when psf_hw is given (center crop), else the
    padded (B, 1, full_hw) image."""
    full_hw = tuple(full_hw)
    d = vol.shape[1]
    chunk = d if depth_chunk is None else min(depth_chunk, d)
    img = None
    for j in range(0, d, chunk):
        part = _project_chunk(vol[:, j:j + chunk], otf[:, j:j + chunk],
                              full_hw)
        img = part if img is None else img + part
    if psf_hw is None:
        return fftshift2d_real(img)
    h0 = (full_hw[0] - psf_hw[0]) // 2
    w0 = (full_hw[1] - psf_hw[1]) // 2
    return shifted_crop(img, (h0, w0), tuple(psf_hw))
