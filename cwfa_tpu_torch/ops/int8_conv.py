"""Plain int8 convolutions and per-channel quantizers (counterpart of the XLA
int8 convolutions of ``cwfa_tpu/models/unet.py:233-253`` and of the
quantizers of ``cwfa_tpu/ops/qtower.py``).

Every product is an exact int8 x int8 -> int32 GEMM (``torch._int_mm``) on
an im2col of the input, so the result does not depend on the summation
order and equals XLA's integer convolution.  ``_int_mm`` takes more than 16
rows and K and N as multiples of 8, and on an H100 cuBLASLt's int8 GEMM
refuses row counts that are not a multiple of 32 at N >= 64 and small K
(measured); the helpers pad with zeros, which add nothing to the sums.

Two quantizer forms, each where the JAX package uses it (they can differ by
one ulp at a ``round()`` boundary, so they are not unified):

- ``quantize_div``: ``v / s`` — the UNet (``unet.py:236-238``);
- ``quantize_mul``: ``v * (1/s)`` with the f32 reciprocal precomputed — the
  towers (``qtower.py:201-209,525``).

Both round half to even and clip to [-127, 127].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _chan(v):
    return v[None, :, None, None]


def quantize_div(v, s):
    """(B, C, H, W) -> int8, ``clip(round(v / s_c))``; s: (C,) f32."""
    return torch.clamp(torch.round(v.float() / _chan(s)), -127, 127).to(
        torch.int8)


def quantize_mul(v, inv):
    """(B, C, H, W) -> int8, ``clip(round(v * inv_c))``; inv: (C,) f32."""
    return torch.clamp(torch.round(v.float() * _chan(inv)), -127, 127).to(
        torch.int8)


def _pad8(n: int) -> int:
    return n + (-n) % 8


def _rows(m: int) -> int:
    return m + (-m) % 32


def int_mm(a, b):
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.  M is zero-padded
    to a multiple of 32, K and N to multiples of 8."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _rows(m), _pad8(k), _pad8(n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


# bytes of one im2col buffer of ``conv2d_int8``
IM2COL_BYTES = 1 << 30


def conv2d_int8(q, wq, padding: int):
    """Stride-1 conv of int8 q (B, I, H, W) with int8 OIHW wq (k x k),
    zero padding ``padding`` on each side -> int32 (B, O, H', W').

    im2col over as many frames at once as fit in ``IM2COL_BYTES``, at least
    one (the 3x3 im2col of a 256-channel 512^2 map is 0.6 GB; the cond
    nets' int8 pair has 32 channels and B x depth frames), K ordered (dy,
    dx, i) and zero-padded to a multiple of 8.  The sums are exact, so the
    grouping does not change the result."""
    b, i, h, w = q.shape
    o, _, k, _ = wq.shape
    kk = k * k * i
    wmat = torch.zeros((_pad8(kk), o), dtype=torch.int8, device=q.device)
    wmat[:kk] = wq.permute(2, 3, 1, 0).reshape(kk, o)
    x = q.permute(0, 2, 3, 1)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    ho, wo = x.shape[1] - k + 1, x.shape[2] - k + 1
    hw = ho * wo
    nb = max(1, min(b, IM2COL_BYTES // (hw * _pad8(kk))))
    out = torch.empty((b, o, ho, wo), dtype=torch.int32, device=q.device)
    cols = torch.zeros((_rows(nb * hw), _pad8(kk)), dtype=torch.int8,
                       device=q.device)
    for n0 in range(0, b, nb):
        m = min(nb, b - n0)
        for dy in range(k):
            for dx in range(k):
                t = (dy * k + dx) * i
                cols[:m * hw, t:t + i] = x[n0:n0 + m, dy:dy + ho,
                                           dx:dx + wo].reshape(m * hw, i)
        # rows past m * hw hold zeros or an earlier group's columns: their
        # sums are dropped
        acc = int_mm(cols[:_rows(m * hw)], wmat)[:m * hw]
        out[n0:n0 + m] = acc.reshape(m, ho, wo, o).permute(0, 3, 1, 2)
    return out


def conv_transpose2x2_int8(q, wq):
    """2x2, stride-2 transposed conv (torch ``ConvTranspose2d`` semantics,
    weight (I, O, 2, 2); JAX ``conv_transpose(..., transpose_kernel=True)``)
    of int8 q (B, I, H, W) -> int32 (B, O, 2H, 2W): one GEMM to O*4 outputs
    per pixel, then a pixel shuffle."""
    b, i, h, w = q.shape
    o = wq.shape[1]
    wmat = wq.reshape(i, o * 4)
    out = torch.empty((b, o, 2 * h, 2 * w), dtype=torch.int32,
                      device=q.device)
    for n in range(b):
        acc = int_mm(q[n].permute(1, 2, 0).reshape(h * w, i), wmat)
        out[n] = acc.reshape(h, w, o, 2, 2).permute(2, 0, 3, 1, 4).reshape(
            o, 2 * h, 2 * w)
    return out
