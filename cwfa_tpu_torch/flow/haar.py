"""The Haar wavelet transforms with their log-dets (counterpart of
``cwfa_tpu/flow/haar.py``): the 1-D transform along depth, and the 2-D
spatial one (``haar2d_downsample`` / ``haar2d_upsample``, at the end).

The core op of every CWF step: an orthonormal Haar butterfly along the depth
(channel) axis — averages in the first half of the channels, differences in
the second; spatial resolution is untouched (reference INN_utils.py:126-174):

    fwd:  out[:, :h] = (x[:, ::2] + x[:, 1::2]) / sqrt(2)
          out[:, h:] = (x[:, ::2] - x[:, 1::2]) / sqrt(2)
    rev:  out[:, ::2] = (x[:, :h] + x[:, h:]) / sqrt(2)
          out[:, 1::2] = (x[:, :h] - x[:, h:]) / sqrt(2)

Log-det quirk, replayed as the JAX package replays it: the reference scales
the VALUES by 1/sqrt(2) whatever ``rebalance`` is, but computes the log-det
from ``fac = 0.5 * rebalance`` (forward) or ``0.5 / rebalance`` (reverse) as
``ndims * (log 16 + 4 log fac) / 4``.  For ``rebalance != 1`` the reported
log-det does not belong to the (still orthonormal) transform, and forward
and reverse are not negatives of each other.  CWFA always uses rebalance 1,
where the log-det is exactly 0.
"""

from __future__ import annotations

import math

import torch

from cwfa_tpu_torch.flow.subnets import SQRT2_INV


def _logdet_coeff(rebalance: float, rev: bool) -> float:
    fac = 0.5 / rebalance if rev else 0.5 * rebalance
    return (math.log(16.0) + 4.0 * math.log(fac)) / 4.0


def _logdet(x, rebalance: float, rev: bool):
    ndims = float(math.prod(x.shape[1:]))
    value = ndims * _logdet_coeff(rebalance, rev)
    return torch.full((x.shape[0],), -value if rev else value,
                      dtype=torch.float32, device=x.device)


def haar1d_split(x, rebalance: float = 1.0):
    """Forward Haar of (B, D, H, W), D even, as its two halves.  Returns
    (averages, differences, logdet (B,) f32)."""
    even, odd = x[:, 0::2], x[:, 1::2]
    return ((even + odd) * SQRT2_INV, (even - odd) * SQRT2_INV,
            _logdet(x, rebalance, rev=False))


def haar1d_merge(avg, diff, rebalance: float = 1.0):
    """Inverse of ``haar1d_split``.  Returns (x (B, 2C, H, W), logdet)."""
    even = (avg + diff) * SQRT2_INV
    odd = (avg - diff) * SQRT2_INV
    b, c = avg.shape[:2]
    x = torch.stack([even, odd], dim=2).reshape((b, 2 * c) + avg.shape[2:])
    return x, _logdet(x, rebalance, rev=True)


def haar1d(x, rev: bool = False, rebalance: float = 1.0):
    """1-D Haar along axis 1 of (B, D, H, W).  Returns (y, logdet)."""
    if rev:
        h = x.shape[1] // 2
        return haar1d_merge(x[:, :h], x[:, h:], rebalance)
    avg, diff, logdet = haar1d_split(x, rebalance)
    return torch.cat([avg, diff], dim=1), logdet


# ---------------------------------------------------------------------------
# 2-D spatial Haar (FrEIA HaarDownsampling), cwfa_tpu/flow/haar.py:91-170
# ---------------------------------------------------------------------------

# the four 2-D Haar filters, LL, LH, HL, HH, applied per input channel
_HAAR2D = ((1, 1, 1, 1), (1, -1, 1, -1), (1, 1, -1, -1), (1, -1, -1, 1))


def _haar2d_perm(c_in: int, order_by_wavelet: bool):
    """Channel order of the 4*c_in outputs (reference reshapes.py:256-271):
    grouped by input channel, or by wavelet with ``order_by_wavelet``
    (output 4*ic + w at position w*c_in + ic)."""
    idx = torch.arange(4 * c_in)
    if not order_by_wavelet:
        return idx
    return idx.reshape(c_in, 4).t().reshape(-1)


def haar2d_downsample(x, rev: bool = False, order_by_wavelet: bool = False,
                      rebalance: float = 1.0):
    """2-D Haar: (B, C, H, W) <-> (B, 4C, H/2, W/2) with the reference's
    log-det (FrEIA/modules/reshapes.py:196-318).  The forward is a depthwise
    stride-2 conv with the four filters, scaled by 0.5 * rebalance; the
    inverse the explicit butterfly, scaled by 0.5 / rebalance.  Returns
    (y, logdet (B,) f32)."""
    fac_fwd, fac_rev = 0.5 * rebalance, 0.5 / rebalance
    jac_fwd = (math.log(16.0) + 4 * math.log(fac_fwd)) / 4.0
    jac_rev = (math.log(16.0) + 4 * math.log(fac_rev)) / 4.0
    b = x.shape[0]
    ndims = float(math.prod(x.shape[1:]))
    if not rev:
        c = x.shape[1]
        w = torch.tensor(_HAAR2D, dtype=x.dtype, device=x.device)
        w = w.reshape(4, 1, 2, 2).repeat(c, 1, 1, 1)
        y = torch.nn.functional.conv2d(x, w, stride=2, groups=c) * fac_fwd
        y = y[:, _haar2d_perm(c, order_by_wavelet).to(x.device)]
        return y, torch.full((b,), ndims * jac_fwd, dtype=torch.float32,
                             device=x.device)
    c4, hh, ww = x.shape[1:]
    c = c4 // 4
    inv = torch.argsort(_haar2d_perm(c, order_by_wavelet)).to(x.device)
    coef = x[:, inv].reshape(b, c, 4, hh, ww)
    ll, lh, hl, hh_ = coef.unbind(2)
    tl = ll + lh + hl + hh_
    tr = ll - lh + hl - hh_
    bl = ll + lh - hl - hh_
    br = ll - lh - hl + hh_
    top = torch.stack([tl, tr], dim=-1).reshape(b, c, hh, 2 * ww)
    bot = torch.stack([bl, br], dim=-1).reshape(b, c, hh, 2 * ww)
    y = torch.stack([top, bot], dim=3).reshape(b, c, 2 * hh, 2 * ww)
    return y * fac_rev, torch.full((b,), -ndims * jac_rev,
                                   dtype=torch.float32, device=x.device)


def haar2d_upsample(x, rev: bool = False, order_by_wavelet: bool = False,
                    rebalance: float = 1.0):
    """FrEIA HaarUpsampling: ``haar2d_downsample`` with rev flipped."""
    return haar2d_downsample(x, rev=not rev,
                             order_by_wavelet=order_by_wavelet,
                             rebalance=rebalance)
