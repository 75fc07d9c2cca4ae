"""The 1-D Haar wavelet transform along depth, with its log-det (counterpart
of ``cwfa_tpu/flow/haar.py:35-88``).

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
