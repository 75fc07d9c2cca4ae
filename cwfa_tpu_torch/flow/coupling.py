"""The soft clamp and the ConditionalAffineTransform (CAT), the default CWFA
coupling block (counterpart of ``cwfa_tpu/flow/coupling.py:32-77``).

Clamp: s = clamp * f(s_raw) with f in {ATAN: 0.636*atan, TANH,
SIGMOID: 2*(sigmoid-0.5)} (reference coupling_layers.py:50-60).  The ATAN
factor is 0.636, not 2/pi.
"""

from __future__ import annotations

from typing import Callable

import torch

# Activation codes shared with the CUDA kernels (csrc/flow_affine.cu).
CLAMP_ACTIVATIONS = ("ATAN", "TANH", "SIGMOID")


def clamp_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "ATAN":
        return lambda u: 0.636 * torch.atan(u)
    if name == "TANH":
        return torch.tanh
    if name == "SIGMOID":
        return lambda u: 2.0 * (torch.sigmoid(u) - 0.5)
    raise ValueError(f"Unknown clamp activation {name!r}")


def cat_transform(subnet, x, conds, rev=False, clamp: float = 2.0,
                  clamp_activation: str = "ATAN"):
    """Affine transform of the whole tensor from the condition only
    (coupling_layers.py:440-500).  ``conds`` is a sequence of (B, Ci, H, W)
    tensors concatenated on channels; ``subnet`` maps sum(Ci) -> 2*C.
    Returns (y, per-sample logdet in f32)."""
    cond = conds[0] if len(conds) == 1 else torch.cat(list(conds), dim=1)
    return cat_apply(subnet(cond), x, rev, clamp, clamp_activation)


def cat_apply(a, x, rev=False, clamp: float = 2.0,
              clamp_activation: str = "ATAN"):
    """The CAT's affine of x from the subnet's output ``a`` = (s_raw | t)
    (B, 2C, H, W).  Returns (y, per-sample logdet in f32)."""
    c = x.shape[1]
    s_raw, t = a[:, :c], a[:, c:]
    s = (clamp * clamp_fn(clamp_activation)(s_raw.float())).to(x.dtype)
    j = s.float().sum(dim=tuple(range(1, s.dim())))
    if rev:
        return (x - t) * torch.exp(-s), -j
    return torch.exp(s) * x + t, j
