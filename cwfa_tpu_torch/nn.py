"""Layer helpers for cwfa_tpu_torch (counterpart of ``cwfa_tpu/nn.py``).

Layers themselves are torch's own modules (``nn.Conv2d``, ``nn.Conv3d``,
``nn.ConvTranspose2d``, ``nn.BatchNorm2d``, ``nn.PReLU``) with torch's
parameter names.  This module adds:

- the initializers of ``cwfa_tpu/nn.py:33-115``, drawing from an explicit
  ``torch.Generator``, so a random-weight model has the reference's
  activation scales (the bits differ from JAX's);
- the few pieces torch lacks as-is: SAME-padded convs, the LayerNorm over
  trailing (C, S, S) computed in f32, and the half-size max-pool.

A PReLU shared across sites (``cwfa_tpu/models/cond_net.py:13-18``) is one
``nn.PReLU(1)`` called at each site.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# Initializers (torch-compatible distributions, explicit generator)
# ---------------------------------------------------------------------------


def _fan_in_out(shape) -> tuple[int, int]:
    """fan_in / fan_out for an OIHW(/OIDHW/OI) weight; on a transposed
    conv's (I, O, kH, kW) weight this gives torch's fan_in = O*kH*kW."""
    out_ch, in_ch = shape[0], shape[1]
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return in_ch * receptive, out_ch * receptive


@torch.no_grad()
def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    t.uniform_(-bound, bound, generator=generator)


def _kaiming_uniform_(w, generator, a: float = 0.0):
    fan_in, _ = _fan_in_out(w.shape)
    gain = math.sqrt(2.0 / (1.0 + a * a))
    _uniform_(w, gain * math.sqrt(3.0 / fan_in), generator)


def _xavier_uniform_(w, generator, gain: float = 1.0):
    fan_in, fan_out = _fan_in_out(w.shape)
    _uniform_(w, gain * math.sqrt(6.0 / (fan_in + fan_out)), generator)


def _default_bias_(conv, generator, scale: float = 1.0):
    if conv.bias is None:
        return
    fan_in, _ = _fan_in_out(conv.weight.shape)
    _uniform_(conv.bias, 1.0 / math.sqrt(fan_in), generator)
    with torch.no_grad():
        conv.bias.mul_(scale)


def torch_default_conv_init_(conv, generator):
    """torch Conv / ConvTranspose default: kaiming_uniform(a=sqrt(5))
    weights, bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    _kaiming_uniform_(conv.weight, generator, a=math.sqrt(5.0))
    _default_bias_(conv, generator)


def subnet_init_small_(conv, generator):
    """reference subnet_initialization_small: xavier(0.01) weights,
    bias*0.01."""
    _xavier_uniform_(conv.weight, generator, gain=0.01)
    _default_bias_(conv, generator, scale=0.01)


def subnet_init_positive_(conv, generator):
    """reference subnet_initialization_positive: |xavier(0.1)| weights,
    bias*0.1."""
    _xavier_uniform_(conv.weight, generator, gain=0.1)
    with torch.no_grad():
        conv.weight.abs_()
    _default_bias_(conv, generator, scale=0.1)


_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)
_DETERMINISTIC = (nn.BatchNorm2d, nn.LayerNorm, nn.PReLU)


def reset_parameters_(module: nn.Module, generator: torch.Generator):
    """Initialize every parameter and buffer under ``module``: convs with the
    torch default drawn from ``generator``; BatchNorm, LayerNorm and PReLU
    with their fixed defaults (ones/zeros, fresh running stats, alpha 0.25).
    Then every module with an ``init_override_(generator)`` method re-draws
    the convs it initializes otherwise.  Raises on a module type it does not
    know, so no parameter keeps its construction-time value."""
    mods = list(module.modules())
    for m in mods:
        if isinstance(m, _CONVS):
            torch_default_conv_init_(m, generator)
        elif isinstance(m, _DETERMINISTIC):
            m.reset_parameters()
        elif any(True for _ in m.parameters(recurse=False)):
            raise TypeError(f"no initializer for {type(m).__name__}")
    for m in mods:
        if hasattr(m, "init_override_"):
            m.init_override_(generator)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def same_conv2d(c_in: int, c_out: int, k: int, bias: bool = True):
    """Stride-1 conv with SAME padding (odd k), as ``cwfa_tpu.nn.conv2d``."""
    return nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=bias)


class LayerNormF32(nn.LayerNorm):
    """LayerNorm over the trailing ``normalized_shape`` dims with an
    elementwise affine, computed in f32 and cast back to the input dtype
    (``cwfa_tpu/nn.py:333-341``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def adaptive_max_pool2d_half(x):
    """reference unet.py:79 — adaptive max-pool to size//2, which is a 2x2/2
    max-pool for the even sizes the UNet sees."""
    return F.max_pool2d(x, 2, 2)
