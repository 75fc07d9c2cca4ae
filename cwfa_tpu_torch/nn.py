"""Layer helpers for cwfa_tpu_torch (counterpart of ``cwfa_tpu/nn.py``).

Layers themselves are torch's own modules (``nn.Conv2d``, ``nn.Conv3d``,
``nn.ConvTranspose2d``, ``nn.BatchNorm2d``, ``nn.PReLU``) with torch's
parameter names.  This module adds:

- the initializers of ``cwfa_tpu/nn.py:33-115``, drawing from an explicit
  ``torch.Generator``, so a random-weight model has the reference's
  activation scales (the bits differ from JAX's);
- the few pieces torch lacks as-is: SAME-padded convs, the LayerNorm over
  trailing (C, S, S) computed in f32, and the half-size max-pool;
- the train-mode pieces (reconstruction runs them too: the LRNN stays in
  train mode at inference, ``cwfa_tpu/models/cwfa_model.py:267-276``):
  BatchNorm on the batch's own statistics, with the running statistics
  updated when the module is in training mode; ``dropout2d``, ``drop_path``
  and the Dropout3d scale ``channel_dropout_scale``, drawing from an
  explicit ``torch.Generator``.  All of them carry gradients.

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


def subnet_init_(conv, generator):
    """reference subnet_initialization: kaiming_uniform weights (a = 0),
    bias*0.1."""
    _kaiming_uniform_(conv.weight, generator)
    _default_bias_(conv, generator, scale=0.1)


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
    the convs it initializes otherwise, or its own parameters.  Raises on a
    module type it does not know, so no parameter keeps its
    construction-time value."""
    mods = list(module.modules())
    for m in mods:
        if isinstance(m, _CONVS):
            torch_default_conv_init_(m, generator)
        elif isinstance(m, _DETERMINISTIC):
            m.reset_parameters()
        elif (any(True for _ in m.parameters(recurse=False))
              and not hasattr(m, "init_override_")):
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
        # written out: ``F.layer_norm`` gives each sample's normalized
        # elements to one thread block, and a sample here is (C, S, S),
        # 16.8 M elements at the flagship's 64 x 512 x 512
        dims = tuple(range(x.dim() - len(self.normalized_shape), x.dim()))
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=dims, correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def batch_norm_batch_stats(bn: nn.BatchNorm2d, x):
    """``bn`` on the statistics of the batch ``x`` itself (f32 sums, the
    biased variance: the train branch of ``cwfa_tpu/nn.py:302-325``), in x's
    dtype.  When ``bn`` is in training mode (``bn.train()``) its running
    statistics move as JAX's mstate does: momentum 0.1, the unbiased
    variance, the count up by one; otherwise they are neither read nor
    updated."""
    if bn.training:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, True, 0.1, bn.eps)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def dropout2d(x, rate: float, generator):
    """Channel dropout on (B, C, ...): whole (B, C) maps are zeroed with
    probability ``rate`` and the kept ones divided by 1 - rate
    (``cwfa_tpu/nn.py:359-369``).  The identity when ``generator`` is None
    or the rate 0; clean zeros at a rate of 1 or more.  The mask is drawn
    from ``generator`` on its device."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape[:2], generator=generator,
                      device=generator.device) < keep
    mask = mask.to(x.device).reshape(x.shape[:2] + (1,) * (x.dim() - 2))
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def channel_dropout_scale(shape, rate: float, generator, device):
    """The scale of a channel dropout over ``shape`` = (B, C): f32, 0 where
    a (sample, channel) map is dropped and 1 / (1 - rate) where it is kept;
    the mask is drawn as ``dropout2d`` draws it.  None (nothing to scale)
    when ``generator`` is None or the rate 0; zeros at a rate of 1 or more.
    The cond nets' Dropout3d (``cwfa_tpu/nn.py:372``) hands it to the 3-D
    pair kernel."""
    if generator is None or rate == 0.0:
        return None
    if rate >= 1.0:
        return torch.zeros(shape, device=device)
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=generator,
                      device=generator.device) < keep
    return mask.to(device, torch.float32) / keep


def drop_path(x, rate: float, generator):
    """Stochastic depth: whole samples of the batch are zeroed with
    probability ``rate``, the kept ones divided by 1 - rate
    (``cwfa_tpu/nn.py:375-383``).  The identity when ``generator`` is None
    or the rate 0; clean zeros at a rate of 1 or more."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                      generator=generator, device=generator.device) < keep
    return (x / keep * mask.to(x.device)).to(x.dtype)


def adaptive_max_pool2d_half(x):
    """reference unet.py:79 — adaptive max-pool to size//2, which is a 2x2/2
    max-pool for the even sizes the UNet sees."""
    return F.max_pool2d(x, 2, 2)
