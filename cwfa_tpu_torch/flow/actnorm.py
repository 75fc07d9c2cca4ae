"""ActNorm: per-channel affine with data-dependent initialization
(counterpart of ``cwfa_tpu/flow/actnorm.py``; reference
FrEIA/modules/invertible_resnet.py:11-85).

The reference initializes log-scale and bias from the first batch it sees
(``init_on_next_batch``); here, as in the JAX package, that is an explicit
pass (``actnorm_data_init``) over a sample batch, and ``actnorm`` is a pure
function of its parameters.
"""

from __future__ import annotations

import math

import torch


def init_actnorm(channels: int, ndim_spatial: int = 2,
                 dtype=torch.float32):
    """{"log_scale", "bias"}: zeros of (1, C, 1, ...)."""
    shape = (1, channels) + (1,) * ndim_spatial
    return {"log_scale": torch.zeros(shape, dtype=dtype),
            "bias": torch.zeros(shape, dtype=dtype)}


def actnorm_data_init(x):
    """Parameters that map the batch ``x`` to zero mean and unit std per
    channel (invertible_resnet.py:54-66): y = (x - mean) / std, the std
    biased, in f32."""
    axes = (0,) + tuple(range(2, x.dim()))
    xf = x.float()
    std = xf.std(dim=axes, keepdim=True, correction=0)
    mean = xf.mean(dim=axes, keepdim=True)
    return {"log_scale": -torch.log(std)[0:1], "bias": (-mean / std)[0:1]}


def actnorm(params, x, rev: bool = False):
    """y = exp(log_scale)*x + bias; logdet = n_pixels * sum(log_scale)
    ((B,) f32, negated in reverse)."""
    ls = params["log_scale"].float()
    jac = float(math.prod(x.shape[2:])) * ls.sum()
    bias = params["bias"].to(x.dtype)
    ones = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    if rev:
        return (x - bias) * torch.exp(-ls).to(x.dtype), ones * -jac
    return x * torch.exp(ls).to(x.dtype) + bias, ones * jac
