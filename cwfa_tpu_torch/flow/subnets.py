"""s,t-predicting subnetwork towers for the coupling blocks (counterpart of
``cwfa_tpu/flow/subnets.py:39-89``).

``WaveletFlowSubnet2d`` follows the Wavelet Flow paper design
(arXiv 2010.13821) as implemented in reference networks.py:586-706:

    b1 = 1x1 conv (in-proj)
    b2 = [3x3 conv -> ELU -> 1x1 conv](b1) + b1       (residual)
    b3 = ELU(b2); b4 = block(b3) + b3; b5 = ELU(b4); b6 = block(b5) + b5
    out = 3x3 conv(ELU(b6))

``tower`` runs the whole tower in one call of
``ops/btower.fused_float_tower``: the CUDA kernel on a card, its plain
version (f32 convs on canvases rounded to the compute dtype) on the CPU.

The ``_first`` variant (networks.py:684-706) is the input
ConditionalAffineTransform's subnet: its input is [low_res_up_grad | cond];
only ``cond`` goes through the tower (predicting s), and the translation is
the prior ``-low_res_up_grad/sqrt(2)``.  Its last conv is 0.01-Xavier
initialized (networks.py:706).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cwfa_tpu_torch.nn import same_conv2d, subnet_init_small_
from cwfa_tpu_torch.ops.btower import fused_float_tower

SQRT2_INV = 1.0 / math.sqrt(2.0)


class WaveletFlowSubnet2d(nn.Module):
    """Normal variant: full input through the tower -> c_out channels."""

    def __init__(self, c_in: int, c_out: int, n_ch: int = 64,
                 use_bias: bool = True):
        super().__init__()
        self.b1 = same_conv2d(c_in, n_ch, 1, use_bias)
        self.b2a = same_conv2d(n_ch, n_ch, 3, use_bias)
        self.b2b = same_conv2d(n_ch, n_ch, 1, use_bias)
        self.b4a = same_conv2d(n_ch, n_ch, 3, use_bias)
        self.b4b = same_conv2d(n_ch, n_ch, 1, use_bias)
        self.b6a = same_conv2d(n_ch, n_ch, 3, use_bias)
        self.b6b = same_conv2d(n_ch, n_ch, 1, use_bias)
        self.b7 = same_conv2d(n_ch, c_out, 3, use_bias)

    def tower(self, x):
        return fused_float_tower(x.contiguous(), self)

    def forward(self, x):
        return self.tower(x)


class WaveletFlowSubnet2dFirst(WaveletFlowSubnet2d):
    """First variant: c_in = 2n (concat of both conditions), c_out = 2n
    (s|t); the tower maps n -> n."""

    def __init__(self, c_in: int, c_out: int, n_ch: int = 64,
                 use_bias: bool = True):
        super().__init__(c_in // 2, c_out // 2, n_ch, use_bias)

    def init_override_(self, generator: torch.Generator):
        subnet_init_small_(self.b7, generator)

    def forward(self, x):
        n = x.shape[1] // 2
        low_res, cond = x[:, :n], x[:, n:]
        return torch.cat([self.tower(cond), low_res * -SQRT2_INV], dim=1)
