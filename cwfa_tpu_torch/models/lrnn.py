"""LRNN — the coarsest-step generator (counterpart of
``cwfa_tpu/models/lrnn.py:31-129``, reference networks.py:505-584); the
train mode that reconstruction and training run it in is an argument.

Maps the lenslet views to the lowest-resolution volume
(n_depths/2^{steps-1} = 6 depths at 512x512), corrected by a mean-volume
spatial prior:

    x = UNet(Conv1x1_positive(views))                       (networks.py:536-542)
    x += ConvNeXt2(ConvNeXt1(mean_vol)) * 2*(attn(mean_vol)-0.5)
                                                            (networks.py:551-555)

ConvNeXt block (networks.py:468-503): 1x1 in-proj, then
[7x7 conv -> LayerNorm([C,S,S]) -> 1x1 conv -> exact GELU] plus the residual
from the in-projection, through ``drop_path`` in train mode.  The LayerNorm carries a full (C, S, S) elementwise
affine, eps 1e-5, computed in f32.

Under a row shard (``parallel.mesh.row_shard``) x holds this rank's rows
and the UNet exchanges its halos; the mean branch reads the whole mean
cache (its LayerNorm spans (C, H, W) and its gate's Conv1d the flattened
H*W), so every rank computes it whole, with the same ``drop_path`` draws,
and adds its own rows.  In training each rank's loss then reaches the
branch's parameters through its own rows only, and the step's gradient
all-reduce adds the ranks' parts, with no exchange.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from cwfa_tpu_torch.models.cond_net import GlobalAttention
from cwfa_tpu_torch.models.unet import UNet, UNetSpec, unet_quantized
from cwfa_tpu_torch.nn import (LayerNormF32, drop_path, same_conv2d,
                               subnet_init_positive_)
from cwfa_tpu_torch.parallel.mesh import current_rows


@dataclass(frozen=True)
class LRNNSpec:
    ch_in: int = 29
    n_depths: int = 6
    spatial: int = 512
    use_bias: bool = False
    unet: UNetSpec = None  # filled by __post_init__ when None
    convnext_width: int = 64
    convnext_drop: float = 0.05
    unet_drop: float = 0.005

    def __post_init__(self):
        if self.unet is None:
            object.__setattr__(self, "unet", UNetSpec(
                in_channels=self.n_depths, n_classes=self.n_depths,
                depth=3, wf=8, batch_norm=True, use_bias=self.use_bias,
                skip_conn=True, drop_out=self.unet_drop))


class ConvNeXt(nn.Module):
    def __init__(self, c_in: int, c_out: int, size: int):
        super().__init__()
        self.inp = same_conv2d(c_in, c_out, 1)
        self.dw = same_conv2d(c_out, c_out, 7)
        self.ln = LayerNormF32((c_out, size, size), eps=1e-5)
        self.pw = same_conv2d(c_out, c_out, 1)

    def forward(self, x, drop_prob: float = 0.0, generator=None):
        up = self.inp(x)
        y = self.ln(self.dw(up))
        return F.gelu(self.pw(y)) + drop_path(up, drop_prob, generator)


class LRNN(nn.Module):
    def __init__(self, spec: LRNNSpec):
        super().__init__()
        self.spec = spec
        self.proj = same_conv2d(spec.ch_in, spec.n_depths, 1, spec.use_bias)
        self.cnx1 = ConvNeXt(spec.n_depths, spec.convnext_width, spec.spatial)
        self.cnx2 = ConvNeXt(spec.convnext_width, spec.n_depths, spec.spatial)
        self.attn = GlobalAttention(spec.n_depths)
        self.unet = UNet(spec.unet)

    def init_override_(self, generator: torch.Generator):
        subnet_init_positive_(self.proj, generator)

    def forward(self, x, mean_vol=None, mean_branch=None, unet_q=None,
                train=False, generator=None):
        """x: (B, ch_in, H, W); mean_vol: (1 or B, n_depths, H, W) or None.
        Under a row shard x holds this rank's rows, and mean_vol and
        mean_branch are whole.

        mean_branch: a precomputed ``lrnn_mean_branch`` output (broadcast
        over the batch); when given, mean_vol is ignored.
        unet_q: optional int8 UNet pack ({"qpack", "scales"} from
        ``CWFAModel.quantize_unet_pack``); ignored in train mode, as
        ``lrnn.py:116``.
        train: the UNet's BatchNorm on batch statistics, and its Dropout2d
        and the ConvNeXt ``drop_path`` drawing from ``generator`` (the UNet
        first, then the mean branch: the order of ``lrnn.py:122-128``)."""
        y = self.proj(x)
        if unet_q is not None and not train:
            y = unet_quantized(self.unet, y, unet_q["qpack"], unet_q["scales"])
        else:
            y = self.unet(y, train=train, generator=generator)
        if mean_branch is None and mean_vol is not None:
            mean_branch = lrnn_mean_branch(self, mean_vol, train=train,
                                           generator=generator)
        if mean_branch is not None:
            rows = current_rows()
            y = y + (mean_branch if rows is None else rows.own(mean_branch))
        return y


def lrnn_mean_branch(lrnn: LRNN, mean_vol, train=False, generator=None):
    """The mean-volume correction ``cnx2(cnx1(m)) * 2*(attn(m)-0.5)``
    (reference networks.py:551-555).  In eval mode a pure function of the
    per-dataset mean cache, so deterministic inference computes it once; in
    train mode each sample of ``mean_vol``'s batch goes through the two
    ``drop_path`` draws (``lrnn.py:84-101``)."""
    drop = lrnn.spec.convnext_drop if train else 0.0
    m = lrnn.cnx1(mean_vol, drop, generator)
    m = lrnn.cnx2(m, drop, generator)
    gate = 2.0 * (lrnn.attn(mean_vol) - 0.5)
    return m * gate
