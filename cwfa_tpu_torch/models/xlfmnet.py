"""XLFMNet baseline (``--INN_net_type 2``): lenslet views -> volume by one
conv net (counterpart of ``cwfa_tpu/models/xlfmnet.py:18-54``; reference
networks.py:758-787, the SLNet_XLFMNet predecessor model kept for comparison
runs).

    3x3 conv (in_views -> out_depths, no bias) -> BatchNorm (momentum 0.1,
    eps 1e-5) -> LeakyReLU 0.01 -> UNet (depth 5, wf 6, ELU, no skips)

``forward(x, train=True)`` normalizes with the batch's own statistics, and
moves the running statistics only when the module is also in training mode
(``.train()``), as the port's UNet does; ``train=False`` uses them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.nn.functional as F
from torch import nn

from cwfa_tpu_torch.models.unet import UNet, UNetSpec
from cwfa_tpu_torch.nn import batch_norm_batch_stats, same_conv2d


@dataclass(frozen=True)
class XLFMNetSpec:
    in_views: int = 29
    out_depths: int = 96
    use_bias: bool = False
    unet: UNetSpec = None

    def __post_init__(self):
        if self.unet is None:
            # drop_out=0, NOT the reference's unet_settings default of 1.0
            # (networks.py:762): there it flows into F.dropout2d whose
            # functional default is training=True, so every channel is
            # dropped ALWAYS — the reference XLFMNet is untrainable as
            # declared (consistent with run_CWFA never building it).  A
            # default-constructed spec here must be a usable model.
            object.__setattr__(self, "unet", UNetSpec(
                in_channels=self.out_depths, n_classes=self.out_depths,
                depth=5, wf=6, batch_norm=True, use_bias=self.use_bias,
                skip_conn=False, drop_out=0.0, activation="elu"))


class XLFMNet(nn.Module):
    """Parameter names as ``init_xlfmnet``'s tree: proj, bn, unet."""

    def __init__(self, spec: XLFMNetSpec):
        super().__init__()
        self.spec = spec
        self.proj = same_conv2d(spec.in_views, spec.out_depths, 3,
                                spec.use_bias)
        self.bn = nn.BatchNorm2d(spec.out_depths, eps=1e-5, momentum=0.1)
        self.unet = UNet(spec.unet)

    def forward(self, x, train: bool = False):
        """x: (B, in_views, H, W) -> (B, out_depths, H, W); H, W divisible
        by 2^(depth-1)."""
        y = self.proj(x)
        y = batch_norm_batch_stats(self.bn, y) if train else self.bn(y)
        return self.unet(F.leaky_relu(y, 0.01), train=train)
