"""Padding U-Net with additive skips (counterpart of
``cwfa_tpu/models/unet.py:27-158``, reference unet.py:9-195), eval mode.

- downsampling via max-pool to exactly half the size (unet.py:79);
- up path: ConvTranspose2d(k=2, s=2) and an ADDITIVE skip (unet.py:190);
- 'last' head = 1x1 conv + activation (unet.py:67-69);
- per-site PReLU parameters; BatchNorm after each activation, in eval mode
  from its running statistics.

Only inference is ported: a module in training mode raises (the Dropout2d
and batch-statistics BatchNorm of training are not ported).  The activation
is PReLU, the one the LRNN uses.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from cwfa_tpu_torch.nn import adaptive_max_pool2d_half, same_conv2d


@dataclass(frozen=True)
class UNetSpec:
    in_channels: int
    n_classes: int
    depth: int = 5
    wf: int = 6
    batch_norm: bool = True
    use_bias: bool = False
    skip_conn: bool = False


class ConvBlock(nn.Module):
    def __init__(self, c_in, c_out, batch_norm, use_bias):
        super().__init__()
        self.conv1 = same_conv2d(c_in, c_out, 3, use_bias)
        self.act1 = nn.PReLU(1)
        self.conv2 = same_conv2d(c_out, c_out, 3, use_bias)
        self.act2 = nn.PReLU(1)
        self.bn1 = nn.BatchNorm2d(c_out) if batch_norm else nn.Identity()
        self.bn2 = nn.BatchNorm2d(c_out) if batch_norm else nn.Identity()

    def forward(self, x):
        y = self.bn1(self.act1(self.conv1(x)))
        return self.bn2(self.act2(self.conv2(y)))


class UpBlock(nn.Module):
    def __init__(self, c_in, c_out, batch_norm, use_bias):
        super().__init__()
        self.up = nn.ConvTranspose2d(c_in, c_out, 2, stride=2, bias=use_bias)
        # the skip is ADDITIVE, so the conv block's input width is c_out
        self.conv_block = ConvBlock(c_out, c_out, batch_norm, use_bias)


class UNet(nn.Module):
    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = spec
        self.down = nn.ModuleList()
        prev = spec.in_channels
        for i in range(spec.depth):
            self.down.append(ConvBlock(prev, 2 ** (spec.wf + i),
                                       spec.batch_norm, spec.use_bias))
            prev = 2 ** (spec.wf + i)
        self.up = nn.ModuleList()
        for i in reversed(range(spec.depth - 1)):
            out_size = 2 ** (spec.wf + i)
            self.up.append(UpBlock(prev, out_size, spec.batch_norm,
                                   spec.use_bias))
            prev = out_size
        self.last = nn.ModuleDict({
            "conv": same_conv2d(prev, spec.n_classes, 1, spec.use_bias),
            "act": nn.PReLU(1)})

    def forward(self, x):
        """x: (B, C, H, W); H, W divisible by 2^(depth-1)."""
        if self.training:
            raise NotImplementedError("UNet training is not ported")
        blocks = []
        for i, block in enumerate(self.down):
            x = block(x)
            if i != len(self.down) - 1:
                blocks.append(x)
                x = adaptive_max_pool2d_half(x)
        for i, up_block in enumerate(self.up):
            up = up_block.up(x)
            if self.spec.skip_conn:
                # H, W divisible by 2^(depth-1): the reference's center
                # crop of the bridge is the identity
                up = up + blocks[-i - 1]
            x = up_block.conv_block(up)
        return self.last["act"](self.last["conv"](x))
