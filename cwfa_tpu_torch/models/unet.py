"""Padding U-Net with additive skips (counterpart of
``cwfa_tpu/models/unet.py:27-268``, reference unet.py:9-195).

- downsampling via max-pool to exactly half the size (unet.py:79);
- up path: ConvTranspose2d(k=2, s=2) and an ADDITIVE skip (unet.py:190);
- 'last' head = 1x1 conv + activation (unet.py:67-69);
- per-site PReLU parameters; BatchNorm after each activation, from its
  running statistics.

``forward(..., train=True)`` is the train mode that reconstruction and
training run the LRNN in (``cwfa_tpu/models/cwfa_model.py:267-276``):
BatchNorm on the batch's own statistics and Dropout2d (``spec.drop_out``)
after every pool and every up block.  The mode is an argument, as in JAX;
the running statistics move (momentum 0.1, unbiased variance, as JAX's
mstate) only when the module is also in training mode (``.train()``, which
the trainer sets for its LRNN step), and are left as they are otherwise.
The activation is PReLU, the one the LRNN uses.

The int8 path (``unet_calibrate``, ``quantize_unet``, ``unet_quantized``)
runs every conv through the same forward with a conv hook, as the JAX
package does: static per-channel activation scales from a calibration
forward, folded into per-output-channel int8 weights; int32 products
(``ops/int8_conv``); dequant and bias in f32, then the cast to the compute
dtype, PReLU and BatchNorm (``_conv_block``, ``unet.py:71-83``).  Sites are
keyed as JAX keys them: ``("down", i, "conv1")``, ``("up", i, "upconv")``,
``("up", i, "conv2")``, ``("last",)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from cwfa_tpu_torch.nn import (adaptive_max_pool2d_half,
                               batch_norm_batch_stats, dropout2d, same_conv2d)
from cwfa_tpu_torch.ops.int8_conv import (
    conv2d_int8, conv_transpose2x2_int8, quantize_div)


@dataclass(frozen=True)
class UNetSpec:
    in_channels: int
    n_classes: int
    depth: int = 5
    wf: int = 6
    batch_norm: bool = True
    use_bias: bool = False
    skip_conn: bool = False
    drop_out: float = 0.0


def _plain_conv(_site, conv, x):
    return conv(x)


class ConvBlock(nn.Module):
    def __init__(self, c_in, c_out, batch_norm, use_bias):
        super().__init__()
        self.conv1 = same_conv2d(c_in, c_out, 3, use_bias)
        self.act1 = nn.PReLU(1)
        self.conv2 = same_conv2d(c_out, c_out, 3, use_bias)
        self.act2 = nn.PReLU(1)
        self.bn1 = nn.BatchNorm2d(c_out) if batch_norm else nn.Identity()
        self.bn2 = nn.BatchNorm2d(c_out) if batch_norm else nn.Identity()

    def forward(self, x, conv_fn=_plain_conv, site=(), train=False):
        def norm(bn, v):
            if train and isinstance(bn, nn.BatchNorm2d):
                return batch_norm_batch_stats(bn, v)
            return bn(v)

        y = norm(self.bn1, self.act1(conv_fn(site + ("conv1",), self.conv1, x)))
        return norm(self.bn2,
                    self.act2(conv_fn(site + ("conv2",), self.conv2, y)))


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

    def forward(self, x, conv_fn=_plain_conv, train=False, generator=None):
        """x: (B, C, H, W); H, W divisible by 2^(depth-1).

        conv_fn(site, conv_module, v): the hook every conv and transposed
        conv goes through (the int8 path and its calibration).
        train: BatchNorm on the batch's statistics, and Dropout2d drawing
        from ``generator`` (none without one), ``unet.py:134-155``."""
        drop = self.spec.drop_out if train else 0.0
        blocks = []
        for i, block in enumerate(self.down):
            x = block(x, conv_fn, ("down", i), train)
            if i != len(self.down) - 1:
                blocks.append(x)
                x = adaptive_max_pool2d_half(x)
                x = dropout2d(x, drop, generator)
        for i, up_block in enumerate(self.up):
            up = conv_fn(("up", i, "upconv"), up_block.up, x)
            if self.spec.skip_conn:
                # H, W divisible by 2^(depth-1): the reference's center
                # crop of the bridge is the identity
                up = up + blocks[-i - 1]
            x = up_block.conv_block(up, conv_fn, ("up", i), train)
            x = dropout2d(x, drop, generator)
        return self.last["act"](conv_fn(("last",), self.last["conv"], x))


# ---------------------------------------------------------------------------
# int8 inference path
# ---------------------------------------------------------------------------


def _act_scale(v):
    a = v.float().abs().amax(dim=(0, 2, 3)) / 127.0
    return torch.where(a > 0, a, torch.ones_like(a))


@torch.inference_mode()
def unet_calibrate(unet: UNet, x):
    """Per-channel absmax activation scales of every conv input, from an
    eval-mode forward on calibration inputs x, in x's dtype.
    Returns {site: (Cin,) f32}."""
    scales = {}

    def rec(site, conv, v):
        scales[site] = _act_scale(v)
        return conv(v)

    unet(x, conv_fn=rec)
    return scales


def _q_w_conv(w, s_in, transposed: bool):
    """f32 conv weights -> (int8, (O,) f32 scale) with the input site's
    per-channel scale folded in (``unet.py:174-189``).  Layout OIHW, or
    (I, O, kH, kW) for a transposed conv."""
    w = w.float()
    if transposed:
        w = w * s_in[:, None, None, None]
        amax = w.abs().amax(dim=(0, 2, 3))
    else:
        w = w * s_in[None, :, None, None]
        amax = w.abs().amax(dim=(1, 2, 3))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    shape = (1, -1, 1, 1) if transposed else (-1, 1, 1, 1)
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127)
    return q.to(torch.int8), scale


def unet_site_conv(unet: UNet, site):
    """The conv module at a JAX site key."""
    if site[0] == "down":
        return getattr(unet.down[site[1]], site[2])
    if site[0] == "up" and site[-1] == "upconv":
        return unet.up[site[1]].up
    if site[0] == "up":
        return getattr(unet.up[site[1]].conv_block, site[2])
    return unet.last["conv"]


@torch.no_grad()
def quantize_unet(unet: UNet, act_scales):
    """int8 weights, f32 dequant scales and f32 biases for every conv site,
    from ``unet``'s (f32 master) weights.  Returns {site: {"wq", "sw"[, "b"]}}."""
    packs = {}
    for site, s_in in act_scales.items():
        conv = unet_site_conv(unet, site)
        wq, sw = _q_w_conv(conv.weight, s_in, site[-1] == "upconv")
        packs[site] = {"wq": wq, "sw": sw}
        if conv.bias is not None:
            packs[site]["b"] = conv.bias.float().clone()
    return packs


def _conv_int8(pack, s_in, v, transposed: bool):
    """Quantize v per channel, int8 conv, dequantize + bias in f32, cast to
    v's dtype (``unet.py:233-253``)."""
    q = quantize_div(v, s_in)
    if transposed:
        acc = conv_transpose2x2_int8(q, pack["wq"])
    else:
        acc = conv2d_int8(q, pack["wq"], pack["wq"].shape[-1] // 2)
    y = acc.float() * pack["sw"][None, :, None, None]
    if "b" in pack:
        y = y + pack["b"][None, :, None, None]
    return y.to(v.dtype)


@torch.inference_mode()
def unet_quantized(unet: UNet, x, qpack, act_scales):
    """Eval forward with every conv in int8 (packs from ``quantize_unet``,
    activations quantized per channel on the fly)."""

    def cf(site, _conv, v):
        return _conv_int8(qpack[site], act_scales[site], v,
                          site[-1] == "upconv")

    return unet(x, conv_fn=cf)
