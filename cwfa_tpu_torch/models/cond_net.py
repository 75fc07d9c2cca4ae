"""Per-step condition processor and the global attention gate (counterpart of
``cwfa_tpu/models/cond_net.py``).

``CondNetwork`` maps the lenslet views (B, n_lenslets, H, W) to the
conditioning features (B, n_depths/2^{k+1}, H, W) of CWF step k
(reference networks.py:165-242):

  out = PReLU( conv3x3(PReLU(conv3x3(x))) + conv3x3_downsample(x) )
  out = Conv3d(K->1) o PReLU o Conv3d(1->K)  over (H, W, depth)

One PReLU alpha per net is shared by its three activation sites.  The 3-D
pair runs in one call of ``ops/cond_pair.cond_pair`` on the (B, D, H, W)
features (the CUDA kernel on a card, its plain version on the CPU), with the
reference layout's weights (``_conv3d_pair_direct``, ``cond_net.py:259-265``):
the TPU's banded, depth-batched and block-diagonally paired forms are
numerically equal rewrites and are not carried over.  In training mode
(``.train()``) the pair's intermediate channels go through the Dropout3d
of ``cond_network(train=True)`` (rate 0.5, a (B, K) mask drawn from the
``generator`` given to ``forward``; none without one), and the pair is
differentiated through ``ops/cond_pair.CondPairFn``, whose backward is a
kernel too.

The int8 option of the reconstructor (``use_int8_cond``; JAX's
``_conv3d_pair_depthbatch_int8``, ``cond_net.py:110-168,339-377``) runs the
pair in depth-batch form with an int8 intermediate: conv_a takes the three
depth taps as channels, per depth, then PReLU; y is quantized per feature
(static absmax / 127 scales from calibration views); conv_b runs as an int8
3x3 conv to the three taps with the y scale folded into its weights, int32
sums on cuBLAS (``ops/int8_conv``), dequantized in f32; the 3-tap depth
band-add and the bias finish it.  Inference only: XLA runs it in JAX, not a
Pallas kernel.

``cond_reach``: the rows of input beyond a row range that a net's output on
it needs (its convs' half-widths along H), which a row shard's window
carries (``parallel/halo``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cwfa_tpu_torch.nn import channel_dropout_scale, same_conv2d
from cwfa_tpu_torch.ops.cond_pair import cond_pair_ad
from cwfa_tpu_torch.ops.int8_conv import conv2d_int8, quantize_mul


class CondNetwork(nn.Module):
    # cond_network's dropout3d_rate (cwfa_tpu/models/cond_net.py:312)
    dropout3d_rate = 0.5

    def __init__(self, c_in: int, c_out: int, chans_3d: int = 32):
        super().__init__()
        self.conv1 = same_conv2d(c_in, c_out, 3)
        self.conv2 = same_conv2d(c_out, c_out, 3)
        self.down = same_conv2d(c_in, c_out, 3)
        self.c3a = nn.Conv3d(1, chans_3d, 3, padding=1)
        self.c3b = nn.Conv3d(chans_3d, 1, 3, padding=1)
        self.prelu = nn.PReLU(1)

    def stack2d(self, x):
        """The 2-D stack: PReLU(conv2(PReLU(conv1(x))) + down(x))."""
        out = self.prelu(self.conv1(x))
        out = self.conv2(out)
        return self.prelu(out + self.down(x))

    def forward(self, x, generator=None, cond_q=None):
        """x: (B, n_lenslets, H, W) -> contiguous (B, c_out, H, W).
        generator: the Dropout3d's draws in training mode.  cond_q: an int8
        pack (``quantize_cond3d``): the pair with the int8 intermediate
        (inference only)."""
        out = self.stack2d(x)
        if cond_q is not None:
            if self.training:
                raise ValueError("the int8 cond pair is inference-only")
            return conv3d_pair_int8(self, out, cond_q)
        scale = channel_dropout_scale(
            (x.shape[0], self.c3a.out_channels),
            self.dropout3d_rate if self.training else 0.0, generator,
            x.device)
        # the 3-D convs run over (H, W, depth)
        return cond_pair_ad(out.contiguous(), self.c3a, self.c3b, self.prelu,
                            scale)


def cond_reach(net: CondNetwork) -> int:
    """Rows of input beyond a row range that the net's output on that range
    needs: the longer 2-D path (conv1 then conv2, or down) plus the pair's
    two 3-D convs along H (their first kernel dim runs over H)."""
    h = lambda c: c.kernel_size[0] // 2
    return (max(h(net.conv1) + h(net.conv2), h(net.down))
            + h(net.c3a) + h(net.c3b))


def cond_networks_batched(nets, x, cond_q=None):
    """All per-step condition nets on the same views (inference path).
    cond_q: None, or per net an int8 pack (``quantize_cond_networks``) or
    None."""
    return [net(x, cond_q=None if cond_q is None else cond_q[i])
            for i, net in enumerate(nets)]


# ---------------------------------------------------------------------------
# The int8 intermediate of the 3-D pair (``use_int8_cond``)
# ---------------------------------------------------------------------------


def conv_a_depthbatch(net: CondNetwork, out):
    """conv_a + bias + PReLU in depth-batch form (``_conv_a_depthbatch``):
    out (B, D, H, W) -> (B*D, K, H, W) in out's dtype, the three depth taps
    (SAME-padded) as the input channels of a 3x3 conv."""
    b, d, h, w = out.shape
    wa = net.c3a.weight[:, 0].permute(0, 3, 1, 2)        # (K, dc, kh, kw)
    xp = F.pad(out, (0, 0, 0, 0, 1, 1))
    x3 = torch.stack([xp[:, 0:d], xp[:, 1:d + 1], xp[:, 2:d + 2]], dim=2)
    y = F.conv2d(x3.reshape(b * d, 3, h, w), wa.to(out.dtype),
                 None if net.c3a.bias is None else net.c3a.bias.to(out.dtype),
                 padding=1)
    return net.prelu(y)


def calibrate_cond3d(net: CondNetwork, x_cond):
    """Per-feature absmax scales (K,) f32 of the post-PReLU conv_a output on
    ``x_cond``, the 2-D stack's output (B, D, H, W) on calibration views,
    computed in f32 (``calibrate_cond3d``)."""
    y = conv_a_depthbatch(net, x_cond.float())
    amax = y.abs().amax(dim=(0, 2, 3))
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def quantize_cond3d(net: CondNetwork, scales):
    """int8 pack for conv_b with the per-feature y scales folded in
    (``quantize_cond3d``), from ``net``'s (f32 master) weights:
    {"wbq": (3 taps, K, 3, 3) int8, "sb": (3,) f32 dequant scales,
    "inv_s": (K,) f32 y-quantization reciprocals}."""
    w_b = net.c3b.weight[0].permute(3, 0, 1, 2).float()   # (dc, K, kh, kw)
    w_b = w_b * scales[None, :, None, None]
    amax = w_b.abs().amax(dim=(1, 2, 3))
    sb = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wbq = torch.clamp(torch.round(w_b / sb[:, None, None, None]), -127, 127)
    return {"wbq": wbq.to(torch.int8), "sb": sb,
            "inv_s": (1.0 / scales).float()}


def band_add(v, bias):
    """The 3-tap depth band-add of every conv_b form (``_band_add``):
    z[c] = v[c-1, tap 0] + v[c, tap 1] + v[c+1, tap 2] (SAME-padded band),
    plus the conv_b bias.  v: (B, D, 3, H, W)."""
    z = v[:, :, 1].clone()
    z[:, 1:] += v[:, :-1, 0]
    z[:, :-1] += v[:, 1:, 2]
    if bias is not None:
        z = z + bias.to(z.dtype)[None, :, None, None]
    return z


@torch.inference_mode()
def conv3d_pair_int8(net: CondNetwork, out, q):
    """The 3-D pair with an int8 y (``_conv3d_pair_depthbatch_int8``):
    out (B, D, H, W) -> (B, D, H, W) in out's dtype.  y quantized per
    feature with ``q["inv_s"]`` (round half to even, clip to +-127), conv_b
    as an int8 conv with int32 sums, dequantized per tap in f32."""
    b, d, h, w = out.shape
    y = conv_a_depthbatch(net, out)
    acc = conv2d_int8(quantize_mul(y, q["inv_s"]), q["wbq"], 1)
    v = (acc.float() * q["sb"][None, :, None, None]).to(out.dtype)
    return band_add(v.reshape(b, d, 3, h, w), net.c3b.bias)


@torch.inference_mode()
def quantize_cond_networks(nets, x_sample):
    """The per-net int8 packs of ``cond_networks_batched(cond_q=)``
    (``quantize_cond_networks``): each net's 2-D stack on the sample views
    in f32, its conv_a features calibrated, the scales folded into int8
    conv_b weights.  ``nets``: the f32 master nets."""
    x = x_sample.float()
    return [quantize_cond3d(net, calibrate_cond3d(net, net.stack2d(x)))
            for net in nets]


class GlobalAttention(nn.Module):
    """Conv1d(C,C,3) -> ReLU -> Conv1d(C,C,1) -> Sigmoid gate over the
    flattened spatial dim (reference networks.py:244-262)."""

    def __init__(self, n_chans: int):
        super().__init__()
        self.c1 = nn.Conv1d(n_chans, n_chans, 3, padding=1)
        self.c2 = nn.Conv1d(n_chans, n_chans, 1)

    def forward(self, x):
        b, c = x.shape[:2]
        y = F.relu(self.c1(x.reshape(b, c, -1)))
        return torch.sigmoid(self.c2(y)).reshape(x.shape)
