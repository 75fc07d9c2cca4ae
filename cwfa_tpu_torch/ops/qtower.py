"""The int8 subnet tower: calibration, weight packing, the plain PyTorch
version and the CUDA kernel's wrapper (counterpart of
``cwfa_tpu/ops/qtower.py``; the kernel is ``csrc/qtower_wg.cu`` for 64-wide
towers and ``csrc/qtower.cu`` for every other width).

One tower (``flow/subnets.WaveletFlowSubnet2d``) per call:

    r1  = b1(x)                                  1x1, Cin -> C
    e2  = elu(b2b(elu(b2a(r1))) + r1)            3x3 then 1x1, residual
    e4  = elu(b4b(elu(b4a(e2))) + e2)
    e6  = elu(b6b(elu(b6a(e4))) + e4)
    out = b7(e6)                                 3x3, C -> Nout

Every conv input is quantized to int8 with a static per-channel scale (row
``SITES.index(site)`` of the (8, C) ``scales``, calibrated on the f32 tower),
by multiplying with the f32 reciprocal; the scale is folded into the
weights, which are int8 per output channel; products accumulate in int32;
dequant, bias, ELU, requant and the residual add run in f32; the residual
canvases r1, e2 and e4 round-trip through bf16 (``qtower.py:212-271``).

The TPU kernel runs two towers paired into one block-diagonal 128-wide
tower.  Unpaired is exact: the scales are per channel, b1 stacks the two
towers on their shared input, and every other paired conv is
block-diagonal, so a tower quantizes exactly as its half of the pair.

Weights are kept in the kernels' layouts.  For ``__dp4a`` a k x k conv with
I inputs and O outputs is int8 (k*k, ceil(I/4), ceil8(O), 4), element
[t, g, o, j] = W[o, 4g+j, t//k, t%k], zero-padded, so that one int32 word
holds four input channels of one output channel; the convs that read a
C-wide canvas pad I to a multiple of 8, the canvas's padded width.  A tower
that the warpgroup tensor cores take (``kernel_instance``) carries one more
entry, ``"wg"``: the same weights as the B operand of the s8 ``wgmma``, in
the order the kernel consumes them (``pack_tower_wg``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cwfa_tpu_torch.ops import cuda_build
from cwfa_tpu_torch.ops.int8_conv import conv2d_int8, quantize_mul
from cwfa_tpu_torch.ops.wgmma_layout import S8_SUM_ORDER
from cwfa_tpu_torch.utils.profiling import check_kernel_outputs

# conv-input sites in execution order: row index of the (8, C) scales
SITES = ("x", "r1", "e2a", "e2", "e4a", "e4", "e6a", "e6")
CONVS = ("b1", "b2a", "b2b", "b4a", "b4b", "b6a", "b6b", "b7")
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WEIGHTS = tuple("w" + n[1:] for n in CONVS)        # the qw keys of the convs

WGMMA_S8, DP4A = "wgmma s8", "dp4a"
WGMMA_WIDTH = 64                       # the tower width of the wgmma instance
WGMMA_NOUT = (16, 32, 48, 64, 96)      # b7 widths it is built for
TOO_WIDE = -1                          # csrc/qtower.cu: no tile fits the width


def _round_up(n: int, m: int) -> int:
    return n + (-n) % m


def kernel_instance(c: int, cin: int, nout: int) -> str:
    """Which instance of the kernel runs a tower of width ``c`` with ``cin``
    inputs and ``nout`` outputs."""
    if c == WGMMA_WIDTH and cin <= WGMMA_WIDTH and nout <= WGMMA_NOUT[-1]:
        return WGMMA_S8
    return DP4A


# ---------------------------------------------------------------------------
# weight layout
# ---------------------------------------------------------------------------


def pack_weight(wq, i_mult: int = 4):
    """int8 OIHW -> the ``__dp4a`` layout (k*k, ceil(I/4), ceil8(O), 4), I
    zero-padded to a multiple of ``i_mult`` (4 or 8)."""
    o, i, k, _ = wq.shape
    i4, o8 = _round_up(i, i_mult) // 4, o + (-o) % 8
    full = torch.zeros((k * k, i4 * 4, o8), dtype=torch.int8,
                       device=wq.device)
    full[:, :i, :o] = wq.permute(2, 3, 1, 0).reshape(k * k, i, o)
    return full.reshape(k * k, i4, 4, o8).permute(0, 1, 3, 2).contiguous()


def unpack_weight(wk, i: int, o: int):
    """The kernel layout -> int8 OIHW (I inputs, O outputs)."""
    kk, i4, o8, _ = wk.shape
    k = int(round(kk ** 0.5))
    w = wk.permute(0, 1, 3, 2).reshape(kk, i4 * 4, o8)[:, :i, :o]
    return w.reshape(k, k, i, o).permute(3, 2, 0, 1)


def _wg_operand(wq, ipad: int, opad: int, after_3x3: bool = False):
    """int8 OIHW -> the B operand of the s8 ``wgmma`` as the tensor cores
    read it from shared memory, K-major without swizzle, per tap
    [Cin / 16][Cout][16]: a core matrix is 8 output channels x 16 bytes of
    input channels.  Cin is zero-padded to ``ipad``, Cout to ``opad``; with
    ``after_3x3`` the input channels of every 16 come in ``S8_SUM_ORDER``
    (the 1x1 of a residual block takes its A operand from the 3x3's sums in
    registers)."""
    o, i, k, _ = wq.shape
    full = torch.zeros((k * k, opad, ipad), dtype=torch.int8, device=wq.device)
    full[:, :o, :i] = wq.permute(2, 3, 0, 1).reshape(k * k, o, i)
    full = full.reshape(k * k, opad, ipad // 16, 16)
    if after_3x3:
        full = full[..., torch.tensor(S8_SUM_ORDER, device=wq.device)]
    return full.permute(0, 2, 1, 3).reshape(-1)


def pack_tower_wg(convs):
    """{"w1".."w7": int8 OIHW} of a 64-wide tower -> the weight pack of
    ``csrc/qtower_wg.cu``, flat int8: b1 (Cin padded to 32), then per
    residual block the 3x3's nine taps and the 1x1, then b7's nine taps
    (Cout padded to the next of ``WGMMA_NOUT``), each as ``_wg_operand``."""
    c, cin = convs["w1"].shape[:2]
    np7 = next(n for n in WGMMA_NOUT if n >= convs["w7"].shape[0])
    parts = [_wg_operand(convs["w1"], _round_up(cin, 32), c)]
    for name in WEIGHTS[1:7]:
        parts.append(_wg_operand(convs[name], c, c,
                                 after_3x3=name.endswith("b")))
    parts.append(_wg_operand(convs["w7"], c, np7))
    return torch.cat(parts)


def pack_convs(convs):
    """{"w1".."w7": int8 OIHW} -> the weight entries of a ``qw``: each conv
    in the ``__dp4a`` layout (``pack_weight``; the convs after b1 with the
    input channels padded to a multiple of 8) and, for a tower of the
    ``wgmma`` instance, ``"wg"`` (``pack_tower_wg``)."""
    out = {name: pack_weight(convs[name], 4 if name == "w1" else 8)
           for name in WEIGHTS}
    (c, cin), nout = convs["w1"].shape[:2], convs["w7"].shape[0]
    if kernel_instance(c, cin, nout) == WGMMA_S8:
        out["wg"] = pack_tower_wg(convs)
    return out


# ---------------------------------------------------------------------------
# calibration + quantization (host side, f32)
# ---------------------------------------------------------------------------


def _quant_w(w, s_in):
    """OIHW f32 -> (int8, (O,) f32 scale), symmetric per output channel,
    with the input site's per-channel scale folded in (``qtower.py:68-77``)."""
    w = w.float() * s_in[None, :, None, None]
    amax = w.abs().amax(dim=(1, 2, 3))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def _conv_params(tower, name):
    conv = getattr(tower, name)
    b = conv.bias
    if b is None:
        b = torch.zeros(conv.out_channels, device=conv.weight.device)
    return conv.weight.float(), b.float()


@torch.inference_mode()
def tower_f32_trace(tower, x):
    """f32 forward of one tower returning every conv-input tensor (the
    pre-quantization sites) and the output (``_f32_tower_trace``,
    ``qtower.py:143-175``).  x: (B, Cin, H, W)."""
    def g(name, v):
        w, b = _conv_params(tower, name)
        return F.conv2d(v, w, b, padding=w.shape[-1] // 2)

    sites = {"x": x}
    r1 = g("b1", x)
    sites["r1"] = r1
    sites["e2a"] = F.elu(g("b2a", r1))
    e2 = F.elu(g("b2b", sites["e2a"]) + r1)
    sites["e2"] = e2
    sites["e4a"] = F.elu(g("b4a", e2))
    e4 = F.elu(g("b4b", sites["e4a"]) + e2)
    sites["e4"] = e4
    sites["e6a"] = F.elu(g("b6a", e4))
    e6 = F.elu(g("b6b", sites["e6a"]) + e4)
    sites["e6"] = e6
    return sites, g("b7", e6)


def tower_calibrate(tower, x):
    """Static per-channel activation scales of the 8 conv-input sites, from
    the f32 tower on calibration conditions x (``pair_tower_calibrate``,
    ``qtower.py:178-193``).  Returns (8, C) f32 in SITES order, absmax/127
    per channel (1.0 where the absmax is 0); row 0 (the Cin input channels)
    is padded to C with 1.0."""
    sites, _ = tower_f32_trace(tower, x.float())
    c = sites["r1"].shape[1]
    rows = []
    for name in SITES:
        amax = sites[name].abs().amax(dim=(0, 2, 3))
        row = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        rows.append(F.pad(row, (0, c - row.shape[0]), value=1.0))
    return torch.stack(rows).float()


@torch.no_grad()
def quantize_tower(tower, scales):
    """One tower's f32 weights -> the kernel's int8 weight set, with the
    per-channel activation scales folded in (``quantize_pair_tower``,
    ``qtower.py:97-140``).

    Returns {"w1".."w7" (kernel layout, keyed by conv: w1, w2a, w2b, w4a,
    w4b, w6a, w6b, w7; "wg" for a tower of the ``wgmma`` instance:
    ``pack_convs``), "sw" (7, C) and "bias" (7, C) for b1..b6b,
    "sw7" (Nout,), "bias7" (Nout,)} — scales and biases f32."""
    cin = tower.b1.in_channels
    convs, sws, bs = {}, [], []
    for row, name in enumerate(CONVS):
        w, b = _conv_params(tower, name)
        s_in = scales[row, :cin] if name == "b1" else scales[row]
        q, s = _quant_w(w, s_in)
        convs["w" + name[1:]] = q
        if name == "b7":
            sw7, bias7 = s, b.clone()
        else:
            sws.append(s)
            bs.append(b)
    out = pack_convs(convs)
    out["sw7"], out["bias7"] = sw7, bias7
    out["sw"] = torch.stack(sws)
    out["bias"] = torch.stack(bs)
    return out


def quantize_input(x, scale_row):
    """(B, Cin, H, W) -> int8 (B, Cin, H, W), multiplying by the f32
    reciprocal of ``scale_row[:Cin]`` (``qtower.py:516-531``; the kernel
    pads and lays out the window itself)."""
    cin = x.shape[1]
    return quantize_mul(x, 1.0 / scale_row[:cin])


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _elu(v):
    # exp(min(v, 0)) - 1, the kernel's form (not expm1): the two differ by
    # ~6e-8 near 0, enough to flip an int8 level (qtower.py:240-244)
    return torch.where(v > 0, v, torch.exp(torch.clamp_max(v, 0.0)) - 1.0)


def quantized_tower_reference(qw, scales, xq):
    """The kernel's math in plain PyTorch (``quantized_pair_tower_reference``,
    ``qtower.py:212-271``), exact int32 sums through ``int8_conv``.

    xq: (B, Cin, H, W) int8, quantized with ``quantize_input``.
    Returns (B, Nout, H, W) f32."""
    c = qw["sw"].shape[1]
    nout = qw["sw7"].shape[0]
    inv = 1.0 / scales
    cin = xq.shape[1]

    def conv(q, name, i, o):
        w = unpack_weight(qw[name], i, o)
        return conv2d_int8(q, w, w.shape[-1] // 2)

    def deq(acc, k):
        return (acc.float() * qw["sw"][k][None, :, None, None]
                + qw["bias"][k][None, :, None, None])

    bf = lambda v: v.to(torch.bfloat16)
    f32 = lambda v: v.float()
    q_ = lambda v, k: quantize_mul(v, inv[k, :v.shape[1]])

    r1 = bf(deq(conv(xq, "w1", cin, c), 0))
    q1 = q_(f32(r1), 1)
    e2a = _elu(deq(conv(q1, "w2a", c, c), 1))
    q2a = q_(e2a, 2)
    r2 = deq(conv(q2a, "w2b", c, c), 2) + f32(r1)
    e2 = bf(_elu(r2))
    q2 = q_(f32(e2), 3)
    e4a = _elu(deq(conv(q2, "w4a", c, c), 3))
    q4a = q_(e4a, 4)
    r4 = deq(conv(q4a, "w4b", c, c), 4) + f32(e2)
    e4 = bf(_elu(r4))
    q4 = q_(f32(e4), 5)
    e6a = _elu(deq(conv(q4, "w6a", c, c), 5))
    q6a = q_(e6a, 6)
    r6 = deq(conv(q6a, "w6b", c, c), 6) + f32(e4)
    q6 = q_(_elu(r6), 7)
    return (conv(q6, "w7", c, nout).float()
            * qw["sw7"][None, :, None, None]
            + qw["bias7"][None, :, None, None])


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    """(the ``__dp4a`` library, the wgmma library)"""
    lib, wg = cuda_build.load("qtower"), cuda_build.load("qtower_wg")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cwfa_qtower.argtypes = [p] * 15 + [i32] * 8 + [p]
    lib.cwfa_qtower.restype = i32
    wg.cwfa_qtower_wg.argtypes = [p] * 8 + [i32] * 7 + [p]
    wg.cwfa_qtower_wg.restype = i32
    return lib, wg


def _check(xq, qw, scales, out_dtype):
    if xq.dim() != 4 or xq.dtype != torch.int8 or not xq.is_contiguous():
        raise ValueError("xq must be a contiguous int8 (B, Cin, H, W) tensor")
    if xq.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {xq.device}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {list(_OUT_DTYPES)}")
    c = qw["sw"].shape[1]
    cin = xq.shape[1]
    cp = _round_up(c, 8)               # the canvases' padded width
    nout = qw["sw7"].shape[0]
    want = {"w1": (1, -(-cin // 4), cp, 4), "sw": (7, c), "bias": (7, c),
            "w7": (9, cp // 4, nout + (-nout) % 8, 4),
            "sw7": (nout,), "bias7": (nout,)}
    for k in ("w2a", "w4a", "w6a"):
        want[k] = (9, cp // 4, cp, 4)
    for k in ("w2b", "w4b", "w6b"):
        want[k] = (1, cp // 4, cp, 4)
    if kernel_instance(c, cin, nout) == WGMMA_S8:
        np7 = next(n for n in WGMMA_NOUT if n >= nout)
        want["wg"] = (c * (_round_up(cin, 32) + 30 * c + 9 * np7),)
    if set(qw) != set(want):
        raise ValueError(f"qw keys {sorted(qw)} != {sorted(want)}")
    for k, shape in want.items():
        t = qw[k]
        if tuple(t.shape) != shape:
            raise ValueError(f"qw[{k!r}] shape {tuple(t.shape)} does not "
                             f"match {shape} for Cin {cin}, C {c}")
        if t.dtype != (torch.int8 if k.startswith("w") else torch.float32):
            raise TypeError(f"qw[{k!r}] dtype {t.dtype}")
    if tuple(scales.shape) != (8, c) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be (8, {c}) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    for k, t in list(qw.items()) + [("scales", scales)]:
        if t.device != xq.device or not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous on {xq.device}")
    return c, nout


def fused_tower(xq, qw, scales, *, out_dtype=torch.bfloat16, instance=None):
    """One int8 tower over the whole batch (``fused_pair_tower``,
    ``qtower.py:454``).

    xq: (B, Cin, H, W) int8 from ``quantize_input``; qw: ``quantize_tower``
    output; scales: its (8, C) calibration.  Returns the raw (s|t) stack
    (B, Nout, H, W) in out_dtype (f32 or bf16), NCHW.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.  instance: ``DP4A`` runs that instance where
    ``kernel_instance`` would pick the tensor cores (to time the two side by
    side).  Counts every launch, and per instance in
    ``fused_tower.by_instance``."""
    c, nout = _check(xq, qw, scales, out_dtype)
    if instance not in (None, DP4A):
        raise ValueError(f"instance {instance!r}: None or {DP4A!r}")
    if xq.device.type == "cpu":
        return quantized_tower_reference(qw, scales, xq).to(out_dtype)
    b, cin, h, w = xq.shape
    out = torch.empty((b, nout, h, w), dtype=out_dtype, device=xq.device)
    inv, sw, bias = 1.0 / scales, qw["sw"], qw["bias"]
    instance = instance or kernel_instance(c, cin, nout)
    lib, wg = _lib()
    tail = (qw["sw7"].data_ptr(), qw["bias7"].data_ptr(), out.data_ptr())
    where = (_OUT_DTYPES[out_dtype], xq.device.index,
             torch.cuda.current_stream(xq.device).cuda_stream)
    if instance == WGMMA_S8:
        rc = wg.cwfa_qtower_wg(
            xq.data_ptr(), qw["wg"].data_ptr(), inv.data_ptr(), sw.data_ptr(),
            bias.data_ptr(), *tail, b, h, w, cin, nout, *where)
    else:
        if c % 8:
            # the canvases' padded channels: sums of zero weights, times 0,
            # plus 0, stay 0 through ELU, the residual and the requant
            pad = (0, (-c) % 8)
            inv = F.pad(inv, pad, value=1.0)
            sw, bias = F.pad(sw, pad), F.pad(bias, pad)
        rc = lib.cwfa_qtower(
            xq.data_ptr(), *(qw[k].data_ptr() for k in WEIGHTS),
            inv.data_ptr(), sw.data_ptr(), bias.data_ptr(), *tail,
            b, h, w, cin, _round_up(c, 8), nout, *where)
        if rc == TOO_WIDE:
            raise ValueError(f"tower width {c}: the canvases of the smallest "
                             "tile exceed the card's shared memory")
    cuda_build.check_launch(rc, f"fused_tower ({instance})")
    fused_tower.launches += 1
    fused_tower.by_instance[instance] += 1
    return check_kernel_outputs("fused_tower", out)


fused_tower.launches = 0                    # every launch of the kernel
fused_tower.by_instance = {WGMMA_S8: 0, DP4A: 0}     # ... and of each instance
