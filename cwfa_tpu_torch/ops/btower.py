"""The float subnet tower in one kernel: the weight pack, the plain PyTorch
version and the CUDA kernel's wrapper (counterpart of
``cwfa_tpu/ops/btower.py``; the kernel is ``csrc/btower.cu``).

One tower of ``flow/subnets.WaveletFlowSubnet2d`` per call, in bf16 or f32:

    r1  = b1(x)                                  1x1, Cin -> C
    e2  = elu(b2b(elu(b2a(r1))) + r1)            3x3 then 1x1, residual
    e4  = elu(b4b(elu(b4a(e2))) + e2)
    e6  = elu(b6b(elu(b6a(e4))) + e4)
    out = b7(e6)                                 3x3, C -> Nout

with the cast structure of ``pair_tower_bf16_reference``
(``cwfa_tpu/ops/btower.py:291-319``) for one unpaired tower: the canvases
between convs are rounded to x's dtype; sums, bias, ELU (as
``exp(min(v, 0)) - 1``) and the residual add are f32.

The kernel has three instances (``kernel_instance``): a 64-wide tower runs
on the warpgroup tensor cores (``wgmma``), in bf16 or, for f32, as 3xTF32
(every f32 operand split into a TF32 high part and a remainder, three
products, f32 sums; ``csrc/btower_wg.cu``); every other width runs on the
CUDA cores (``csrc/btower.cu``), any width whose canvases fit in shared
memory at the smallest tile (400 wide in bf16, 240 in f32).  Each reads the weights from a pack in its
own layout, built once per set of weights by ``pack_float_tower`` and kept
on the module.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cwfa_tpu_torch.ops import cuda_build

CONVS = ("b1", "b2a", "b2b", "b4a", "b4b", "b6a", "b6b", "b7")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _elu(v):
    # the kernel's form (btower.py:117-120)
    return torch.where(v > 0, v, torch.exp(torch.clamp_max(v, 0.0)) - 1.0)


def float_tower_reference(tower, x):
    """The kernel's math in plain PyTorch: f32 convs on inputs rounded to
    x's dtype.  x: (B, Cin, H, W).  Returns (B, Nout, H, W) f32."""
    dt = x.dtype

    def conv(name, v):
        c = getattr(tower, name)
        b = None if c.bias is None else c.bias.float()
        return F.conv2d(v.float(), c.weight.float(), b,
                        padding=c.weight.shape[-1] // 2)

    def block(a, b, e):
        return _elu(conv(b, _elu(conv(a, e)).to(dt)) + e.float()).to(dt)

    r1 = conv("b1", x).to(dt)
    e2 = block("b2a", "b2b", r1)
    e4 = block("b4a", "b4b", e2)
    e6 = block("b6a", "b6b", e4)
    return conv("b7", e6)


WGMMA_BF16, WGMMA_3XTF32, CUDA_CORES = "wgmma bf16", "wgmma 3xTF32", "CUDA cores"
WGMMA_WIDTH = 64                       # the tower width of the wgmma instances
WGMMA_NOUT = (16, 32, 48, 64, 96)      # b7 widths they are built for
TF32_CHUNK = 32                        # input channels per weight slice, 3xTF32
TOO_WIDE = -1                          # csrc/btower.cu: no tile fits the width
# a 1x1 that follows a 3x3 in registers reads its input channels in the
# order the 3x3's sums sit in a thread: slot s of 8 is channel _SUM_ORDER[s]
_SUM_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def kernel_instance(dtype, c: int, cin: int, nout: int) -> str:
    """Which instance of the kernel runs a tower of width ``c`` with ``cin``
    inputs and ``nout`` outputs in ``dtype``."""
    if c == WGMMA_WIDTH and cin <= WGMMA_WIDTH and nout <= WGMMA_NOUT[-1]:
        return WGMMA_BF16 if dtype == torch.bfloat16 else WGMMA_3XTF32
    return CUDA_CORES


def _round_up(n: int, m: int) -> int:
    return n + (-n) % m


def split_tf32(w):
    """f32 -> (hi, lo), both exact TF32 values (10 mantissa bits): hi is w
    rounded to nearest (ties away from zero), lo the remainder w - hi rounded
    the same way.  hi + lo is w to 2^-22 relative."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(w)
    return hi, rna(w - hi)


def _taps(w, ipad: int, opad: int):
    """OIHW -> [tap][O padded to opad][I padded to a multiple of ipad]."""
    o, i, k, _ = w.shape
    full = torch.zeros((k * k, opad, _round_up(i, ipad)), device=w.device)
    full[:, :o, :i] = w.permute(2, 3, 0, 1).reshape(k * k, o, i)
    return full


def _pack_conv(w, instance: str, *, nout_pad: int = 0, after_3x3: bool = False,
               first: bool = False):
    """One conv's OIHW f32 weight in the layout of ``instance``, flattened.

    CUDA cores: f32 [tap][Cin][Cout], zero-padded: Cout to a multiple of 8,
    Cin to a multiple of 2 for b1 (``first``) and of 8 for the others, whose
    input is a canvas of the tower's width padded to 8.

    wgmma: the B operand as the tensor cores read it from shared memory,
    K-major without swizzle: a core matrix is 8 output channels x 16 bytes
    of input channels (``nout_pad`` output channels, the conv's own if 0).
    bf16: [tap][Cin/8][Cout][8], Cin rounded up to 16.  3xTF32: per tap and
    per chunk of 32 input channels (Cin rounded up to 8) the high parts
    [chunk/4][Cout][4] and then the low parts, f32 (``split_tf32``); with
    ``after_3x3`` (the 1x1 of a residual block, whose A operand is the
    3x3's sums in registers) the input channels of every 8 in the order
    ``_SUM_ORDER``."""
    o, i, k, _ = w.shape
    if instance == CUDA_CORES:
        return (_taps(w, 2 if first else 8, _round_up(o, 8))
                .transpose(1, 2).reshape(-1))
    opad = nout_pad or o
    if instance == WGMMA_BF16:
        t = _taps(w, 16, opad)                                # [tap][O][I]
        t = t.reshape(k * k, opad, -1, 8).permute(0, 2, 1, 3)  # [tap][I/8][O][8]
        return t.reshape(-1).to(torch.bfloat16)
    t = _taps(w, 8, opad)
    if after_3x3:
        order = torch.tensor(_SUM_ORDER, device=w.device)
        t = t.reshape(k * k, opad, -1, 8)[..., order].reshape(k * k, opad, -1)
    parts = []
    for tap in t:
        for c0 in range(0, tap.shape[1], TF32_CHUNK):
            chunk = tap[:, c0:c0 + TF32_CHUNK]                # [O][kc]
            for part in split_tf32(chunk):
                parts.append(part.reshape(opad, -1, 4).permute(1, 0, 2).reshape(-1))
    return torch.cat(parts)


def _pack(tower, instance: str):
    weights, biases = [], []
    nout_pad = 0
    if instance != CUDA_CORES:
        nout_pad = next(n for n in WGMMA_NOUT if n >= tower.b7.out_channels)
    for name in CONVS:
        conv = getattr(tower, name)
        weights.append(_pack_conv(
            conv.weight.detach().float(), instance,
            nout_pad=nout_pad if name == "b7" else 0,
            after_3x3=name in ("b2b", "b4b", "b6b"), first=name == "b1"))
        bias = (torch.zeros(conv.out_channels, device=conv.weight.device)
                if conv.bias is None else conv.bias.detach().float())
        if instance == CUDA_CORES and name != "b7":
            # the padded channels of a width that is not a multiple of 8
            bias = F.pad(bias, (0, (-bias.numel()) % 8))
        biases.append(bias)
    return torch.cat(weights), torch.cat(biases)


def _instance_of(tower) -> str:
    return kernel_instance(tower.b1.weight.dtype, tower.b1.out_channels,
                           tower.b1.in_channels, tower.b7.out_channels)


def pack_float_tower(tower):
    """The tower's kernel pack (weights, biases): the weights of b1, b2a,
    b2b, b4a, b4b, b6a, b6b and b7 in turn, each in the layout of
    ``_pack_conv`` for the tower's instance (``kernel_instance``), and the
    eight biases in f32 (zeros where a conv has none; for the CUDA cores
    those of b1..b6b padded with zeros to a multiple of 8).  Built at first use
    and kept on the module until a weight changes (in place or by
    replacement)."""
    key = tuple((t.device, t.dtype, t.data_ptr(),
                 None if t.is_inference() else t._version)
                for t in tower.parameters())
    cached = getattr(tower, "_float_tower_pack", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, _pack(tower, _instance_of(tower)))
        tower._float_tower_pack = cached
    return cached[1]


@functools.lru_cache(maxsize=None)
def _lib():
    """(the CUDA-core library, the wgmma library)"""
    lib, wg = cuda_build.load("btower"), cuda_build.load("btower_wg")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cwfa_btower.argtypes = [p] * 4 + [i32] * 8 + [p]
    lib.cwfa_btower.restype = i32
    wg.cwfa_btower_wg.argtypes = [p] * 4 + [i32] * 7 + [p]
    wg.cwfa_btower_wg.restype = i32
    return lib, wg


def _check(x, tower):
    if x.dim() != 4 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError("x must be a contiguous non-empty (B, Cin, H, W) "
                         f"tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x.device}")
    cin, c = tower.b1.in_channels, tower.b1.out_channels
    if x.shape[1] != cin:
        raise ValueError(f"x has {x.shape[1]} channels, the tower takes {cin}")
    for name in CONVS:
        conv = getattr(tower, name)
        i = cin if name == "b1" else c
        o = c if name != "b7" else conv.out_channels
        k = 1 if name in ("b1", "b2b", "b4b", "b6b") else 3
        if tuple(conv.weight.shape) != (o, i, k, k):
            raise ValueError(f"{name}.weight shape {tuple(conv.weight.shape)}"
                             f" != {(o, i, k, k)}")
        for t in (conv.weight, conv.bias):
            if t is not None and (t.dtype != x.dtype or t.device != x.device):
                raise TypeError(f"{name} is {t.dtype} on {t.device}; x is "
                                f"{x.dtype} on {x.device}")
    return c, tower.b7.out_channels


def fused_float_tower(x, tower):
    """One subnet tower over the whole batch (``fused_pair_tower_bf16``,
    ``cwfa_tpu/ops/btower.py:235``).

    x: (B, Cin, H, W), contiguous, f32 or bf16; tower: a
    ``WaveletFlowSubnet2d`` with weights of x's dtype and device.  Returns
    the tower's output (B, Nout, H, W) in x's dtype, NCHW.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.  Counts every launch, and per instance in
    ``fused_float_tower.by_instance``."""
    c, nout = _check(x, tower)
    if x.device.type == "cpu":
        return float_tower_reference(tower, x).to(x.dtype)
    b, cin, h, w = x.shape
    weights, biases = pack_float_tower(tower)
    out = torch.empty((b, nout, h, w), dtype=x.dtype, device=x.device)
    instance = kernel_instance(x.dtype, c, cin, nout)
    lib, wg = _lib()
    ptrs = (x.data_ptr(), weights.data_ptr(), biases.data_ptr(), out.data_ptr())
    where = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if instance == CUDA_CORES:
        rc = lib.cwfa_btower(*ptrs, b, h, w, cin, c, nout, _DTYPES[x.dtype],
                             *where)
    else:
        rc = wg.cwfa_btower_wg(*ptrs, b, h, w, cin, nout, _DTYPES[x.dtype],
                               *where)
    if rc == TOO_WIDE:
        raise ValueError(f"tower width {c} in {x.dtype}: the canvases of the "
                         "smallest tile exceed the card's shared memory")
    cuda_build.check_launch(rc, f"fused_float_tower ({instance})")
    fused_float_tower.launches += 1
    fused_float_tower.by_instance[instance] += 1
    return out


fused_float_tower.launches = 0              # every launch of the kernel
# ... and of each instance
fused_float_tower.by_instance = {WGMMA_BF16: 0, WGMMA_3XTF32: 0, CUDA_CORES: 0}
