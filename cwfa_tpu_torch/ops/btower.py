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

The kernel runs a bf16 tower of width C % 16 == 0 on the tensor cores
(``mma.sync``) and the others on the CUDA cores; it reads the weights from a
pack in the layout of that path, built once per set of weights by
``pack_float_tower`` and kept on the module.
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


def uses_mma(dtype, c: int) -> bool:
    """Whether the kernel runs a tower of width ``c`` in ``dtype`` on the
    tensor cores (bf16, C a multiple of 16) rather than the CUDA cores."""
    return dtype == torch.bfloat16 and c % 16 == 0


def _pack_conv(w, mma: bool):
    """One conv's OIHW weight in the kernel's layout, flattened.

    CUDA cores: f32 [tap][Cin rounded up to 2][Cout rounded up to 8].
    Tensor cores: bf16 [tap][Cin/16][Cout/16][lane][8] (both rounded up to
    16): lane l's 8 values are, for the two n8 blocks h of that pair,
    W[16 j + 8 h + l // 4][16 i + 2 (l % 4) + {0, 1, 8, 9}], the B fragment
    of mma.sync m16n8k16 (k = input channel, n = output channel)."""
    o, i, k, _ = w.shape
    taps = w.permute(2, 3, 0, 1).reshape(k * k, o, i)        # [tap][O][I]
    if not mma:
        full = torch.zeros((k * k, i + i % 2, o + (-o) % 8), device=w.device)
        full[:, :i, :o] = taps.transpose(1, 2)
        return full.flatten()
    ip, op = i + (-i) % 16, o + (-o) % 16
    full = torch.zeros((k * k, op, ip), device=w.device)
    full[:, :o, :i] = taps
    # n = (pair, h, l // 4); k = (step, j // 2, l % 4, j % 2)
    f = full.reshape(k * k, op // 16, 2, 8, ip // 16, 2, 4, 2)
    f = f.permute(0, 4, 1, 3, 6, 2, 5, 7)
    return f.reshape(-1).to(torch.bfloat16)


def _pack(tower):
    mma = uses_mma(tower.b1.weight.dtype, tower.b1.out_channels)
    weights, biases = [], []
    for name in CONVS:
        conv = getattr(tower, name)
        weights.append(_pack_conv(conv.weight.detach().float(), mma))
        biases.append(torch.zeros(conv.out_channels, device=conv.weight.device)
                      if conv.bias is None else conv.bias.detach().float())
    return torch.cat(weights), torch.cat(biases)


def pack_float_tower(tower):
    """The tower's kernel pack (weights, biases): the weights of b1, b2a,
    b2b, b4a, b4b, b6a, b6b and b7 in turn, each in the layout of
    ``_pack_conv`` for the tower's dtype and width (``uses_mma``), and the
    eight biases in f32 (zeros where a conv has none).  Built at first use
    and kept on the module until a weight changes (in place or by
    replacement)."""
    key = tuple((t.device, t.dtype, t.data_ptr(),
                 None if t.is_inference() else t._version)
                for t in tower.parameters())
    cached = getattr(tower, "_float_tower_pack", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, _pack(tower))
        tower._float_tower_pack = cached
    return cached[1]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("btower")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cwfa_btower.argtypes = [p] * 4 + [i32] * 9 + [p]
    lib.cwfa_btower.restype = i32
    return lib


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
    (tower width C a multiple of 8, at most 64) or raises."""
    c, nout = _check(x, tower)
    if x.device.type == "cpu":
        return float_tower_reference(tower, x).to(x.dtype)
    if c % 8 or c > 64:
        raise ValueError(f"the kernel takes a tower width C % 8 == 0, "
                         f"C <= 64; got {c}")
    b, cin, h, w = x.shape
    weights, biases = pack_float_tower(tower)
    out = torch.empty((b, nout, h, w), dtype=x.dtype, device=x.device)
    rc = _lib().cwfa_btower(
        x.data_ptr(), weights.data_ptr(), biases.data_ptr(), out.data_ptr(), b,
        h, w, cin, c, nout, _DTYPES[x.dtype], int(uses_mma(x.dtype, c)),
        x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, "fused_float_tower")
    fused_float_tower.launches += 1
    fused_float_tower.cuda_core_launches += int(not uses_mma(x.dtype, c))
    return out


fused_float_tower.launches = 0              # every launch of the kernel
fused_float_tower.cuda_core_launches = 0    # those of the CUDA-core instance
