"""Ceiling probes: a tiled GEMM, a chained on-chip GEMM and an FMA-rate
probe — CUDA wrappers and their plain PyTorch versions (the kernels are in
``csrc/probes.cu``).

Replace the Pallas TPU kernels of the two probe scripts:

- ``tiled_gemm`` (``scripts/bench_int8_micro.py:182`` ``_pallas_gemm``, and
  with ``out8`` ``:305`` ``gemm_out8``): A (M, K) x B (K, N); int8 x int8 with
  int32 sums -> int32, or with the requant epilogue ``clip(sum >> 7, -127,
  127)`` -> int8; bf16 x bf16 with f32 sums -> bf16;
- ``chained_gemm`` (``:255`` ``_chained``): ``depth`` chained products of a
  row tile with 128 x 128 weights, the tile never leaving the chip; between
  products int8: ``clip(sum >> 7, -127, 127)`` -> int8, bf16: ``max(sum, 0)``
  -> bf16;
- ``fma_probe`` (``scripts/probe_vpu_rate.py:24`` ``fma_kernel``): ``u``
  accumulators ``a_k = y * (0.5 + 0.01 k)``, ``t`` times ``a <- a * x + y``
  (one fused multiply-add), ``a <- a * x`` or ``a <- roll(a, 1, axis 1) + y``,
  output ``sum_k a_k``.

``>>`` on a negative int32 is an arithmetic shift (it rounds toward minus
infinity) in JAX, in PyTorch and in CUDA C++ alike.  The int8 results are
exact, so the kernels equal their plain versions to the bit; bf16 sums run
in another order.  The ``fma`` mode rounds once per step (``fmaf``): its
plain version forms ``a * x + y`` in f64, where the product of two f32
values is exact, and rounds that to f32, which is the fused result except
where the f64 sum itself lands on an f32 rounding tie.

A wrapper dispatches on the device of its inputs: CPU tensors take the plain
version; CUDA tensors launch the kernel (or raise).  Each wrapper counts its
launches in ``<wrapper>.launches``; the plain path does not count.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cwfa_tpu_torch.ops import cuda_build

_DTYPES = {torch.int8: 0, torch.bfloat16: 1}
FMA_MODES = ("fma", "mul", "roll")
CHAIN_WIDTH = 128
_ROW_CHUNK = 1 << 16        # rows per matmul of a plain version on a card


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def requant(acc):
    """The probes' int8 epilogue: ``clip(acc >> 7, -127, 127)`` -> int8, the
    shift arithmetic (-1 >> 7 == -1, -128 >> 7 == -1, -129 >> 7 == -2)."""
    return torch.clamp(acc >> 7, -127, 127).to(torch.int8)


def _int_matmul(a, b):
    """Exact int8 x int8 -> int32 product.  The CPU has an int32 matmul; a
    card has none, so there the product runs in f64 (every sum is far below
    2^53, where f32 would already round: K * 127^2 exceeds 2^24 from K =
    1041 on), in row chunks."""
    if a.device.type == "cpu":
        return a.int() @ b.int()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    bd = b.double()
    for r in range(0, a.shape[0], _ROW_CHUNK):
        out[r:r + _ROW_CHUNK] = (a[r:r + _ROW_CHUNK].double() @ bd).int()
    return out


def _bf16_matmul(a, b):
    """bf16 x bf16 with f32 sums (exact products, TF32 off), f32 out."""
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    bf = b.float()
    for r in range(0, a.shape[0], _ROW_CHUNK):
        out[r:r + _ROW_CHUNK] = a[r:r + _ROW_CHUNK].float() @ bf
    return out


def tiled_gemm_reference(a, b, *, out8: bool = False):
    if a.dtype == torch.int8:
        acc = _int_matmul(a, b)
        return requant(acc) if out8 else acc
    return _bf16_matmul(a, b).to(torch.bfloat16)


def chained_gemm_reference(x, ws):
    y = x
    for w in ws:
        if x.dtype == torch.int8:
            y = requant(_int_matmul(y, w))
        else:
            y = torch.clamp_min(_bf16_matmul(y, w), 0.0).to(torch.bfloat16)
    return y


def fma_probe_reference(x, y, *, t: int, u: int, mode: str):
    accs = [y * (0.5 + 0.01 * k) for k in range(u)]
    xd, yd = x.double(), y.double()
    for _ in range(t):
        if mode == "fma":
            accs = [(a.double() * xd + yd).float() for a in accs]
        elif mode == "mul":
            accs = [a * x for a in accs]
        else:
            accs = [torch.roll(a, 1, 1) + y for a in accs]
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc


# ---------------------------------------------------------------------------
# library entries
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("probes")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.cwfa_tiled_gemm.argtypes = [p, p, p, i64, i32, i32, i32, i32, i32, p]
    lib.cwfa_tiled_gemm.restype = i32
    lib.cwfa_chained_gemm.argtypes = [p, p, p, i64, i32, i32, i32, p]
    lib.cwfa_chained_gemm.restype = i32
    lib.cwfa_fma_probe.argtypes = [p, p, p, i64, i32, i32, i32, i32, p]
    lib.cwfa_fma_probe.restype = i32
    return lib


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_pair(a, b, names, dtypes):
    for name, v in zip(names, (a, b)):
        if v.numel() == 0 or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous and non-empty, got "
                             f"shape {tuple(v.shape)}")
    if a.dtype not in dtypes:
        raise TypeError(f"{names[0]} dtype {a.dtype} not in {list(dtypes)}")
    if b.dtype != a.dtype or b.device != a.device:
        raise TypeError(f"{names[1]} is {b.dtype} on {b.device}, {names[0]} "
                        f"is {a.dtype} on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {a.device}")


def tiled_gemm(a, b, *, out8: bool = False):
    """a (M, K) x b (K, N), both int8 or both bf16, contiguous.

    int8: int32 sums; returns int32, or with ``out8`` the requantized int8
    ``clip(sum >> 7, -127, 127)``.  bf16: f32 sums, returns bf16.

    On a card the kernel reads B transposed and K padded with zeros to a
    multiple of 16 bytes; both are made here (B is small)."""
    _check_pair(a, b, ("a", "b"), _DTYPES)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} x b {tuple(b.shape)} is not a "
                         "matrix product")
    if out8 and a.dtype != torch.int8:
        raise TypeError("out8 is the int8 epilogue; a is " + str(a.dtype))
    if a.device.type == "cpu":
        return tiled_gemm_reference(a, b, out8=out8)
    (m, k), n = a.shape, b.shape[1]
    bt = b.t().contiguous()
    pad = (-k * a.element_size()) % 16 // a.element_size()
    if pad:
        a, bt = F.pad(a, (0, pad)), F.pad(bt, (0, pad))
    out_dtype = (torch.bfloat16 if a.dtype == torch.bfloat16
                 else torch.int8 if out8 else torch.int32)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    rc = _lib().cwfa_tiled_gemm(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k + pad,
        _DTYPES[a.dtype], int(bool(out8)), a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check_launch(rc, "tiled_gemm")
    tiled_gemm.launches += 1
    tiled_gemm.out8_launches += int(bool(out8))
    return out


tiled_gemm.launches = 0         # every launch of the kernel
tiled_gemm.out8_launches = 0    # those with the int8 requant epilogue


def chained_gemm(x, ws):
    """x (M, 128) through ``depth`` products with ws (depth, 128, 128), both
    int8 or both bf16, contiguous; the activation between products is the
    module docstring's.  Returns (M, 128) in x's dtype.

    On a card the kernel reads every stage's weights transposed; the
    transpose is made here (the weights are small)."""
    _check_pair(x, ws, ("x", "ws"), _DTYPES)
    if x.dim() != 2 or ws.dim() != 3 or ws.shape[1] != ws.shape[2] \
            or x.shape[1] != ws.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and ws {tuple(ws.shape)} are "
                         "not (M, C) and (depth, C, C)")
    if x.device.type == "cpu":
        return chained_gemm_reference(x, ws)
    if x.shape[1] != CHAIN_WIDTH:
        raise ValueError(f"the kernel takes C == {CHAIN_WIDTH}, got "
                         f"{x.shape[1]}")
    wt = ws.transpose(1, 2).contiguous()
    out = torch.empty_like(x)
    rc = _lib().cwfa_chained_gemm(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), x.shape[0], ws.shape[0],
        _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, "chained_gemm")
    chained_gemm.launches += 1
    return out


chained_gemm.launches = 0


def fma_probe(x, y, *, t: int, u: int, mode: str):
    """x, y: (rows, 128) f32, contiguous.  ``u`` (1..16) accumulators per
    element, ``t`` steps of ``mode`` ("fma", "mul" or "roll"); returns their
    sum, (rows, 128) f32."""
    _check_pair(x, y, ("x", "y"), (torch.float32,))
    if x.dim() != 2 or x.shape[1] != 128 or y.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         "both be (rows, 128)")
    if mode not in FMA_MODES:
        raise ValueError(f"mode {mode!r} not in {FMA_MODES}")
    if not 1 <= u <= 16 or t < 0:
        raise ValueError(f"u must be in 1..16 and t >= 0; got u={u}, t={t}")
    if x.device.type == "cpu":
        return fma_probe_reference(x, y, t=t, u=u, mode=mode)
    out = torch.empty_like(x)
    rc = _lib().cwfa_fma_probe(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0], t, u,
        FMA_MODES.index(mode), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, "fma_probe")
    fma_probe.launches += 1
    return out


fma_probe.launches = 0
