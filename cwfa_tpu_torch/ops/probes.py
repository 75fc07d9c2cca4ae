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

The int8 kernels have two instances each (``gemm_plan``, ``chain_plan`` pick
one by shape; ``<wrapper>.by_instance`` counts the launches of each):
``WGMMA_S8``, persistent blocks on s8 ``wgmma`` fed by TMA, for the requant
GEMM where B^T's column slice fits resident in shared memory (K up to 1408)
and for a chain of up to 8 stages (all weights resident); ``MMA_SYNC``, the
older ``mma.sync`` kernels, for the int32-out GEMM and everything else.
The bf16 GEMM is ``WGMMA_BF16``, the bf16 chain ``MMA_SYNC``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cwfa_tpu_torch.ops import cuda_build
from cwfa_tpu_torch.ops.wgmma_layout import S8_SUM_ORDER

_DTYPES = {torch.int8: 0, torch.bfloat16: 1}
FMA_MODES = ("fma", "mul", "roll")
CHAIN_WIDTH = 128
_ROW_CHUNK = 1 << 16        # rows per matmul of a plain version on a card

MMA_SYNC, WGMMA_BF16, WGMMA_S8 = "mma.sync", "wgmma bf16", "wgmma s8"
_GEMM_IDS = {MMA_SYNC: 0, WGMMA_BF16: 1, WGMMA_S8: 2}
_CHAIN_IDS = {MMA_SYNC: 0, WGMMA_S8: 1}
SMEM_MAX = 232448           # bytes of shared memory a block may use (H100)
H100_SMS = 132              # the plans' SM count where no card is asked
GEMM_RING_MAX, CHAIN_RING_MAX = 6, 4
_HALF = 64 * 128            # a consumer warpgroup's 64 rows x 128 bytes
_TILE = 2 * _HALF           # a 128-row tile: a resident slice, a GEMM slot
CHAIN_WGS = 3               # consumer warpgroups of the s8 chain
CHAIN_RESIDENT = 8          # chain stages whose weights fit beside the ring


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
# host plans of the kernels: instance, tiles, shared memory
# ---------------------------------------------------------------------------


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _tma_smem(nres: int, ring: int, slot: int, nc: int) -> int:
    """Shared memory of an s8 instance, laid out as csrc/probes.cu
    ``tma_smem`` reads it: the base aligned to 1024 bytes, ``nres`` resident
    16 KB tiles, ``ring`` slots of ``slot`` bytes, a 64-row staging tile for
    each of the ``nc`` consumer warpgroups, the mbarriers."""
    return 1024 + nres * _TILE + ring * slot + nc * _HALF + 8 * (2 * ring + 1)


def _tma_ring(nres: int, slot: int, nc: int, most: int) -> int:
    """The largest ring of at most ``most`` slots that fits beside the
    rest, 0 if not two.  The kernels take it as given and only check that
    it fits the card."""
    return next((r for r in range(most, 1, -1)
                 if _tma_smem(nres, r, slot, nc) <= SMEM_MAX), 0)


def gemm_plan(m: int, k: int, n: int, dtype, out8: bool = False,
              aligned: bool = True, sms: int = H100_SMS) -> dict:
    """How ``tiled_gemm`` runs A (m, k) x B (k, n) on a card: the instance,
    K padded to a multiple of 16 bytes, the 128 x 128 tile counts and, for
    ``WGMMA_S8``, the resident K slices of B^T, the ring, the shared memory
    and the grid (persistent: column slices x row-tile walkers).  The s8
    instance takes the requant GEMM when two ring tiles fit beside the
    resident slices and both inputs are 16-byte aligned (TMA)."""
    esize = 2 if dtype == torch.bfloat16 else 1
    kpad = k + (-k * esize) % 16 // esize
    plan = {"k_padded": kpad, "m_tiles": _ceil(m, 128),
            "n_tiles": _ceil(n, 128), "instance": MMA_SYNC}
    if dtype == torch.bfloat16:
        plan["instance"] = WGMMA_BF16
        return plan
    nk = _ceil(kpad, 128)
    ring = _tma_ring(nk, _TILE, 2, GEMM_RING_MAX)
    if out8 and aligned and ring:
        gm = max(1, min(plan["m_tiles"], sms // plan["n_tiles"]))
        plan.update(instance=WGMMA_S8, slices=nk, ring=ring,
                    smem=_tma_smem(nk, ring, _TILE, 2),
                    grid=gm * plan["n_tiles"])
    return plan


def chain_plan(m: int, depth: int, dtype, aligned: bool = True,
               sms: int = H100_SMS) -> dict:
    """How ``chained_gemm`` runs x (m, 128) through ``depth`` stages on a
    card: ``WGMMA_S8`` for int8 with every stage's weights resident (depth
    <= 8) and 16-byte aligned x, with its tiles of 64 ``CHAIN_WGS`` rows,
    ring, shared memory and grid; ``MMA_SYNC`` otherwise."""
    rows = 64 * CHAIN_WGS
    plan = {"instance": MMA_SYNC}
    if dtype == torch.int8 and depth <= CHAIN_RESIDENT and aligned:
        ring = _tma_ring(depth, rows * 128, CHAIN_WGS, CHAIN_RING_MAX)
        plan.update(instance=WGMMA_S8, tiles=_ceil(m, rows), ring=ring,
                    smem=_tma_smem(depth, ring, rows * 128, CHAIN_WGS),
                    grid=min(sms, _ceil(m, rows)))
    return plan


@functools.lru_cache(maxsize=None)
def _chain_index(device, depth: int):
    """(depth, 1, 128) gather index over K: stage 0 in order, every later
    stage in the order of its A registers, slot s of every 16 channel
    ``S8_SUM_ORDER[s]``."""
    perm = torch.tensor([16 * (k // 16) + S8_SUM_ORDER[k % 16]
                         for k in range(CHAIN_WIDTH)])
    idx = perm.expand(depth, 1, CHAIN_WIDTH).clone()
    idx[0, 0] = torch.arange(CHAIN_WIDTH)
    return idx.to(device)


def chain_operand(ws, instance: str):
    """The weights (depth, 128, 128) as the chain kernel reads them: every
    stage transposed, (N, K); for the s8 ``wgmma`` instance the input
    channels of every stage after the first in ``S8_SUM_ORDER`` within each
    16, the order in which the requantized sums of the stage before sit in a
    thread's A registers.  One gather."""
    if instance == MMA_SYNC:
        return ws.transpose(1, 2).contiguous()
    d, c = ws.shape[0], ws.shape[1]
    return torch.gather(ws.transpose(1, 2), 2,
                        _chain_index(ws.device, d).expand(d, c, c))


# ---------------------------------------------------------------------------
# library entries
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("probes")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.cwfa_tiled_gemm.argtypes = [p, p, p, i64] + [i32] * 8 + [p]
    lib.cwfa_tiled_gemm.restype = i32
    lib.cwfa_chained_gemm.argtypes = [p, p, p, i64] + [i32] * 6 + [p]
    lib.cwfa_chained_gemm.restype = i32
    lib.cwfa_fma_probe.argtypes = [p, p, p, i64, i32, i32, i32, i32, p]
    lib.cwfa_fma_probe.restype = i32
    return lib


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _sms(device) -> int:
    """The SMs a plan's persistent grid is sized for: the card's own."""
    if device.type == "cpu":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def tiled_gemm(a, b, *, out8: bool = False, instance=None):
    """a (M, K) x b (K, N), both int8 or both bf16, contiguous.

    int8: int32 sums; returns int32, or with ``out8`` the requantized int8
    ``clip(sum >> 7, -127, 127)``.  bf16: f32 sums, returns bf16.

    On a card the kernel reads B transposed and K padded with zeros to a
    multiple of 16 bytes; both are made here (B is small).  ``gemm_plan``
    picks the instance; ``instance=MMA_SYNC`` runs the ``mma.sync`` kernel
    where it would pick ``WGMMA_S8`` (to time the two side by side), and
    the instance it picks may be named too.
    Counts every launch, those with ``out8`` in ``out8_launches``, and per
    instance in ``tiled_gemm.by_instance``."""
    _check_pair(a, b, ("a", "b"), _DTYPES)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} x b {tuple(b.shape)} is not a "
                         "matrix product")
    if out8 and a.dtype != torch.int8:
        raise TypeError("out8 is the int8 epilogue; a is " + str(a.dtype))
    (m, k), n = a.shape, b.shape[1]
    plan = gemm_plan(m, k, n, a.dtype, out8, a.data_ptr() % 16 == 0,
                     _sms(a.device))
    if instance not in (None, plan["instance"]) and (
            instance != MMA_SYNC or a.dtype != torch.int8):
        raise ValueError(f"instance {instance!r}: None, {plan['instance']!r} "
                         f"or, for int8, {MMA_SYNC!r}")
    if a.device.type == "cpu":
        return tiled_gemm_reference(a, b, out8=out8)
    instance, kpad = instance or plan["instance"], plan["k_padded"]
    bt = b.t().contiguous()
    if kpad != k:
        a, bt = F.pad(a, (0, kpad - k)), F.pad(bt, (0, kpad - k))
    out_dtype = (torch.bfloat16 if a.dtype == torch.bfloat16
                 else torch.int8 if out8 else torch.int32)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    rc = _lib().cwfa_tiled_gemm(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, kpad,
        _DTYPES[a.dtype], int(bool(out8)), _GEMM_IDS[instance],
        plan.get("ring", 0), plan.get("grid", 0), a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check_launch(rc, f"tiled_gemm ({instance})")
    tiled_gemm.launches += 1
    tiled_gemm.out8_launches += int(bool(out8))
    tiled_gemm.by_instance[instance] += 1
    return out


tiled_gemm.launches = 0         # every launch of the kernel
tiled_gemm.out8_launches = 0    # those with the int8 requant epilogue
tiled_gemm.by_instance = {WGMMA_S8: 0, WGMMA_BF16: 0, MMA_SYNC: 0}


def chained_gemm(x, ws, *, instance=None):
    """x (M, 128) through ``depth`` products with ws (depth, 128, 128), both
    int8 or both bf16, contiguous; the activation between products is the
    module docstring's.  Returns (M, 128) in x's dtype.

    On a card the kernel reads the weights as ``chain_operand`` makes them
    (here: the weights are small).  ``chain_plan`` picks the instance;
    ``instance=MMA_SYNC`` runs the ``mma.sync`` kernel where it would pick
    ``WGMMA_S8`` (to time the two side by side), and the instance it picks
    may be named too.  Counts every launch, and per instance in
    ``chained_gemm.by_instance``."""
    _check_pair(x, ws, ("x", "ws"), _DTYPES)
    if x.dim() != 2 or ws.dim() != 3 or ws.shape[1] != ws.shape[2] \
            or x.shape[1] != ws.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and ws {tuple(ws.shape)} are "
                         "not (M, C) and (depth, C, C)")
    m, depth = x.shape[0], ws.shape[0]
    plan = chain_plan(m, depth, x.dtype, x.data_ptr() % 16 == 0,
                      _sms(x.device))
    picked = plan["instance"]
    if instance not in (None, picked) and (
            instance != MMA_SYNC or picked != WGMMA_S8):
        raise ValueError(f"instance {instance!r}: None, {picked!r}, or "
                         f"{MMA_SYNC!r} where {WGMMA_S8!r} runs")
    if x.device.type == "cpu":
        return chained_gemm_reference(x, ws)
    if x.shape[1] != CHAIN_WIDTH:
        raise ValueError(f"the kernel takes C == {CHAIN_WIDTH}, got "
                         f"{x.shape[1]}")
    instance = instance or picked
    wt = chain_operand(ws, instance)
    out = torch.empty_like(x)
    rc = _lib().cwfa_chained_gemm(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(), m, depth,
        _DTYPES[x.dtype], _CHAIN_IDS[instance], plan.get("ring", 0),
        plan.get("grid", 0), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, f"chained_gemm ({instance})")
    chained_gemm.launches += 1
    chained_gemm.by_instance[instance] += 1
    return out


chained_gemm.launches = 0
chained_gemm.by_instance = {WGMMA_S8: 0, MMA_SYNC: 0}


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
