"""int8/bf16 GEMM ceiling probes of the PyTorch port on one GPU: the
counterparts of ``scripts/bench_int8_micro.py``'s two probes that hold a
kernel.

  pallas  the hand-written tiled GEMM (``ops/probes.tiled_gemm``) beside the
          library call for the same product (``torch._int_mm``,
          ``torch.matmul``) at the tower GEMM shapes: M 2^20, K 1152,
          N 128/256/512.
  chain   eight chained 128 x 128 products on a row tile that stays on chip
          (``ops/probes.chained_gemm``: the fused-tower ceiling) beside eight
          library calls through device memory, and the int8-out GEMM (the
          write-traffic variant, ``tiled_gemm(out8=True)``).

Times are CUDA events; every line ends with the card's name and power limit.

Usage: python3 scripts/torch_bench_int8_micro.py [pallas|chain]
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cwfa_tpu_torch.ops import probes
from cwfa_tpu_torch.roofline import card_line, time_ms

GEMM_SHAPES = ((1152, 128), (1152, 256), (1152, 512))
CHAIN_DEPTH = 8


def make(shape, dtype, dev, gen):
    """Random operands made on the card: int8 uniform in [-127, 127], bf16
    standard normal."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                             generator=gen)
    return torch.randn(shape, device=dev, generator=gen).to(dtype)


def library_gemm(a, b):
    """One PyTorch call for ``tiled_gemm``'s product."""
    return torch._int_mm(a, b) if a.dtype == torch.int8 else a @ b


def library_chain(x, ws):
    """``chained_gemm``'s function as library calls, every intermediate
    through device memory."""
    y = x
    for w in ws:
        if x.dtype == torch.int8:
            y = probes.requant(torch._int_mm(y, w))
        else:
            y = torch.clamp_min(y @ w, 0)
    return y


def _line(log, rec, card):
    lib = ("" if rec.get("library_ms") is None else
           f"  library {rec['library_ms']:7.3f} ms "
           f"{rec['ops'] / rec['library_ms'] / 1e9:6.1f} T/s")
    log(f"{rec['name']:34s}: {rec['ms']:7.3f} ms "
        f"{rec['ops'] / rec['ms'] / 1e9:6.1f} T/s{lib}  [{card}]")


def probe_pallas(m: int = 1 << 20, iters: int = 30, log=print):
    """The tiled GEMM vs the library at the tower shapes.  Returns one
    record per line: key, name, ms, library_ms, ops."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    card, recs = card_line(), []
    for k, n in GEMM_SHAPES:
        for dtype, tag in ((torch.int8, "i8"), (torch.bfloat16, "bf16")):
            a, b = make((m, k), dtype, dev, gen), make((k, n), dtype, dev, gen)
            rec = {"key": ("gemm", tag, k, n),
                   "name": f"gemm {tag:4s} M={m} K={k} N={n}",
                   "ops": 2 * m * k * n,
                   "ms": time_ms(lambda: probes.tiled_gemm(a, b), iters),
                   "library_ms": time_ms(lambda: library_gemm(a, b), iters)}
            _line(log, rec, card)
            recs.append(rec)
            del a, b
    return recs


def probe_chain(m: int = 1 << 20, iters: int = 30, log=print):
    """Chained on-chip 128-wide products (the fused-tower ceiling) vs the
    same chain through device memory, and the int8-out GEMM."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    card, recs = card_line(), []
    c = probes.CHAIN_WIDTH
    for dtype, tag in ((torch.int8, "int8"), (torch.bfloat16, "bfloat16")):
        x = make((m, c), dtype, dev, gen)
        ws = make((CHAIN_DEPTH, c, c), dtype, dev, gen)
        rec = {"key": ("chain", tag),
               "name": f"chain {tag:8s} M={m} depth={CHAIN_DEPTH}",
               "ops": 2 * m * c * c * CHAIN_DEPTH,
               "ms": time_ms(lambda: probes.chained_gemm(x, ws), iters),
               "library_ms": time_ms(lambda: library_chain(x, ws), iters)}
        _line(log, rec, card)
        recs.append(rec)
        del x, ws
    a8, b8 = make((m, 1152), torch.int8, dev, gen), make((1152, 128),
                                                         torch.int8, dev, gen)
    rec = {"key": ("gemm_out8", "i8", 1152, 128),
           "name": f"gemm M={m} K=1152 N=128 i8->i8 out",
           "ops": 2 * m * 1152 * 128,
           "ms": time_ms(lambda: probes.tiled_gemm(a8, b8, out8=True), iters),
           "library_ms": None}
    _line(log, rec, card)
    recs.append(rec)
    return recs


PROBES = {"pallas": probe_pallas, "chain": probe_chain}


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    PROBES[sys.argv[1] if len(sys.argv) > 1 else "pallas"]()
