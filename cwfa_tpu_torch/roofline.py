"""Timing on the card and the least time the card could take (the bound).

``bound_ms`` is the larger of two times: the bytes a function must move
(each input read once, each output written once) over the card's memory
rate, and its operations over the card's peak rate for their type.  The
peaks are NVIDIA's data-sheet figures for one H100 SXM at its full 700 W
power limit (dense rates, no sparsity); a card set below that limit runs
slower, so every line that carries a time also names the card and its limit
(``card_line``).
"""

from __future__ import annotations

import subprocess

import torch

H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {
    "int8": 1979e12,        # tensor cores
    "bf16": 989e12,         # tensor cores
    "tf32": 495e12,         # tensor cores
    "f32": 67e12,           # CUDA cores (FMA = 2 operations)
}


def bound_ms(nbytes: float, ops: float, kind: str):
    """(least time in ms, "bytes" or "operations") for a function that moves
    ``nbytes`` and does ``ops`` operations of type ``kind``."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = ops / H100_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


WARMUP = 5      # calls of fn() before the timed ones, unless the caller says


def time_ms(fn, iters: int = 50, warmup: int = WARMUP) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls after
    ``warmup`` untimed ones, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
