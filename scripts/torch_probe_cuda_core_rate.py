"""Measure the CUDA cores' elementwise FMA throughput: the counterpart of
``scripts/probe_vpu_rate.py`` for the PyTorch port on one GPU.

The cond nets' 3-D pair kernel (``ops/cond_pair``) is a chain of f32 FMAs on
the CUDA cores; its share of the card's FMA peak is only worth as much as
the rate a pure FMA kernel reaches here.  ``ops/probes.fma_probe`` runs
chains of multiply-adds on (rows, 128) f32 with ``u`` independent
accumulators per element (instruction-level parallelism) repeated ``t``
times, all in registers.  Also the ``mul`` rate, and ``roll`` (a rotation by
one along the 128 columns: a warp shuffle) with one add.

Operations are counted as the JAX script counts them: fma 2 per element,
iteration and accumulator, mul 1, roll 1 (the add only).  ``rows`` 256 is
the JAX probe's size (32 blocks: a quarter of the card's 132 SMs); the
larger ``rows`` fills every SM several times over and gives the rate.

Usage: python3 scripts/torch_probe_cuda_core_rate.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cwfa_tpu_torch.ops import probes
from cwfa_tpu_torch.roofline import card_line, time_ms

OPS_PER_STEP = {"fma": 2, "mul": 1, "roll": 1}
ROWS_PROBE = 256                # the JAX probe's size
ROWS_FULL = 132 * 64 * 4        # 4 x 64 warps for each of the 132 SMs


def run(rows: int = ROWS_PROBE, t: int = 512, u: int = 8, mode: str = "fma",
        n: int = 20, log=print, card: str | None = None):
    """Time one configuration; prints a line and returns a record with
    ``ms`` and ``ops``."""
    dev = torch.device("cuda", 0)
    x = torch.full((rows, 128), 1.0000001, device=dev)
    y = torch.full((rows, 128), 1e-9, device=dev)
    ms = time_ms(lambda: probes.fma_probe(x, y, t=t, u=u, mode=mode), n)
    ops = rows * 128 * t * u * OPS_PER_STEP[mode]
    log(f"mode={mode:5s} rows={rows} t={t} u={u}: {ms * 1e3:9.1f} us  "
        f"{ops / ms / 1e9:7.2f} TF/s  [{card or card_line()}]")
    return {"mode": mode, "rows": rows, "t": t, "u": u, "ms": ms, "ops": ops}


def probe_fma(n: int = 20, us=(1, 2, 4, 8, 16), log=print):
    card = card_line()
    return [run(rows=rows, u=u, mode=mode, n=n, log=log, card=card)
            for rows in (ROWS_PROBE, ROWS_FULL)
            for mode in probes.FMA_MODES for u in us]


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    probe_fma()
