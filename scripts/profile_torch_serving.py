"""Whether a reconstruction call of the serving CLI's configurations returns
to the host before the card has finished it, on one GPU.

    python3 scripts/profile_torch_serving.py [--batch 8]

The serving loop (``cwfa_tpu_torch/engine/serving.py``) dispatches batch N
and then collects batch N-1: that overlaps only if ``XLFMReconstructor``'s
call does not wait for the card.  For each configuration the serving CLI
builds (deterministic bf16 with the int8 UNet, calibrated on two frames;
and ``--no_int8``) on the flagship rig (random weights, seed 0), this
prints:

- the host time of a call (until it returns) against its device time
  (CUDA events), median of 3, after a warm-up;
- for one call under ``torch.profiler``: the CUDA runtime calls by name,
  with their count and host time — kernel launches, and any call that
  waits for the device (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``, ``cudaMemcpy``).

A host time close to the device time with no waiting call among them is
back-pressure: the call queues more launches than the device's queue holds,
so a launch blocks until earlier work drains.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.rig import flagship
from cwfa_tpu_torch.roofline import card_line

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def host_and_device_ms(fn, reps: int = 3):
    """(median host ms until fn() returns, median device ms of the call)."""
    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    return float(np.median(host)), float(np.median(dev))


def runtime_calls(fn):
    """{CUDA runtime / driver call name: (count, host ms)} of one fn()."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith(("cuda", "cu")):
            calls[e.name][0] += 1
            calls[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    return calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    frames = torch.as_tensor(
        rng.randint(0, 400, (args.batch, img, img)).astype(np.float32)).to(dev)
    for name, int8 in (("int8 UNet (the CLI's default)", True),
                       ("bf16 (--no_int8)", False)):
        recon = XLFMReconstructor(
            model, stats, vidx, caches, device=dev, deterministic=True,
            compute_dtype=torch.bfloat16, use_int8=int8,
            calib_frames=frames[:2] if int8 else None)
        host, device = host_and_device_ms(lambda: recon(frames))
        calls = runtime_calls(lambda: recon(frames))
        launches = sum(n for k, (n, _) in calls.items() if "Launch" in k)
        waits = {k: v for k, v in calls.items() if k.startswith(WAITS)
                 and not k.startswith("cudaMemcpyAsync")}
        print(f"{name}, batch {args.batch}: host {host:.2f} ms until the call "
              f"returns, device {device:.2f} ms; {launches} launches in the "
              f"call; calls that wait for the device (the trailing "
              f"synchronize is the profiler's own): "
              f"{ {k: (n, round(ms, 3)) for k, (n, ms) in waits.items()} }; "
              f"on {card}")
        for k, (n, ms) in sorted(calls.items(), key=lambda kv: -kv[1][1])[:8]:
            print(f"    {k:40s} x{n:<6d} {ms:9.3f} ms host")
        del recon
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
