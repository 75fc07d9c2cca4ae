"""One step-0 flow optimizer step of the CAT flagship in f32
(``use_half_precision=0``, batch 1, random weights from seed 0) on the card:
its time (CUDA events around each call, the median of the calls after the
first) and the launches of the training backward kernels K2
(``btower.float_tower_backward``) and K3 (``cond_pair.cond_pair_backward``)
by instance in the first call.

    python3 scripts/torch_f32_step.py [--root DIR] [--iters 5] [--profile]

--root: the repository whose ``cwfa_tpu_torch`` runs (default: this
script's), so that another checkout's step can be timed on the same card.
--profile: one more call under ``torch.profiler``: the device's busy time
(the union of its kernels' intervals) against the call's, and the kernels
that take the most device time.  Prints the card's name and power limit
first and one JSON line last.  Needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def run(dev, iters: int = 5, profile: bool = False) -> dict:
    """The step on ``dev``: {"ms", "readings", "loss", "k2", "k3"}, k2 / k3
    the launches by instance of the first call; with ``profile``, also
    "busy_ms" and "top" (ms of device time by kernel name, the largest ten)
    of one more call."""
    from cwfa_tpu_torch.engine.trainer import CWFATrainer
    from cwfa_tpu_torch.ops import btower
    from cwfa_tpu_torch.ops import cond_pair as cpair
    from cwfa_tpu_torch.rig import flagship

    cfg, model, stats, vidx, _ = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    cfg.use_half_precision = 0
    tr = CWFATrainer(model, stats, vidx, device=dev)
    side, d = cfg.volume_side_size, model.step_specs[0].d_in
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(c, scale=1.0):
        return torch.randn((1, c, side, side), device=dev, generator=gen) * scale

    inputs = (randn(cfg.n_lenslets), randn(d // 2, 0.3), randn(d), randn(d // 2))
    wrappers = {"k2": btower.float_tower_backward,
                "k3": cpair.cond_pair_backward}
    before = {k: dict(w.by_instance) for k, w in wrappers.items()}
    readings = []
    loss = None
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = tr._flow_step(0, *inputs)
        end.record()
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end))
        if loss is None:
            loss = float(out[0])
            first = {k: {i: n - before[k][i] for i, n in w.by_instance.items()
                         if n != before[k][i]} for k, w in wrappers.items()}
    if not math.isfinite(loss):
        raise RuntimeError(f"f32 flow step 0: loss {loss}")
    out = {"ms": statistics.median(readings[1:]), "readings": readings,
           "loss": loss, **first}
    if profile:
        out.update(device_time(lambda: tr._flow_step(0, *inputs)))
    return out


def device_time(fn) -> dict:
    """fn() once under torch.profiler: {"call_ms", "busy_ms", "top"}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    busy, last = 0.0, None
    for a, b in sorted(spans):
        if last is None or a > last:
            busy += b - a
            last = b
        elif b > last:
            busy += b - last
            last = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"call_ms": start.elapsed_time(end), "busy_ms": busy / 1e3,
            "top": {name[:60]: round(ms, 3) for name, ms in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(a.root.resolve()))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = run(torch.device("cuda", 0), a.iters, a.profile)
    print(f"f32 flow step 0 of the flagship, batch 1 ({a.root}): "
          f"{out['ms']:.2f} ms (readings {[round(t, 2) for t in out['readings']]}); "
          f"K2 {out['k2']}, K3 {out['k3']}", flush=True)
    if a.profile:
        print(f"profiled call {out['call_ms']:.2f} ms, device busy "
              f"{out['busy_ms']:.2f} ms; by kernel {out['top']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
