"""Where the time goes in the PyTorch port's reconstruction slice, on one GPU.

    python3 scripts/profile_torch_port.py [--batch 8] [--int8]

Builds the flagship rig (``cwfa_tpu_torch.rig.flagship``, random weights
from seed 0) as a bf16 ``XLFMReconstructor`` — with ``--int8``, the int8
configuration (``use_int8`` + ``use_int8_towers``, calibrated on the
batch) — and prints:

- the whole call's time (CUDA events, median of 5 after a warm-up);
- each component run alone on the same inputs, with CUDA events: view
  extraction, LRNN, the cond nets (and their 3-D pairs alone), the 20
  subnet towers, the 20 flow-kernel launches and the 16 inverse
  permutations, with its share of the whole call;
- one call under ``torch.profiler``: device time by kernel and the device's
  idle share of the call's wall time.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cwfa_tpu_torch.data.views import extract_views
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.models.cond_net import cond_networks_batched
from cwfa_tpu_torch.ops import qtower
from cwfa_tpu_torch.ops.flow_affine import cat_affine, haar_merge_affine
from cwfa_tpu_torch.rig import flagship


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args()
    batch = args.batch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    frames = torch.as_tensor(
        rng.rand(batch, img, img).astype(np.float32) * 1000).to(dev)
    int8 = ({"use_int8": True, "use_int8_towers": True,
             "calib_frames": frames} if args.int8 else {})
    recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                              compute_dtype=torch.bfloat16, **int8)
    m = recon.model
    qpacks = recon.qpacks or [None] * m.n_flow_steps

    whole = cuda_ms(lambda: recon(frames))
    print(f"batch {batch}{' int8' if args.int8 else ''}: whole call "
          f"{whole:.2f} ms = {whole / batch:.2f} ms/frame")

    with torch.inference_mode():
        views_n = ((extract_views(frames, vidx) - stats.mean_imgs)
                   / stats.std_imgs).to(torch.bfloat16)
        cv = cond_networks_batched(m.cond, views_n)
        ups = {}
        up = m.lrnn(views_n, mean_branch=recon.mean_branch,
                    unet_q=recon.unet_q)
        for k in range(m.n_flow_steps - 1, -1, -1):
            ups[k] = up
            spec = m.step_specs[k]
            z = torch.zeros((batch, spec.c_flow, side, side),
                            dtype=up.dtype, device=dev)
            up = m.flow[k].reverse_fast(z, up, cv[k], recon.mean_caches[k],
                                        qpack=qpacks[k])

        def pair3d():
            for net, c in zip(m.cond, cv):
                v = c.permute(0, 2, 3, 1).unsqueeze(1)
                net.c3b(net.prelu(net.c3a(v)))

        def towers():
            for k, step in enumerate(m.flow):
                packs = qpacks[k] or [None] * len(step.blocks)
                xq = None
                for blk, pk in zip(step.blocks, packs):
                    if pk is None:
                        blk["subnet"](cv[k])
                        continue
                    if xq is None:
                        xq = qtower.quantize_input(cv[k], pk["scales"][0])
                    qtower.fused_tower(xq, pk["qw"], pk["scales"],
                                       out_dtype=cv[k].dtype)
                step.input_block["subnet"].tower(cv[k])

        def kernels():
            for k, step in enumerate(m.flow):
                kw = {"clamp": step.spec.clamp,
                      "activation": step.spec.clamp_activation}
                x = ups[k]
                st = torch.cat([x, x], 1)
                for _ in step.blocks:
                    cat_affine(x, st, rev=True, **kw)
                haar_merge_affine(x, x, recon.mean_caches[k].expand(x.shape),
                                  x, **kw)

        def perms():
            for k, step in enumerate(m.flow):
                for i in range(len(step.spec.perms)):
                    step._inverse_perm(i, ups[k])

        parts = {
            "views+normalize": lambda: ((extract_views(frames, vidx)
                                         - stats.mean_imgs) / stats.std_imgs
                                        ).to(torch.bfloat16),
            "lrnn (proj+unet)": lambda: m.lrnn(
                views_n, mean_branch=recon.mean_branch, unet_q=recon.unet_q),
            "cond nets (all)": lambda: cond_networks_batched(m.cond, views_n),
            "  of which 3-D pairs": pair3d,
            "towers (20)": towers,
            "flow kernels (20)": kernels,
            "inverse perms": perms,
        }
        for name, fn in parts.items():
            ms = cuda_ms(fn)
            print(f"{name:22s} {ms:9.3f} ms  {100 * ms / whole:5.1f}%")

    recon(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recon(frames)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in kern:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    print(f"profiled call: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
          f"{len(kern)} device events")
    rows = []
    for a in prof.key_averages():
        t = getattr(a, "self_device_time_total", None)
        if t is None:
            t = a.self_cuda_time_total
        if t > 0:
            rows.append((t, a.count, a.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    for t, count, key in rows[:25]:
        print(f"{t / 1e3:9.3f} ms {100 * t / total:5.1f}% x{count:<4d} "
              f"{key[:90]}")


if __name__ == "__main__":
    main()
