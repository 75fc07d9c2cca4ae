"""Smoke test of the PyTorch/CUDA port (``cwfa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cwfa_tpu_torch/csrc/``, then, failing (exit
code != 0) on the first phase that does not hold:

1. prints the card's name and power limit and the kernel build time;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, in f32 and bf16, for every clamp activation, and
   times both (CUDA events);
3. runs the small rig through ``XLFMReconstructor`` on the card (kernels)
   and on the CPU (plain versions), in f32, and compares;
4. runs the flagship configuration (2160^2 frames, 29 views of 512^2,
   512x512x96 volumes, 4 CAT steps x 4 blocks, 64-wide towers, random
   weights from a seed) in bf16 at batch 1 and 8: shape, finiteness, the
   kernels' launch counts, ms per frame and peak device memory;
5. compares the flagship bf16 output with the f32 output at batch 1.

Prints a ``{"kernels": [...]}`` JSON line, then, as its last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without that line when no
CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.flow.coupling import CLAMP_ACTIVATIONS
from cwfa_tpu_torch.ops import flow_affine as fa
from cwfa_tpu_torch.rig import flagship

SLICE_C, SLICE_HW = 48, 512        # step 0 of the flagship: (1, 48, 512, 512)
KERNELS = {
    "cat_affine": {"replaces": "cwfa_tpu/ops/pallas_flow.py:138",
                   "per_call": 16},
    "haar_merge_affine": {"replaces": "cwfa_tpu/ops/pallas_flow.py:118",
                          "per_call": 4},
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, ref, dtype, what: str) -> float:
    """max |got - ref|, failing unless every element is within the bound:
    f32 |d| <= 1e-5 * max(1, |ref|) (atanf/expf differ from torch's by a few
    ulp); bf16 |d| <= 2^-7 * |ref| (one bf16 ulp of the output)."""
    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    if dtype == torch.float32:
        bound = 1e-5 * r.abs().clamp_min(1.0)
    else:
        bound = 2.0 ** -7 * r.abs() + torch.finfo(torch.bfloat16).tiny
    if not bool(torch.isfinite(g).all()) or bool((d > bound).any()):
        fail(f"{what}: max |d| {d.max().item():.3e} over the bound")
    return d.max().item()


def phase_kernels(dev, kernels):
    gen = torch.Generator(device=dev).manual_seed(0)

    def mk(c, dtype):
        return torch.randn((1, c, SLICE_HW, SLICE_HW), generator=gen,
                           device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        x, st = mk(SLICE_C, dtype), mk(2 * SLICE_C, dtype)
        z, s_raw, t, avg = (mk(SLICE_C, dtype) for _ in range(4))
        for act in CLAMP_ACTIVATIONS:
            kw = {"clamp": 2.0, "activation": act}
            for rev in (True, False):
                e = max_err(fa.cat_affine(x, st, rev=rev, **kw),
                            fa.cat_affine_reference(x, st, rev=rev, **kw),
                            dtype, f"cat_affine {dtype} {act} rev={rev}")
                kernels["cat_affine"]["max_abs_err"] = max(
                    kernels["cat_affine"].get("max_abs_err", 0.0), e)
                log(f"cat_affine {str(dtype):14s} {act:7s} rev={rev!s:5s} "
                    f"max|d| {e:.3e}")
            e = max_err(fa.haar_merge_affine(z, s_raw, t, avg, **kw),
                        fa.haar_merge_affine_reference(z, s_raw, t, avg, **kw),
                        dtype, f"haar_merge_affine {dtype} {act}")
            kernels["haar_merge_affine"]["max_abs_err"] = max(
                kernels["haar_merge_affine"].get("max_abs_err", 0.0), e)
            log(f"haar_merge_affine {str(dtype):14s} {act:7s} max|d| {e:.3e}")
        # times at the slice's shapes, ATAN (the configured clamp), rev
        kw = {"clamp": 2.0, "activation": "ATAN"}
        n = x.numel()
        times = {
            "cat_affine": (
                lambda: fa.cat_affine(x, st, rev=True, **kw),
                lambda: fa.cat_affine_reference(x, st, rev=True, **kw),
                4 * n * x.element_size()),
            "haar_merge_affine": (
                lambda: fa.haar_merge_affine(z, s_raw, t, avg, **kw),
                lambda: fa.haar_merge_affine_reference(z, s_raw, t, avg, **kw),
                6 * n * x.element_size()),
        }
        for name, (kern, plain, nbytes) in times.items():
            ms, plain_ms = time_ms(kern), time_ms(plain)
            log(f"time {name} {str(dtype):14s} kernel {ms:.4f} ms "
                f"({nbytes / ms / 1e6:.1f} GB/s)  plain {plain_ms:.4f} ms")
            if dtype == torch.bfloat16:
                kernels[name]["ms"], kernels[name]["plain_ms"] = ms, plain_ms


def phase_small_rig(dev):
    cfg, model, stats, vidx, img = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), cfg.volume_side_size,
                        cfg.volume_side_size).astype(np.float32)
              for k in range(model.n_flow_steps + 1)]
    frames = rng.rand(2, img, img).astype(np.float32) * 1000
    ref = XLFMReconstructor(model, stats, vidx, caches, device="cpu")(frames)
    got = XLFMReconstructor(model, stats, vidx, caches, device=dev)(frames)
    rel = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
    log(f"small rig f32, card vs CPU: max|d|/max|ref| {rel:.3e} "
        f"(bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"small rig card vs CPU {rel:.3e} > 1e-4")


def launch_counts():
    return {"cat_affine": fa.cat_affine.launches,
            "haar_merge_affine": fa.haar_merge_affine.launches}


def phase_flagship(dev, card, kernels):
    t0 = time.perf_counter()
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    log(f"flagship model built on the CPU in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters)")
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                              compute_dtype=torch.bfloat16)
    out_shape = (cfg.n_depths, side, side)
    frames1 = None
    fa.cat_affine.launches = fa.haar_merge_affine.launches = 0
    for batch in (1, 8):
        frames = torch.as_tensor(
            rng.rand(batch, img, img).astype(np.float32) * 1000).to(dev)
        if batch == 1:
            frames1 = frames
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = recon(frames)                                   # warm-up
        torch.cuda.synchronize()
        if tuple(out.shape) != (batch,) + out_shape:
            fail(f"flagship output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail("flagship output has non-finite values")
        ms = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = recon(frames)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        after = launch_counts()
        for name, k in KERNELS.items():
            if after[name] - before[name] != k["per_call"] * 4:
                fail(f"{name} launched {after[name] - before[name]} times "
                     f"in 4 calls, expected {k['per_call'] * 4}")
        log(f"flagship bf16 batch {batch}: out {tuple(out.shape)} finite; "
            f"{np.median(ms) / batch:.2f} ms/frame (median of {ms} ms per "
            f"call); peak memory {peak / 2**30:.2f} GiB; launches "
            f"{ {n: after[n] - before[n] for n in after} } in 4 calls; "
            f"on {card}")
        del out
    for name, n in launch_counts().items():
        kernels[name]["launches"] = n
    return model, stats, vidx, caches, frames1, recon


def phase_bf16_vs_f32(dev, model, stats, vidx, caches, frames1, recon16):
    out16 = recon16(frames1)
    recon32 = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                                compute_dtype=torch.float32)
    out32 = recon32(frames1)
    rel = ((out16 - out32).abs().max() / out32.abs().max()).item()
    log(f"flagship batch 1, bf16 vs f32: max|d|/max|f32| {rel:.3e} "
        f"(bound 5e-2)")
    if not rel <= 5e-2:
        fail(f"flagship bf16 vs f32 {rel:.3e} > 5e-2")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = fa.build_kernels()
    fa._lib()
    log(f"kernels built from cwfa_tpu_torch/csrc/*.cu with nvcc "
        f"{' '.join(fa.NVCC_FLAGS)} -> {lib.relative_to(fa.BUILD_DIR.parents[1])}"
        f" in {time.perf_counter() - t0:.1f} s")

    kernels = {name: {} for name in KERNELS}
    phase_kernels(dev, kernels)
    phase_small_rig(dev)
    state = phase_flagship(dev, card, kernels)
    phase_bf16_vs_f32(dev, *state)

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "cwfa_tpu_torch/csrc/flow_affine.cu",
         "replaces": KERNELS[name]["replaces"],
         "launches": k["launches"], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for name, k in kernels.items()]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
