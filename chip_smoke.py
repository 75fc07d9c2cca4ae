"""Smoke test of the PyTorch/CUDA port (``cwfa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cwfa_tpu_torch/csrc/``, then, failing (exit
code != 0) on the first phase that does not hold:

1. prints the card's name and power limit and the kernel build time;
2. holds each flow kernel against its plain PyTorch version on the card, at
   the main path's shapes, in f32 and bf16, for every clamp activation, and
   times both (CUDA events);
3. holds the int8 tower kernel (``fused_tower``) against its plain version
   at each flagship step's shape (B 1, 512^2, Cin 48/24/12/6, 64 wide,
   Nout 2*Cin), at step 0's shape at batch 8 and at two odd shapes, in f32
   and bf16 output; times the kernel at every batch-1 step shape and the
   plain version at step 0;
4. runs the small rig through ``XLFMReconstructor`` on the card (kernels)
   and on the CPU (plain versions), in f32, and compares; then the same in
   int8 (``use_int8`` + ``use_int8_towers``);
5. runs the flagship configuration (2160^2 frames, 29 views of 512^2,
   512x512x96 volumes, 4 CAT steps x 4 blocks, 64-wide towers, random
   weights from a seed) in bf16 at batch 1 and 8: shape, finiteness, the
   kernels' launch counts, ms per frame and peak device memory;
6. compares the flagship bf16 output with the f32 output at batch 1;
7. runs the flagship in int8 (bf16, ``use_int8`` + ``use_int8_towers``,
   calibrated on the batch) at batch 1 and 8: calibration time, shape,
   finiteness, launch counts (16 ``fused_tower`` per call), ms per frame,
   peak memory, and the int8 UNet and the 16 int8 towers timed against
   their bf16 counterparts;
8. compares the flagship int8 output with the f32 output at batch 1.

Each path is driven with every launch count set to 0 just before it and
read just after.  Prints a ``{"kernels": [...]}`` JSON line, then, as its
last line, ``{"ok": true, "device": {...}}``.  Exits non-zero without that
line when no CUDA device is present.
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
from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d
from cwfa_tpu_torch.models.cond_net import cond_networks_batched
from cwfa_tpu_torch.models.unet import unet_quantized
from cwfa_tpu_torch.nn import reset_parameters_
from cwfa_tpu_torch.ops import cuda_build
from cwfa_tpu_torch.ops import flow_affine as fa
from cwfa_tpu_torch.ops import qtower
from cwfa_tpu_torch.rig import flagship

SLICE_C, SLICE_HW = 48, 512        # step 0 of the flagship: (1, 48, 512, 512)
TOWER_CIN = (48, 24, 12, 6)        # the flagship steps' condition widths
INT8 = {"use_int8": True, "use_int8_towers": True}
FLOW_SRC = "cwfa_tpu_torch/csrc/flow_affine.cu"
KERNELS = {
    "cat_affine": {"replaces": "cwfa_tpu/ops/pallas_flow.py:138",
                   "source": FLOW_SRC, "wrapper": fa.cat_affine},
    "haar_merge_affine": {"replaces": "cwfa_tpu/ops/pallas_flow.py:118",
                          "source": FLOW_SRC, "wrapper": fa.haar_merge_affine},
    "fused_tower": {"replaces": "cwfa_tpu/ops/qtower.py:454",
                    "source": "cwfa_tpu_torch/csrc/qtower.cu",
                    "wrapper": qtower.fused_tower},
}
# launches per reconstruction call of each path
BF16_PER_CALL = {"cat_affine": 16, "haar_merge_affine": 4, "fused_tower": 0}
INT8_PER_CALL = {"cat_affine": 16, "haar_merge_affine": 4, "fused_tower": 16}


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


def rel_norm(got, ref) -> float:
    """tests/test_inference.py's norm ratio ||got - ref|| / ||ref - mean||."""
    g, r = got.double(), ref.double()
    return (torch.linalg.norm(g - r) / torch.linalg.norm(r - r.mean())).item()


def to_device(tree, dev):
    """A pack (nested dicts / lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree if tree is None else tree.to(dev)


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


def phase_tower(dev, kernels):
    """fused_tower vs quantized_tower_reference on the card: every flagship
    step shape (64 wide), step 0 at batch 8 (the int8 main path's batch),
    and two odd shapes (H, W not multiples of the 16x16 tile, batch 2; 64
    wide and the small rig's 8 wide), f32 and bf16 output; times the kernel
    at every batch-1 step shape and the plain version at step 0 (bf16
    out)."""
    gen = torch.Generator().manual_seed(1)
    shapes = [(1, cin, SLICE_HW, SLICE_HW, 64) for cin in TOWER_CIN]
    shapes += [(8, SLICE_C, SLICE_HW, SLICE_HW, 64),
               (2, 12, 37, 53, 64), (2, 4, 19, 35, 8)]
    k = kernels["fused_tower"]
    for b, cin, h, w, width in shapes:
        tower = WaveletFlowSubnet2d(cin, 2 * cin, width)
        reset_parameters_(tower, gen)
        tower = tower.to(dev).eval()
        x = torch.randn((b, cin, h, w), generator=gen).to(dev)
        scales = qtower.tower_calibrate(tower, x)
        qw = qtower.quantize_tower(tower, scales)
        xq = qtower.quantize_input(x, scales[0])
        ref = qtower.quantized_tower_reference(qw, scales, xq)
        for dtype in (torch.float32, torch.bfloat16):
            got = qtower.fused_tower(xq, qw, scales, out_dtype=dtype)
            want = ref.to(dtype)
            e = max_err(got, want, dtype,
                        f"fused_tower {(b, cin, h, w)} C {width} {dtype}")
            ndiff = int((got.float() != want.float()).sum())
            k["max_abs_err"] = max(k.get("max_abs_err", 0.0), e)
            log(f"fused_tower B{b} Cin {cin:2d} {h}x{w} C {width} "
                f"{str(dtype):14s} "
                f"max|d| {e:.3e}, {ndiff} of {got.numel()} elements differ")
        if b != 1 or h != SLICE_HW:
            continue
        ms = time_ms(lambda: qtower.fused_tower(xq, qw, scales), 20)
        ops = 2 * b * h * w * (cin * 64 + 3 * (9 * 64 * 64 + 64 * 64)
                               + 9 * 64 * 2 * cin)
        line = (f"time fused_tower (1, {cin}, {h}, {w}) bf16 out: kernel "
                f"{ms:.4f} ms ({ops / ms / 1e9:.1f} int8 TOP/s)")
        if cin == SLICE_C:                  # step 0: the plain version too
            plain_ms = time_ms(
                lambda: qtower.quantized_tower_reference(qw, scales, xq), 5)
            line += (f"  plain {plain_ms:.4f} ms "
                     f"({ops / plain_ms / 1e9:.1f} TOP/s)")
            k["ms"], k["plain_ms"] = ms, plain_ms
        log(line)


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


def small_rig_int8(dev):
    """The small rig in int8 (f32), card vs CPU.  The CPU's packs are carried
    to the card for the bound (<= 1e-3 of max|ref|); the card's own
    calibration is compared as well, with the int8 weights that differ
    between the two calibrations named."""
    cfg, model, stats, vidx, img = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), cfg.volume_side_size,
                        cfg.volume_side_size).astype(np.float32)
              for k in range(model.n_flow_steps + 1)]
    frames = rng.rand(2, img, img).astype(np.float32) * 1000
    cpu = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                            calib_frames=frames, **INT8)
    ref = cpu(frames)
    card = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                             calib_frames=frames, **INT8)
    flips = []
    for k, (a, b) in enumerate(zip(cpu.qpacks, card.qpacks)):
        for i, (pa, pb) in enumerate(zip(a, b)):
            for name, t in pa["qw"].items():
                if t.dtype != torch.int8:
                    continue
                n = int((t != pb["qw"][name].cpu()).sum())
                if n:
                    flips.append(f"step {k} block {i} {name}: {n}")
    for site, pk in cpu.unet_q["qpack"].items():
        n = int((pk["wq"] != card.unet_q["qpack"][site]["wq"].cpu()).sum())
        if n:
            flips.append(f"unet {site}: {n}")
    own = card(frames).cpu()
    card.qpacks = to_device(cpu.qpacks, dev)
    card.unet_q = to_device(cpu.unet_q, dev)
    got = card(frames).cpu()
    scale = ref.abs().max()
    rel = ((got - ref).abs().max() / scale).item()
    rel_own = ((own - ref).abs().max() / scale).item()
    log(f"small rig int8 f32, card vs CPU, CPU packs: max|d|/max|ref| "
        f"{rel:.3e} (bound 1e-3); card's own calibration: {rel_own:.3e} "
        f"(bound 5e-3); int8 weights that differ between the card's and the "
        f"CPU's calibration: {'; '.join(flips) or 'none'}")
    if not rel <= 1e-3:
        fail(f"small rig int8 card vs CPU {rel:.3e} > 1e-3")
    if not rel_own <= 5e-3:
        fail(f"small rig int8, card's own calibration, {rel_own:.3e} > 5e-3")


def launch_counts():
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def reset_counts():
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def check_counts(per_call: dict, calls: int, what: str) -> dict:
    counts = launch_counts()
    for name, n in per_call.items():
        if counts[name] != n * calls:
            fail(f"{what}: {name} launched {counts[name]} times in {calls} "
                 f"calls, expected {n * calls}")
    return counts


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
    reset_counts()
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
        for name, n in BF16_PER_CALL.items():
            if after[name] - before[name] != n * 4:
                fail(f"{name} launched {after[name] - before[name]} times "
                     f"in 4 calls, expected {n * 4}")
        log(f"flagship bf16 batch {batch}: out {tuple(out.shape)} finite; "
            f"{np.median(ms) / batch:.2f} ms/frame (median of {ms} ms per "
            f"call); peak memory {peak / 2**30:.2f} GiB; launches "
            f"{ {n: after[n] - before[n] for n in after} } in 4 calls; "
            f"on {card}")
        del out
    for name, n in launch_counts().items():
        if BF16_PER_CALL[name]:
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
    return out32


def cuda_ms(fn, iters: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of fn() after one warm-up."""
    fn()
    ms = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


def int8_layer_times(recon, frames):
    """(int8 UNet, bf16 UNet, 16 int8 towers, 16 bf16 towers) ms on the
    batch's own inputs."""
    m = recon.model
    with torch.inference_mode():
        views = recon._normalized_views(frames)
        y = m.lrnn.proj(views)
        c_views = cond_networks_batched(m.cond, views)
        uq = recon.unet_q

        def towers_int8():
            for k, packs in enumerate(recon.qpacks):
                xq = qtower.quantize_input(c_views[k], packs[0]["scales"][0])
                for pk in packs:
                    qtower.fused_tower(xq, pk["qw"], pk["scales"],
                                       out_dtype=c_views[k].dtype)

        def towers_bf16():
            for k, step in enumerate(m.flow):
                for block in step.blocks:
                    block["subnet"](c_views[k])

        return (cuda_ms(lambda: unet_quantized(m.lrnn.unet, y, uq["qpack"],
                                               uq["scales"])),
                cuda_ms(lambda: m.lrnn.unet(y)),
                cuda_ms(towers_int8), cuda_ms(towers_bf16))


def phase_flagship_int8(dev, card, kernels, model, stats, vidx, caches,
                        frames1):
    """The int8 slice at the flagship width, bf16, batch 1 (the bf16 path's
    batch-1 frames) and 8, each calibrated on its own batch
    (bench.py:99-102).  Returns the batch-1 output."""
    rng = np.random.RandomState(1)
    img = frames1.shape[-1]
    side = model.cfg.volume_side_size
    out_shape = (model.cfg.n_depths, side, side)
    out1, runs = None, []
    reset_counts()
    for batch in (1, 8):
        frames = frames1 if batch == 1 else torch.as_tensor(
            rng.rand(batch, img, img).astype(np.float32) * 1000).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                                  compute_dtype=torch.bfloat16,
                                  calib_frames=frames, **INT8)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        if (sum(pk is not None for step in recon.qpacks for pk in step)
                != INT8_PER_CALL["fused_tower"]):
            fail("flagship int8: not every coupling tower was quantized")
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = recon(frames)                                   # warm-up
        torch.cuda.synchronize()
        if tuple(out.shape) != (batch,) + out_shape:
            fail(f"flagship int8 output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail("flagship int8 output has non-finite values")
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
        for name, n in INT8_PER_CALL.items():
            if after[name] - before[name] != n * 4:
                fail(f"flagship int8: {name} launched "
                     f"{after[name] - before[name]} times in 4 calls, "
                     f"expected {n * 4}")
        log(f"flagship int8 bf16 batch {batch}: calibration + build "
            f"{calib_s:.2f} s; out {tuple(out.shape)} finite; "
            f"{np.median(ms) / batch:.2f} ms/frame (median of {ms} ms per "
            f"call); peak memory {peak / 2**30:.2f} GiB; launches "
            f"{ {n: after[n] - before[n] for n in after} } in 4 calls; "
            f"on {card}")
        if batch == 1:
            out1 = out
        runs.append((batch, recon, frames))
    kernels["fused_tower"]["launches"] = launch_counts()["fused_tower"]
    for batch, recon, frames in runs:
        uq, ub, tq, tb = int8_layer_times(recon, frames)
        log(f"flagship batch {batch} layers: UNet int8 {uq:.3f} ms vs bf16 "
            f"{ub:.3f} ms; 16 coupling towers int8 (fused_tower) {tq:.3f} ms "
            f"vs bf16 {tb:.3f} ms; on {card}")
    return out1


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
    libs = cuda_build.build_kernels()
    fa._lib()
    qtower._lib()
    root = cuda_build.BUILD_DIR.parents[1]
    names = ", ".join(str(p.relative_to(root)) for p in libs.values())
    log(f"kernels built from cwfa_tpu_torch/csrc/*.cu with nvcc "
        f"{' '.join(cuda_build.NVCC_FLAGS)} (one nvcc per source, in "
        f"parallel) -> {names} in {time.perf_counter() - t0:.1f} s")

    kernels = {name: {} for name in KERNELS}
    phase_kernels(dev, kernels)
    phase_tower(dev, kernels)
    phase_small_rig(dev)
    small_rig_int8(dev)
    model, stats, vidx, caches, frames1, recon16 = phase_flagship(
        dev, card, kernels)
    out32 = phase_bf16_vs_f32(dev, model, stats, vidx, caches, frames1,
                              recon16)
    del recon16
    out8 = phase_flagship_int8(dev, card, kernels, model, stats, vidx, caches,
                               frames1)
    rel = rel_norm(out8, out32)
    log(f"flagship batch 1, int8 (bf16) vs f32: ||d||/||f32 - mean|| "
        f"{rel:.3e} (bound 5e-2)")
    if not rel < 5e-2:
        fail(f"flagship int8 vs f32 {rel:.3e} >= 5e-2")

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name]["source"],
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
