"""Where the time goes in the PyTorch port's reconstruction slice, in its
exact-likelihood path, or in a training step, on one GPU.

    python3 scripts/profile_torch_port.py [--batch 8] [--int8 | --nll
                                           | --stochastic | --train]

Builds the flagship rig (``cwfa_tpu_torch.rig.flagship``, random weights
from seed 0) as a deterministic bf16 ``XLFMReconstructor`` — with
``--int8``, the int8 configuration (``use_int8`` + ``use_int8_towers``,
calibrated on the batch); with ``--stochastic``, the reconstructor's
default mode (the LRNN in train mode, its mean branch computed per call) —
and prints:

- the whole call's time (CUDA events, median of 5 after a warm-up);
- each component run alone on the same inputs, with CUDA events: view
  extraction, LRNN, the cond nets (and their 3-D pairs alone, through
  ``cond_pair``), the 20 subnet towers (``fused_float_tower``, or
  ``fused_tower`` for the int8 coupling towers), the 20 flow-kernel
  launches and the 16 inverse permutations, with its share of the whole
  call;
- one call under ``torch.profiler``: device time by kernel and the device's
  idle share of the call's wall time.

With ``--nll`` the call is ``PyramidScorer`` (f32 volumes -> per-frame NLLs of
every step) on the same rig, and the components are the 20 towers (the f32
instance of ``fused_float_tower`` on the zero views condition), the 16
forward ``cat_affine`` launches, the 20 permutations, the four Haar splits,
and the reductions (16 log-det sums of the clamped s, four priors) with the
four input blocks' plain affines.

With ``--train`` the call is one flow optimizer step of each stage
(``CWFATrainer._flow_step``, steps 3 .. 0, bf16, batch 1 whatever
``--batch`` says, random inputs from seed 0): the step's time (CUDA events,
median of 5 after a warm-up) and one step under ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cwfa_tpu_torch.data.views import extract_views
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.ood import PyramidScorer
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.flow.coupling import clamp_fn
from cwfa_tpu_torch.flow.haar import haar1d_split
from cwfa_tpu_torch.models.cond_net import cond_networks_batched
from cwfa_tpu_torch.ops import qtower
from cwfa_tpu_torch.ops.cond_pair import cond_pair
from cwfa_tpu_torch.ops.flow_affine import cat_affine, haar_merge_affine
from cwfa_tpu_torch.rig import flagship
from cwfa_tpu_torch.roofline import card_line


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


def print_parts(parts: dict, whole: float):
    for name, fn in parts.items():
        ms = cuda_ms(fn)
        print(f"{name:22s} {ms:9.3f} ms  {100 * ms / whole:5.1f}%")


def profile_call(fn):
    """One call of ``fn`` under ``torch.profiler``: the device's idle share
    of the wall time and the device time by kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def profile_nll(model, stats, batch: int, dev):
    """The exact-likelihood path: ``PyramidScorer`` on random f16 volumes."""
    cfg = model.cfg
    m = model.to(dev).eval()
    side = cfg.volume_side_size
    rng = np.random.RandomState(0)
    vols = torch.as_tensor((rng.rand(batch, cfg.n_depths, side, side) * 20)
                           .astype(np.float16)).to(dev)
    scorer = PyramidScorer(m, stats, device=dev, batch_size=batch,
                           generator=torch.Generator(device=dev).manual_seed(0))
    whole = cuda_ms(lambda: scorer(vols))
    print(f"batch {batch} nll f32: whole call {whole:.2f} ms = "
          f"{whole / batch:.2f} ms/frame")
    with torch.inference_mode():
        levels = scorer(vols)[1]                   # the pyramid volumes
        zeros = [torch.zeros_like(levels[k + 1]) for k in range(len(m.flow))]
        sts = [m.flow[k].blocks[0]["subnet"](zeros[k])
               for k in range(len(m.flow))]

        def towers():
            for k, step in enumerate(m.flow):
                for blk in step.blocks:
                    blk["subnet"](zeros[k])
                step.input_block["subnet"].tower(zeros[k])

        def affines():
            for k, step in enumerate(m.flow):
                kw = {"clamp": step.spec.clamp,
                      "activation": step.spec.clamp_activation}
                for _ in step.blocks:
                    cat_affine(zeros[k], sts[k], rev=False, **kw)

        def perms():
            for k, step in enumerate(m.flow):
                for i in range(len(step.spec.perms)):
                    step._perm(i, zeros[k], inverse=False)

        def haar():
            for k in range(len(m.flow)):
                haar1d_split(levels[k])

        def reductions():
            for k, step in enumerate(m.flow):
                spec = step.spec
                n = spec.c_flow
                fcl = clamp_fn(spec.clamp_activation)
                for _ in step.blocks:
                    (spec.clamp * fcl(sts[k][:, :n].float())).sum(dim=(1, 2, 3))
                (zeros[k].float() ** 2).sum(dim=(1, 2, 3))
                # the input block's affine and log-det, in plain torch
                s = spec.clamp * fcl(sts[k][:, :n].float())
                s.sum(dim=(1, 2, 3))
                torch.exp(s) * zeros[k] + sts[k][:, n:]

        def normalize():
            v = (vols.float() - stats.mean_vols) / stats.std_vols
            return v + 0.001 * torch.randn(v.shape, device=dev)

        print_parts({
            "normalize + noise": normalize,
            "towers (20, f32)": towers,
            "cat_affine fwd (16)": affines,
            "permutations (20)": perms,
            "haar splits (4)": haar,
            "reductions + input affines": reductions,
        }, whole)
    profile_call(lambda: scorer(vols))


def profile_train(model, stats, dev):
    """Training: one flow optimizer step of each stage, batch 1, the
    model's compute dtype (bf16 for the flagship), inputs of the step's
    shapes from seed 0."""
    cfg = model.cfg
    tr = CWFATrainer(model, stats, None, device=dev)
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size

    def rand(c, scale=1.0):
        return torch.as_tensor((rng.randn(1, c, side, side) * scale)
                               .astype(np.float32)).to(dev)

    for k in reversed(range(model.n_flow_steps)):
        spec = model.step_specs[k]
        inputs = [rand(cfg.n_lenslets), rand(spec.c_flow, 0.3),
                  rand(spec.d_in), rand(spec.c_flow)]

        def step():
            tr._flow_step(k, *inputs)

        print(f"flow step {k} (c_flow {spec.c_flow}, batch 1, "
              f"{tr.compute_dtype}): {cuda_ms(step):.3f} ms per optimizer "
              f"step")
        profile_call(step)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--int8", action="store_true")
    mode.add_argument("--nll", action="store_true")
    mode.add_argument("--stochastic", action="store_true")
    mode.add_argument("--train", action="store_true")
    args = ap.parse_args()
    batch = args.batch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    print(card_line())
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    if args.nll:
        return profile_nll(model, stats, batch, dev)
    if args.train:
        return profile_train(model, stats, dev)
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    frames = torch.as_tensor(
        rng.rand(batch, img, img).astype(np.float32) * 1000).to(dev)
    int8 = ({"use_int8": True, "use_int8_towers": True,
             "calib_frames": frames} if args.int8 else {})
    recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                              deterministic=not args.stochastic,
                              compute_dtype=torch.bfloat16, **int8)
    m = recon.model
    lrnn_kw = {"mean_branch": recon.mean_branch, "unet_q": recon.unet_q}
    if args.stochastic:
        mean_vol = recon.mean_caches[m.n_flow_steps - 1]
        lrnn_kw = {"mean_vol": mean_vol.expand((batch,) + mean_vol.shape[1:]),
                   "train": True, "generator": recon.generator}
    qpacks = recon.qpacks or [None] * m.n_flow_steps

    whole = cuda_ms(lambda: recon(frames))
    print(f"batch {batch}{' int8' if args.int8 else ''}: whole call "
          f"{whole:.2f} ms = {whole / batch:.2f} ms/frame")

    with torch.inference_mode():
        views_n = ((extract_views(frames, vidx) - stats.mean_imgs)
                   / stats.std_imgs).to(torch.bfloat16)
        cv = cond_networks_batched(m.cond, views_n)
        ups = {}
        up = m.lrnn(views_n, **lrnn_kw)
        for k in range(m.n_flow_steps - 1, -1, -1):
            ups[k] = up
            spec = m.step_specs[k]
            z = torch.zeros((batch, spec.c_flow, side, side),
                            dtype=up.dtype, device=dev)
            up = m.flow[k].reverse_fast(z, up, cv[k], recon.mean_caches[k],
                                        qpack=qpacks[k])

        def pair3d():
            # the 3-D pairs as the path runs them, on their 2-D stacks'
            # outputs (the same shape and dtype as cv)
            for net, c in zip(m.cond, cv):
                cond_pair(c, net.c3a, net.c3b, net.prelu)

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
                    step._perm(i, ups[k], inverse=True)

        parts = {
            "views+normalize": lambda: ((extract_views(frames, vidx)
                                         - stats.mean_imgs) / stats.std_imgs
                                        ).to(torch.bfloat16),
            "lrnn (proj+unet)" + (" + mean branch" if args.stochastic else ""):
                lambda: m.lrnn(views_n, **lrnn_kw),
            "cond nets (all)": lambda: cond_networks_batched(m.cond, views_n),
            "  of which 3-D pairs": pair3d,
            "towers (20)": towers,
            "flow kernels (20)": kernels,
            "inverse perms": perms,
        }
        print_parts(parts, whole)

    profile_call(lambda: recon(frames))


if __name__ == "__main__":
    main()
