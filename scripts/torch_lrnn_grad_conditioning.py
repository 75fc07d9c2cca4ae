"""Where the LRNN step's f32 gradients part from exact arithmetic: the
small rig's LRNN optimizer step (``CWFATrainer.lrnn_loss``, train mode,
nothing drawn) in f32 on a device against the same step in f64 on the CPU,
from one seed and one set of inputs (those of ``chip_smoke.py``'s
small-rig training check).

Prints, as shares of max|ref| over the LRNN's gradients, the error of each
parameter's gradient (the worst ones), of the gradient at each module's
output, and for the worst module the element where the two part: its
pre-activation in both precisions.  A PReLU input that lies within f32
rounding of zero takes the slope 1 in one precision and alpha in the other,
so the gradient at that one element differs by (1 - alpha) of itself and
every parameter upstream inherits the difference: the f32 gradient is not a
continuous function of the rounding there.

Usage: python3 scripts/torch_lrnn_grad_conditioning.py [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.rig import flagship


def lrnn_step(tr, inputs):
    """The LRNN step's loss, {module: (output, gradient at the output)} and
    {parameter: gradient}, all f64 on the CPU."""
    lrnn = tr.model.lrnn
    outs, hooks = {}, []
    for name, mod in lrnn.named_modules():
        if name and name.count(".") <= 3:
            def keep(mod, inp, out, name=name):
                if torch.is_tensor(out) and out.requires_grad:
                    out.retain_grad()
                    outs[name] = out
            hooks.append(mod.register_forward_hook(keep))
    for p in lrnn.parameters():
        p.grad = None
    lrnn.train()
    try:
        loss, _ = tr.lrnn_loss(*inputs, generator=None)
        loss.backward()
    finally:
        lrnn.eval()
        for h in hooks:
            h.remove()

    def f64(t):
        return t.detach().cpu().double()

    acts = {n: (f64(o), f64(o.grad)) for n, o in outs.items()
            if o.grad is not None}
    return (float(loss.detach()), acts,
            {n: f64(p.grad) for n, p in lrnn.named_parameters()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    _, model, stats, _, _ = flagship(True, "cpu",
                                     torch.Generator().manual_seed(0))
    cfg = model.cfg = dataclasses.replace(model.cfg, use_half_precision=0)
    exact = CWFATrainer(copy.deepcopy(model), stats, None, device="cpu")
    exact.model.double()
    exact.compute_dtype = torch.float64
    f32 = CWFATrainer(model, stats, None, device=args.device)
    rng = np.random.RandomState(4)
    s, b = cfg.volume_side_size, 2

    def rand(c, scale=1.0):
        return torch.as_tensor((rng.randn(b, c, s, s) * scale)
                               .astype(np.float32))

    d_lrnn = cfg.n_depths // 2 ** model.n_flow_steps
    inputs = [rand(cfg.n_lenslets), rand(d_lrnn, 0.3), rand(d_lrnn)]
    l64, a64, g64 = lrnn_step(exact, [t.double() for t in inputs])
    l32, a32, g32 = lrnn_step(f32, [t.to(args.device) for t in inputs])
    scale = max(g.abs().max().item() for g in g64.values())
    print(f"LRNN step, small rig, batch {b}, {s}^2: f32 on {args.device} "
          f"against f64 on the CPU; loss {l32:.9g} vs {l64:.9g}; max|ref| "
          f"of the gradients {scale:.4e}")
    errs = sorted(((g32[n] - g64[n]).abs().max().item() / scale, n)
                  for n in g64)
    for e, n in errs[::-1][:4]:
        print(f"  parameter {n:32s} {tuple(g64[n].shape)}: max|d| {e:.3e} "
              f"of max|ref|")
    rows = sorted((((a32[n][1] - a64[n][1]).abs().max()
                    / a64[n][1].abs().max()).item(), n)
                  for n in a64 if n in a32)
    for e, n in rows[::-1][:3]:
        print(f"  gradient at the output of {n:24s}: max|d| {e:.3e} of its "
              f"own max")
    worst = rows[-1][1]
    (o64, d64), (o32, d32) = a64[worst], a32[worst]
    diff = (d32 - d64).abs()
    at = np.unravel_index(int(diff.argmax()), diff.shape)
    big = int((diff > 1e-4 * d64.abs().max()).sum())
    print(f"  {worst} at {tuple(int(i) for i in at)}: output f64 "
          f"{o64[at].item():.4e}, f32 {o32[at].item():.4e}; gradient there "
          f"f64 {d64[at].item():.4e}, f32 {d32[at].item():.4e}; {big} of "
          f"{diff.numel()} elements differ by more than 1e-4 of the max")


if __name__ == "__main__":
    main()
