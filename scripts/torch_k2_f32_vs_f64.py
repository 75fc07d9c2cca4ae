"""The float tower's backward in f32 on the card against the f64 gradient
(``btower.float_tower_backward_f64``): K2 (``btower.float_tower_backward``,
the instance that ``bwd_instance`` picks) and the plain f32 backward
(``btower.float_tower_backward_reference``, cuDNN f32 convs with TF32 off),
each gradient's max|d| as a share of max|f64|.  Says which of the two sits
farther from the exact gradient where they differ.

    python3 scripts/torch_k2_f32_vs_f64.py [--cin 65] [--nout 48] [--side 512]

Needs a CUDA card; prints the card's name first."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d  # noqa: E402
from cwfa_tpu_torch.ops import btower  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cin", type=int, default=65)
    ap.add_argument("--nout", type=int, default=48)
    ap.add_argument("--side", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(a.seed)
    tower = WaveletFlowSubnet2d(a.cin, a.nout, 64)
    with torch.no_grad():
        for p in tower.parameters():
            fan = p[0].numel() if p.dim() > 1 else 16
            p.copy_(torch.randn(p.shape, generator=gen) / fan ** 0.5)
    tower = tower.to(dev)
    x = torch.randn((1, a.cin, a.side, a.side), generator=gen).to(dev)
    dy = torch.randn((1, a.nout, a.side, a.side), generator=gen).to(dev)

    def flat(g):
        return [g[0]] + [t for pair in zip(g[1], g[2]) for t in pair]

    kernel = flat(btower.float_tower_backward(tower, x, dy))
    plain = flat(btower.float_tower_backward_reference(tower, x, dy))
    exact = flat(btower.float_tower_backward_f64(tower, x, dy))
    torch.cuda.synchronize()
    names = ["dx"] + [f"{k} {n}" for n in btower.CONVS for k in ("dW", "db")]
    print(torch.cuda.get_device_name(0))
    print(f"(1, {a.cin}, {a.side}, {a.side}) -> {a.nout}, f32; max|d| / "
          f"max|f64| of K2 ({btower.bwd_instance(torch.float32, 64, a.cin, a.nout)})"
          f" and of the plain backward")
    for name, k, p, e in zip(names, kernel, plain, exact):
        s = e.abs().max().item()
        print(f"{name:8s} K2 {(k.double() - e).abs().max().item() / s:.3e}  "
              f"plain {(p.double() - e).abs().max().item() / s:.3e}  "
              f"K2 - plain {(k.double() - p.double()).abs().max().item() / s:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
