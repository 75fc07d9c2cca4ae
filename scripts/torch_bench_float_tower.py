"""The float tower kernel's instances and the bf16 GEMM probe on the card:
each against its plain version, then timed.

    python3 scripts/torch_bench_float_tower.py [--quick] [--gemm] [--tower]

For every flagship tower shape (batch 1, 512 x 512, 64 wide, Cin 48/24/12/6,
coupling Nout = 2 Cin and input Nout = Cin) in bf16 (wgmma) and f32 (wgmma,
3xTF32): max|kernel - plain| / max|plain| and the kernel's time; at step 0
also the plain version's time.  ``--quick`` checks two small odd shapes and
step 0 only.  ``--gemm`` runs the bf16 ``tiled_gemm`` at M 2^20, K 1152,
N 128 / 256 / 512 beside ``torch.matmul`` and its bound (the larger of its
bytes over the memory rate and its operations over the bf16 peak).  Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d  # noqa: E402
from cwfa_tpu_torch.nn import reset_parameters_  # noqa: E402
from cwfa_tpu_torch.ops import btower, cuda_build, probes  # noqa: E402
from cwfa_tpu_torch.roofline import bound_ms, card_line, time_ms  # noqa: E402


def tower_case(dev, gen, b, cin, h, w, width, nout, dtype, timed):
    tower = WaveletFlowSubnet2d(cin, nout, width)
    reset_parameters_(tower, gen)
    tower = tower.to(dev, dtype).eval()
    x = torch.randn((b, cin, h, w), generator=gen).to(dev, dtype)
    with torch.inference_mode():
        got = btower.fused_float_tower(x, tower).float()
        torch.cuda.synchronize()
        want = btower.float_tower_reference(tower, x).to(dtype).float()
        err = (got - want).abs().max().item() / want.abs().max().item()
        finite = bool(torch.isfinite(got).all())
        line = (f"{btower.kernel_instance(dtype, width, cin, nout):13s} "
                f"B{b} Cin {cin:2d} {h}x{w} C {width} Nout {nout:2d}: "
                f"max|d|/max|ref| {err:.3e} finite {finite}")
        if timed:
            ms = time_ms(lambda: btower.fused_float_tower(x, tower), 20)
            flop = 2 * b * h * w * (cin * width + 30 * width * width
                                    + 9 * width * nout)
            line += f"  {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s useful)"
            if cin == 48 and nout == 96:
                plain = time_ms(lambda: btower.float_tower_reference(tower, x), 5)
                line += f"  plain {plain:.4f} ms"
    print(line, flush=True)
    return err


def gemm_cases(dev, gen):
    m, k = 1 << 20, 1152
    for n in (128, 256, 512):
        a = (torch.randn((m, k), device=dev, generator=gen) * 0.5).bfloat16()
        b = (torch.randn((k, n), device=dev, generator=gen) * 0.5).bfloat16()
        got = probes.tiled_gemm(a, b).float()
        want = probes.tiled_gemm_reference(a, b).float()
        err = (got - want).abs().max().item() / want.abs().max().item()
        del got, want
        ms = time_ms(lambda: probes.tiled_gemm(a, b), 10)
        lib = time_ms(lambda: torch.matmul(a, b), 10)
        flop = 2 * m * k * n
        bound, by = bound_ms(2 * (m * k + k * n + m * n), flop, "bf16")
        print(f"tiled_gemm bf16 ({m}, {k}, {n}): max|d|/max|ref| {err:.3e}  "
              f"{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s)  torch.matmul "
              f"{lib:.4f} ms ({flop / lib / 1e9:.1f} TFLOP/s)  bound "
              f"{bound:.4f} ms by {by}", flush=True)
        del a, b
    for m, k, n in ((37, 20, 5), (129, 100, 130), (300, 1153, 136)):
        a = torch.randn((m, k), device=dev, generator=gen).bfloat16()
        b = torch.randn((k, n), device=dev, generator=gen).bfloat16()
        got = probes.tiled_gemm(a, b).float()
        want = probes.tiled_gemm_reference(a, b).float()
        err = (got - want).abs().max().item() / want.abs().max().item()
        print(f"tiled_gemm bf16 ({m}, {k}, {n}): max|d|/max|ref| {err:.3e}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--gemm", action="store_true")
    ap.add_argument("--tower", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    cuda_build.build_kernels()
    dev = torch.device("cuda", 0)
    if args.gemm:
        gemm_cases(dev, torch.Generator(device=dev).manual_seed(0))
    if args.tower or not args.gemm:
        gen = torch.Generator().manual_seed(3)
        shapes = [(2, 12, 37, 53, 64, 24, False), (1, 48, 64, 64, 64, 96, False),
                  (1, 48, 512, 512, 64, 96, True)]
        if not args.quick:
            shapes += [(1, cin, 512, 512, 64, nout, True)
                       for cin in (48, 24, 12, 6) for nout in (2 * cin, cin)
                       if (cin, nout) != (48, 96)]
            shapes += [(8, 48, 512, 512, 64, 96, True)]
        for *shape, timed in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                tower_case(dev, gen, *shape, dtype, timed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
