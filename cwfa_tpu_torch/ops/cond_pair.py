"""The condition nets' fused 3-D pair: the plain PyTorch version and the CUDA
kernel's wrapper (counterpart of ``cwfa_tpu/ops/cond_pair.py``; the kernel
is ``csrc/cond_pair.cu``).

Over (H, W, depth) of the cond features x (B, D, H, W):

    y = PReLU(Conv3d(1 -> K, 3x3x3)(x) + b_a)      rounded to x's dtype
    z = Conv3d(K -> 1, 3x3x3)(y) + b_b             rounded to x's dtype

with SAME (zero) padding in all three dims for both convs, one PReLU alpha,
f32 sums.  The weights are the modules' own: c3a (K, 1, 3, 3, 3) and c3b
(1, K, 3, 3, 3), whose kernel dims act on (H, W, depth) as ``nn.Conv3d``
does on the (B, 1, H, W, D) view (``_conv3d_pair_direct``,
``cwfa_tpu/models/cond_net.py:259-265``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cwfa_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cond_pair_reference(x, c3a, c3b, prelu):
    """The kernel's math in plain PyTorch: two f32 ``conv3d`` on the
    (B, 1, H, W, D) view, y rounded to x's dtype in between.  Returns
    (B, D, H, W) in x's dtype, contiguous."""
    v = x.float().permute(0, 2, 3, 1).unsqueeze(1)
    y = F.conv3d(v, c3a.weight.float(), c3a.bias.float(), padding=1)
    y = F.prelu(y, prelu.weight.float()).to(x.dtype).float()
    z = F.conv3d(y, c3b.weight.float(), c3b.bias.float(), padding=1)
    return z[:, 0].permute(0, 3, 1, 2).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("cond_pair")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cwfa_cond_pair.argtypes = [p] * 7 + [i32] * 7 + [p]
    lib.cwfa_cond_pair.restype = i32
    return lib


def _check(x, c3a, c3b, prelu) -> int:
    if x.dim() != 4 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError("x must be a contiguous non-empty (B, D, H, W) "
                         f"tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x.device}")
    k = c3a.weight.shape[0]
    want = {"c3a.weight": (c3a.weight, (k, 1, 3, 3, 3)),
            "c3a.bias": (c3a.bias, (k,)),
            "c3b.weight": (c3b.weight, (1, k, 3, 3, 3)),
            "c3b.bias": (c3b.bias, (1,)),
            "prelu.weight": (prelu.weight, (1,))}
    for name, (t, shape) in want.items():
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape "
                             f"{None if t is None else tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise TypeError(f"{name} is {t.dtype} on {t.device}; x is "
                            f"{x.dtype} on {x.device} (contiguous weights of "
                            "x's dtype and device)")
    return k


def cond_pair(x, c3a, c3b, prelu):
    """Conv3d(1->K) -> PReLU -> Conv3d(K->1) over (H, W, depth) of x
    (``cond_pair_fused``, ``cwfa_tpu/ops/cond_pair.py:276``).

    x: (B, D, H, W), contiguous, f32 or bf16; c3a, c3b: the ``nn.Conv3d``
    modules (with biases), prelu: the ``nn.PReLU(1)``, all of x's dtype and
    device.  Returns z (B, D, H, W) in x's dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    k = _check(x, c3a, c3b, prelu)
    if x.device.type == "cpu":
        return cond_pair_reference(x, c3a, c3b, prelu)
    b, d, h, w = x.shape
    z = torch.empty_like(x)
    rc = _lib().cwfa_cond_pair(
        x.data_ptr(), c3a.weight.data_ptr(), c3a.bias.data_ptr(),
        c3b.weight.data_ptr(), c3b.bias.data_ptr(), prelu.weight.data_ptr(),
        z.data_ptr(), b, d, h, w, k, _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, "cond_pair")
    cond_pair.launches += 1
    return z


cond_pair.launches = 0
