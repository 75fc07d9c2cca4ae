"""The condition nets' fused 3-D pair: the plain PyTorch version and the CUDA
kernel's wrapper (counterpart of ``cwfa_tpu/ops/cond_pair.py``; the kernel
is ``csrc/cond_pair.cu``).

Over (H, W, depth) of the cond features x (B, D, H, W):

    y = PReLU(Conv3d(1 -> K, 3x3x3)(x) + b_a)      rounded to x's dtype
    y = y * scale[b, k]                            (training) rounded
    z = Conv3d(K -> 1, 3x3x3)(y) + b_b             rounded to x's dtype

with SAME (zero) padding in all three dims for both convs, one PReLU alpha,
f32 sums.  The weights are the modules' own: c3a (K, 1, 3, 3, 3) and c3b
(1, K, 3, 3, 3), whose kernel dims act on (H, W, depth) as ``nn.Conv3d``
does on the (B, 1, H, W, D) view (``_conv3d_pair_direct``,
``cwfa_tpu/models/cond_net.py:259-265``).

The kernel has three instances (``kernel_instance``): K = 32 runs both
convs as products on the tensor cores, bf16 or, for f32, as 3xTF32 (every
operand split into a TF32 high part and the remainder; ``pair_plan`` gives
its depth chunk), and z as the shift-and-add of conv_b's 27 per-tap planes
(``cond_pair_products`` is that form in plain PyTorch); another K runs on
the CUDA cores.  ``cond_pair_f64`` is the exact pair in f64 that the f32
instances are held to.

``scale`` is the Dropout3d of training (``cond_net.py:259-265``): a (B, K)
f32 scale of the intermediate channels, 0 or 1/keep; None (inference)
multiplies nothing.  The weights may be f32 master weights under a bf16 x
(training): they then run rounded to bf16.  ``CondPairFn`` differentiates
the pair; its backward is a kernel too (``cond_pair_backward``,
``csrc/cond_pair_bwd.cu``; the TPU kernel has none, JAX trains through its
XLA convs), with the forward's three instances (``bwd_instance``; their
arithmetic in plain PyTorch ``cond_pair_backward_products``).
``cond_pair_backward_f64`` is the exact gradient, f64 autograd, that the
f32 instances are held to.  The f32 tensor-core instances of both compute
pre alike (``pre_products``), so they take PReLU's branch at the same
voxels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cwfa_tpu_torch.ops import cuda_build
from cwfa_tpu_torch.ops.btower import round_through, tf32x3
from cwfa_tpu_torch.utils.profiling import check_kernel_outputs

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORES, CUDA_CORES = "tensor cores", "CUDA cores"
TENSOR_CORES_TF32 = "tensor cores 3xTF32"   # f32 with K = 32
_INSTANCE_IDS = {CUDA_CORES: 0, TENSOR_CORES: 1, TENSOR_CORES_TF32: 2}
TENSOR_CORE_K = 32                     # the K of the tensor-core instances
KINK = 2.0 ** -16                      # a pre this close to 0 is summed again
SMEM_MAX = 232448                      # bytes of shared memory a block may use
SM_SMEM = 233472                       # ... an SM holds (a block reserves 1 KB)
TF32_MAX_TD = 24                       # depths a block of the f32 instance
# floats of the f32 instance's shared memory: the 27 contribution planes
# (356 floats each) and the split B fragments of both weights (16 KB), then
# per depth of its x window 12 x 36
_TF32_FIXED, _X_PLANE = 27 * 356 + 2 * 16 * 32 * 4, 12 * 36


def kernel_instance(dtype, k: int) -> str:
    """Which instance of the kernel runs a pair with ``k`` intermediate
    channels in ``dtype``: K = 32 on the tensor cores (bf16, or f32 as
    3xTF32), any other K on the CUDA cores."""
    if k != TENSOR_CORE_K:
        return CUDA_CORES
    return TENSOR_CORES if dtype == torch.bfloat16 else TENSOR_CORES_TF32


def bwd_instance(dtype, k: int) -> str:
    """Which instance of the backward kernel runs a pair with ``k``
    intermediate channels in ``dtype``: the forward's."""
    return kernel_instance(dtype, k)


def pair_plan(dtype, k: int, d: int, instance=None) -> dict:
    """How ``cond_pair`` runs a pair of depth ``d`` on a card: the instance
    (``kernel_instance``, or ``instance`` where one is asked for) and, for
    the f32 tensor-core instance, its depth chunk ``td`` (at most
    ``TF32_MAX_TD`` depths, the chunks as even as they come), ``nchunks`` and
    the block's shared memory in bytes as ``csrc/cond_pair.cu``
    ``launch_tf32`` computes it (the launch only checks that it fits)."""
    plan = {"instance": instance or kernel_instance(dtype, k)}
    if plan["instance"] == TENSOR_CORES_TF32:
        n = -(-d // TF32_MAX_TD)
        td = -(-d // n)
        plan.update(td=td, nchunks=n, smem=(_TF32_FIXED + (td + 4) * _X_PLANE)
                    * 4)
    return plan


def _pair_math(x, wa, ba, wb, bb, alpha, scale=None):
    dt = x.dtype

    def q(t):                   # a weight as the kernel reads it
        return t.to(dt).float()

    v = x.float().permute(0, 2, 3, 1).unsqueeze(1)
    y = F.conv3d(v, q(wa), q(ba), padding=1)
    y = round_through(F.prelu(y, q(alpha)), dt)
    if scale is not None:
        y = round_through(y * scale[:, :, None, None, None], dt)
    z = F.conv3d(y, q(wb), q(bb), padding=1)
    return z[:, 0].permute(0, 3, 1, 2).to(dt).contiguous()


def _pair_params(c3a, c3b, prelu):
    return c3a.weight, c3a.bias, c3b.weight, c3b.bias, prelu.weight


def cond_pair_reference(x, c3a, c3b, prelu, scale=None):
    """The kernel's math in plain PyTorch: two f32 ``conv3d`` on the
    (B, 1, H, W, D) view with weights rounded to x's dtype, y rounded to
    x's dtype in between (and again after the scale, where there is one).
    Returns (B, D, H, W) in x's dtype, contiguous."""
    return _pair_math(x, *_pair_params(c3a, c3b, prelu), scale)


def cond_pair_backward_reference(x, dz, c3a, c3b, prelu, scale=None):
    """(dx, dW_a, db_a, dW_b, db_b, dalpha) of ``cond_pair_reference`` for
    the output gradient dz: autograd through the plain version; dx in x's
    dtype, the rest f32 in the parameters' shapes."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        ps = [t.detach().float().requires_grad_()
              for t in _pair_params(c3a, c3b, prelu)]
        z = _pair_math(xr, *ps, scale)
        return torch.autograd.grad(z, [xr] + ps, dz)


def _taps_view(v):
    """(B, 1, H, W, D) -> the 27 zero-padded shifts of v in tap order (the
    weights' (kh, kw, kd) order), each (B, 1, H, W, D)."""
    _, _, h, w, d = v.shape
    vp = F.pad(v, (1, 1, 1, 1, 1, 1))
    return [vp[..., i:i + h, j:j + w, l:l + d]
            for i in range(3) for j in range(3) for l in range(3)]


def pre_f32_taps(x, wa, ba):
    """pre = Conv3d(1 -> K)(x) + b_a in f32 as the f32 kernels sum it: the
    27 products in tap order with fused multiply-adds (exact here: the
    product and the add in f64, rounded once to f32), then the bias.
    x: (B, D, H, W) f32; wa (K, 1, 3, 3, 3), ba (K,).  Returns (B, K, H, W,
    D) f32."""
    v = x.float().permute(0, 2, 3, 1).unsqueeze(1).double()
    w = wa.detach().float().reshape(-1, 27).double()
    s = torch.zeros((v.shape[0], w.shape[0]) + v.shape[2:], dtype=torch.float32,
                    device=x.device)
    for t, shifted in enumerate(_taps_view(v)):
        s = (w[:, t, None, None, None] * shifted + s.double()).float()
    return s + ba.detach().float()[:, None, None, None]


def pre_products(x, wa, ba):
    """pre = Conv3d(1 -> K)(x) + b_a as the f32 tensor-core instances,
    forward and backward, compute it: the product as 3xTF32
    (``btower.tf32x3``, both operands split as the kernels split them in
    registers), and a pre within ``KINK`` of 0 summed again in tap order
    (``pre_f32_taps``).  x: (B, D, H, W) f32; wa (K, 1, 3, 3, 3), ba (K,).
    Returns (B, K, H, W, D) f32."""
    v = x.float().permute(0, 2, 3, 1).unsqueeze(1)
    pre = tf32x3(lambda a, w: F.conv3d(a, w, padding=1), v,
                 wa.detach().float()) + ba.detach().float()[:, None, None, None]
    return torch.where(pre.abs() < KINK, pre_f32_taps(x, wa, ba), pre)


def _pair_f64(x, wa, ba, wb, bb, alpha, pos, scale):
    """z of the pair in f64 on f64 arguments, PReLU's branch from ``pos``."""
    pre = F.conv3d(x.permute(0, 2, 3, 1).unsqueeze(1), wa, ba, padding=1)
    y = torch.where(pos, pre, alpha * pre)
    if scale is not None:
        y = y * scale.double()[:, :, None, None, None]
    return F.conv3d(y, wb, bb, padding=1)[:, 0].permute(0, 3, 1, 2)


def cond_pair_f64(x, c3a, c3b, prelu, scale=None):
    """The f32 pair's function in f64: the weights' f32 values, nothing
    rounded, PReLU's branch at each voxel and channel where the f32 kernels
    take it (``pre_f32_taps`` > 0; f64 can put a pre within f32 rounding of
    0 on the other side).  What the f32 instances of ``cond_pair`` are held
    to; (B, D, H, W) f64."""
    pos = pre_f32_taps(x, c3a.weight, c3a.bias) > 0
    params = [t.detach().double() for t in _pair_params(c3a, c3b, prelu)]
    return _pair_f64(x.double(), *params, pos, scale).contiguous()


def cond_pair_backward_f64(x, dz, c3a, c3b, prelu, scale=None):
    """(dx, dW_a, db_a, dW_b, db_b, dalpha) of the f32 pair's function for
    the output gradient dz, f64 autograd: the weights' f32 values, nothing
    rounded, PReLU's branch at each voxel and channel where the f32 forward
    takes it (``pre_f32_taps`` > 0): a pre within f32 rounding of 0 can land
    on the other side in f64, and its slope then differs by 1 - alpha.
    What the f32 instances of ``cond_pair_backward`` are held to; f64
    results in the parameters' shapes."""
    pos = pre_f32_taps(x, c3a.weight, c3a.bias) > 0
    with torch.enable_grad():
        xr = x.detach().double().requires_grad_()
        params = [t.detach().double().requires_grad_()
                  for t in _pair_params(c3a, c3b, prelu)]
        z = _pair_f64(xr, *params, pos, scale)
        return torch.autograd.grad(z, [xr, *params], dz.double())


def cond_pair_products(x, c3a, c3b, prelu, scale=None):
    """The pair as the tensor-core instances compute it, in plain PyTorch:
    conv_a as (positions x 27 taps) . (27 x K) on the 3x3x3 neighbourhoods of
    the zero-padded x; conv_b as (positions x K) . (K x 27), every y
    position's contribution to each of its 27 neighbours; z as the
    shift-and-add of those 27 planes.  y is zero outside the volume.  bf16:
    bf16 operands, f32 sums, y rounded (and again after the scale); f32:
    both products as 3xTF32, pre as ``pre_products`` gives it (the kink
    rule), nothing rounded.  Same arguments and result as
    ``cond_pair_reference``."""
    b, d, h, w = x.shape
    k = c3a.weight.shape[0]
    f32 = x.dtype == torch.float32
    taps = [(i, j, l) for i in range(3) for j in range(3) for l in range(3)]
    if f32:
        y = pre_products(x, c3a.weight, c3a.bias).permute(0, 2, 3, 4, 1)
    else:
        v = x.float().permute(0, 2, 3, 1)                   # (B, H, W, D)
        xp = F.pad(v, (1, 1, 1, 1, 1, 1))
        cols = torch.stack([xp[:, i:i + h, j:j + w, l:l + d]
                            for i, j, l in taps], dim=-1)   # (B, H, W, D, 27)
        y = cols @ c3a.weight.float().reshape(k, 27).t() + c3a.bias.float()
    y = F.prelu(y, prelu.weight.float()).to(x.dtype).float()
    if scale is not None:                                   # (B, H, W, D, K)
        y = (y * scale[:, None, None, None, :]).to(x.dtype).float()
    wb = c3b.weight.float().reshape(k, 27)
    planes = tf32x3(torch.matmul, y, wb) if f32 else y @ wb  # (B, H, W, D, 27)
    pp = F.pad(planes, (0, 0, 1, 1, 1, 1, 1, 1))
    # tap (i, j, l) of the plane of y at (h + i - 1, w + j - 1, d + l - 1)
    z = sum(pp[:, i:i + h, j:j + w, l:l + d, t]
            for t, (i, j, l) in enumerate(taps)) + c3b.bias.float()
    return z.permute(0, 3, 1, 2).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("cond_pair")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cwfa_cond_pair.argtypes = [p] * 8 + [i32] * 9 + [p]
    lib.cwfa_cond_pair.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = cuda_build.load("cond_pair_bwd")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cwfa_cond_pair_bwd.argtypes = [p] * 10 + [i32] * 8 + [p]
    lib.cwfa_cond_pair_bwd.restype = i32
    lib.cwfa_cond_pair_bwd_part.argtypes = [i32] * 5
    lib.cwfa_cond_pair_bwd_part.restype = ctypes.c_int64
    return lib


def _check(x, c3a, c3b, prelu, scale=None) -> int:
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
        if (t.dtype not in (x.dtype, torch.float32) or t.device != x.device
                or not t.is_contiguous()):
            raise TypeError(f"{name} is {t.dtype} on {t.device}; x is "
                            f"{x.dtype} on {x.device} (contiguous weights of "
                            "x's dtype or f32, on x's device)")
    if scale is not None and (tuple(scale.shape) != (x.shape[0], k)
                              or scale.dtype != torch.float32
                              or scale.device != x.device
                              or not scale.is_contiguous()):
        raise ValueError(f"scale is {tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device}; expected a contiguous "
                         f"{(x.shape[0], k)} float32 on {x.device}")
    return k


def _kernel_params(x, c3a, c3b, prelu):
    """The five parameters in x's dtype, contiguous (no copy when they are
    already)."""
    return [t.detach().to(x.dtype).contiguous()
            for t in _pair_params(c3a, c3b, prelu)]


def cond_pair(x, c3a, c3b, prelu, *, scale=None, instance=None):
    """Conv3d(1->K) -> PReLU -> Conv3d(K->1) over (H, W, depth) of x
    (``cond_pair_fused``, ``cwfa_tpu/ops/cond_pair.py:276``).

    x: (B, D, H, W), contiguous, f32 or bf16; c3a, c3b: the ``nn.Conv3d``
    modules (with biases), prelu: the ``nn.PReLU(1)``, of x's dtype or f32,
    on x's device; scale: None or the (B, K) f32 Dropout3d scale.  Returns z
    (B, D, H, W) in x's dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.  instance: ``CUDA_CORES`` runs that instance where
    ``kernel_instance`` would pick a tensor-core one (to time the two side
    by side).  Counts every launch, and per instance in
    ``cond_pair.by_instance``."""
    k = _check(x, c3a, c3b, prelu, scale)
    if instance not in (None, CUDA_CORES):
        raise ValueError(f"instance {instance!r}: None or {CUDA_CORES!r}")
    if x.device.type == "cpu":
        return cond_pair_reference(x, c3a, c3b, prelu, scale)
    b, d, h, w = x.shape
    plan = pair_plan(x.dtype, k, d, instance)
    instance = plan["instance"]
    z = torch.empty_like(x)
    params = _kernel_params(x, c3a, c3b, prelu)
    rc = _lib().cwfa_cond_pair(
        x.data_ptr(), *[t.data_ptr() for t in params],
        None if scale is None else scale.data_ptr(),
        z.data_ptr(), b, d, h, w, k, _DTYPES[x.dtype],
        _INSTANCE_IDS[instance], plan.get("td", 0), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, f"cond_pair ({instance})")
    cond_pair.launches += 1
    cond_pair.by_instance[instance] += 1
    return check_kernel_outputs("cond_pair", z)


cond_pair.launches = 0                      # every launch of the kernel
cond_pair.by_instance = dict.fromkeys(_INSTANCE_IDS, 0)   # ... per instance


def cond_pair_backward_products(x, dz, c3a, c3b, prelu, scale=None):
    """The tensor-core instances' arithmetic in plain PyTorch.  bf16 (x, dz
    bf16): pre and dy = conv_b^T(dz) from bf16 operands with f32 sums; y
    rounded as the forward rounds it; dpre = dy m PReLU'(pre) in f32,
    rounded to bf16 once as the operand of dx's and dW_a's products; db_a
    and dalpha from the f32 values.  f32: nothing rounded, every product
    (pre, dy, dx, dW_a, dW_b) as 3xTF32 (``btower.tf32x3``, every operand
    split as the kernel splits it in registers), pre as the forward's
    (``pre_products``: the kink rule).  Same results as
    ``cond_pair_backward``."""
    f32 = x.dtype == torch.float32
    dt = x.dtype

    def q(t):
        return t.detach().to(dt).float()

    def prod(fn, a, b):
        return tf32x3(fn, a, b) if f32 else fn(a, b)

    wa, ba, wb, _, alpha = (q(t) for t in _pair_params(c3a, c3b, prelu))
    v = x.float().permute(0, 2, 3, 1).unsqueeze(1)            # (B, 1, H, W, D)
    g = dz.float().permute(0, 2, 3, 1).unsqueeze(1)
    conv = lambda a, w: F.conv3d(a, w, padding=1)             # noqa: E731
    convt = lambda a, w: F.conv_transpose3d(a, w, padding=1)  # noqa: E731
    pre = pre_products(x, wa, ba) if f32 else \
        conv(v, wa) + ba[:, None, None, None]
    y = F.prelu(pre, alpha).to(dt).float()
    m = torch.ones_like(pre[:, :, :1, :1, :1]) if scale is None \
        else scale[:, :, None, None, None]
    if scale is not None:
        y = (y * m).to(dt).float()
    gy = prod(convt, g, wb) * m                               # dL/dPReLU(pre)
    neg = pre <= 0
    dpre = torch.where(neg, gy * alpha, gy)
    dal = (gy * pre * neg).sum()
    dq = dpre.to(dt).float()
    dx = prod(convt, dq, wa)
    dwa = prod(lambda a, gg: torch.nn.grad.conv3d_weight(
        a, wa.shape, gg, padding=1), v, dq)
    dwb = prod(lambda a, gg: torch.nn.grad.conv3d_weight(
        a, wb.shape, gg, padding=1), y, g)
    return (dx[:, 0].permute(0, 3, 1, 2).to(dt).contiguous(), dwa,
            dpre.sum((0, 2, 3, 4)), dwb, g.sum().reshape(1), dal.reshape(1))


def cond_pair_backward(x, dz, c3a, c3b, prelu, scale=None, *, instance=None):
    """The pair's backward: (dx in x's dtype, dW_a, db_a, dW_b, db_b,
    dalpha), the last five f32 in the parameters' shapes, for the gradient
    dz of ``cond_pair(x, c3a, c3b, prelu, scale=scale)``.  dalpha is this
    site's share: the cond net's PReLU alpha is shared with its 2-D stack,
    whose shares autograd adds.

    A CPU tensor runs the plain version (``cond_pair_backward_reference``);
    a CUDA tensor launches the instance that ``bwd_instance`` picks
    (``csrc/cond_pair_bwd.cu``) or raises.  instance: ``CUDA_CORES`` runs
    that instance where a tensor-core one would be picked (to time the
    two side by side).  Counts every launch, and per instance in
    ``cond_pair_backward.by_instance``."""
    k = _check(x, c3a, c3b, prelu, scale)
    if dz.shape != x.shape or dz.dtype != x.dtype or dz.device != x.device \
            or not dz.is_contiguous():
        raise ValueError(f"dz is {tuple(dz.shape)} {dz.dtype} on {dz.device}"
                         f"; expected x's {tuple(x.shape)} {x.dtype}, "
                         "contiguous")
    if instance not in (None, CUDA_CORES):
        raise ValueError(f"instance {instance!r}: None or {CUDA_CORES!r}")
    if x.device.type == "cpu":
        return cond_pair_backward_reference(x, dz, c3a, c3b, prelu, scale)
    instance = instance or bwd_instance(x.dtype, k)
    b, d, h, w = x.shape
    lib = _bwd_lib()
    wa, ba, wb, _, alpha = _kernel_params(x, c3a, c3b, prelu)
    dx = torch.empty_like(x)
    grads = torch.empty(k * 56 + 1, device=x.device)
    part = torch.empty(lib.cwfa_cond_pair_bwd_part(b, d, h, w, k),
                       device=x.device)
    rc = lib.cwfa_cond_pair_bwd(
        x.data_ptr(), dz.data_ptr(), wa.data_ptr(), ba.data_ptr(),
        wb.data_ptr(), alpha.data_ptr(),
        None if scale is None else scale.data_ptr(),
        dx.data_ptr(), grads.data_ptr(), part.data_ptr(), b, d, h, w, k,
        _DTYPES[x.dtype], int(instance != CUDA_CORES), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, f"cond_pair_backward ({instance})")
    cond_pair_backward.launches += 1
    cond_pair_backward.by_instance[instance] += 1
    per = grads[:k * 56].view(k, 56)
    return check_kernel_outputs("cond_pair_backward", (
        dx, per[:, :27].reshape(k, 1, 3, 3, 3), per[:, 54].contiguous(),
        per[:, 27:54].reshape(1, k, 3, 3, 3), grads[k * 56:],
        per[:, 55].sum().reshape(1)))


cond_pair_backward.launches = 0             # every launch of the kernel
# ... and of each instance
cond_pair_backward.by_instance = {TENSOR_CORES: 0, TENSOR_CORES_TF32: 0,
                                  CUDA_CORES: 0}


class CondPairFn(torch.autograd.Function):
    """``cond_pair`` with its backward kernel: apply(x, c3a.weight,
    c3a.bias, c3b.weight, c3b.bias, prelu.weight, scale, (c3a, c3b, prelu))
    -> z.  The parameters are passed so that autograd tracks them; the
    gradients of f32 master weights come back f32."""

    @staticmethod
    def forward(ctx, x, wa, ba, wb, bb, alpha, scale, mods):
        ctx.mods = mods
        ctx.save_for_backward(x, wa, ba, wb, bb, alpha, scale)
        return cond_pair(x, *mods, scale=scale)

    @staticmethod
    def backward(ctx, dz):
        x, *params, scale = ctx.saved_tensors
        grads = cond_pair_backward(x, dz.contiguous(), *ctx.mods, scale)
        return (grads[0], *[g.to(p.dtype) for g, p in zip(grads[1:], params)],
                None, None)


def cond_pair_ad(x, c3a, c3b, prelu, scale=None):
    """``cond_pair``, differentiable through ``CondPairFn``."""
    return CondPairFn.apply(x, *_pair_params(c3a, c3b, prelu), scale,
                            (c3a, c3b, prelu))
