"""The float subnet tower in one kernel: the weight pack, the plain PyTorch
version and the CUDA kernel's wrapper (counterpart of
``cwfa_tpu/ops/btower.py``; the kernel is ``csrc/btower.cu``).

One tower of ``flow/subnets.WaveletFlowSubnet2d`` per call, in bf16 or f32:

    r1  = b1(x)                                  1x1, Cin -> C
    e2  = elu(b2b(elu(b2a(r1))) + r1)            3x3 then 1x1, residual
    e4  = elu(b4b(elu(b4a(e2))) + e2)
    e6  = elu(b6b(elu(b6a(e4))) + e4)
    out = b7(e6)                                 3x3, C -> Nout

with the cast structure of ``pair_tower_bf16_reference``
(``cwfa_tpu/ops/btower.py:291-319``) for one unpaired tower: the canvases
between convs are rounded to x's dtype; sums, bias, ELU (as
``exp(min(v, 0)) - 1``) and the residual add are f32.

The kernel has three instances (``kernel_instance``): a 64-wide tower runs
on the warpgroup tensor cores (``wgmma``), in bf16 or, for f32, as 3xTF32
(every f32 operand split into a TF32 high part and a remainder, three
products, f32 sums; ``csrc/btower_wg.cu``); every other width runs on the
CUDA cores (``csrc/btower.cu``), any width whose canvases fit in shared
memory at the smallest tile (400 wide in bf16, 240 in f32).  Each reads the weights from a pack in its
own layout, built once per set of weights by ``pack_float_tower`` and kept
on the module.

The weights may be f32 master weights under a bf16 x (training): the
kernel and the plain version then use them rounded to bf16, and the biases
as they are.  ``FloatTowerFn`` differentiates the tower; its backward is a
kernel too (``float_tower_backward``; the TPU kernel has none, JAX trains
through its XLA convs), with two instances (``bwd_instance``): a 64-wide
tower in bf16 on the warpgroup tensor cores (``csrc/btower_bwd_wg.cu``,
weights packed by ``pack_float_tower_bwd``, its arithmetic in plain PyTorch
``float_tower_backward_products``), every other on the CUDA cores
(``csrc/btower_bwd.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cwfa_tpu_torch.ops import cuda_build

CONVS = ("b1", "b2a", "b2b", "b4a", "b4b", "b6a", "b6b", "b7")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _elu(v):
    # the kernel's form (btower.py:117-120)
    return torch.where(v > 0, v, torch.exp(torch.clamp_max(v, 0.0)) - 1.0)


def round_through(v, dtype):
    """f32 v with the values of v rounded to ``dtype`` and v's own gradient:
    the rounding of a canvas between convs, whose derivative is the
    identity; the backward kernels keep the gradient in f32 as this does
    (a cast would round the gradient to ``dtype`` as well)."""
    if dtype == torch.float32:
        return v
    return v + (v.to(dtype).float() - v).detach()


def _tower_params(tower):
    """[(weight, bias or None)] of the eight convs, in ``CONVS`` order."""
    return [(getattr(tower, n).weight, getattr(tower, n).bias) for n in CONVS]


def _tower_math(params, x):
    """``float_tower_reference`` on explicit (weight, bias) pairs."""
    dt = x.dtype
    convs = dict(zip(CONVS, params))

    def conv(name, v):
        w, b = convs[name]
        return F.conv2d(v.float(), w.to(dt).float(),
                        None if b is None else b.float(),
                        padding=w.shape[-1] // 2)

    def block(a, b, e):
        return round_through(_elu(conv(b, round_through(_elu(conv(a, e)), dt))
                                  + e), dt)

    r1 = round_through(conv("b1", x), dt)
    e2 = block("b2a", "b2b", r1)
    e4 = block("b4a", "b4b", e2)
    e6 = block("b6a", "b6b", e4)
    return conv("b7", e6)


def float_tower_reference(tower, x):
    """The kernel's math in plain PyTorch: f32 convs on inputs and weights
    rounded to x's dtype, f32 biases; each canvas between convs rounded to
    x's dtype (``round_through``).  x: (B, Cin, H, W).  Returns (B, Nout,
    H, W) f32."""
    return _tower_math(_tower_params(tower), x)


def float_tower_backward_reference(tower, x, dy):
    """(dx, [dW], [db]) of the tower's output in x's dtype (``fused_float_
    tower``) for the output gradient dy: autograd through the plain version.
    dW in each conv's OIHW layout, f32 like the weights it differentiates;
    db None where a conv has no bias."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        params = [(w.detach().float().requires_grad_(),
                   None if b is None else b.detach().float().requires_grad_())
                  for w, b in _tower_params(tower)]
        flat = [t for pair in params for t in pair if t is not None]
        out = _tower_math(params, xr).to(x.dtype)
        grads = iter(torch.autograd.grad(out, [xr] + flat, dy))
        dx = next(grads)
        dws, dbs = [], []
        for _, b in params:
            dws.append(next(grads))
            dbs.append(None if b is None else next(grads))
    return dx, dws, dbs


WGMMA_BF16, WGMMA_3XTF32, CUDA_CORES = "wgmma bf16", "wgmma 3xTF32", "CUDA cores"
WGMMA_WIDTH = 64                       # the tower width of the wgmma instances
WGMMA_NOUT = (16, 32, 48, 64, 96)      # b7 widths they are built for
TF32_CHUNK = 32                        # input channels per weight slice, 3xTF32
TOO_WIDE = -1                          # csrc/btower.cu: no tile fits the width
# a 1x1 that follows a 3x3 in registers reads its input channels in the
# order the 3x3's sums sit in a thread: slot s of 8 is channel _SUM_ORDER[s]
_SUM_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def kernel_instance(dtype, c: int, cin: int, nout: int) -> str:
    """Which instance of the kernel runs a tower of width ``c`` with ``cin``
    inputs and ``nout`` outputs in ``dtype``."""
    if c == WGMMA_WIDTH and cin <= WGMMA_WIDTH and nout <= WGMMA_NOUT[-1]:
        return WGMMA_BF16 if dtype == torch.bfloat16 else WGMMA_3XTF32
    return CUDA_CORES


def _round_up(n: int, m: int) -> int:
    return n + (-n) % m


def split_tf32(w):
    """f32 -> (hi, lo), both exact TF32 values (10 mantissa bits): hi is w
    rounded to nearest (ties away from zero), lo the remainder w - hi rounded
    the same way.  hi + lo is w to 2^-22 relative."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(w)
    return hi, rna(w - hi)


def _taps(w, ipad: int, opad: int):
    """OIHW -> [tap][O padded to opad][I padded to a multiple of ipad]."""
    o, i, k, _ = w.shape
    full = torch.zeros((k * k, opad, _round_up(i, ipad)), device=w.device)
    full[:, :o, :i] = w.permute(2, 3, 0, 1).reshape(k * k, o, i)
    return full


def _pack_conv(w, instance: str, *, nout_pad: int = 0, after_3x3: bool = False,
               first: bool = False):
    """One conv's OIHW f32 weight in the layout of ``instance``, flattened.

    CUDA cores: f32 [tap][Cin][Cout], zero-padded: Cout to a multiple of 8,
    Cin to a multiple of 2 for b1 (``first``) and of 8 for the others, whose
    input is a canvas of the tower's width padded to 8.

    wgmma: the B operand as the tensor cores read it from shared memory,
    K-major without swizzle: a core matrix is 8 output channels x 16 bytes
    of input channels (``nout_pad`` output channels, the conv's own if 0).
    bf16: [tap][Cin/8][Cout][8], Cin rounded up to 16.  3xTF32: per tap and
    per chunk of 32 input channels (Cin rounded up to 8) the high parts
    [chunk/4][Cout][4] and then the low parts, f32 (``split_tf32``); with
    ``after_3x3`` (the 1x1 of a residual block, whose A operand is the
    3x3's sums in registers) the input channels of every 8 in the order
    ``_SUM_ORDER``."""
    o, i, k, _ = w.shape
    if instance == CUDA_CORES:
        return (_taps(w, 2 if first else 8, _round_up(o, 8))
                .transpose(1, 2).reshape(-1))
    opad = nout_pad or o
    if instance == WGMMA_BF16:
        t = _taps(w, 16, opad)                                # [tap][O][I]
        t = t.reshape(k * k, opad, -1, 8).permute(0, 2, 1, 3)  # [tap][I/8][O][8]
        return t.reshape(-1).to(torch.bfloat16)
    t = _taps(w, 8, opad)
    if after_3x3:
        order = torch.tensor(_SUM_ORDER, device=w.device)
        t = t.reshape(k * k, opad, -1, 8)[..., order].reshape(k * k, opad, -1)
    parts = []
    for tap in t:
        for c0 in range(0, tap.shape[1], TF32_CHUNK):
            chunk = tap[:, c0:c0 + TF32_CHUNK]                # [O][kc]
            for part in split_tf32(chunk):
                parts.append(part.reshape(opad, -1, 4).permute(1, 0, 2).reshape(-1))
    return torch.cat(parts)


def _pack(tower, instance: str):
    weights, biases = [], []
    nout_pad = 0
    if instance != CUDA_CORES:
        nout_pad = next(n for n in WGMMA_NOUT if n >= tower.b7.out_channels)
    for name in CONVS:
        conv = getattr(tower, name)
        weights.append(_pack_conv(
            conv.weight.detach().float(), instance,
            nout_pad=nout_pad if name == "b7" else 0,
            after_3x3=name in ("b2b", "b4b", "b6b"), first=name == "b1"))
        bias = (torch.zeros(conv.out_channels, device=conv.weight.device)
                if conv.bias is None else conv.bias.detach().float())
        if instance == CUDA_CORES and name != "b7":
            # the padded channels of a width that is not a multiple of 8
            bias = F.pad(bias, (0, (-bias.numel()) % 8))
        biases.append(bias)
    return torch.cat(weights), torch.cat(biases)


def _instance_of(tower, dtype) -> str:
    return kernel_instance(dtype, tower.b1.out_channels,
                           tower.b1.in_channels, tower.b7.out_channels)


def pack_float_tower(tower, dtype=None):
    """The tower's kernel pack (weights, biases): the weights of b1, b2a,
    b2b, b4a, b4b, b6a, b6b and b7 in turn, each in the layout of
    ``_pack_conv`` for the tower's instance (``kernel_instance``), and the
    eight biases in f32 (zeros where a conv has none; for the CUDA cores
    those of b1..b6b padded with zeros to a multiple of 8).  ``dtype``: the
    compute dtype whose instance the pack is for (default: the weights').
    Built at first use and kept on the module until a weight changes (in
    place or by replacement) or another dtype asks."""
    dtype = tower.b1.weight.dtype if dtype is None else dtype
    key = (dtype,) + tuple((t.device, t.dtype, t.data_ptr(),
                            None if t.is_inference() else t._version)
                           for t in tower.parameters())
    cached = getattr(tower, "_float_tower_pack", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, _pack(tower, _instance_of(tower, dtype)))
        tower._float_tower_pack = cached
    return cached[1]


@functools.lru_cache(maxsize=None)
def _lib():
    """(the CUDA-core library, the wgmma library)"""
    lib, wg = cuda_build.load("btower"), cuda_build.load("btower_wg")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cwfa_btower.argtypes = [p] * 4 + [i32] * 8 + [p]
    lib.cwfa_btower.restype = i32
    wg.cwfa_btower_wg.argtypes = [p] * 4 + [i32] * 7 + [p]
    wg.cwfa_btower_wg.restype = i32
    return lib, wg


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    """(the CUDA-core library, the wgmma library) of the backward"""
    lib, wg = cuda_build.load("btower_bwd"), cuda_build.load("btower_bwd_wg")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.cwfa_btower_bwd.argtypes = [p] * 10 + [i32] * 7 + [i32, p]
    lib.cwfa_btower_bwd.restype = i32
    lib.cwfa_btower_bwd_scratch.argtypes = [i32] * 4
    lib.cwfa_btower_bwd_scratch.restype = i64
    lib.cwfa_btower_bwd_part.argtypes = [i32] * 5
    lib.cwfa_btower_bwd_part.restype = i64
    wg.cwfa_btower_bwd_wg.argtypes = [p] * 8 + [i32] * 6 + [p]
    wg.cwfa_btower_bwd_wg.restype = i32
    wg.cwfa_btower_bwd_wg_scratch.argtypes = [i32] * 6
    wg.cwfa_btower_bwd_wg_scratch.restype = i64
    return lib, wg


def _check(x, tower):
    if x.dim() != 4 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError("x must be a contiguous non-empty (B, Cin, H, W) "
                         f"tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x.device}")
    cin, c = tower.b1.in_channels, tower.b1.out_channels
    if x.shape[1] != cin:
        raise ValueError(f"x has {x.shape[1]} channels, the tower takes {cin}")
    for name in CONVS:
        conv = getattr(tower, name)
        i = cin if name == "b1" else c
        o = c if name != "b7" else conv.out_channels
        k = 1 if name in ("b1", "b2b", "b4b", "b6b") else 3
        if tuple(conv.weight.shape) != (o, i, k, k):
            raise ValueError(f"{name}.weight shape {tuple(conv.weight.shape)}"
                             f" != {(o, i, k, k)}")
        for t in (conv.weight, conv.bias):
            if t is not None and (t.dtype not in (x.dtype, torch.float32)
                                  or t.device != x.device):
                raise TypeError(f"{name} is {t.dtype} on {t.device}; x is "
                                f"{x.dtype} on {x.device} (weights of x's "
                                "dtype, or f32 master weights)")
    return c, tower.b7.out_channels


def fused_float_tower(x, tower):
    """One subnet tower over the whole batch (``fused_pair_tower_bf16``,
    ``cwfa_tpu/ops/btower.py:235``).

    x: (B, Cin, H, W), contiguous, f32 or bf16; tower: a
    ``WaveletFlowSubnet2d`` with weights of x's dtype or f32, on x's device
    (f32 weights under a bf16 x run rounded to bf16).  Returns
    the tower's output (B, Nout, H, W) in x's dtype, NCHW.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.  Counts every launch, and per instance in
    ``fused_float_tower.by_instance``."""
    c, nout = _check(x, tower)
    if x.device.type == "cpu":
        # NCHW as the kernel writes it (a conv of a 1-channel x may come out
        # channels-last)
        return float_tower_reference(tower, x).to(x.dtype).contiguous()
    b, cin, h, w = x.shape
    weights, biases = pack_float_tower(tower, x.dtype)
    out = torch.empty((b, nout, h, w), dtype=x.dtype, device=x.device)
    instance = kernel_instance(x.dtype, c, cin, nout)
    lib, wg = _lib()
    ptrs = (x.data_ptr(), weights.data_ptr(), biases.data_ptr(), out.data_ptr())
    where = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if instance == CUDA_CORES:
        rc = lib.cwfa_btower(*ptrs, b, h, w, cin, c, nout, _DTYPES[x.dtype],
                             *where)
    else:
        rc = wg.cwfa_btower_wg(*ptrs, b, h, w, cin, nout, _DTYPES[x.dtype],
                               *where)
    if rc == TOO_WIDE:
        raise ValueError(f"tower width {c} in {x.dtype}: the canvases of the "
                         "smallest tile exceed the card's shared memory")
    cuda_build.check_launch(rc, f"fused_float_tower ({instance})")
    fused_float_tower.launches += 1
    fused_float_tower.by_instance[instance] += 1
    return out


fused_float_tower.launches = 0              # every launch of the kernel
# ... and of each instance
fused_float_tower.by_instance = {WGMMA_BF16: 0, WGMMA_3XTF32: 0, CUDA_CORES: 0}


def bwd_instance(dtype, c: int, cin: int, nout: int) -> str:
    """Which instance of the backward kernel runs a tower of width ``c``
    with ``cin`` inputs and ``nout`` outputs in ``dtype``."""
    if (dtype == torch.bfloat16 and c == WGMMA_WIDTH and cin <= WGMMA_WIDTH
            and nout <= WGMMA_NOUT[-1]):
        return WGMMA_BF16
    return CUDA_CORES


# the order of the wgmma backward's weight slices: the forward convs it
# recomputes, then the dgrads from the top
BWD_FORWARD = CONVS[:7]
BWD_DGRAD = CONVS[::-1]


def _wg_slices(w, npad: int = 16):
    """An OIHW weight as wgmma's K-major B operand, flattened: [tap][I/8][O][8]
    bf16, I padded with zeros to a multiple of 16, O to a multiple of
    ``npad``."""
    o, i, k, _ = w.shape
    t = _taps(w, 16, _round_up(o, npad))                  # [tap][O][I]
    t = t.reshape(k * k, t.shape[1], -1, 8).permute(0, 2, 1, 3)
    return t.reshape(-1).to(torch.bfloat16)


def dgrad_weight(w):
    """The weight of a conv's dgrad: the taps flipped, in and out swapped
    (OIHW -> the OIHW of the transposed conv)."""
    return w.flip(2, 3).transpose(0, 1)


def pack_float_tower_bwd(tower):
    """The wgmma backward's pack (weights, biases): the weights rounded to
    bf16 as ``_wg_slices`` of b1 .. b6b (``BWD_FORWARD``, the recomputed
    forward), then of the dgrad weights (``dgrad_weight``) of b7 .. b1
    (``BWD_DGRAD``); the biases of b1 .. b6b, f32 (zeros where a conv has
    none).  Built at first use and kept on the module until a weight
    changes."""
    key = tuple((t.device, t.dtype, t.data_ptr(),
                 None if t.is_inference() else t._version)
                for t in tower.parameters())
    cached = getattr(tower, "_float_tower_bwd_pack", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            ws = {n: getattr(tower, n).weight.detach().to(torch.bfloat16)
                  .float() for n in CONVS}
            weights = [_wg_slices(ws[n]) for n in BWD_FORWARD]
            weights += [_wg_slices(dgrad_weight(ws[n])) for n in BWD_DGRAD]
            biases = [torch.zeros(WGMMA_WIDTH, device=ws["b1"].device)
                      if getattr(tower, n).bias is None
                      else getattr(tower, n).bias.detach().float()
                      for n in BWD_FORWARD]
            cached = (key, (torch.cat(weights), torch.cat(biases)))
        tower._float_tower_bwd_pack = cached
    return cached[1]


def _conv_bwd_parts(params):
    """{name: (weight rounded to bf16, f32 bias or zeros)}."""
    out = {}
    for n, (w, b) in zip(CONVS, params):
        w = w.detach().to(torch.bfloat16).float()
        out[n] = (w, torch.zeros(w.shape[0], device=w.device) if b is None
                  else b.detach().float())
    return out


def float_tower_backward_products(tower, x, dy):
    """The wgmma bf16 instance's arithmetic in plain PyTorch (x, dy bf16):
    the forward recomputed with its canvases rounded to bf16 as the forward
    rounds them; then each gradient with ELU' taken from the stored canvas
    (``min(e, 0) + 1``), the residual chain in f32, and the gradient rounded
    to bf16 as the operand of each product (dgrad, wgrad, bias sum) that
    reads it.  Same results as ``float_tower_backward``."""
    c = _conv_bwd_parts(_tower_params(tower))

    def rnd(v):
        return v.to(torch.bfloat16).float()

    def conv(n, v):
        w, b = c[n]
        return F.conv2d(v, w, b, padding=w.shape[-1] // 2)

    def dgrad(n, g):
        w = c[n][0]
        return F.conv_transpose2d(g, w, padding=w.shape[-1] // 2)

    def wgrad(n, g, v):
        w = c[n][0]
        return torch.nn.grad.conv2d_weight(v, w.shape, g,
                                           padding=w.shape[-1] // 2)

    def elu_grad(e):
        return torch.clamp_max(e, 0.0) + 1.0

    xf, g_out = x.float(), dy.float()
    cv = {"r1": rnd(conv("b1", xf))}
    below = "r1"
    for a, e, ca, cb in (("a2", "e2", "b2a", "b2b"), ("a4", "e4", "b4a", "b4b"),
                         ("a6", "e6", "b6a", "b6b")):
        cv[a] = rnd(_elu(conv(ca, cv[below])))
        cv[e] = rnd(_elu(conv(cb, cv[a]) + cv[below]))
        below = e
    dws, dbs = {}, {}
    dws["b7"], dbs["b7"] = wgrad("b7", g_out, cv["e6"]), g_out.sum((0, 2, 3))
    g_e = dgrad("b7", g_out) * elu_grad(cv["e6"])            # f32 chain
    for a, e, ca, cb, lower in (("a6", "e6", "b6a", "b6b", "e4"),
                                ("a4", "e4", "b4a", "b4b", "e2"),
                                ("a2", "e2", "b2a", "b2b", "r1")):
        ge = rnd(g_e)
        g_a = rnd(dgrad(cb, ge) * elu_grad(cv[a]))
        dws[cb], dbs[cb] = wgrad(cb, ge, cv[a]), ge.sum((0, 2, 3))
        g_e = dgrad(ca, g_a) + g_e
        if lower != "r1":
            g_e = g_e * elu_grad(cv[lower])
        dws[ca], dbs[ca] = wgrad(ca, g_a, cv[lower]), g_a.sum((0, 2, 3))
    g_r1 = rnd(g_e)
    dx = dgrad("b1", g_r1).to(torch.bfloat16)
    dws["b1"], dbs["b1"] = wgrad("b1", g_r1, xf), g_r1.sum((0, 2, 3))
    params = _tower_params(tower)
    return (dx, [dws[n] for n in CONVS],
            [None if b is None else dbs[n] for n, (_, b) in zip(CONVS, params)])


def _bwd_layouts(w, dgrad: bool):
    """An OIHW weight (f32 values of the compute dtype) as the CUDA-core
    backward's direct conv reads it: [tap][Ci padded to 8][Co padded to 64]
    for the forward; for the dgrad the taps flipped and I, O swapped."""
    if dgrad:
        w = dgrad_weight(w)
    o, i, k, _ = w.shape
    out = torch.zeros((k * k, _round_up(i, 8), _round_up(o, 64)),
                      device=w.device)
    out[:, :i, :o] = w.permute(2, 3, 1, 0).reshape(k * k, i, o)
    return out


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _backward_cuda_cores(tower, x, dy, c, nout):
    b, cin, h, w = x.shape
    dt = x.dtype
    params = _tower_params(tower)
    ws = [wt.detach().to(dt).float() for wt, _ in params]
    bs = [torch.zeros(wt.shape[0], device=x.device) if bi is None
          else bi.detach().float() for wt, bi in params]
    wf = [_bwd_layouts(wt, False) for wt in ws]
    wd = [_bwd_layouts(wt, True) for wt in ws]
    lib = _bwd_lib()[0]
    scratch = torch.empty(lib.cwfa_btower_bwd_scratch(b, h, w, c),
                          device=x.device)
    part = torch.empty(lib.cwfa_btower_bwd_part(b, h, cin, c, nout),
                       device=x.device)
    dx = torch.empty((b, cin, h, w), device=x.device)
    dws = [torch.empty_like(wt) for wt in ws]
    dbs = [torch.empty_like(bi) for bi in bs]
    # held until the launch is queued: a temporary's memory would go back to
    # the allocator, and the next one of the same size would take it
    x32, dy32 = x.float().contiguous(), dy.float().contiguous()
    rc = lib.cwfa_btower_bwd(
        x32.data_ptr(), dy32.data_ptr(),
        _ptrs(wf), _ptrs(wd), _ptrs(bs), dx.data_ptr(), _ptrs(dws), _ptrs(dbs),
        scratch.data_ptr(), part.data_ptr(), b, h, w, cin, c, nout,
        int(dt == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, f"float_tower_backward ({CUDA_CORES})")
    return dx.to(dt), dws, dbs


def _backward_wgmma(tower, x, dy, nout):
    b, cin, h, w = x.shape
    wg = _bwd_lib()[1]
    weights, biases = pack_float_tower_bwd(tower)
    nbytes = wg.cwfa_btower_bwd_wg_scratch(b, h, w, cin, nout, x.device.index)
    if nbytes < 0:
        raise RuntimeError("float_tower_backward: no device attributes")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    dws = [torch.empty(getattr(tower, n).weight.shape, device=x.device)
           for n in CONVS]
    dbs = [torch.empty(getattr(tower, n).out_channels, device=x.device)
           for n in CONVS]
    rc = wg.cwfa_btower_bwd_wg(
        x.data_ptr(), dy.data_ptr(), weights.data_ptr(), biases.data_ptr(),
        dx.data_ptr(), _ptrs(dws), _ptrs(dbs), scratch.data_ptr(),
        b, h, w, cin, nout, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, f"float_tower_backward ({WGMMA_BF16})")
    return dx, dws, dbs


def float_tower_backward(tower, x, dy, *, instance=None):
    """The tower's backward: (dx in x's dtype, [dW], [db]) for the gradient
    dy (B, Nout, H, W) of ``fused_float_tower(x, tower)``.  dW in each
    conv's OIHW layout and db, f32 (the weights' gradients also when they
    are bf16); db None where a conv has no bias.

    A CPU tensor runs the plain version (``float_tower_backward_reference``);
    a CUDA tensor launches the instance that ``bwd_instance`` picks
    (``csrc/btower_bwd_wg.cu`` or ``csrc/btower_bwd.cu``, one host entry
    each) or raises.  instance: ``CUDA_CORES`` runs that instance where the
    wgmma one would be picked (to time the two side by side).  Counts every
    launch, and per instance in ``float_tower_backward.by_instance``."""
    c, nout = _check(x, tower)
    b, cin, h, w = x.shape
    if tuple(dy.shape) != (b, nout, h, w) or dy.dtype != x.dtype \
            or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"dy is {tuple(dy.shape)} {dy.dtype} on {dy.device}"
                         f", expected a contiguous {(b, nout, h, w)} "
                         f"{x.dtype} on {x.device}")
    if instance not in (None, CUDA_CORES):
        raise ValueError(f"instance {instance!r}: None or {CUDA_CORES!r}")
    if x.device.type == "cpu":
        return float_tower_backward_reference(tower, x, dy)
    instance = instance or bwd_instance(x.dtype, c, cin, nout)
    if instance == WGMMA_BF16:
        dx, dws, dbs = _backward_wgmma(tower, x, dy, nout)
    else:
        dx, dws, dbs = _backward_cuda_cores(tower, x, dy, c, nout)
    float_tower_backward.launches += 1
    float_tower_backward.by_instance[instance] += 1
    return (dx, dws, [None if conv.bias is None else db for conv, db in
                      zip((getattr(tower, n) for n in CONVS), dbs)])


float_tower_backward.launches = 0             # every launch of the kernel
# ... and of each instance
float_tower_backward.by_instance = {WGMMA_BF16: 0, CUDA_CORES: 0}


class FloatTowerFn(torch.autograd.Function):
    """``fused_float_tower`` with its backward kernel: apply(x, tower,
    *tower.parameters()) -> the tower's output in x's dtype.  The
    parameters are passed so that autograd tracks them; the gradients of
    f32 master weights come back f32."""

    @staticmethod
    def forward(ctx, x, tower, *params):
        ctx.tower = tower
        ctx.save_for_backward(x, *params)
        return fused_float_tower(x, tower)

    @staticmethod
    def backward(ctx, dy):
        x = ctx.saved_tensors[0]
        dx, dws, dbs = float_tower_backward(ctx.tower, x, dy.contiguous())
        flat = []
        for dw, db in zip(dws, dbs):
            flat.append(dw)
            if db is not None:
                flat.append(db)
        return (dx, None, *[g.to(p.dtype) for g, p in
                            zip(flat, ctx.saved_tensors[1:])])


def float_tower(x, tower):
    """The tower's output (``fused_float_tower``), differentiable through
    ``FloatTowerFn``."""
    return FloatTowerFn.apply(x, tower, *tower.parameters())
