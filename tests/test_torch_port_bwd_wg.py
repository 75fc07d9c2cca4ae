"""The tensor-core instances of the training backward kernels, on the CPU:
their weight packs unpacked in plain PyTorch, the wrappers' choice of
instance, and plain-PyTorch models of their numerics held to a reference
within the chip check's bounds (``BWD_BOUND``): bf16 (the gradient operand
rounded to bf16 before each product; ELU' from the stored canvas) against
the plain backward within 2^-5 of max|ref|; f32 as 3xTF32 (every operand
split into TF32 high and low parts, three products, f32 sums; near PReLU's
kink the pair's pre summed as the CUDA-core instances sum it) against the
f64 gradient within 1e-5 (dx) and 1e-4 (dW, db) of max|ref|.  Tiny shapes:
every elementwise tensor below 32,768 elements."""

import numpy as np
import pytest
import torch

from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d
from cwfa_tpu_torch.ops import btower
from cwfa_tpu_torch.ops import cond_pair as cpair

BF16_BOUND = 2.0 ** -5          # chip_smoke.BWD_BOUND for bf16, dx and dW
F32_BOUND = (1e-5, 1e-4)        # chip_smoke.BWD_BOUND for f32: dx, dW and db


def _tower(cin, nout, width, seed):
    rng = np.random.RandomState(seed)
    tower = WaveletFlowSubnet2d(cin, nout, width)
    with torch.no_grad():
        for p in tower.parameters():
            fan = p[0].numel() if p.dim() > 1 else 4
            p.copy_(torch.as_tensor(rng.randn(*p.shape).astype(np.float32)
                                    / np.sqrt(fan)))
    return tower


def _assert_within(got, ref, bound, what):
    """Every gradient within its bound x max|ref|: bound a number, or (dx's,
    the others') as F32_BOUND."""
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None, f"{what} gradient {i}"
            continue
        b = (bound[0] if i == 0 else bound[1]) if isinstance(bound, tuple) \
            else bound
        d = (g.double() - r.double()).abs().max().item()
        scale = r.double().abs().max().item()
        assert d <= b * scale, (
            f"{what} gradient {i}: max|d| {d:.3e} over {b:.3e} x "
            f"max|ref| {scale:.3e}")


def _unpack_wg_slices(flat, k, i, o):
    """The inverse of ``btower._wg_slices`` for a k x k weight of ``o``
    outputs and ``i`` inputs: OIHW f32, the padding dropped."""
    ip, op = btower._round_up(i, 16), btower._round_up(o, 16)
    t = flat.float().reshape(k * k, ip // 8, op, 8).permute(0, 2, 1, 3)
    t = t.reshape(k * k, op, ip)[:, :o, :i]
    return t.reshape(k, k, o, i).permute(2, 3, 0, 1)


def _flat(g):
    return [g[0]] + [t for pair in zip(g[1], g[2]) for t in pair]


@pytest.mark.parametrize("cin,nout", [(6, 12), (6, 6), (12, 24), (48, 96),
                                      (24, 24), (5, 80), (72, 24), (128, 48)])
def test_float_tower_bwd_pack_unpacks_to_oihw(cin, nout):
    """Every slice of ``pack_float_tower_bwd``, unpacked, is the OIHW weight
    (rounded to bf16) it came from: the forward's for b1 .. b6b, the flipped
    and transposed one for each dgrad, b1's in chunks of at most 64 of its
    outputs (Cin 72: 64 + 8 padded to 16)."""
    tower = _tower(cin, nout, 64, 0)
    weights, biases = btower.pack_float_tower_bwd(tower)
    assert weights.dtype == torch.bfloat16 and biases.dtype == torch.float32
    ws = {n: getattr(tower, n).weight.detach().to(torch.bfloat16).float()
          for n in btower.CONVS}
    off = 0
    for n in btower.BWD_FORWARD:
        o, i, k, _ = ws[n].shape
        size = k * k * btower._round_up(i, 16) * btower._round_up(o, 16)
        got = _unpack_wg_slices(weights[off:off + size], k, i, o)
        assert torch.equal(got, ws[n]), n
        off += size
    for n in btower.BWD_DGRAD:
        o, i, k, _ = ws[n].shape                 # the dgrad: i outputs
        chunk = btower.DX_CHUNK if n == "b1" else i
        for i0 in range(0, i, chunk):
            ic = min(chunk, i - i0)
            size = k * k * btower._round_up(o, 16) * btower._round_up(ic, 16)
            got = _unpack_wg_slices(weights[off:off + size], k, o, ic)
            # flip the taps back, swap in and out back
            assert torch.equal(got.flip(2, 3).transpose(0, 1),
                               ws[n][:, i0:i0 + ic]), n
            off += size
    assert off == weights.numel()
    want_b = torch.cat([getattr(tower, n).bias.detach().float()
                        for n in btower.BWD_FORWARD])
    assert torch.equal(biases, want_b)


def test_float_tower_bwd_pack_pads_with_zeros():
    """The channels that pad Cin 6 and Nout 12 to 16 are zeros in every
    slice that carries them."""
    tower = _tower(6, 12, 64, 1)
    weights, _ = btower.pack_float_tower_bwd(tower)
    first = weights[:16 * 64].float().reshape(2, 64, 8)     # b1: [Cin/8][64][8]
    assert torch.count_nonzero(first[0, :, 6:]) == 0
    assert torch.count_nonzero(first[1]) == 0


def test_float_tower_bwd_pack_cached_until_a_weight_changes():
    tower = _tower(6, 12, 64, 2)
    a = btower.pack_float_tower_bwd(tower)
    assert btower.pack_float_tower_bwd(tower) is a
    with torch.no_grad():
        tower.b2a.weight.add_(1.0)
    b = btower.pack_float_tower_bwd(tower)
    assert b is not a and not torch.equal(a[0], b[0])


@pytest.mark.parametrize("dtype,c,cin,nout,want", [
    (torch.bfloat16, 64, 48, 96, btower.WGMMA_BF16),
    (torch.bfloat16, 64, 6, 6, btower.WGMMA_BF16),
    (torch.bfloat16, 64, 64, 96, btower.WGMMA_BF16),
    (torch.bfloat16, 64, 48, 128, btower.CUDA_CORES),
    (torch.bfloat16, 64, 72, 24, btower.WGMMA_BF16),
    (torch.bfloat16, 64, 65, 48, btower.WGMMA_BF16),
    (torch.bfloat16, 64, 128, 96, btower.WGMMA_BF16),
    (torch.bfloat16, 64, 129, 24, btower.CUDA_CORES),
    (torch.float32, 64, 72, 24, btower.WGMMA_3XTF32),
    (torch.bfloat16, 20, 5, 10, btower.CUDA_CORES),
    (torch.bfloat16, 72, 12, 24, btower.CUDA_CORES),
    (torch.float32, 64, 48, 96, btower.WGMMA_3XTF32),
    (torch.float32, 20, 5, 10, btower.CUDA_CORES),
    (torch.float32, 64, 6, 6, btower.WGMMA_3XTF32),
    (torch.float32, 64, 128, 96, btower.WGMMA_3XTF32),
    (torch.float32, 64, 129, 24, btower.CUDA_CORES),
    (torch.float32, 64, 48, 128, btower.CUDA_CORES),
])
def test_float_tower_bwd_instance(dtype, c, cin, nout, want):
    assert btower.bwd_instance(dtype, c, cin, nout) == want


@pytest.mark.parametrize("dtype,k,want", [
    (torch.bfloat16, 32, cpair.TENSOR_CORES),
    (torch.bfloat16, 16, cpair.CUDA_CORES),
    (torch.bfloat16, 64, cpair.CUDA_CORES),
    (torch.float32, 32, cpair.TENSOR_CORES_TF32),
    (torch.float32, 16, cpair.CUDA_CORES),
    (torch.float32, 64, cpair.CUDA_CORES),
])
def test_cond_pair_bwd_instance(dtype, k, want):
    assert cpair.bwd_instance(dtype, k) == want


def test_cond_pair_f32_forward_stays_on_the_cuda_cores():
    """The f32 forward at K = 32 no longer stays on the CUDA cores: it runs
    the 3xTF32 instance, as the backward does, and the two pick alike."""
    assert cpair.kernel_instance(torch.float32, 32) == cpair.TENSOR_CORES_TF32
    assert cpair.bwd_instance(torch.float32, 32) == cpair.TENSOR_CORES_TF32
    for dtype in (torch.float32, torch.bfloat16):
        for k in (16, 32, 64):
            assert cpair.bwd_instance(dtype, k) == \
                cpair.kernel_instance(dtype, k)


def test_float_tower_backward_rejects_unknown_instance():
    tower = _tower(6, 12, 64, 3)
    x = torch.zeros((1, 6, 4, 4), dtype=torch.bfloat16)
    dy = torch.zeros((1, 12, 4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        btower.float_tower_backward(tower, x, dy, instance=btower.WGMMA_BF16)


@pytest.mark.parametrize("b,cin,h,w,nout", [(1, 6, 8, 8, 12), (1, 12, 7, 9, 12),
                                            (2, 5, 5, 6, 10), (1, 48, 4, 4, 96),
                                            (1, 72, 5, 7, 24), (1, 128, 4, 4, 48)])
def test_float_tower_backward_products_within_bound(b, cin, h, w, nout):
    """The wgmma instance's numerics (one bf16 rounding of each gradient
    operand, ELU' from the canvas) against autograd through the plain
    version, in bf16: every gradient within 2^-5 of its max|ref|."""
    rng = np.random.RandomState(cin * 100 + h)
    tower = _tower(cin, nout, 64, cin + h)
    x = torch.as_tensor(rng.randn(b, cin, h, w).astype(np.float32)
                        ).to(torch.bfloat16)
    dy = torch.as_tensor(rng.randn(b, nout, h, w).astype(np.float32)
                         ).to(torch.bfloat16)
    ref = btower.float_tower_backward_reference(tower, x, dy)
    got = btower.float_tower_backward_products(tower, x, dy)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == x.shape
    for g, r in zip(got[1], ref[1]):
        assert g.shape == r.shape and g.dtype == torch.float32
    _assert_within(_flat(got), _flat(ref), BF16_BOUND,
                   f"float tower {(b, cin, h, w)} -> {nout}")


def test_wgrad_tap_split_is_the_weight_gradient():
    """The wgrad's decomposition: dW[co][ci, tap] = sum_p g[co](p) in[ci](p +
    tap) over the zero-padded input, the 9 taps taken three to a warpgroup,
    each tap a shifted window."""
    rng = np.random.RandomState(11)
    g = torch.as_tensor(rng.randn(1, 8, 6, 7).astype(np.float32))
    v = torch.as_tensor(rng.randn(1, 5, 6, 7).astype(np.float32))
    vp = torch.nn.functional.pad(v, (1, 1, 1, 1))
    dw = torch.zeros(8, 5, 3, 3)
    for wgi in range(3):
        for tap in range(3 * wgi, 3 * wgi + 3):
            ky, kx = divmod(tap, 3)
            win = vp[:, :, ky:ky + 6, kx:kx + 7]
            dw[:, :, ky, kx] = torch.einsum("bchw,bdhw->cd", g, win)
    want = torch.nn.grad.conv2d_weight(v, (8, 5, 3, 3), g, padding=1)
    assert torch.allclose(dw, want, rtol=1e-5, atol=1e-5)


def _pair(k, seed):
    rng = np.random.RandomState(seed)
    c3a = torch.nn.Conv3d(1, k, 3, padding=1)
    c3b = torch.nn.Conv3d(k, 1, 3, padding=1)
    prelu = torch.nn.PReLU(1)
    with torch.no_grad():
        c3a.weight.copy_(torch.as_tensor(rng.randn(k, 1, 3, 3, 3) / 5.2,
                                         dtype=torch.float32))
        c3a.bias.copy_(torch.as_tensor(rng.randn(k) * 0.1, dtype=torch.float32))
        c3b.weight.copy_(torch.as_tensor(rng.randn(1, k, 3, 3, 3) / 29.4,
                                         dtype=torch.float32))
        c3b.bias.copy_(torch.as_tensor(rng.randn(1) * 0.1, dtype=torch.float32))
        prelu.weight.fill_(float(rng.uniform(0.05, 0.5)))
    return c3a, c3b, prelu


@pytest.mark.parametrize("shape,with_scale", [((1, 6, 8, 9), False),
                                              ((1, 6, 8, 9), True),
                                              ((2, 5, 6, 7), True),
                                              ((1, 12, 5, 5), False)])
def test_cond_pair_backward_products_within_bound(shape, with_scale):
    """The tensor-core instance's numerics (dpre rounded to bf16 once as the
    operand of dx's and dW_a's products) against autograd through the plain
    version, in bf16, with and without the Dropout3d scale: every gradient
    within 2^-5 of its max|ref|."""
    rng = np.random.RandomState(sum(shape) + with_scale)
    c3a, c3b, prelu = _pair(32, sum(shape))
    x = torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)
    dz = torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)
    scale = None
    if with_scale:
        scale = torch.as_tensor(
            ((rng.rand(shape[0], 32) < 0.5) * 2.0).astype(np.float32))
    ref = cpair.cond_pair_backward_reference(x, dz, c3a, c3b, prelu, scale)
    got = cpair.cond_pair_backward_products(x, dz, c3a, c3b, prelu, scale)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == x.shape
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape and g.dtype == torch.float32
    _assert_within(got, ref, BF16_BOUND, f"cond pair {shape} scale={with_scale}")


def test_cond_pair_backward_rejects_unknown_instance():
    c3a, c3b, prelu = _pair(32, 1)
    x = torch.zeros((1, 2, 3, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        cpair.cond_pair_backward(x, x.clone(), c3a, c3b, prelu,
                                 instance=cpair.TENSOR_CORES)


def _unpack_tf32(flat, k, i, o):
    """The inverse of ``btower._tf32_bwd_slices`` for a k x k weight of
    ``o`` outputs and ``i`` inputs: (hi, lo) OIHW, the padding dropped, and
    the floats read."""
    ip, op = btower._round_up(i, 16), btower._round_up(o, 16)
    parts = torch.zeros((2, k * k, op, ip))
    off = 0
    for t in range(k * k):
        for c0 in range(0, ip, btower.TF32_CHUNK):
            kc = min(btower.TF32_CHUNK, ip - c0)
            for h in range(2):
                parts[h, t, :, c0:c0 + kc] = (flat[off:off + kc * op]
                                              .reshape(kc // 4, op, 4)
                                              .permute(1, 0, 2).reshape(op, kc))
                off += kc * op
    hi, lo = (p[:, :o, :i].reshape(k, k, o, i).permute(2, 3, 0, 1)
              for p in parts)
    return hi, lo, off


@pytest.mark.parametrize("cin,nout", [(6, 12), (48, 96), (72, 24), (128, 48),
                                      (5, 80)])
def test_float_tower_bwd_pack_f32_unpacks_to_oihw(cin, nout):
    """The f32 pack of ``pack_float_tower_bwd`` unpacks to each forward and
    dgrad OIHW weight (b1's dgrad in chunks of at most 64 outputs): every
    high part has its low 13 bits zero (a TF32 value), and hi + lo is the
    weight within 2^-21 of it."""
    tower = _tower(cin, nout, 64, cin + nout)
    weights, biases = btower.pack_float_tower_bwd(tower, torch.float32)
    assert weights.dtype == torch.float32 and biases.dtype == torch.float32
    ws = {n: getattr(tower, n).weight.detach() for n in btower.CONVS}
    want = [ws[n] for n in btower.BWD_FORWARD]
    want += [btower.dgrad_weight(ws[n]) for n in btower.BWD_DGRAD[:-1]]
    d1 = btower.dgrad_weight(ws["b1"])
    want += [d1[n0:n0 + btower.DX_CHUNK]
             for n0 in range(0, d1.shape[0], btower.DX_CHUNK)]
    off = 0
    for w in want:
        o, i, k, _ = w.shape
        hi, lo, n = _unpack_tf32(weights[off:], k, i, o)
        off += n
        assert int((hi.contiguous().view(torch.int32) & 0x1fff).abs().sum()) == 0
        err = (hi.double() + lo.double() - w.double()).abs()
        assert bool((err <= 2.0 ** -21 * w.double().abs()).all())
    assert off == weights.numel()
    assert btower.pack_float_tower_bwd(tower, torch.float32)[0] is weights


@pytest.mark.parametrize("b,cin,h,w,nout", [(1, 6, 8, 8, 12), (1, 48, 4, 4, 96),
                                            (1, 72, 5, 7, 24),
                                            (1, 128, 4, 4, 48)])
def test_float_tower_backward_products_f32_within_f64(b, cin, h, w, nout):
    """The 3xTF32 instance's arithmetic (``float_tower_backward_products``
    in f32) against the f64 gradient of the tower's exact function: dx
    within 1e-5 and every dW, db within 1e-4 of max|ref|."""
    rng = np.random.RandomState(cin + h)
    tower = _tower(cin, nout, 64, cin * 3 + h)
    x = torch.as_tensor(rng.randn(b, cin, h, w).astype(np.float32))
    dy = torch.as_tensor(rng.randn(b, nout, h, w).astype(np.float32))
    ref = btower.float_tower_backward_f64(tower, x, dy)
    got = btower.float_tower_backward_products(tower, x, dy)
    assert got[0].dtype == torch.float32 and got[0].shape == x.shape
    assert ref[0].dtype == torch.float64
    _assert_within(_flat(got), _flat(ref), F32_BOUND,
                   f"float tower f32 {(b, cin, h, w)} -> {nout}")


def test_tf32x3_drops_only_the_low_product():
    """``tf32x3`` of a product is hi*hi + hi*lo + lo*hi: within 2^-20 of the
    f64 product, and not equal to the plain TF32 product hi*hi."""
    rng = np.random.RandomState(4)
    a = torch.as_tensor(rng.randn(64).astype(np.float32))
    b = torch.as_tensor(rng.randn(64).astype(np.float32))
    got = btower.tf32x3(torch.mul, a, b)
    exact = a.double() * b.double()
    assert bool(((got.double() - exact).abs()
                 <= 2.0 ** -20 * exact.abs()).all())
    ah, _ = btower.split_tf32_read(a)
    bh, _ = btower.split_tf32_read(b)
    assert not torch.equal(got, ah * bh)


@pytest.mark.parametrize("shape,with_scale", [((1, 6, 8, 9), False),
                                              ((1, 6, 8, 9), True),
                                              ((2, 5, 6, 7), True),
                                              ((1, 12, 5, 5), False)])
def test_cond_pair_backward_products_f32_within_f64(shape, with_scale):
    """The 3xTF32 instance's arithmetic (``cond_pair_backward_products`` in
    f32) against the f64 gradient (PReLU's branch where the f32 forward
    takes it), with and without the Dropout3d scale: dx within 1e-5, the
    parameters' gradients within 1e-4 of max|ref|."""
    rng = np.random.RandomState(sum(shape) + 7 * with_scale)
    c3a, c3b, prelu = _pair(32, sum(shape) + 1)
    x = torch.as_tensor(rng.randn(*shape).astype(np.float32))
    dz = torch.as_tensor(rng.randn(*shape).astype(np.float32))
    scale = None
    if with_scale:
        scale = torch.as_tensor(
            ((rng.rand(shape[0], 32) < 0.5) * 2.0).astype(np.float32))
    ref = cpair.cond_pair_backward_f64(x, dz, c3a, c3b, prelu, scale)
    got = cpair.cond_pair_backward_products(x, dz, c3a, c3b, prelu, scale)
    assert got[0].dtype == torch.float32 and got[0].shape == x.shape
    for g, r in zip(got, ref):
        assert g.shape == r.shape and r.dtype == torch.float64
    _assert_within(got, ref, F32_BOUND,
                   f"cond pair f32 {shape} scale={with_scale}")


def test_pre_f32_taps_sums_in_tap_order():
    """``pre_f32_taps`` is the f32 forward's pre: the 27 products summed in
    tap order with fused multiply-adds, then the bias; here 1 + 2^-30 - 1
    (the middle product lost to rounding) where the exact sum is 2^-30."""
    c3a, _, _ = _pair(2, 3)
    with torch.no_grad():
        c3a.weight.zero_()
        c3a.weight[0, 0, 0, 0, :] = torch.tensor([1.0, 2.0 ** -15, -1.0])
        c3a.bias.zero_()
    x = torch.zeros((1, 4, 3, 3))                  # (B, D, H, W)
    x[0, 0:3, 0, 0] = torch.tensor([1.0, 2.0 ** -15, 1.0])
    pre = cpair.pre_f32_taps(x, c3a.weight, c3a.bias)   # (B, K, H, W, D)
    assert pre[0, 0, 1, 1, 1].item() == 0.0
    exact = torch.nn.functional.conv3d(
        x.double().permute(0, 2, 3, 1).unsqueeze(1), c3a.weight.double(),
        padding=1)
    assert exact[0, 0, 1, 1, 1].item() == 2.0 ** -30


def _kink_pair(alpha=0.2):
    """A pair and an x where channel 0's pre at voxel (d, h, w) = (2, 2, 2)
    is 1 + 2^-30 - 1 - 2^-31: -2^-31 in the f32 forward's sum (the 2^-30
    lost to rounding), +2^-31 exactly."""
    c3a, c3b, prelu = _pair(32, 5)
    with torch.no_grad():
        c3a.weight[0].zero_()
        c3a.weight[0, 0, 0, 0, :] = torch.tensor([1.0, 2.0 ** -15, -1.0])
        c3a.bias[0] = -2.0 ** -31
        prelu.weight.fill_(alpha)
    rng = np.random.RandomState(6)
    x = torch.as_tensor(rng.randn(1, 6, 6, 7).astype(np.float32))
    x[0, 1:4, 1:4, 1:4] = 0.0                      # the voxel's neighbours
    x[0, 1:4, 1, 1] = torch.tensor([1.0, 2.0 ** -15, 1.0])
    dz = torch.as_tensor(rng.randn(1, 6, 6, 7).astype(np.float32))
    return x, dz, (c3a, c3b, prelu)


def test_cond_pair_backward_products_f32_takes_the_cuda_core_slope():
    """Near PReLU's kink the 3xTF32 model takes the slope of the pre that
    the f32 forward sums (``pre_f32_taps``): a pre of -2^-31 there, +2^-31
    exactly.  Its gradients match the f64 gradient with the forward's branch
    within the f32 bounds, and not the one with the exact branch (dx off by
    far more than its bound there)."""
    x, dz, mods = _kink_pair()
    pre = cpair.pre_f32_taps(x, mods[0].weight, mods[0].bias)
    assert pre[0, 0, 2, 2, 2].item() == -2.0 ** -31
    assert pre[0, 0, 2, 2, 2].abs().item() < cpair.KINK
    got = cpair.cond_pair_backward_products(x, dz, *mods)
    ref = cpair.cond_pair_backward_f64(x, dz, *mods)
    _assert_within(got, ref, F32_BOUND, "cond pair f32 at the kink")
    # the exact branch: autograd through F.prelu in f64
    with torch.enable_grad():
        xr = x.double().requires_grad_()
        wa, ba, wb, bb, al = [t.detach().double() for t in
                              cpair._pair_params(*mods)]
        v = xr.permute(0, 2, 3, 1).unsqueeze(1)
        y = torch.nn.functional.prelu(
            torch.nn.functional.conv3d(v, wa, ba, padding=1), al)
        z = torch.nn.functional.conv3d(y, wb, bb, padding=1)
        dx_exact, = torch.autograd.grad(z[:, 0].permute(0, 3, 1, 2), xr,
                                        dz.double())
    d = (got[0].double() - dx_exact).abs().max().item()
    assert d > 10 * F32_BOUND[0] * dx_exact.abs().max().item()
