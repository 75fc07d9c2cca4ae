"""The tensor-core instances of the training backward kernels, on the CPU:
their weight packs unpacked in plain PyTorch, the wrappers' choice of
instance, and plain-PyTorch models of their numerics (the gradient operand
rounded to bf16 before each product; ELU' from the stored canvas) held to
the plain backward within the chip check's bf16 bound (``BWD_BOUND``,
2^-5 of max|ref| for every gradient).  Tiny shapes: every elementwise
tensor below 32,768 elements."""

import numpy as np
import pytest
import torch

from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d
from cwfa_tpu_torch.ops import btower
from cwfa_tpu_torch.ops import cond_pair as cpair

BF16_BOUND = 2.0 ** -5          # chip_smoke.BWD_BOUND for bf16, dx and dW


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
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            assert g is None, f"{what} gradient {i}"
            continue
        d = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        assert d <= bound * scale, (
            f"{what} gradient {i}: max|d| {d:.3e} over {bound:.3e} x "
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
    (torch.float32, 64, 72, 24, btower.CUDA_CORES),
    (torch.bfloat16, 20, 5, 10, btower.CUDA_CORES),
    (torch.bfloat16, 72, 12, 24, btower.CUDA_CORES),
    (torch.float32, 64, 48, 96, btower.CUDA_CORES),
    (torch.float32, 20, 5, 10, btower.CUDA_CORES),
])
def test_float_tower_bwd_instance(dtype, c, cin, nout, want):
    assert btower.bwd_instance(dtype, c, cin, nout) == want


@pytest.mark.parametrize("dtype,k,want", [
    (torch.bfloat16, 32, cpair.TENSOR_CORES),
    (torch.bfloat16, 16, cpair.CUDA_CORES),
    (torch.bfloat16, 64, cpair.CUDA_CORES),
    (torch.float32, 32, cpair.CUDA_CORES),
])
def test_cond_pair_bwd_instance(dtype, k, want):
    assert cpair.bwd_instance(dtype, k) == want


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
