"""The port's float subnet tower (cwfa_tpu_torch.ops.btower) on the CPU,
against the JAX package's bf16 tower kernel and its oracle
(cwfa_tpu.ops.btower) and its f32 subnets (cwfa_tpu.flow.subnets), with the
same weights carried across by load_jax_params.

- bf16: the plain version of one tower against ``pair_tower_bf16_reference``
  on that tower, and two towers against ``fused_pair_tower_bf16`` in
  interpret mode on the pair (``pair_tower_params``), each half of its
  (oa|ob) output against its tower; tests/test_btower.py's bound (atol 2e-3,
  rtol 2e-2: the f32 sums run in another order).  The JAX side gets the
  biases rounded to bf16, as the port's bf16 module holds them.
- f32: ``WaveletFlowSubnet2d`` and ``WaveletFlowSubnet2dFirst`` against
  ``wavelet_flow_subnet2d`` and ``_first``, 1e-5 of max|ref|.
- The image border (rows and columns within the 4-pixel halo of the four
  3x3 convs) is checked on its own, where the SAME padding shows.

Every elementwise tensor stays under 32,768 elements (PERF.md).  On the CPU
``fused_float_tower`` runs the plain version and counts no launch; the CUDA
kernel is held to the plain version on the card by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.flow import subnets as jsubnets
from cwfa_tpu.models.cwf import pair_tower_params
from cwfa_tpu.ops import btower as jbt

from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.flow.subnets import (WaveletFlowSubnet2d,
                                         WaveletFlowSubnet2dFirst)
from cwfa_tpu_torch.ops import btower as tbt

B, H, W, CIN, NCH = 2, 16, 16, 12, 16        # (B, NCH, H, W): 8,192 elements
BORDERS = {"top": np.s_[..., :5, :], "bottom": np.s_[..., -5:, :],
           "left": np.s_[..., :, :5], "right": np.s_[..., :, -5:]}


def _bf16_round(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)), tree)


def _module(params, cls=WaveletFlowSubnet2d, c_out=2 * CIN):
    m = cls(CIN if cls is WaveletFlowSubnet2d else 2 * CIN, c_out, n_ch=NCH)
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, params), {})
    return m.eval()


@pytest.fixture(scope="module")
def towers():
    ka, kb, kx = jax.random.split(jax.random.PRNGKey(0), 3)
    pa = _bf16_round(jsubnets.init_wavelet_flow_subnet2d(ka, CIN, 2 * CIN,
                                                         n_ch=NCH))
    pb = _bf16_round(jsubnets.init_wavelet_flow_subnet2d(kb, CIN, 2 * CIN,
                                                         n_ch=NCH))
    x = np.array(jax.random.normal(kx, (B, CIN, H, W), jnp.float32)
                 .astype(jnp.bfloat16).astype(jnp.float32))
    mods = [_module(p).to(torch.bfloat16) for p in (pa, pb)]
    got = [tbt.fused_float_tower(torch.from_numpy(x).to(torch.bfloat16), m)
           for m in mods]
    assert all(g.dtype == torch.bfloat16 for g in got)     # x's dtype
    return pa, pb, x, [g.detach().float().numpy() for g in got]


def _assert_btower_close(got, want):
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-2)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_bf16_matches_jax_oracle(towers):
    pa, _, x, got = towers
    want = np.asarray(jbt.pair_tower_bf16_reference(_jax(pa), jnp.asarray(x)))
    assert got[0].shape == want.shape == (B, 2 * CIN, H, W)
    _assert_btower_close(got[0], want)


def _pallas_pair(pa, pb, x):
    paired = pair_tower_params(_jax(pa), _jax(pb))
    out = jbt.fused_pair_tower_bf16(jbt.prep_input_bf16(jnp.asarray(x)),
                                    jbt.pack_pair_tower_bf16(paired), h=H,
                                    w=W, th=8, tw=16, out_dtype=jnp.float32,
                                    interpret=True)
    return np.transpose(np.asarray(out), (0, 3, 1, 2))


@pytest.fixture(scope="module")
def pallas_pair(towers):
    pa, pb, x, _ = towers
    return _pallas_pair(pa, pb, x)


def test_bf16_matches_pallas_pair_interpret(towers, pallas_pair):
    _, _, _, got = towers
    half = 2 * CIN
    _assert_btower_close(got[0], pallas_pair[:, :half])
    _assert_btower_close(got[1], pallas_pair[:, half:])


@pytest.mark.parametrize("side", sorted(BORDERS))
def test_bf16_border_matches_jax(towers, pallas_pair, side):
    pa, _, x, got = towers
    sl = BORDERS[side]
    want = np.asarray(jbt.pair_tower_bf16_reference(_jax(pa), jnp.asarray(x)))
    _assert_btower_close(got[0][sl], want[sl])
    _assert_btower_close(got[1][sl], pallas_pair[:, 2 * CIN:][sl])


@pytest.mark.parametrize("first", [False, True])
def test_f32_matches_jax_subnet(first):
    key = jax.random.PRNGKey(3)
    if first:
        params = jsubnets.init_wavelet_flow_subnet2d_first(key, 2 * CIN,
                                                           2 * CIN, n_ch=NCH)
        fn = jsubnets.wavelet_flow_subnet2d_first
        module = _module(params, WaveletFlowSubnet2dFirst, 2 * CIN)
    else:
        params = jsubnets.init_wavelet_flow_subnet2d(key, CIN, 2 * CIN,
                                                     n_ch=NCH)
        fn = jsubnets.wavelet_flow_subnet2d
        module = _module(params)
    cin = 2 * CIN if first else CIN
    x = np.random.RandomState(4).randn(B, cin, H, W).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(fn(_jax(params), jnp.asarray(x)))
    launches = tbt.fused_float_tower.launches
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert tbt.fused_float_tower.launches == launches  # CPU: plain, no launch
    scale = np.abs(want).max()
    for sl in [np.s_[...]] + list(BORDERS.values()):
        assert np.abs(got[sl] - want[sl]).max() <= 1e-5 * scale


def _conv_blocks(m, pack, size):
    """(name, weight, the conv's flat block of the pack) in pack order."""
    off = 0
    for name in tbt.CONVS:
        w = getattr(m, name).weight.detach()
        n = size(name, w)
        yield name, w, pack[off:off + n]
        off += n
    assert off == pack.numel()


def test_pack_layout_and_reuse():
    m = WaveletFlowSubnet2d(3, 6, n_ch=8)           # f32, 8 wide: CUDA cores
    assert tbt.kernel_instance(torch.float32, 8, 3, 6) == tbt.CUDA_CORES
    pack, biases = tbt.pack_float_tower(m)
    assert tbt.pack_float_tower(m)[0] is pack       # built once

    def size(name, w):
        o, i, k, _ = w.shape
        return k * k * (i + i % 2) * (o + (-o) % 8)

    for name, w, blk in _conv_blocks(m, pack, size):
        o, i, k, _ = w.shape
        blk = blk.reshape(k * k, i + i % 2, o + (-o) % 8)
        assert torch.equal(blk[:, :i, :o],
                           w.permute(2, 3, 1, 0).reshape(k * k, i, o))
        assert not blk[:, i:].any() and not blk[:, :, o:].any()
    assert torch.equal(biases, torch.cat([getattr(m, n).bias.detach()
                                          for n in tbt.CONVS]))
    with torch.no_grad():
        m.b4a.weight.mul_(2.0)                      # a weight changed in place
    repacked = tbt.pack_float_tower(m)[0]
    assert repacked is not pack and not torch.equal(repacked, pack)

    # bf16, 64 wide: the wgmma layout, B as the tensor cores read it from
    # shared memory: [tap][Cin / 8][Cout][8], Cin padded to 16, b7's Cout to
    # the next width the kernel is built for
    m = WaveletFlowSubnet2d(5, 10, n_ch=64).to(torch.bfloat16)
    assert tbt.kernel_instance(torch.bfloat16, 64, 5, 10) == tbt.WGMMA_BF16
    pack, biases = tbt.pack_float_tower(m)
    assert pack.dtype == torch.bfloat16 and biases.dtype == torch.float32

    def dims(name, w):
        o, i, k, _ = w.shape
        return k * k, i + (-i) % 16, 16 if name == "b7" else o

    def size16(name, w):
        taps, ip, op = dims(name, w)
        return taps * ip * op

    for name, w, blk in _conv_blocks(m, pack, size16):
        o, i, k, _ = w.shape
        taps, ip, op = dims(name, w)
        blk = blk.reshape(taps, ip // 8, op, 8).permute(0, 2, 1, 3)
        blk = blk.reshape(taps, op, ip)             # [tap][Cout][Cin]
        assert torch.equal(blk[:, :o, :i],
                           w.permute(2, 3, 0, 1).reshape(taps, o, i)), name
        assert not blk[:, o:].any() and not blk[:, :, i:].any()


@pytest.mark.parametrize("cin,nout", [(5, 10), (48, 96), (40, 33)])
def test_mma_fragment_layout(cin, nout):
    """The 3xTF32 pack of the f32 wgmma instance: per tap and per chunk of
    32 input channels the high parts [chunk / 4][Cout][4] and then the low
    parts; both are TF32 values and hi + lo is the f32 weight to 2^-21; the
    1x1 of a residual block reads the input channels of every 8 in the order
    its 3x3's sums sit in a thread."""
    assert tbt.kernel_instance(torch.float32, 64, cin, nout) == tbt.WGMMA_3XTF32
    assert tbt.kernel_instance(torch.float32, 64, 65, nout) == tbt.CUDA_CORES
    assert tbt.kernel_instance(torch.float32, 64, cin, 97) == tbt.CUDA_CORES
    assert tbt.kernel_instance(torch.bfloat16, 16, cin, nout) == tbt.CUDA_CORES
    m = WaveletFlowSubnet2d(cin, nout, n_ch=64)
    pack = tbt.pack_float_tower(m)[0]
    assert pack.dtype == torch.float32
    np7 = next(n for n in tbt.WGMMA_NOUT if n >= nout)

    def dims(name, w):
        o, i, k, _ = w.shape
        return k * k, i + (-i) % 8, np7 if name == "b7" else o

    def size(name, w):
        taps, ip, op = dims(name, w)
        return 2 * taps * ip * op

    for name, w, blk in _conv_blocks(m, pack, size):
        o, i, k, _ = w.shape
        taps, ip, op = dims(name, w)
        want = torch.zeros((taps, op, ip))
        want[:, :o, :i] = w.permute(2, 3, 0, 1).reshape(taps, o, i)
        if name in ("b2b", "b4b", "b6b"):
            want = want.reshape(taps, op, ip // 8, 8)[
                ..., [0, 2, 4, 6, 1, 3, 5, 7]].reshape(taps, op, ip)
        off = 0
        for tap in range(taps):
            for c0 in range(0, ip, tbt.TF32_CHUNK):
                kc = min(tbt.TF32_CHUNK, ip - c0)
                hi, lo = (blk[off + j * kc * op:off + (j + 1) * kc * op]
                          .reshape(kc // 4, op, 4).permute(1, 0, 2)
                          .reshape(op, kc) for j in range(2))
                off += 2 * kc * op
                for part in (hi, lo):               # TF32: 13 low bits clear
                    assert not (part.contiguous().view(torch.int32)
                                & 0x1fff).any()
                ref = want[tap, :, c0:c0 + kc]
                assert (hi.double() + lo.double() - ref.double()).abs().max() \
                    <= 2.0 ** -21 * ref.abs().max()
                assert ((hi - ref).abs() <= 2.0 ** -11 * ref.abs()).all()
        assert off == blk.numel()


_CONV2D = torch.nn.functional.conv2d


def _tf32_mask(v):
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _conv_3xtf32(x, w, padding):
    """A conv as the f32 wgmma instance computes it: x and w split into a
    TF32 high part and the remainder (the remainder of x cut to TF32 by the
    tensor cores), hi*hi + hi*lo + lo*hi, f32 sums."""
    xh = tbt.split_tf32(x)[0]
    xl = _tf32_mask(x - xh)
    wh, wl = tbt.split_tf32(w)
    return (_CONV2D(xl, wh, padding=padding) + _CONV2D(xh, wl, padding=padding)
            + _CONV2D(xh, wh, padding=padding))


@pytest.mark.parametrize("k", [1, 3])
def test_3xtf32_conv_holds_the_f32_bound(k):
    """One 64 -> 64 conv of the tower (K = 576 for the 3x3) through the
    three TF32 products against the f32 conv: <= 1e-5 of max|ref|, the
    kernel's bound, where one TF32 product alone misses it."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(1, 64, 12, 12).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, 64, k, k) / np.sqrt(64 * k * k))
                         .astype(np.float32))
    ref = torch.nn.functional.conv2d(x.double(), w.double(), padding=k // 2)
    f32 = torch.nn.functional.conv2d(x, w, padding=k // 2)
    got = _conv_3xtf32(x, w, k // 2)
    scale = ref.abs().max()
    assert (got - f32).abs().max() <= 1e-5 * f32.abs().max()
    assert (got.double() - ref).abs().max() <= 2e-6 * scale
    one = torch.nn.functional.conv2d(_tf32_mask(x), _tf32_mask(w),
                                     padding=k // 2)
    assert (one.double() - ref).abs().max() > 1e-5 * scale


def test_3xtf32_tower_holds_the_f32_bound(monkeypatch):
    """The whole tower with every conv through the three TF32 products
    against the plain f32 version: <= 1e-5 of max|ref|."""
    m = WaveletFlowSubnet2d(CIN, 2 * CIN, n_ch=64).eval()
    x = torch.from_numpy(np.random.RandomState(8).randn(1, CIN, 12, 12)
                         .astype(np.float32))
    with torch.no_grad():
        want = tbt.float_tower_reference(m, x)

        def conv2d(v, w, bias=None, padding=0):
            out = _conv_3xtf32(v, w, padding)
            return out if bias is None else out + bias[None, :, None, None]

        monkeypatch.setattr(tbt.F, "conv2d", conv2d)
        got = tbt.float_tower_reference(m, x)
        monkeypatch.undo()
    assert not torch.equal(got, want)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_fused_float_tower_rejects_what_the_kernel_does_not_take():
    m = WaveletFlowSubnet2d(CIN, 2 * CIN, n_ch=NCH).eval()
    x = torch.randn(1, CIN, 8, 8)
    with pytest.raises(TypeError):                  # f64
        tbt.fused_float_tower(x.double(), m.double())
    with pytest.raises(TypeError):                  # unsupported dtype
        tbt.fused_float_tower(x.half(), m.half())
    with pytest.raises(TypeError):                  # weights neither x's
        tbt.fused_float_tower(x.to(torch.bfloat16), m.half())  # dtype nor f32
    with pytest.raises(ValueError):                 # wrong Cin
        tbt.fused_float_tower(x[:, :5].contiguous(), m.float())
    with pytest.raises(ValueError):                 # not contiguous
        tbt.fused_float_tower(x.transpose(2, 3), m)
    with pytest.raises(ValueError):                 # not (B, Cin, H, W)
        tbt.fused_float_tower(x[0], m)
    with pytest.raises(RuntimeError):               # neither CPU nor CUDA
        tbt.fused_float_tower(x.to("meta"), m.to("meta"))
