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


def test_pack_layout_and_reuse():
    m = WaveletFlowSubnet2d(3, 6, n_ch=8)           # f32: the CUDA-core layout
    pack, biases = tbt.pack_float_tower(m)
    assert tbt.pack_float_tower(m)[0] is pack       # built once
    off = 0
    for name in tbt.CONVS:
        w = getattr(m, name).weight.detach()
        o, i, k, _ = w.shape
        ip, op = i + i % 2, o + (-o) % 8
        blk = pack[off:off + k * k * ip * op].reshape(k * k, ip, op)
        assert torch.equal(blk[:, :i, :o],
                           w.permute(2, 3, 1, 0).reshape(k * k, i, o))
        assert not blk[:, i:].any() and not blk[:, :, o:].any()
        off += blk.numel()
    assert off == pack.numel()
    assert torch.equal(biases, torch.cat([getattr(m, n).bias.detach()
                                          for n in tbt.CONVS]))
    with torch.no_grad():
        m.b4a.weight.mul_(2.0)                      # a weight changed in place
    repacked = tbt.pack_float_tower(m)[0]
    assert repacked is not pack and not torch.equal(repacked, pack)


def test_mma_fragment_layout():
    """The tensor-core pack holds, at [tap][i][j][lane][8], the B fragments
    of mma.sync m16n8k16: value (h, e) of lane l is W[16 j + 8 h + l // 4]
    [16 i + 2 (l % 4) + (e % 2) + 8 (e // 2)]."""
    m = WaveletFlowSubnet2d(5, 10, n_ch=16).to(torch.bfloat16)
    assert tbt.uses_mma(torch.bfloat16, 16)
    assert not tbt.uses_mma(torch.bfloat16, 8)
    assert not tbt.uses_mma(torch.float32, 64)
    pack = tbt.pack_float_tower(m)[0]
    assert pack.dtype == torch.bfloat16
    off = 0
    for name in tbt.CONVS:
        w = getattr(m, name).weight.detach()
        o, i, k, _ = w.shape
        ip, op = i + (-i) % 16, o + (-o) % 16
        blk = pack[off:off + k * k * ip * op].reshape(k * k, ip // 16,
                                                      op // 16, 32, 2, 4)
        off += blk[0].numel() * k * k
        full = torch.zeros((op, ip, k, k), dtype=w.dtype)
        full[:o, :i] = w
        for lane in range(32):
            for h in range(2):
                for e in range(4):
                    n = torch.arange(op // 16)[:, None] * 16 + 8 * h + lane // 4
                    kk = (torch.arange(ip // 16)[None, :] * 16
                          + 2 * (lane % 4) + e % 2 + 8 * (e // 2))
                    want = full[n, kk].permute(2, 3, 1, 0).reshape(
                        k * k, ip // 16, op // 16)
                    assert torch.equal(blk[:, :, :, lane, h, e], want), name
    assert off == pack.numel()


def test_fused_float_tower_rejects_what_the_kernel_does_not_take():
    m = WaveletFlowSubnet2d(CIN, 2 * CIN, n_ch=NCH).eval()
    x = torch.randn(1, CIN, 8, 8)
    with pytest.raises(TypeError):                  # f64
        tbt.fused_float_tower(x.double(), m.double())
    with pytest.raises(TypeError):                  # unsupported dtype
        tbt.fused_float_tower(x.half(), m.half())
    with pytest.raises(TypeError):                  # weights of another dtype
        tbt.fused_float_tower(x.to(torch.bfloat16), m.float())
    with pytest.raises(ValueError):                 # wrong Cin
        tbt.fused_float_tower(x[:, :5].contiguous(), m.float())
    with pytest.raises(ValueError):                 # not contiguous
        tbt.fused_float_tower(x.transpose(2, 3), m)
    with pytest.raises(ValueError):                 # not (B, Cin, H, W)
        tbt.fused_float_tower(x[0], m)
    with pytest.raises(RuntimeError):               # neither CPU nor CUDA
        tbt.fused_float_tower(x.to("meta"), m.to("meta"))
