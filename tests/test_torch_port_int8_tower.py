"""The port's int8 convolutions and int8 tower (cwfa_tpu_torch.ops.int8_conv,
cwfa_tpu_torch.ops.qtower) on the CPU, against int64 numpy and the JAX
package's int8 pair tower (cwfa_tpu.ops.qtower).

- int8_conv: exact (integer sums), against an int64 numpy reference.
- Tower pack parity, at tests/test_qtower.py's sizes: scales within rtol
  1e-6 (the f32 trace convs sum in another order in XLA and PyTorch), int8
  weights equal.
- Tower math, with JAX's packs carried across: the port's plain version for
  both towers against JAX's oracle and its Pallas kernel in interpret mode,
  within rtol = atol = 2e-4, the bound of tests/test_qtower.py.

- The weight pack of the s8 ``wgmma`` instance (64-wide towers): a CPU
  emulation that walks the pack in the kernel's order of slices and
  fragments reproduces the plain version to the bit.

On the CPU ``fused_tower`` runs the plain version and counts no launch; the
CUDA kernels are held to the plain version on the card by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.flow.subnets import init_wavelet_flow_subnet2d
from cwfa_tpu.models.cwf import pair_tower_params
from cwfa_tpu.ops import qtower as jq

from cwfa_tpu_torch.engine.jax_params import (load_jax_params,
                                              split_jax_tower_pair)
from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d
from cwfa_tpu_torch.ops import int8_conv as ic
from cwfa_tpu_torch.ops import qtower as tq

B, CIN, H, W, NCH, NOUT1 = 2, 6, 16, 16, 8, 12  # tests/test_qtower.py


def _i8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _conv_i64(q, w, pad):
    q = np.pad(q.astype(np.int64), ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    k = w.shape[-1]
    ho, wo = q.shape[2] - k + 1, q.shape[3] - k + 1
    out = np.zeros((q.shape[0], w.shape[0], ho, wo), np.int64)
    for dy in range(k):
        for dx in range(k):
            out += np.einsum("bihw,oi->bohw", q[:, :, dy:dy + ho, dx:dx + wo],
                             w[:, :, dy, dx].astype(np.int64))
    return out


@pytest.mark.parametrize("k,cin,cout", [(3, 5, 7), (3, 16, 8), (1, 6, 3),
                                        (1, 24, 16)])
def test_conv2d_int8_is_exact(k, cin, cout):
    rng = np.random.RandomState(k * 100 + cin)
    q, w = _i8(rng, 2, cin, 7, 9), _i8(rng, cout, cin, k, k)
    got = ic.conv2d_int8(torch.from_numpy(q), torch.from_numpy(w), k // 2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _conv_i64(q, w, k // 2))


def test_conv_transpose2x2_int8_is_exact():
    rng = np.random.RandomState(3)
    q, w = _i8(rng, 2, 12, 5, 3), _i8(rng, 12, 6, 2, 2)   # w: (I, O, 2, 2)
    want = np.zeros((2, 6, 10, 6), np.int64)
    for dy in range(2):
        for dx in range(2):
            want[:, :, dy::2, dx::2] = np.einsum(
                "bihw,io->bohw", q.astype(np.int64),
                w[:, :, dy, dx].astype(np.int64))
    got = ic.conv_transpose2x2_int8(torch.from_numpy(q), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantizers_round_half_to_even_and_clip():
    v = torch.tensor([0.5, 1.5, 2.5, -0.5, 300.0, -300.0]).reshape(1, 6, 1, 1)
    ones = torch.ones(6)
    want = [0, 2, 2, 0, 127, -127]
    assert ic.quantize_div(v, ones).flatten().tolist() == want
    assert ic.quantize_mul(v, ones).flatten().tolist() == want


def test_weight_layout_round_trips():
    rng = np.random.RandomState(4)
    for o, i, k in ((12, 8, 3), (8, 6, 1), (5, 3, 3)):
        w = torch.from_numpy(_i8(rng, o, i, k, k))
        wk = tq.pack_weight(w)
        assert tuple(wk.shape) == (k * k, -(-i // 4), o + (-o) % 8, 4)
        assert torch.equal(tq.unpack_weight(wk, i, o), w)


@pytest.fixture(scope="module")
def towers():
    ka, kb, kx = jax.random.split(jax.random.PRNGKey(0), 3)
    pa = init_wavelet_flow_subnet2d(ka, CIN, NOUT1, n_ch=NCH)
    pb = init_wavelet_flow_subnet2d(kb, CIN, NOUT1, n_ch=NCH)
    paired = pair_tower_params(pa, pb)
    x = np.asarray(jax.random.normal(kx, (B, CIN, H, W), jnp.float32))
    scales = jq.pair_tower_calibrate(paired, jnp.asarray(x))
    qw = jq.quantize_pair_tower(paired, scales)
    pair = jax.tree_util.tree_map(np.asarray, {"qw": qw, "scales": scales})
    mods = []
    for p in (pa, pb):
        m = WaveletFlowSubnet2d(CIN, NOUT1, n_ch=NCH)
        load_jax_params(m, jax.tree_util.tree_map(np.asarray, p), {})
        mods.append(m.eval())
    return mods, x, pair, split_jax_tower_pair(pair, CIN)


def test_tower_pack_matches_jax(towers):
    mods, x, _, want = towers
    for m, w in zip(mods, want):
        scales = tq.tower_calibrate(m, torch.from_numpy(x))
        np.testing.assert_allclose(scales.numpy(), w["scales"].numpy(),
                                   rtol=1e-6)
        qw = tq.quantize_tower(m, scales)
        assert set(qw) == set(w["qw"])
        for k in qw:
            if qw[k].dtype == torch.int8:
                assert torch.equal(qw[k], w["qw"][k]), k
            else:
                np.testing.assert_allclose(qw[k].numpy(),
                                           w["qw"][k].numpy(), rtol=1e-6,
                                           err_msg=k)


def test_tower_math_matches_jax_oracle_and_kernel(towers):
    _, x, pair, split = towers
    scales = jnp.asarray(pair["scales"])
    qw = jax.tree_util.tree_map(jnp.asarray, pair["qw"])
    inv = (1.0 / scales[0, :CIN]).astype(jnp.float32)
    xq_j = jnp.clip(jnp.round(jnp.asarray(x) * inv[None, :, None, None]),
                    -127, 127).astype(jnp.int8)
    oracle = np.asarray(jq.quantized_pair_tower_reference(qw, scales, xq_j))
    kern = jq.fused_pair_tower(jq.quantize_input(jnp.asarray(x), scales[0]),
                               qw, scales, h=H, w=W, th=4,
                               out_dtype=jnp.float32, interpret=True)
    kern = np.transpose(np.asarray(kern), (0, 3, 1, 2))

    xq = tq.quantize_input(torch.from_numpy(x), split[0]["scales"][0])
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    launches = tq.fused_tower.launches
    outs = [tq.fused_tower(xq, t["qw"], t["scales"], out_dtype=torch.float32)
            for t in split]
    assert tq.fused_tower.launches == launches      # CPU: plain, no launch
    got = torch.cat(outs, dim=1).numpy()
    assert got.shape == (B, 2 * NOUT1, H, W)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-4)
    ref = tq.quantized_tower_reference(split[0]["qw"], split[0]["scales"], xq)
    np.testing.assert_array_equal(outs[0].numpy(), ref.numpy())
    bf = tq.fused_tower(xq, split[0]["qw"], split[0]["scales"])
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())


def test_int8_tower_close_to_f32_tower(towers):
    """Quantization error of one tower against its f32 forward, the bound
    of tests/test_qtower.py:54-63."""
    mods, x, _, _ = towers
    m = mods[0]
    xt = torch.from_numpy(x)
    scales = tq.tower_calibrate(m, xt)
    qw = tq.quantize_tower(m, scales)
    got = tq.fused_tower(tq.quantize_input(xt, scales[0]), qw, scales,
                         out_dtype=torch.float32)
    with torch.no_grad():
        want = m(xt)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel < 0.06, rel


def test_fused_tower_rejects_what_the_kernel_does_not_take(towers):
    _, x, _, split = towers
    qw, scales = split[0]["qw"], split[0]["scales"]
    xq = tq.quantize_input(torch.from_numpy(x), scales[0])
    with pytest.raises(ValueError):                 # not int8
        tq.fused_tower(xq.float(), qw, scales)
    with pytest.raises(ValueError):                 # wrong Cin for w1
        tq.fused_tower(xq[:, :2].contiguous(), qw, scales)
    with pytest.raises(TypeError):                  # unsupported out dtype
        tq.fused_tower(xq, qw, scales, out_dtype=torch.float16)
    with pytest.raises(ValueError):                 # wrong scales
        tq.fused_tower(xq, qw, scales[:7])
    with pytest.raises(TypeError):                  # f64 dequant scales
        tq.fused_tower(xq, dict(qw, sw=qw["sw"].double()), scales)
    with pytest.raises(ValueError):                 # bias7 not Nout long
        tq.fused_tower(xq, dict(qw, bias7=qw["bias7"][:3]), scales)
    with pytest.raises(ValueError):                 # a weight left out
        tq.fused_tower(xq, {k: v for k, v in qw.items() if k != "w4b"},
                       scales)
    with pytest.raises(RuntimeError):               # neither CPU nor CUDA
        tq.fused_tower(xq.to("meta"), qw, scales)


def _tower_from_wg_pack(qw, scales, xq, cin, nout):
    """The tower as ``csrc/qtower_wg.cu`` computes it from ``qw["wg"]``:
    the slices in the order the kernel consumes them (b1; per residual block
    the 3x3's nine taps, then the 1x1; b7's nine taps), each the B operand
    [Cin / 16][Cout][16] of an s8 product, the 1x1's A operand being the
    3x3's requantized sums in the order they sit in a thread's registers."""
    c, pack = qw["sw"].shape[1], qw["wg"]
    np7 = next(n for n in tq.WGMMA_NOUT if n >= nout)
    cinp = cin + (-cin) % 32
    order = torch.tensor(tq._SUM_ORDER)
    off = 0

    def operand(k, ipad, opad):
        """The next k x k conv of the pack as OIHW (opad, ipad, k, k)."""
        nonlocal off
        n = k * k * ipad * opad
        blk = pack[off:off + n].reshape(k * k, ipad // 16, opad, 16)
        off += n
        return (blk.permute(2, 1, 3, 0).reshape(opad, ipad, k, k)
                .contiguous())

    def conv(q, w):
        return ic.conv2d_int8(q, w, w.shape[-1] // 2)

    def deq(acc, k):
        return (acc.float() * qw["sw"][k][None, :, None, None]
                + qw["bias"][k][None, :, None, None])

    inv = 1.0 / scales
    quant = lambda v, k: ic.quantize_mul(v, inv[k, :v.shape[1]])
    bf = lambda v: v.to(torch.bfloat16)
    x = torch.nn.functional.pad(xq, (0, 0, 0, 0, 0, cinp - cin))
    res = bf(deq(conv(x, operand(1, cinp, c)), 0))                  # r1
    q = quant(res.float(), 1)
    for blk in range(3):
        ka, kb = 1 + 2 * blk, 2 + 2 * blk
        qa = quant(tq._elu(deq(conv(q, operand(3, c, c)), ka)), ka + 1)
        # a thread's requantized sums fill its A registers in _SUM_ORDER
        a = qa.reshape(qa.shape[0], c // 16, 16, *qa.shape[2:])[:, :, order]
        r = deq(conv(a.reshape(qa.shape), operand(1, c, c)), kb) + res.float()
        e = tq._elu(r)
        if blk < 2:
            res = bf(e)
            e = res.float()
        q = quant(e, kb + 1)
    w7 = operand(3, c, np7)
    assert off == pack.numel() and not w7[nout:].any()
    return (conv(q, w7)[:, :nout].float() * qw["sw7"][None, :, None, None]
            + qw["bias7"][None, :, None, None])


@pytest.mark.parametrize("cin,nout", [(12, 24), (6, 6), (48, 96), (40, 33)])
def test_wgmma_pack_walked_in_kernel_order_is_the_plain_version(cin, nout):
    gen = torch.Generator().manual_seed(cin)
    m = WaveletFlowSubnet2d(cin, nout, n_ch=64).eval()
    from cwfa_tpu_torch.nn import reset_parameters_
    reset_parameters_(m, gen)
    x = torch.randn((1, cin, 9, 7), generator=gen)
    assert tq.kernel_instance(64, cin, nout) == tq.WGMMA_S8
    assert tq.kernel_instance(64, 65, nout) == tq.DP4A
    assert tq.kernel_instance(64, cin, 97) == tq.DP4A
    assert tq.kernel_instance(56, cin, nout) == tq.DP4A
    scales = tq.tower_calibrate(m, x)
    qw = tq.quantize_tower(m, scales)
    np7 = next(n for n in tq.WGMMA_NOUT if n >= nout)
    assert qw["wg"].dtype == torch.int8 and qw["wg"].shape == (
        64 * (cin + (-cin) % 32 + 30 * 64 + 9 * np7),)
    xq = tq.quantize_input(x, scales[0])
    ref = tq.quantized_tower_reference(qw, scales, xq)
    got = _tower_from_wg_pack(qw, scales, xq, cin, nout)
    assert torch.equal(got, ref)
    assert torch.equal(tq.fused_tower(xq, qw, scales, out_dtype=torch.float32),
                       ref)
    with pytest.raises(ValueError):                 # the pack left out
        tq.fused_tower(xq, {k: v for k, v in qw.items() if k != "wg"}, scales)
    with pytest.raises(ValueError):                 # not an instance to ask for
        tq.fused_tower(xq, qw, scales, instance=tq.WGMMA_S8)
    assert torch.equal(tq.fused_tower(xq, qw, scales, out_dtype=torch.float32,
                                      instance=tq.DP4A), ref)


def test_wgmma_pack_from_jax_packs():
    """``split_jax_tower_pair`` on a 64-wide pair carries the wgmma pack
    too, equal to the one built from the same int8 weights."""
    ka, kb, kx = jax.random.split(jax.random.PRNGKey(7), 3)
    pa = init_wavelet_flow_subnet2d(ka, CIN, NOUT1, n_ch=64)
    pb = init_wavelet_flow_subnet2d(kb, CIN, NOUT1, n_ch=64)
    paired = pair_tower_params(pa, pb)
    x = jax.random.normal(kx, (1, CIN, 8, 8), jnp.float32)
    scales = jq.pair_tower_calibrate(paired, x)
    pair = jax.tree_util.tree_map(
        np.asarray, {"qw": jq.quantize_pair_tower(paired, scales),
                     "scales": scales})
    for t in split_jax_tower_pair(pair, CIN):
        convs = {k: tq.unpack_weight(t["qw"][k], CIN if k == "w1" else 64,
                                     NOUT1 if k == "w7" else 64)
                 for k in tq.WEIGHTS}
        assert torch.equal(t["qw"]["wg"], tq.pack_tower_wg(convs))
        xq = tq.quantize_input(torch.from_numpy(np.array(x)), t["scales"][0])
        assert torch.equal(
            _tower_from_wg_pack(t["qw"], t["scales"], xq, CIN, NOUT1),
            tq.quantized_tower_reference(t["qw"], t["scales"], xq))
