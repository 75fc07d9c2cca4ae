"""Both subnet towers of the PyTorch port at tower widths other than the
flagship's 64 (20: not a multiple of 8; 72 and 128: above 64), on the CPU:

- the plain versions against the JAX package's references with the same
  weights: the float tower against ``cwfa_tpu.flow.subnets`` (1e-5 of
  max|ref|), the int8 tower against ``cwfa_tpu.ops.qtower``'s oracle on the
  pair of two towers (rtol = atol = 2e-4, tests/test_qtower.py's bound);
- the kernels' weight packs of those widths: the canvases' padded channels
  (the width rounded up to a multiple of 8) carry zero weights and zero
  biases, and the real ones sit where the kernels read them.

The CUDA kernels themselves are held to the plain versions at these widths
on the card by chip_smoke.py.  Every elementwise tensor stays under 32,768
elements.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.flow import subnets as jsubnets
from cwfa_tpu.models.cwf import pair_tower_params
from cwfa_tpu.ops import qtower as jq

from cwfa_tpu_torch.engine.jax_params import (load_jax_params,
                                              split_jax_tower_pair)
from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d
from cwfa_tpu_torch.ops import btower as tbt
from cwfa_tpu_torch.ops import qtower as tq

WIDTHS = (20, 72, 128)
B, CIN, NOUT, H, W = 1, 5, 10, 8, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _module(params, width):
    m = WaveletFlowSubnet2d(CIN, NOUT, n_ch=width)
    load_jax_params(m, _np(params), {})
    return m.eval()


@pytest.mark.parametrize("width", WIDTHS)
def test_float_tower_matches_jax_subnet(width):
    params = jsubnets.init_wavelet_flow_subnet2d(jax.random.PRNGKey(width),
                                                 CIN, NOUT, n_ch=width)
    x = np.random.RandomState(width).randn(B, CIN, H, W).astype(np.float32)
    want = np.asarray(jsubnets.wavelet_flow_subnet2d(params, jnp.asarray(x)))
    module = _module(params, width)
    assert tbt.kernel_instance(torch.float32, width, CIN, NOUT) == tbt.CUDA_CORES
    with torch.no_grad():
        got = tbt.fused_float_tower(torch.from_numpy(x), module).numpy()
    assert got.shape == want.shape == (B, NOUT, H, W)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("width", WIDTHS)
def test_float_tower_pack_pads_the_width_with_zeros(width):
    m = WaveletFlowSubnet2d(CIN, NOUT, n_ch=width)
    cp = width + (-width) % 8
    pack, biases = tbt.pack_float_tower(m)
    off = boff = 0
    for name in tbt.CONVS:
        conv = getattr(m, name)
        w = conv.weight.detach()
        o, i, k, _ = w.shape
        ip = i + i % 2 if name == "b1" else cp
        op = o + (-o) % 8
        blk = pack[off:off + k * k * ip * op].reshape(k * k, ip, op)
        off += blk.numel()
        assert torch.equal(blk[:, :i, :o],
                           w.permute(2, 3, 1, 0).reshape(k * k, i, o)), name
        assert not blk[:, i:].any() and not blk[:, :, o:].any(), name
        nb = o if name == "b7" else cp              # b1..b6b: the padded width
        assert torch.equal(biases[boff:boff + o], conv.bias.detach()), name
        assert not biases[boff + o:boff + nb].any(), name
        boff += nb
    assert off == pack.numel() and boff == biases.numel()


@pytest.fixture(scope="module", params=WIDTHS)
def int8_pair(request):
    width = request.param
    ka, kb, kx = jax.random.split(jax.random.PRNGKey(width), 3)
    pa = jsubnets.init_wavelet_flow_subnet2d(ka, CIN, NOUT, n_ch=width)
    pb = jsubnets.init_wavelet_flow_subnet2d(kb, CIN, NOUT, n_ch=width)
    paired = pair_tower_params(pa, pb)
    x = np.array(jax.random.normal(kx, (B, CIN, H, W), jnp.float32))
    scales = jq.pair_tower_calibrate(paired, jnp.asarray(x))
    qw = jq.quantize_pair_tower(paired, scales)
    inv = (1.0 / scales[0, :CIN]).astype(jnp.float32)
    xq = jnp.clip(jnp.round(jnp.asarray(x) * inv[None, :, None, None]),
                  -127, 127).astype(jnp.int8)
    oracle = np.asarray(jq.quantized_pair_tower_reference(qw, scales, xq))
    split = split_jax_tower_pair(_np({"qw": qw, "scales": scales}), CIN)
    return width, (pa, pb), x, np.asarray(xq), oracle, split


def test_int8_tower_matches_jax_oracle(int8_pair):
    width, _, x, xq_j, oracle, split = int8_pair
    assert tq.kernel_instance(width, CIN, NOUT) == tq.DP4A
    xq = tq.quantize_input(torch.from_numpy(x), split[0]["scales"][0])
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    outs = [tq.fused_tower(xq, t["qw"], t["scales"], out_dtype=torch.float32)
            for t in split]
    got = torch.cat(outs, dim=1).numpy()
    assert got.shape == oracle.shape == (B, 2 * NOUT, H, W)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


def test_int8_tower_pack_pads_the_width_with_zeros(int8_pair):
    width, params, x, _, _, split = int8_pair
    cp = width + (-width) % 8
    for p, want in zip(params, split):
        m = _module(p, width)
        scales = tq.tower_calibrate(m, torch.from_numpy(x))
        # the f32 trace's sums (up to 9 x 128 terms) run in another order
        np.testing.assert_allclose(scales.numpy(), want["scales"].numpy(),
                                   rtol=1e-5)
        # the same scales: the same int8 weights, in the same layout
        qw = tq.quantize_tower(m, want["scales"])
        assert set(qw) == set(want["qw"]) and "wg" not in qw
        for name in tq.WEIGHTS:
            assert torch.equal(qw[name], want["qw"][name]), name
            k = 1 if name in ("w1", "w2b", "w4b", "w6b") else 3
            i = CIN if name == "w1" else width
            o = NOUT if name == "w7" else width
            wk = qw[name]
            assert tuple(wk.shape) == (
                k * k, -(-CIN // 4) if name == "w1" else cp // 4,
                o + (-o) % 8, 4), name
            flat = wk.permute(0, 1, 3, 2).reshape(k * k, -1, wk.shape[2])
            assert not flat[:, i:].any() and not flat[:, :, o:].any(), name
            assert tq.unpack_weight(wk, i, o).shape == (o, i, k, k)
        assert qw["sw"].shape == qw["bias"].shape == (7, width)
