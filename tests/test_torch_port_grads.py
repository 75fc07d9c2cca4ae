"""The plain backward of the three kernels that training differentiates,
against ``jax.vjp`` of the JAX package's functions on the CPU: the CAT
affine of ``_cat_chain`` (clamp included), the subnet tower and the cond
nets' 3-D pair ``_conv3d_pair_direct`` (with ``rng=None``, and with the
Dropout3d on the same mask).  On the CPU each wrapper (``cat_affine_
backward``, ``float_tower_backward``, ``cond_pair_backward``) runs its plain
version, autograd through the plain forward; the CUDA kernels are held to it
on the card by ``chip_smoke.py train``.

f32, JAX at ``jax_default_matmul_precision=highest``; every gradient within
1e-4 * max(1, max|ref|) (sums in another order).  Tiny shapes: every
elementwise tensor stays under 32,768 elements.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu import nn as jnn
from cwfa_tpu.flow import coupling as jfc
from cwfa_tpu.flow import subnets as jfs
from cwfa_tpu.models import cond_net as jcond

from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d
from cwfa_tpu_torch.nn import channel_dropout_scale
from cwfa_tpu_torch.ops import btower, cond_pair as tcp, flow_affine as fa
from cwfa_tpu_torch.ops.btower import CONVS


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _x(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def assert_grad_close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound, \
        (float(np.abs(got - want).max()), bound)


@pytest.mark.parametrize("activation", ["ATAN", "TANH", "SIGMOID"])
@pytest.mark.parametrize("rev", [True, False])
def test_cat_affine_backward_matches_jax(activation, rev):
    """d(x) and d(s_raw | t) of the clamped affine (``_cat_chain``,
    ``cwf.py:386-411``, with the clamp of ``_cat_block_st``)."""
    c, clamp = 3, 2.0
    x, dy = _x(2, c, 5, 7, seed=1), _x(2, c, 5, 7, seed=2)
    st = _x(2, 2 * c, 5, 7, seed=3) * 2

    def f(x, st):
        s = clamp * jfc.clamp_fn(activation)(st[:, :c])
        t = st[:, c:]
        return (x - t) * jnp.exp(-s) if rev else jnp.exp(s) * x + t

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(st))
    want = vjp(jnp.asarray(dy))
    got = fa.cat_affine_backward(
        torch.from_numpy(dy), torch.from_numpy(x), torch.from_numpy(st),
        clamp=clamp, activation=activation, rev=rev)
    for g, w in zip(got, want):
        assert_grad_close(g, w)


def _tower_pair(cin, nout, nch, seed):
    """(JAX subnet params as numpy, the port's tower with them)."""
    params = jfs.init_wavelet_flow_subnet2d(jax.random.PRNGKey(seed), cin,
                                            nout, n_ch=nch)
    params = jax.tree_util.tree_map(np.array, params)
    tower = WaveletFlowSubnet2d(cin, nout, n_ch=nch)
    with torch.no_grad():
        for name in CONVS:
            conv = getattr(tower, name)
            conv.weight.copy_(torch.from_numpy(params[name]["w"]))
            conv.bias.copy_(torch.from_numpy(params[name]["b"]))
    return params, tower


@pytest.mark.parametrize("cin,nout", [(4, 8), (4, 4), (3, 6)])
def test_float_tower_backward_matches_jax(cin, nout):
    """dx and every conv's dW, db of the subnet tower (``_tower``,
    ``flow/subnets.py:54-61``), 8 wide; the coupling (Cin -> 2 Cin) and the
    input block's (Cin -> Cin) shapes, and an odd Cin."""
    params, tower = _tower_pair(cin, nout, 8, seed=cin + nout)
    x, dy = _x(2, cin, 9, 11, seed=4), _x(2, nout, 9, 11, seed=5)
    _, vjp = jax.vjp(jfs.wavelet_flow_subnet2d,
                     jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(x))
    dparams, dx_want = vjp(jnp.asarray(dy))
    dx, dws, dbs = btower.float_tower_backward(
        tower, torch.from_numpy(x), torch.from_numpy(dy))
    assert_grad_close(dx, dx_want)
    for name, dw, db in zip(CONVS, dws, dbs):
        assert_grad_close(dw, dparams[name]["w"])
        assert_grad_close(db, dparams[name]["b"])


def test_float_tower_fn_gives_the_master_weights_f32_gradients():
    """Through ``FloatTowerFn`` the tower's parameters get their gradients
    from the backward (f32, the parameters' shapes), equal to the wrapper's."""
    _, tower = _tower_pair(4, 8, 8, seed=9)
    x = torch.from_numpy(_x(1, 4, 6, 7, seed=6)).requires_grad_()
    dy = torch.from_numpy(_x(1, 8, 6, 7, seed=7))
    btower.float_tower(x, tower).backward(dy)
    dx, dws, dbs = btower.float_tower_backward(tower, x.detach(), dy)
    assert torch.equal(x.grad, dx)
    for name, dw, db in zip(CONVS, dws, dbs):
        conv = getattr(tower, name)
        assert conv.weight.grad.dtype == torch.float32
        assert torch.equal(conv.weight.grad, dw)
        assert torch.equal(conv.bias.grad, db)


def _pair_pair(k, seed):
    """(JAX cond-net pair params as numpy, the port's three modules)."""
    rng = np.random.RandomState(seed)
    params = {
        "c3a": {"w": rng.randn(k, 1, 3, 3, 3).astype(np.float32) * 0.3,
                "b": rng.randn(k).astype(np.float32) * 0.1},
        "c3b": {"w": rng.randn(1, k, 3, 3, 3).astype(np.float32) * 0.1,
                "b": rng.randn(1).astype(np.float32) * 0.1},
        "prelu": {"alpha": np.array([0.2], np.float32)}}
    c3a = torch.nn.Conv3d(1, k, 3, padding=1)
    c3b = torch.nn.Conv3d(k, 1, 3, padding=1)
    prelu = torch.nn.PReLU(1)
    with torch.no_grad():
        for mod, name in ((c3a, "c3a"), (c3b, "c3b")):
            mod.weight.copy_(torch.from_numpy(params[name]["w"]))
            mod.bias.copy_(torch.from_numpy(params[name]["b"]))
        prelu.weight.copy_(torch.from_numpy(params["prelu"]["alpha"]))
    return params, (c3a, c3b, prelu)


@pytest.mark.parametrize("dropout", [False, True])
def test_cond_pair_backward_matches_jax(dropout):
    """dx, dW_a, db_a, dW_b, db_b and dalpha of ``_conv3d_pair_direct``
    (``cond_net.py:259-265``); with the Dropout3d, JAX's mask of
    ``dropout3d`` (``where(mask, x / keep, 0)``) handed to the port as the
    (B, K) scale."""
    k, rate = 4, 0.5
    params, mods = _pair_pair(k, seed=8)
    x, dz = _x(2, 5, 6, 7, seed=9), _x(2, 5, 6, 7, seed=10)
    rng = jax.random.PRNGKey(3) if dropout else None
    scale = None
    if dropout:
        mask = np.asarray(jax.random.bernoulli(rng, 1.0 - rate, (2, k)))
        scale = torch.from_numpy(mask.astype(np.float32) / (1.0 - rate))
        assert 0 < mask.sum() < mask.size

    def f(p, out):
        act = lambda u: jnn.prelu(p["prelu"], u)   # noqa: E731
        return jcond._conv3d_pair_direct(p, out, act, rate if dropout else 0.0,
                                         rng)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    z_want, vjp = jax.vjp(f, jp, jnp.asarray(x))
    dp, dx_want = vjp(jnp.asarray(dz))
    z = tcp.cond_pair_reference(torch.from_numpy(x), *mods, scale)
    assert_grad_close(z, z_want)
    dx, dwa, dba, dwb, dbb, dalpha = tcp.cond_pair_backward(
        torch.from_numpy(x), torch.from_numpy(dz), *mods, scale)
    assert_grad_close(dx, dx_want)
    assert_grad_close(dwa, dp["c3a"]["w"])
    assert_grad_close(dba, dp["c3a"]["b"])
    assert_grad_close(dwb, dp["c3b"]["w"])
    assert_grad_close(dbb, dp["c3b"]["b"])
    assert_grad_close(dalpha, dp["prelu"]["alpha"])


def test_channel_dropout_scale():
    """0 or 1/keep per (sample, channel), drawn as ``dropout2d`` draws its
    mask; nothing without a generator or at rate 0; zeros at rate 1."""
    gen = torch.Generator().manual_seed(0)
    scale = channel_dropout_scale((3, 8), 0.5, gen, "cpu")
    mask = torch.rand((3, 8), generator=torch.Generator().manual_seed(0)) < 0.5
    assert torch.equal(scale, mask.float() / 0.5)
    assert channel_dropout_scale((3, 8), 0.5, None, "cpu") is None
    assert channel_dropout_scale((3, 8), 0.0, gen, "cpu") is None
    assert not channel_dropout_scale((3, 8), 1.0, gen, "cpu").any()


@pytest.mark.parametrize("cin,nout", [(6, 12), (72, 24)])
def test_float_tower_backward_products_f32_matches_jax(cin, nout):
    """The 3xTF32 instance's arithmetic (``float_tower_backward_products``
    in f32) of the 64-wide tower against ``jax.vjp`` of
    ``wavelet_flow_subnet2d``: dx within 1e-5 and every dW, db within 1e-4
    of max|JAX's| (the chip check's f32 bounds)."""
    params, tower = _tower_pair(cin, nout, 64, seed=cin + 2 * nout)
    x, dy = _x(1, cin, 6, 7, seed=11), _x(1, nout, 6, 7, seed=12)
    _, vjp = jax.vjp(jfs.wavelet_flow_subnet2d,
                     jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(x))
    dparams, dx_want = vjp(jnp.asarray(dy))
    dx, dws, dbs = btower.float_tower_backward_products(
        tower, torch.from_numpy(x), torch.from_numpy(dy))
    assert_share(dx, dx_want, 1e-5)
    for name, dw, db in zip(CONVS, dws, dbs):
        assert_share(dw, dparams[name]["w"], 1e-4)
        assert_share(db, dparams[name]["b"], 1e-4)


@pytest.mark.parametrize("dropout", [False, True])
def test_cond_pair_backward_products_f32_matches_jax(dropout):
    """The 3xTF32 instance's arithmetic (``cond_pair_backward_products`` in
    f32, K = 32) against ``jax.vjp`` of ``_conv3d_pair_direct``, with and
    without the Dropout3d on JAX's mask: dx within 1e-5, the parameters'
    gradients within 1e-4 of max|JAX's|."""
    k, rate = 32, 0.5
    params, mods = _pair_pair(k, seed=13)
    x, dz = _x(1, 6, 7, 8, seed=14), _x(1, 6, 7, 8, seed=15)
    rng = jax.random.PRNGKey(4) if dropout else None
    scale = None
    if dropout:
        mask = np.asarray(jax.random.bernoulli(rng, 1.0 - rate, (1, k)))
        scale = torch.from_numpy(mask.astype(np.float32) / (1.0 - rate))

    def f(p, out):
        act = lambda u: jnn.prelu(p["prelu"], u)   # noqa: E731
        return jcond._conv3d_pair_direct(p, out, act, rate if dropout else 0.0,
                                         rng)

    _, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(x))
    dp, dx_want = vjp(jnp.asarray(dz))
    dx, dwa, dba, dwb, dbb, dalpha = tcp.cond_pair_backward_products(
        torch.from_numpy(x), torch.from_numpy(dz), *mods, scale)
    assert_share(dx, dx_want, 1e-5)
    for got, want in ((dwa, dp["c3a"]["w"]), (dba, dp["c3a"]["b"]),
                      (dwb, dp["c3b"]["w"]), (dbb, dp["c3b"]["b"]),
                      (dalpha, dp["prelu"]["alpha"])):
        assert_share(got, want, 1e-4)


def assert_share(got, want, share):
    """max|got - want| <= share * max|want| (the chip check's f32 bounds,
    ``BWD_BOUND``)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    d, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert d <= share * scale, (d, share * scale)
