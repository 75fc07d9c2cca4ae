"""The rest of the port's flow library against ``cwfa_tpu.flow`` on the CPU,
from the same numpy inputs and parameters: ActNorm (with its data init),
the 2-D Haar (both channel orders, ``rebalance`` 1 and not), the generic
``SubnetConv``, the oracles of ``flow/core.py``, every function of
``flow/extra.py`` and ``SequenceINN``, the two deprecation shims, the
package's exports, and ``sample_z_rev_like``.

f32; values within 1e-4 of max|ref|, log-dets within 1e-4 * max(1, |ref|)
(as ``tests/test_torch_port_couplings.py``), unless a test says otherwise.
Where JAX draws from a key and the port from a ``torch.Generator``, the
draw is handed to both sides (the Hutchinson probe) or the port is held to
what the draw must satisfy.
"""

import functools
import importlib
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import cwfa_tpu.flow as jflow
from cwfa_tpu.flow import core as jcore
from cwfa_tpu.flow import deprecated as jdep
from cwfa_tpu.flow import extra as jx
from cwfa_tpu.flow import haar as jhaar
from cwfa_tpu.flow import subnets as jsub
from cwfa_tpu.models import cwfa_model as jmodel

import cwfa_tpu_torch.flow as tflow
from cwfa_tpu_torch.engine.jax_params import (export_jax_params,
                                              load_jax_params)
from cwfa_tpu_torch.flow import core as tcore
from cwfa_tpu_torch.flow import deprecated as tdep
from cwfa_tpu_torch.flow import extra as tx
from cwfa_tpu_torch.flow import haar as thaar
from cwfa_tpu_torch.flow import subnets as tsub
from cwfa_tpu_torch.models import cwfa_model as tmodel

# the packages export the function ``actnorm`` under the module's name
jact = importlib.import_module("cwfa_tpu.flow.actnorm")
tact = importlib.import_module("cwfa_tpu_torch.flow.actnorm")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _rand(*shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(tree):
    """numpy / JAX arrays -> torch tensors, through dicts."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def assert_close(got, want, tol=1e-4):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def assert_logdet_close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.broadcast_to(np.asarray(want), got.shape)
    assert got.dtype == np.float32
    assert np.all(np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want)))


def test_exports_match_jax():
    public = {n for n in dir(jflow) if not n.startswith("_")}
    assert public <= set(dir(tflow))


# ----------------------------------------------------------------- ActNorm


def test_actnorm_with_data_init_matches_jax():
    x = _rand(3, 4, 6, 6, seed=1, scale=2.0) + 0.5
    jp = jact.actnorm_data_init(jnp.asarray(x))
    tp = tact.actnorm_data_init(torch.from_numpy(x))
    for k in ("log_scale", "bias"):
        assert_close(tp[k], jp[k], 1e-5)
    init = tact.init_actnorm(4)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in jact.init_actnorm(4).items()}
    for rev in (False, True):
        want, wj = jact.actnorm(jp, jnp.asarray(x), rev=rev)
        got, gj = tact.actnorm(tp, torch.from_numpy(x), rev=rev)
        assert_close(got, want)
        assert_logdet_close(gj, wj)
    y, _ = tact.actnorm(tp, torch.from_numpy(x))
    assert float(y.mean(dim=(0, 2, 3)).abs().max()) < 1e-5
    assert float((y.std(dim=(0, 2, 3), correction=0) - 1).abs().max()) < 1e-4


# ------------------------------------------------------------------ 2-D Haar


@pytest.mark.parametrize("rebalance", [1.0, 0.7])
@pytest.mark.parametrize("order_by_wavelet", [False, True])
def test_haar2d_matches_jax(order_by_wavelet, rebalance):
    x = _rand(2, 3, 8, 6, seed=2)
    kw = {"order_by_wavelet": order_by_wavelet, "rebalance": rebalance}
    for fn_j, fn_t in ((jhaar.haar2d_downsample, thaar.haar2d_downsample),
                       (jhaar.haar2d_upsample, thaar.haar2d_upsample)):
        for rev, inp in ((False, x), (True, _rand(2, 12, 4, 3, seed=3))):
            if fn_t is thaar.haar2d_upsample:
                rev = not rev           # upsample takes the other shapes
            want, wj = fn_j(jnp.asarray(inp), rev=rev, **kw)
            got, gj = fn_t(torch.from_numpy(inp), rev=rev, **kw)
            assert_close(got, want, 1e-6)
            assert_logdet_close(gj, wj)
    y, _ = thaar.haar2d_downsample(torch.from_numpy(x), **kw)
    back, _ = thaar.haar2d_downsample(y, rev=True, **kw)
    if rebalance == 1.0:
        assert_close(back, x, 1e-6)


# --------------------------------------------------------------- SubnetConv


def test_subnet_conv_matches_jax():
    """The port's kaiming init has the reference's scales (weights within
    the fan-in bound, biases 0.1 of torch's default bound); with the same
    weights the forward is JAX's (the weights carried to JAX as numpy, its
    keys those of JAX's init)."""
    mod = tsub.init_subnet_conv(torch.Generator().manual_seed(0), 5, 7, 6)
    for name in ("c1", "c2", "c3", "c4"):
        conv = getattr(mod, name)
        fan = conv.weight[0].numel()
        assert float(conv.weight.abs().max()) <= np.sqrt(6.0 / fan)
        assert float(conv.weight.abs().max()) > 0.5 * np.sqrt(6.0 / fan)
        assert float(conv.bias.abs().max()) <= 0.1 / np.sqrt(fan)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if a is not None else None,
        export_jax_params(mod)[0])
    assert (jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.eval_shape(lambda: jsub.init_subnet_conv(
            jax.random.PRNGKey(0), 5, 7, 6))))
    load_jax_params(mod, jax.tree_util.tree_map(np.asarray, jp), {})
    x = _rand(2, 5, 8, 8, seed=4)
    assert_close(tsub.subnet_conv(mod, torch.from_numpy(x)),
                 jsub.subnet_conv(jp, jnp.asarray(x)))


# ----------------------------------------------------------------- oracles


def test_numerical_logdet_and_check_inverse_match_jax():
    """On ActNorm and the 2-D Haar at rebalance 0.7 (a log-det of its own):
    the Jacobian oracle equals JAX's and the closed form; check_inverse
    agrees with JAX's on the same pair, and catches a broken reverse."""
    p = {"log_scale": _rand(1, 2, 1, 1, seed=5, scale=0.3),
         "bias": _rand(1, 2, 1, 1, seed=6)}
    x = _rand(2, 4, 4, seed=7)
    want = jcore.numerical_logdet(
        lambda u: jact.actnorm(p, u)[0], x)
    got = tcore.numerical_logdet(lambda u: tact.actnorm(_t(p), u)[0], x)
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want))
    assert abs(got - 16 * float(p["log_scale"].sum())) <= 1e-4 * abs(got)
    hd = tcore.numerical_logdet(
        lambda u: thaar.haar2d_downsample(u, rebalance=0.7)[0], x)
    assert abs(hd - float(thaar.haar2d_downsample(
        torch.from_numpy(x[None]), rebalance=0.7)[1][0])) <= 1e-4 * abs(hd)
    xb = _rand(2, 2, 4, 4, seed=8)
    jr = jcore.check_inverse(lambda u: jact.actnorm(p, u),
                             lambda u: jact.actnorm(p, u, rev=True),
                             jnp.asarray(xb))
    tr = tcore.check_inverse(lambda u: tact.actnorm(_t(p), u),
                             lambda u: tact.actnorm(_t(p), u, rev=True),
                             torch.from_numpy(xb))
    assert tr[:2] == (True, True) == tuple(bool(v) for v in jr[:2])
    assert tr[2] <= 1e-5
    bad = tcore.check_inverse(lambda u: tact.actnorm(_t(p), u),
                              lambda u: (u, torch.zeros(2)),
                              torch.from_numpy(xb))
    assert bad[:2] == (False, False)


# -------------------------------------------------------------------- extra


def _fixed(seed, d=4):
    m = _rand(d, d, seed=seed) + 3 * np.eye(d, dtype=np.float32)
    return m, jx.init_fixed_linear(m), tx.init_fixed_linear(m)


def _case_fixed_linear():
    _, jp, tp = _fixed(10)
    x = _rand(3, 4, seed=11)
    return lambda rev: (jx.fixed_linear(jp, jnp.asarray(x), rev),
                        tx.fixed_linear(tp, torch.from_numpy(x), rev))


def _case_fixed_1x1_conv():
    _, jp, tp = _fixed(12)
    x = _rand(2, 4, 3, 5, seed=13)
    return lambda rev: (jx.fixed_1x1_conv(jp, jnp.asarray(x), rev),
                        tx.fixed_1x1_conv(tp, torch.from_numpy(x), rev))


def _shape_case(jfn, tfn, fwd_shape, rev_shape, **kw):
    def run(rev):
        x = _rand(*(rev_shape if rev else fwd_shape), seed=14 + rev)
        return (jfn(jnp.asarray(x), rev=rev, **kw),
                tfn(torch.from_numpy(x), rev=rev, **kw))
    return run


def _case_householder():
    vs = _rand(3, 5, seed=16, scale=0.2)
    x = _rand(4, 5, seed=17)
    return lambda rev: (jx.householder_perm({"vs": jnp.asarray(vs)},
                                            jnp.asarray(x), rev),
                        tx.householder_perm({"vs": torch.from_numpy(vs)},
                                            torch.from_numpy(x), rev))


def _case_orthogonal():
    w = np.linalg.qr(_rand(5, 5, seed=18))[0].astype(np.float32)
    x = _rand(4, 5, seed=19)
    return lambda rev: (jx.orthogonal_transform({"w": jnp.asarray(w)},
                                                jnp.asarray(x), rev),
                        tx.orthogonal_transform({"w": torch.from_numpy(w)},
                                                torch.from_numpy(x), rev))


def _case_inv_auto_act():
    x = _rand(2, 3, 4, 4, seed=20)
    return lambda rev: (jx.inv_auto_act({"log_alpha": jnp.asarray(0.3)},
                                        jnp.asarray(x), rev),
                        tx.inv_auto_act({"log_alpha": torch.tensor(0.3)},
                                        torch.from_numpy(x), rev))


def _case_inv_auto_act_two_sided():
    jp = jx.init_inv_auto_act_two_sided(3, 2.0, 0.5)
    tp = tx.init_inv_auto_act_two_sided(3, 2.0, 0.5)
    for k in jp:
        assert_close(tp[k], jp[k], 1e-6)
    x = _rand(2, 3, 4, 4, seed=21)
    return lambda rev: (jx.inv_auto_act_two_sided(jp, jnp.asarray(x), rev),
                        tx.inv_auto_act_two_sided(tp, torch.from_numpy(x),
                                                  rev))


def _case_inv_auto_fc():
    p = {"w": _rand(6, 5, seed=22), "b": _rand(6, seed=23)}
    return lambda rev: (
        jx.inv_auto_fc(p, jnp.asarray(_rand(3, 6 if rev else 5, seed=24)),
                       rev),
        tx.inv_auto_fc(_t(p), torch.from_numpy(_rand(3, 6 if rev else 5,
                                                     seed=24)), rev))


def _case_inv_auto_conv2d():
    p = {"w": _rand(5, 3, 3, 3, seed=25, scale=0.2), "b": _rand(5, seed=26)}
    return lambda rev: (
        jx.inv_auto_conv2d(p, jnp.asarray(_rand(2, 5 if rev else 3, 6, 6,
                                                seed=27)), rev),
        tx.inv_auto_conv2d(_t(p), torch.from_numpy(_rand(2, 5 if rev else 3,
                                                         6, 6, seed=27)),
                           rev))


def _case_learned_scaling():
    s = _rand(3, 4, 4, seed=28, scale=0.3)
    x = _rand(2, 3, 4, 4, seed=29)
    return lambda rev: (jx.learned_elementwise_scaling(
        {"s": jnp.asarray(s)}, jnp.asarray(x), rev),
        tx.learned_elementwise_scaling({"s": torch.from_numpy(s)},
                                       torch.from_numpy(x), rev))


EXTRA_CASES = {
    "fixed_linear": _case_fixed_linear,
    "fixed_1x1_conv": _case_fixed_1x1_conv,
    "irevnet_downsampling": lambda: _shape_case(
        jx.irevnet_downsampling, tx.irevnet_downsampling, (2, 3, 4, 6),
        (2, 12, 2, 3)),
    "irevnet_upsampling": lambda: _shape_case(
        jx.irevnet_upsampling, tx.irevnet_upsampling, (2, 12, 2, 3),
        (2, 3, 4, 6)),
    "flatten": lambda: _shape_case(jx.flatten, tx.flatten, (2, 3, 4),
                                   (2, 12), shape=(3, 4)),
    "reshape": lambda: _shape_case(jx.reshape, tx.reshape, (2, 12), (2, 3, 4),
                                   target_shape=(3, 4), input_shape=(12,)),
    "inv_2d_to_3d": lambda: _shape_case(jx.inv_2d_to_3d, tx.inv_2d_to_3d,
                                        (2, 6, 4, 5), (2, 3, 4, 5, 2)),
    "inv_3d_to_2d": lambda: _shape_case(jx.inv_3d_to_2d, tx.inv_3d_to_2d,
                                        (2, 3, 4, 5, 2), (2, 6, 4, 5)),
    "householder_perm": _case_householder,
    "orthogonal_transform": _case_orthogonal,
    "inv_auto_act": _case_inv_auto_act,
    "inv_auto_act_two_sided": _case_inv_auto_act_two_sided,
    "inv_auto_fc": _case_inv_auto_fc,
    "inv_auto_conv2d": _case_inv_auto_conv2d,
    "learned_elementwise_scaling": _case_learned_scaling,
}


@pytest.mark.parametrize("name", sorted(EXTRA_CASES))
def test_extra_op_matches_jax(name):
    """Both directions of each (params, x, rev) -> (y, logdet) op."""
    run = EXTRA_CASES[name]()
    for rev in (False, True):
        (want, wj), (got, gj) = run(rev)
        assert_close(got, want)
        assert_logdet_close(gj, wj)


def test_layout_helpers_match_jax():
    x = _rand(2, 6, 4, 5, seed=30)
    want = jx.turn_2d_to_3d(jnp.asarray(x), 3)
    got = tx.turn_2d_to_3d(torch.from_numpy(x), 3)
    assert_close(got, want, 0)
    assert_close(tx.turn_3d_to_2d(got), x, 0)
    assert tx.turn_3d_to_2d(torch.from_numpy(x)).shape == x.shape
    with pytest.raises(ValueError):
        tx.turn_2d_to_3d(torch.from_numpy(x), 4)


def test_orthogonal_inits_and_projection():
    """The port's draws from a generator have JAX's properties:
    householder W orthogonal, the orthogonal init orthogonal, the
    projection of a perturbed W JAX's."""
    g = torch.Generator().manual_seed(1)
    vs = tx.init_householder_perm(g, 5, 2)["vs"]
    assert vs.shape == (2, 5)
    w = tx.householder_matrix(vs)
    assert_close(w, jx.householder_matrix(jnp.asarray(vs.numpy())))
    assert_close(w @ w.t(), np.eye(5, dtype=np.float32), 1e-5)
    q = tx.init_orthogonal_transform(g, 5)["w"]
    assert_close(q @ q.t(), np.eye(5, dtype=np.float32), 1e-5)
    bent = q.numpy() + _rand(5, 5, seed=31, scale=0.05)
    assert_close(tx.stiefel_project({"w": torch.from_numpy(bent)})["w"],
                 jx.stiefel_project({"w": jnp.asarray(bent)})["w"], 1e-4)
    fc = tx.init_inv_auto_fc(g, 6, 4)
    assert fc["w"].shape == (4, 6) and fc["b"].shape == (4,)
    conv = tx.init_inv_auto_conv2d(g, 3, 5, 3)
    assert float(conv["w"].abs().max()) <= np.sqrt(1.0 / 27)
    assert conv["b"].shape == (5,)


def test_iresnet_matches_jax_with_the_same_probe(monkeypatch):
    """y and the Hutchinson log-det for one Rademacher probe handed to
    both (JAX's draw replaced by the port's); the fixed-point inverse."""
    w = _rand(6, 6, seed=32)
    w = (w / np.linalg.norm(w, 2) * 0.5).astype(np.float32)
    x = _rand(2, 6, seed=33)
    gen = torch.Generator().manual_seed(4)
    probe = tx.rademacher(torch.Generator().manual_seed(4), x.shape)
    assert set(probe.unique().tolist()) == {-1.0, 1.0}
    monkeypatch.setattr(jax.random, "rademacher",
                        lambda key, shape, dtype: jnp.asarray(probe.numpy()))
    want, wj = jx.iresnet_forward(lambda u: jnp.tanh(u @ w), jnp.asarray(x),
                                  n_series=10, key=jax.random.PRNGKey(0))
    got, gj = tx.iresnet_forward(
        lambda u: torch.tanh(u @ torch.from_numpy(w)), torch.from_numpy(x),
        n_series=10, generator=gen)
    assert_close(got, want)
    assert_logdet_close(gj, wj)
    assert not tx.iresnet_forward(lambda u: u * 0.1, torch.from_numpy(x))[
        1].any()
    back = tx.iresnet_inverse(lambda u: torch.tanh(u @ torch.from_numpy(w)),
                              got, n_iter=100)
    assert_close(back, x, 1e-4)
    assert_close(back, jx.iresnet_inverse(lambda u: jnp.tanh(u @ w), want,
                                          n_iter=100), 1e-5)


def test_gmm_matches_jax():
    mu = _rand(3, 2, seed=34, scale=3.0)
    ls = _rand(3, 2, seed=35, scale=0.2)
    lw = _rand(3, seed=36)
    z = _rand(5, 2, seed=37, scale=3.0)
    assert_close(tx.gmm_nll(*map(torch.from_numpy, (z, mu, ls, lw))),
                 jx.gmm_nll(*map(jnp.asarray, (z, mu, ls, lw))))
    far = np.array([[0.0, 0.0], [40.0, 40.0]], np.float32)
    s = tx.gmm_sample(torch.Generator().manual_seed(5), 4096,
                      torch.from_numpy(far), torch.zeros(2, 2),
                      torch.tensor([0.0, np.log(3.0)], dtype=torch.float32))
    assert s.shape == (4096, 2) and bool(torch.isfinite(s).all())
    near_b = (s[:, 0] > 20).float().mean()
    assert abs(float(near_b) - 0.75) < 0.04
    assert float(s[s[:, 0] > 20].mean(0).sub(40).abs().max()) < 0.1


def _seq_ops(lib, p):
    return [(lib.fixed_linear, p), (lib.inv_auto_act, {"log_alpha": 0.2})]


def test_sequence_inn_matches_jax():
    _, jp, tp = _fixed(38)
    x = _rand(2, 4, seed=39)
    jseq = jx.SequenceINN(*_seq_ops(jx, jp))
    tseq = tx.SequenceINN(*_seq_ops(tx, tp))
    tseq.append(functools.partial(tx.flatten, shape=(4,)))
    jseq.append(functools.partial(jx.flatten, shape=(4,)))
    for rev, inp in ((False, x), (True, _rand(2, 4, seed=40))):
        (want, wj), (got, gj) = (jseq(jnp.asarray(inp), rev=rev),
                                 tseq(torch.from_numpy(inp), rev=rev))
        assert_close(got, want)
        assert_logdet_close(gj, wj)


def test_deprecated_shims_match_jax():
    _, jp, tp = _fixed(41)
    x = _rand(2, 4, seed=42)
    with pytest.warns(DeprecationWarning, match="SequenceINN"):
        seq = tdep.ReversibleSequential((tx.fixed_linear, tp))
    with pytest.warns(DeprecationWarning):
        jseq = jdep.ReversibleSequential((jx.fixed_linear, jp))
    want, wj = jseq(jnp.asarray(x))
    got, gj = seq(torch.from_numpy(x))
    assert_close(got, want)
    assert_logdet_close(gj, wj)
    with pytest.warns(DeprecationWarning):
        net = tdep.ReversibleGraphNet([(tx.fixed_linear, tp)])
    with pytest.warns(DeprecationWarning, match="tuple"):
        y, j = net(torch.from_numpy(x))
    assert_close(y, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        back, jr = net(y, rev=True)
        for kw in ({"ind_in": [0]}, {"ind_out": [0]}):
            with pytest.raises(ValueError, match="removed"):
                tdep.ReversibleGraphNet([], **kw)
    assert_close(back, x, 1e-5)
    assert_logdet_close(jr, -np.asarray(wj))


# ------------------------------------------------------------ z sampling


def test_sample_z_rev_like_matches_jax():
    """Shapes of the three forms as JAX's; zeros at temperature 0; at 0.5
    a normal of std 0.5 drawn from the generator (the same seed, the same
    draw)."""
    x = np.zeros((2, 3, 4, 5), np.float32)
    for arg, kw in ((x, {}), (x, {"same_size": True}), ((2, 7, 3), {})):
        jarg = jnp.asarray(arg) if isinstance(arg, np.ndarray) else arg
        targ = torch.from_numpy(arg) if isinstance(arg, np.ndarray) else arg
        want = jmodel.sample_z_rev_like(jax.random.PRNGKey(0), jarg, **kw)
        got = tmodel.sample_z_rev_like(torch.Generator(), targ, **kw)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert not got.any()
    a = tmodel.sample_z_rev_like(torch.Generator().manual_seed(3),
                                 (64, 8, 8), 0.5)
    b = tmodel.sample_z_rev_like(torch.Generator().manual_seed(3),
                                 (64, 8, 8), 0.5)
    assert torch.equal(a, b)
    assert abs(float(a.std()) - 0.5) < 0.03 and abs(float(a.mean())) < 0.03
