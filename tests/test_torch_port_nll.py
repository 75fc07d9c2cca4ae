"""The exact-likelihood path of the PyTorch port on the CPU — the depth Haar,
both directions of a CWF step with their log-dets, the forward pyramid, the
per-frame NLLs, the mean caches and the OOD decision — against the JAX
package, from the same numpy volumes and the same weights
(``load_jax_params``).

f32 throughout, JAX at ``jax_default_matmul_precision=highest``; every
comparison is |d| <= 1e-4 * max(1, |ref|) (``assert_close``: convs and
reductions sum in another order; the log-dets are sums over thousands of
elements).  The small rig is 16 depths at 32^2, two steps of two blocks,
8-wide towers; batches are chosen so that every elementwise tensor stays at
or under 32,768 elements (PERF.md).  On the CPU ``cat_affine`` and the
towers run their plain versions and count no launch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.flow import haar as jhaar
from cwfa_tpu.models import cwf as jcwf
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.engine import ood
from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.flow import haar as thaar
from cwfa_tpu_torch.models import cwfa_model as tmodel
from cwfa_tpu_torch.ops import btower, flow_affine

from test_torch_port_layers import randomize_fixed_leaves

SMALL = dict(n_depths=16, volume_side_size=32, n_lenslets=4,
             INN_max_down_steps=3, INN_n_blocks=2, INN_internal_chans=8,
             INN_cond_chans=4)
B, D, S = 2, 16, 32


def assert_close(got, want, tol=1e-4):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))), \
        float(np.abs(got - want).max())


def _rand(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _build(**extra):
    """(JAX model, its params as numpy, the port's model with them)."""
    jmodel = JModel.build(JConfig(**SMALL, **extra).decode_lrs())
    params, mstate = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    mstate = randomize_fixed_leaves(mstate, rng)
    model = tmodel.CWFAModel.build(CWFAConfig(**SMALL, **extra).decode_lrs(),
                                   torch.Generator().manual_seed(0)).eval()
    load_jax_params(model, params, mstate)
    return jmodel, params, model


@pytest.fixture(scope="module")
def rig():
    return _build()


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


# ------------------------------------------------------------------- Haar


@pytest.mark.parametrize("rebalance", [1.0, 0.7])
def test_haar1d_matches_jax_both_directions(rebalance):
    x = _rand(B, D, S, S, seed=1)
    for rev in (False, True):
        want, want_ld = jhaar.haar1d(jnp.asarray(x), rev=rev,
                                     rebalance=rebalance)
        got, got_ld = thaar.haar1d(torch.from_numpy(x), rev=rev,
                                   rebalance=rebalance)
        assert_close(got, want, 1e-6)
        assert got_ld.dtype == torch.float32
        assert_close(got_ld, want_ld, 1e-6)
    # the reference's quirk: only rebalance 1 gives log-det 0, and for
    # another value forward and reverse are not negatives of each other
    fwd = thaar.haar1d(torch.from_numpy(x), rebalance=rebalance)[1]
    rev = thaar.haar1d(torch.from_numpy(x), rev=True, rebalance=rebalance)[1]
    if rebalance == 1.0:
        assert not fwd.any() and not rev.any()
    else:
        assert fwd[0] != 0 and fwd[0] != -rev[0]


def test_haar1d_split_merge_match_jax_and_round_trip():
    x = _rand(B, D, S, S, seed=2)
    avg, diff, ld = thaar.haar1d_split(torch.from_numpy(x))
    javg, jdiff, jld = jhaar.haar1d_split(jnp.asarray(x))
    assert_close(avg, javg, 1e-6)
    assert_close(diff, jdiff, 1e-6)
    assert_close(ld, jld, 1e-6)
    back, ld2 = thaar.haar1d_merge(avg, diff)
    jback, _ = jhaar.haar1d_merge(javg, jdiff)
    assert_close(back, jback, 1e-6)
    assert_close(back, x, 1e-6)
    assert not ld2.any()


# --------------------------------------------------------------- CWF step


def _step_inputs(k, seed):
    d = D // 2 ** k
    return (_rand(B, d, S, S, seed=seed), _rand(B, d // 2, S, S, seed=seed + 1),
            _rand(B, d // 2, S, S, seed=seed + 2))


@pytest.mark.parametrize("k", [0, 1])
def test_step_forward_matches_jax(rig, k):
    jmodel, params, model = rig
    v, cv, cm = _step_inputs(k, 10 * k + 3)
    jz, javg, jld = jcwf.cwf_step_forward(
        jmodel.step_specs[k], _jnp(params["flow"][k]), *map(jnp.asarray,
                                                            (v, cv, cm)))
    launches = (flow_affine.cat_affine.launches,
                btower.fused_float_tower.launches)
    z, avg, ld = model.flow[k](*map(torch.from_numpy, (v, cv, cm)))
    assert (flow_affine.cat_affine.launches,
            btower.fused_float_tower.launches) == launches   # CPU: plain
    assert_close(z, jz)
    assert_close(avg, javg)
    assert ld.dtype == torch.float32 and ld.shape == (B,)
    assert_close(ld, jld)


@pytest.mark.parametrize("k", [0, 1])
def test_step_reverse_matches_jax(rig, k):
    jmodel, params, model = rig
    d = D // 2 ** k
    z, cv, cm = (_rand(B, d // 2, S, S, seed=20 + k + i) for i in range(3))
    avg = _rand(B, d // 2, S, S, seed=30 + k)
    jv, jld = jcwf.cwf_step_reverse(
        jmodel.step_specs[k], _jnp(params["flow"][k]),
        *map(jnp.asarray, (z, avg, cv, cm)))
    v, ld = model.flow[k].reverse(*map(torch.from_numpy, (z, avg, cv, cm)))
    assert v.shape == (B, d, S, S)
    assert_close(v, jv)
    assert_close(ld, jld)


@pytest.mark.parametrize("k", [0, 1])
def test_forward_then_reverse_is_the_identity(rig, k):
    _, _, model = rig
    v, cv, cm = map(torch.from_numpy, _step_inputs(k, 40 + k))
    cm = cm[:1]                      # a batch-1 mean cache is broadcast
    step = model.flow[k]
    z, avg, ld = step(v, cv, cm)
    back, ld_rev = step.reverse(z, avg, cv, cm)
    assert_close(back, v)
    assert_close(ld + ld_rev, np.zeros(B, np.float32))
    # the fast reverse (no log-det) reconstructs the same volume
    assert_close(step.reverse_fast(z, avg, cv, cm), back)


def test_disable_low_res_input_matches_jax():
    jmodel, params, model = _build(disable_low_res_input=1)
    spec, p = jmodel.step_specs[0], _jnp(params["flow"][0])
    v, cv, cm = _step_inputs(0, 50)
    want = jcwf.cwf_step_forward(spec, p, *map(jnp.asarray, (v, cv, cm)))
    z, avg, ld = model.flow[0](*map(torch.from_numpy, (v, cv, cm)))
    for got, ref in zip((z, avg, ld), want):
        assert_close(got, ref)
    # the mean condition plays no part
    z2, _, _ = model.flow[0](torch.from_numpy(v), torch.from_numpy(cv),
                             torch.from_numpy(2 * cm))
    assert torch.equal(z, z2)
    for fast in (False, True):
        jv, _ = jcwf.cwf_step_reverse(spec, p, want[0], want[1],
                                      jnp.asarray(cv), jnp.asarray(cm),
                                      fast=fast)
        assert_close(jv, v)
    assert_close(model.flow[0].reverse(z, avg, torch.from_numpy(cv),
                                       torch.from_numpy(cm))[0], v)
    assert_close(model.flow[0].reverse_fast(z, avg, torch.from_numpy(cv),
                                            torch.from_numpy(cm)), v)


# ---------------------------------------------------------------- pyramid


def _caches(seed):
    return [_rand(B, D // 2 ** (k + 1), S, S, seed=seed + k) for k in range(2)]


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("with_caches", [False, True])
def test_forward_pyramid_matches_jax(rig, per_sample, with_caches):
    jmodel, params, model = rig
    vol = _rand(B, D, S, S, seed=60)
    caches = _caches(61) if with_caches else None
    want = jmodel.forward_pyramid(
        _jnp(params), jnp.asarray(vol),
        mean_caches=None if caches is None else _jnp(caches),
        per_sample=per_sample)
    got = model.forward_pyramid(
        torch.from_numpy(vol),
        mean_caches=None if caches is None else list(map(torch.from_numpy,
                                                         caches)),
        per_sample=per_sample)
    assert [len(g) for g in got] == [2, 3, 2, 2]
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            assert g.dtype == torch.float32
            assert g.shape == np.shape(w)
            assert_close(g, w)
    if per_sample:
        assert got[0][0].shape == (B,)
        # nll = prior - log-jacobian, per frame
        for nll, prior, lj in zip(got[0], got[2], got[3]):
            assert_close(nll, (prior - lj).numpy(), 1e-5)


def test_nll_from_pyramid_matches_jax_and_forward_pyramid(rig):
    jmodel, params, model = rig
    vol = _rand(B, D, S, S, seed=70)
    nlls, cache, _, _ = model.forward_pyramid(torch.from_numpy(vol),
                                              per_sample=True)
    again = model.nll_from_pyramid(cache)
    want = jmodel.nll_from_pyramid(
        _jnp(params), [jnp.asarray(c.numpy()) for c in cache])
    for a, n, w in zip(again, nlls, want):
        assert torch.equal(a, n)
        assert_close(a, w)


def test_make_mean_caches_matches_jax(rig):
    jmodel, params, model = rig
    mv = _rand(1, D, S, S, seed=80)
    want = jmodel.make_mean_caches(_jnp(params), jnp.asarray(mv))
    got = model.make_mean_caches(torch.from_numpy(mv))
    assert [tuple(g.shape) for g in got] == [(1, 8, S, S), (1, 4, S, S),
                                             (1, 2, S, S)]
    for g, w in zip(got, want):
        assert_close(g, w)
    noisy = model.make_mean_caches(torch.from_numpy(mv),
                                   torch.Generator().manual_seed(0))
    d = (noisy[0] - got[0]).abs().max()
    assert 0 < d < 0.02               # sigma 1e-3 on the volume


# ------------------------------------------------- the port alone: scoring


def test_check_empty_depths_touches_only_constant_slices():
    vol = torch.from_numpy(_rand(B, D, S, S, seed=90))
    vol[0, 3] = 0.0
    vol[1, 7] = 2.5
    out = tmodel.check_empty_depths(torch.Generator().manual_seed(0), vol)
    changed = (out != vol).flatten(2).any(dim=2)
    want = torch.zeros(B, D, dtype=torch.bool)
    want[0, 3] = want[1, 7] = True
    assert torch.equal(changed, want)
    assert 1e-4 < out[0, 3].std() < 1e-2 and (out[1, 7] - 2.5).abs().max() < 0.01


def test_sample_z_truncated_range_and_moments():
    g = torch.Generator().manual_seed(0)
    assert not tmodel.sample_z_truncated(g, (4, 5), 0.0).any()
    t = 1.5
    z = tmodel.sample_z_truncated(g, (200_000,), t)
    assert z.dtype == torch.float32 and float(z.abs().max()) <= t
    # a std-1 normal truncated to [-T, T]: mean 0, variance
    # 1 - 2 T phi(T) / (2 Phi(T) - 1)
    phi = np.exp(-t * t / 2) / np.sqrt(2 * np.pi)
    mass = float(torch.special.erf(torch.tensor(t / np.sqrt(2.0))))
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - (1 - 2 * t * phi / mass)) < 0.01
    wide = tmodel.sample_z_truncated(g, (200_000,), 6.0)   # ~ untruncated
    assert abs(float(wide.var()) - 1.0) < 0.02


def _scorer(model, **kw):
    stats = DatasetStatistics(100.0, 50.0, 100.0, 50.0, 10.0, 5.0)
    return ood.PyramidScorer(model, stats, device="cpu",
                             generator=torch.Generator().manual_seed(0), **kw)


def test_scorer_with_zero_noise_equals_forward_pyramid(rig):
    _, _, model = rig
    raw = (_rand(1, D, S, S, seed=100) * 5 + 10).astype(np.float16)
    nlls, cache, priors, ljs = _scorer(model, noise_std=0.0)(raw)
    v = (torch.from_numpy(raw).float() - 10.0) / 5.0
    want = model.forward_pyramid(v, per_sample=True)
    assert nlls.shape == priors.shape == ljs.shape == (2, 1)
    assert torch.equal(nlls, torch.stack(want[0]))
    assert torch.equal(priors, torch.stack(want[2]))
    assert torch.equal(ljs, torch.stack(want[3]))
    assert all(torch.equal(a, b) for a, b in zip(cache, want[1]))
    # with the reference's 1e-3 noise the NLLs move, a little
    noisy = _scorer(model)(raw)[0]
    assert 0 < float((noisy - nlls).abs().max()) < 0.05


def test_scorer_replaces_nan_and_inf_by_the_sentinel(rig):
    _, _, model = rig
    raw = _rand(1, D, S, S, seed=101)
    raw[0, 0, 0, 0] = np.inf
    nlls, _, priors, _ = _scorer(model)(raw)
    assert torch.equal(nlls, torch.full((2, 1), ood.NLL_SENTINEL))
    assert torch.isfinite(priors).all()


def test_detect_ood_threshold_step_and_empty_case(rig):
    _, _, model = rig
    vols = _rand(3, D, S, S, seed=110) * 5 + 10
    scorer = _scorer(model, batch_size=2)
    res = ood.detect_ood(scorer, vols)
    assert res.nll_per_frame.shape == (3, 2)
    assert res.nll_per_frame.dtype == np.float32
    assert res.step_used == model.cfg.step_LL_to_use == 0
    assert res.threshold == model.cfg.step_LL_ths_to_use == -1.33
    assert np.array_equal(res.scores, res.nll_per_frame[:, 0])
    assert np.array_equal(res.is_ood, res.scores > -1.33)
    # a fresh scorer from the same seed draws the same noise: same NLLs,
    # thresholded at another step
    mid = float(np.median(res.nll_per_frame[:, 1]))
    res1 = ood.detect_ood(_scorer(model, batch_size=2), vols,
                          step_ll_to_use=1, threshold=mid)
    assert res1.step_used == 1 and res1.threshold == mid
    assert np.array_equal(res1.nll_per_frame, res.nll_per_frame)
    assert np.array_equal(res1.is_ood, res.nll_per_frame[:, 1] > mid)
    assert res1.is_ood.sum() == 1     # strictly above the median of three
    empty = ood.detect_ood(scorer, vols[:0])
    assert empty.nll_per_frame.shape == (0, 2) and empty.scores.shape == (0,)
    assert empty.is_ood.shape == (0,) and empty.is_ood.dtype == bool
    assert empty.step_used == 0 and empty.threshold == -1.33


def test_unported_flags_still_raise():
    """The two force flags are ported now: the model builds under each
    (force_last_step_NF with one more flow step) and its forward pyramid
    matches JAX's per frame."""
    vol = _rand(1, D, S, S, seed=80)
    for flag, nf in (("force_last_step_NF", 3), ("force_all_steps_NF", 2)):
        jmodel, params, model = _build(**{flag: 1})
        assert model.n_flow_steps == jmodel.n_flow_steps == nf
        want = jmodel.forward_pyramid(_jnp(params), jnp.asarray(vol),
                                      per_sample=True)
        got = model.forward_pyramid(torch.from_numpy(vol), per_sample=True)
        assert len(got[0]) == nf and len(got[1]) == nf + 1
        for g_list, w_list in zip(got, want):
            for g, w in zip(g_list, w_list):
                assert_close(g, w)
