"""The stochastic reconstruction mode of the PyTorch port (the reference's
default: the LRNN in train mode, z sampled at a temperature, the mean over
n_samples) on the CPU, against the JAX package with the same weights.

- UNet and LRNN with ``train=True`` and both drop rates 0 against
  ``cwfa_tpu.models.lrnn.lrnn(..., train=True, rng=None)``: 1e-4 of
  max|ref|; the port's BatchNorm buffers are left as they were.
- ``reconstruct`` with ``lrnn_train=True`` at temperature 0, and at
  temperature 0.7 with two samples with ``sample_z_truncated`` patched on
  both sides to hand out the same numpy arrays: 1e-4 of max|ref|.
- ``dropout2d`` / ``drop_path`` / ``sample_z_truncated`` on the port alone
  (the two frameworks' generators give other numbers from one seed).
- ``XLFMReconstructor`` with no mode is the stochastic one and agrees with
  JAX's default within 1e-4 of max|ref| (drop rates 0, temperature 0).

JAX runs at ``jax_default_matmul_precision=highest`` (tests/conftest.py);
every elementwise tensor stays under 32,768 elements.
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import cwfa_tpu.models.cwfa_model as jmodel_mod
from cwfa_tpu.engine.inference import XLFMReconstructor as JReconstructor
from cwfa_tpu.models.lrnn import (LRNNSpec as JLRNNSpec, init_lrnn,
                                  lrnn as jlrnn)
from cwfa_tpu.models.unet import UNetSpec as JUNetSpec

import cwfa_tpu_torch.models.cwfa_model as tmodel_mod
from cwfa_tpu_torch import nn as tnn
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.models import lrnn as tlrnn
from cwfa_tpu_torch.models import unet as tunet
from cwfa_tpu_torch.rig import flagship

from test_torch_port_layers import randomize_fixed_leaves


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# (a) UNet and LRNN in train mode
# ---------------------------------------------------------------------------


def _lrnn_specs(drop):
    def spec(lrnn_cls, unet_cls):
        unet = unet_cls(in_channels=3, n_classes=3, depth=3, wf=2,
                        batch_norm=True, use_bias=True, skip_conn=True,
                        drop_out=drop)
        return lrnn_cls(ch_in=4, n_depths=3, spatial=16, use_bias=True,
                        unet=unet, convnext_width=8, convnext_drop=drop,
                        unet_drop=drop)
    return spec(JLRNNSpec, JUNetSpec), spec(tlrnn.LRNNSpec, tunet.UNetSpec)


@pytest.fixture(scope="module")
def lrnn_pair():
    jspec, tspec = _lrnn_specs(0.0)
    params, state = init_lrnn(jax.random.PRNGKey(5), jspec)
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    state = randomize_fixed_leaves(state, rng)
    module = tlrnn.LRNN(tspec).eval()
    load_jax_params(module, params, state)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    mv = rng.randn(1, 3, 16, 16).astype(np.float32)
    return jspec, params, state, module, x, mv


def test_spec_defaults_match_jax():
    j, t = JLRNNSpec(), tlrnn.LRNNSpec()
    assert (t.convnext_drop, t.unet_drop) == (j.convnext_drop, j.unet_drop) \
        == (0.05, 0.005)
    assert t.unet.drop_out == j.unet.drop_out == 0.005
    assert tunet.UNetSpec(3, 3).drop_out == JUNetSpec(3, 3).drop_out == 0.0


def test_lrnn_train_mode_matches_jax(lrnn_pair):
    jspec, params, state, module, x, mv = lrnn_pair
    want, _ = jlrnn(jspec, _jnp(params), _jnp(state), jnp.asarray(x),
                    jnp.broadcast_to(jnp.asarray(mv), (2, 3, 16, 16)),
                    train=True, rng=None)
    buffers = copy.deepcopy(dict(module.named_buffers()))
    with torch.inference_mode():
        got = module(torch.from_numpy(x), mean_vol=torch.from_numpy(mv),
                     train=True)
        unet = module.unet(module.proj(torch.from_numpy(x)), train=True)
        eval_out = module(torch.from_numpy(x), mean_vol=torch.from_numpy(mv))
    assert _rel(got, want) <= 1e-4
    # batch statistics, not the running ones
    assert _rel(eval_out, want) > 1e-2
    assert not module.training
    # the running statistics are neither read nor updated
    after = dict(module.named_buffers())
    assert set(after) == set(buffers) and any("running_var" in k for k in after)
    for k, v in buffers.items():
        assert torch.equal(after[k], v), k
    # the UNet alone, against JAX's through the same projection
    from cwfa_tpu.models.unet import unet as junet
    from cwfa_tpu import nn as cnn
    y = cnn.conv2d(_jnp(params)["proj"], jnp.asarray(x))
    want_u, new_state = junet(jspec.unet, _jnp(params)["unet"],
                              _jnp(state)["unet"], y, train=True, rng=None)
    assert _rel(unet, want_u) <= 1e-4
    assert int(new_state["down"][0]["bn1"]["count"]) \
        == int(state["unet"]["down"][0]["bn1"]["count"]) + 1


def test_lrnn_train_mode_ignores_the_int8_unet(lrnn_pair):
    module, x, mv = lrnn_pair[3], lrnn_pair[4], lrnn_pair[5]
    xt, mvt = torch.from_numpy(x), torch.from_numpy(mv)
    with torch.inference_mode():
        scales = tunet.unet_calibrate(module.unet, module.proj(xt))
        unet_q = {"qpack": tunet.quantize_unet(module.unet, scales),
                  "scales": scales}
        plain = module(xt, mean_vol=mvt, train=True)
        assert torch.equal(module(xt, mean_vol=mvt, train=True, unet_q=unet_q),
                           plain)                   # lrnn.py:116
        assert not torch.equal(module(xt, mean_vol=mvt, unet_q=unet_q),
                               module(xt, mean_vol=mvt))


def test_batch_norm_batch_stats_in_bf16():
    """Statistics in f32 from the bf16 input (``cwfa_tpu/nn.py:307-324``).
    JAX rounds x - mean, the product with 1/std, the product with the scale
    and the sum with the bias to bf16; the port rounds the result once.  Each
    of JAX's four roundings is within 2^-8 of an intermediate that stays
    under twice max|ref| here: 2^-5 of max|ref| bounds their sum."""
    gen = torch.Generator().manual_seed(0)
    bn = torch.nn.BatchNorm2d(3).eval()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
    x = (torch.randn(4, 3, 8, 8, generator=gen) * 3 + 1).to(torch.bfloat16)
    weight, bias = bn.weight.detach().clone(), bn.bias.detach().clone()
    with torch.no_grad():
        got = tnn.batch_norm_batch_stats(bn.to(torch.bfloat16), x)
    assert got.dtype == torch.bfloat16
    from cwfa_tpu import nn as cnn
    p = {"scale": jnp.asarray(weight.numpy()), "bias": jnp.asarray(bias.numpy())}
    s = {"mean": jnp.zeros(3), "var": jnp.ones(3),
         "count": jnp.zeros((), jnp.int32)}
    want, _ = cnn.batchnorm(
        p, s, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), True)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -5 * np.abs(want).max(), err
    # in f32 the two are the same function
    with torch.no_grad():
        got32 = tnn.batch_norm_batch_stats(bn.float(), x.float())
    want32, _ = cnn.batchnorm(
        {k: jnp.asarray(np.asarray(v.astype(jnp.bfloat16).astype(jnp.float32)))
         for k, v in p.items()}, s, jnp.asarray(x.float().numpy()), True)
    assert _rel(got32, want32) <= 1e-5


# ---------------------------------------------------------------------------
# (c) the random pieces, on the port alone
# ---------------------------------------------------------------------------


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_dropout2d_drops_whole_maps():
    x = torch.rand(64, 16, 4, 4) + 1.0              # no zeros of its own
    y = tnn.dropout2d(x, 0.25, _gen())
    dropped = (y == 0).flatten(2).all(-1)
    kept = (y != 0).flatten(2).all(-1)
    assert bool((dropped | kept).all())              # a map is whole
    assert 0.15 < dropped.float().mean() < 0.35
    assert torch.allclose(y[kept], x[kept] / 0.75)
    assert torch.equal(tnn.dropout2d(x, 0.25, _gen()), y)     # same seed
    assert not torch.equal(tnn.dropout2d(x, 0.25, _gen(1)), y)
    assert tnn.dropout2d(x.to(torch.bfloat16), 0.25, _gen()).dtype == torch.bfloat16


def test_drop_path_drops_whole_samples():
    x = torch.rand(256, 2, 3, 3) + 1.0
    y = tnn.drop_path(x, 0.5, _gen())
    dropped = (y == 0).flatten(1).all(-1)
    kept = (y != 0).flatten(1).all(-1)
    assert bool((dropped | kept).all())
    assert 0.4 < dropped.float().mean() < 0.6
    assert torch.allclose(y[kept], x[kept] / 0.5)
    assert torch.equal(tnn.drop_path(x, 0.5, _gen()), y)


@pytest.mark.parametrize("fn", [tnn.dropout2d, tnn.drop_path])
def test_drop_rates_0_and_1_and_no_generator(fn):
    x = torch.rand(4, 3, 5, 5) + 1.0
    x[0, 0, 0, 0] = float("inf")                    # rate 1: clean zeros
    assert fn(x, 0.0, _gen()) is x
    assert fn(x, 0.3, None) is x
    assert torch.equal(fn(x, 1.0, _gen()), torch.zeros_like(x))
    g = _gen()
    state = g.get_state()
    fn(x, 0.0, g)
    assert torch.equal(g.get_state(), state)        # rate 0 draws nothing


@pytest.mark.parametrize("t", [0.5, 0.7, 2.0])
def test_sample_z_truncated_stays_inside_the_temperature(t):
    z = tmodel_mod.sample_z_truncated(_gen(), (4, 8, 16, 16), t)
    assert z.dtype == torch.float32 and z.shape == (4, 8, 16, 16)
    assert float(z.abs().max()) <= t
    assert abs(float(z.mean())) < 0.05 and float(z.std()) > 0.25 * min(t, 1.0)
    assert torch.equal(tmodel_mod.sample_z_truncated(_gen(), z.shape, t), z)
    assert not tmodel_mod.sample_z_truncated(_gen(), (2, 3), 0.0).any()


# ---------------------------------------------------------------------------
# (b), (d) reconstruct and the reconstructor
# ---------------------------------------------------------------------------


def _zero_drop(spec):
    """An LRNN spec with both drop rates 0 (a generator is then only the
    source of z)."""
    unet = dataclasses.replace(spec.unet, drop_out=0.0)
    return dataclasses.replace(spec, unet=unet, convnext_drop=0.0,
                               unet_drop=0.0)


@pytest.fixture(scope="module")
def rig():
    from __graft_entry__ import _flagship
    cfg, jmodel, params, mstate, stats, vidx, img = _flagship(small=True)
    jmodel = dataclasses.replace(jmodel,
                                 lrnn_spec=_zero_drop(jmodel.lrnn_spec))
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    mstate = randomize_fixed_leaves(mstate, rng)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(jmodel.n_flow_steps + 1)]
    frames = (rng.rand(2, img, img) * 1000).astype(np.float32)
    _, model, tstats, tvidx, _ = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    load_jax_params(model, params, mstate)
    model.lrnn.spec = _zero_drop(model.lrnn.spec)
    model.lrnn.unet.spec = model.lrnn.spec.unet
    model.eval()
    tree = _jnp((params, mstate))
    return jmodel, tree, stats, vidx, model, tstats, tvidx, caches, frames


def _views(rig):
    """Normalized views of the rig's frames, as numpy (the port's)."""
    model, stats, vidx, caches, frames = rig[4:]
    recon = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                              deterministic=True)
    return recon._normalized_views(frames).numpy()


def test_reconstruct_lrnn_train_matches_jax(rig):
    jmodel, (params, mstate), _, _, model, _, _, caches, _ = rig
    views = _views(rig)
    mcs = [jnp.asarray(c) for c in caches]
    want = jmodel.reconstruct(params, mstate, jnp.asarray(views), mcs,
                              lrnn_train=True, fast=True)
    tcs = [torch.from_numpy(c) for c in caches]
    got = model.reconstruct(torch.from_numpy(views), tcs, lrnn_train=True)
    assert _rel(got, want) <= 1e-4
    eval_mode = model.reconstruct(torch.from_numpy(views), tcs)
    assert _rel(eval_mode, want) > 1e-3             # the mode matters
    # a generator alone turns the LRNN's train mode on (cwfa_model.py:270)
    by_gen = model.reconstruct(torch.from_numpy(views), tcs,
                               generator=torch.Generator().manual_seed(0))
    assert torch.equal(by_gen, got)


def test_reconstruct_sampled_z_matches_jax(rig, monkeypatch):
    """Temperature 0.7, two samples per frame; both sides get the same z
    (numpy draws inside +-0.7, one array per step, coarsest step first)."""
    jmodel, (params, mstate), _, _, model, _, _, caches, _ = rig
    views = _views(rig)
    rng = np.random.RandomState(1)
    draws = [rng.uniform(-0.7, 0.7, (4, spec.c_flow, spec.spatial, spec.spatial))
             .astype(np.float32) for spec in reversed(model.step_specs)]
    asked = {"jax": [], "torch": []}

    def jax_z(key, shape, temperature, dtype=jnp.float32):
        assert key is not None and temperature == 0.7
        asked["jax"].append(tuple(shape))
        return jnp.asarray(draws[len(asked["jax"]) - 1], dtype)

    def torch_z(generator, shape, temperature):
        assert generator is not None and temperature == 0.7
        asked["torch"].append(tuple(shape))
        return torch.from_numpy(draws[len(asked["torch"]) - 1])

    monkeypatch.setattr(jmodel_mod, "sample_z_truncated", jax_z)
    monkeypatch.setattr(tmodel_mod, "sample_z_truncated", torch_z)
    mcs = [jnp.asarray(c) for c in caches]
    want = jmodel.reconstruct(params, mstate, jnp.asarray(views), mcs,
                              z_temperature=0.7, rng=jax.random.PRNGKey(0),
                              n_samples=2, fast=True)
    tcs = [torch.from_numpy(c) for c in caches]
    got = model.reconstruct(torch.from_numpy(views), tcs, z_temperature=0.7,
                            generator=torch.Generator().manual_seed(0),
                            n_samples=2)
    assert asked["jax"] == asked["torch"] == [d.shape for d in draws]
    assert got.shape == (2, 16, 32, 32)
    assert _rel(got, want) <= 1e-4
    one = model.reconstruct(torch.from_numpy(views), tcs, lrnn_train=True)
    assert _rel(one, want) > 1e-3                   # z moved the volume


def test_reconstructor_default_is_the_stochastic_mode(rig):
    jmodel, (params, mstate), stats, vidx, model, tstats, tvidx, caches, \
        frames = rig
    want = np.asarray(JReconstructor(jmodel, params, mstate, stats, vidx,
                                     caches, use_pallas=True)(frames))
    default = XLFMReconstructor(model, tstats, tvidx, caches, device="cpu")
    assert default.deterministic is False
    assert default.mean_branch is None              # computed per call
    got = default(frames)
    assert _rel(got, want) <= 1e-4
    explicit = XLFMReconstructor(model, tstats, tvidx, caches, device="cpu",
                                 deterministic=False)
    assert torch.equal(explicit(frames), got)
    det = XLFMReconstructor(model, tstats, tvidx, caches, device="cpu",
                            deterministic=True)
    assert det.mean_branch is not None
    assert _rel(det(frames), want) > 1e-3
    with pytest.raises(ValueError, match="deterministic"):
        XLFMReconstructor(model, tstats, tvidx, caches, device="cpu",
                          use_int8=True, calib_frames=frames)


def test_reconstructor_draws_from_its_seeded_generator(rig):
    """With the spec's own drop rates and a temperature, two calls differ
    and two reconstructors from one seed agree."""
    model, stats, vidx, caches, frames = rig[4:]
    m = copy.deepcopy(model)
    m.cfg = dataclasses.replace(m.cfg, INN_z_temperature=0.7, INN_n_samples=2)
    m.lrnn.spec = dataclasses.replace(m.lrnn.spec, convnext_drop=0.5)
    a = XLFMReconstructor(m, stats, vidx, caches, device="cpu")
    b = XLFMReconstructor(m, stats, vidx, caches, device="cpu")
    a1, a2, b1 = a(frames), a(frames), b(frames)
    assert a1.shape == (2, 16, 32, 32) and torch.isfinite(a1).all()
    assert torch.equal(a1, b1)
    assert not torch.equal(a1, a2)
