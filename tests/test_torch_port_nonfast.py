"""The port's non-fast reconstruction (``CWFAModel.reconstruct(fast=False)``:
every step through ``CWFStep.reverse``, the exact inverse of the forward,
its log-det dropped) on the CPU, against the JAX package's
``reconstruct(..., fast=False, return_pyramid=True)`` with the same
weights, at every level of the pyramid:

- deterministic (the LRNN in eval mode, z = 0);
- the LRNN in train mode with both drop rates 0;
- z at temperature 0.7 with two samples per frame, the same z handed to
  both sides;
  each within 1e-4 of max|ref|, and within 1e-5 of max|ref| of the port's
  own fast path on the same inputs;
- with int8 coupling-tower packs of JAX's ``quantize_steps`` carried across
  (``load_jax_int8_packs``), against JAX's non-fast chain with the same
  packs (its int8 tower kernel in interpret mode), within the bound of
  tests/test_torch_port_int8_reconstruct.py (1e-3 of max|ref|, at most 2%
  of the voxels beyond 1e-4).

Also ``param_counts`` against JAX's.  The small rig (16 depths at 32^2, two
steps of two 8-wide blocks), f32; JAX at
``jax_default_matmul_precision=highest``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import cwfa_tpu.models.cwfa_model as jmodel_mod

import cwfa_tpu_torch.models.cwfa_model as tmodel_mod
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.jax_params import (load_jax_int8_packs,
                                              load_jax_params)
from cwfa_tpu_torch.rig import flagship

from test_torch_port_layers import randomize_fixed_leaves


def _zero_drop(spec):
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
    views = XLFMReconstructor(model, tstats, tvidx, caches, device="cpu",
                              deterministic=True)._normalized_views(frames)
    tree = jax.tree_util.tree_map(jnp.asarray, (params, mstate))
    return {"jmodel": jmodel, "tree": tree, "model": model, "caches": caches,
            "views": views.numpy()}


def _jax(rig, **kw):
    params, mstate = rig["tree"]
    _, pyr = rig["jmodel"].reconstruct(
        params, mstate, jnp.asarray(rig["views"]),
        [jnp.asarray(c) for c in rig["caches"]], fast=False,
        return_pyramid=True, **kw)
    return {k: np.asarray(v) for k, v in pyr.items()}


def _port(rig, fast=False, **kw):
    vol, pyr = rig["model"].reconstruct(
        torch.from_numpy(rig["views"]),
        [torch.from_numpy(c) for c in rig["caches"]], fast=fast,
        return_pyramid=True, **kw)
    assert torch.equal(vol, pyr[0])
    return {k: v.numpy() for k, v in pyr.items()}


def _assert_levels(got, want, bound):
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for lvl, ref in want.items():
        assert got[lvl].shape == ref.shape
        err = float(np.abs(got[lvl] - ref).max())
        assert err <= bound * float(np.abs(ref).max()), (lvl, err)


@pytest.fixture
def same_z(monkeypatch):
    """Both packages' sample_z_truncated hand out the same numpy draws
    inside +-0.7, one array per step, coarsest first."""
    draws, asked = [], {"jax": 0, "torch": 0}

    def draw(side, shape):
        i = asked[side]
        asked[side] += 1
        if i == len(draws):
            draws.append(np.random.RandomState(10 + i).uniform(
                -0.7, 0.7, shape).astype(np.float32))
        assert draws[i].shape == tuple(shape)
        return draws[i]

    monkeypatch.setattr(jmodel_mod, "sample_z_truncated",
                        lambda key, shape, t, dtype=jnp.float32:
                        jnp.asarray(draw("jax", shape), dtype))
    monkeypatch.setattr(tmodel_mod, "sample_z_truncated",
                        lambda gen, shape, t: torch.from_numpy(
                            draw("torch", shape)))
    return asked


CASES = {
    "deterministic": ({}, {}),
    "lrnn_train": ({"lrnn_train": True}, {"lrnn_train": True}),
    "z0.7x2": ({"z_temperature": 0.7, "rng": jax.random.PRNGKey(0),
                "n_samples": 2},
               {"z_temperature": 0.7, "n_samples": 2,
                "generator": torch.Generator().manual_seed(0)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_non_fast_matches_jax_at_every_level(rig, case, same_z):
    jkw, tkw = CASES[case]
    want = _jax(rig, **jkw)
    got = _port(rig, **tkw)
    _assert_levels(got, want, 1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_non_fast_matches_the_fast_path(rig, case, same_z):
    _, tkw = CASES[case]
    slow = _port(rig, **tkw)
    same_z["torch"] = 0                     # the same z again
    if "generator" in tkw:
        tkw = {**tkw, "generator": torch.Generator().manual_seed(0)}
    fast = _port(rig, fast=True, **tkw)
    _assert_levels(slow, fast, 1e-5)


def test_non_fast_with_jax_int8_packs_matches_jax(rig):
    params, mstate = rig["tree"]
    jq = rig["jmodel"].quantize_steps(params, jnp.asarray(rig["views"]))
    jq = jax.tree_util.tree_map(np.asarray, jq)
    want = _jax(rig, qpacks=jax.tree_util.tree_map(jnp.asarray, jq))
    qpacks, _ = load_jax_int8_packs(rig["model"], jq)
    got = _port(rig, qpacks=qpacks)
    plain = _port(rig)
    for lvl in (0, 1):
        ref = float(np.abs(want[lvl]).max())
        d = np.abs(got[lvl] - want[lvl])
        assert d.max() <= 1e-3 * ref, (lvl, d.max() / ref)
        assert (d > 1e-4 * ref).mean() <= 2e-2
        # the packs were used
        assert np.abs(got[lvl] - plain[lvl]).max() > 1e-6 * ref
    # the same packs through the fast path
    fast = _port(rig, fast=True, qpacks=qpacks)
    _assert_levels(got, fast, 1e-5)


def test_param_counts_match_jax(rig):
    params, _ = rig["tree"]
    assert rig["model"].param_counts() == rig["jmodel"].param_counts(params)
