"""The whole reconstruction slice of the PyTorch port on the small rig,
against the JAX XLFMReconstructor (deterministic, use_pallas=True, which on
the CPU runs the flow kernels' plain references), with the same weights.

f32: max|d| <= 1e-4 * max|ref|.  The port's bf16 output is held to its own
f32 output within 5e-2 of max|f32|, the bound __graft_entry__.py uses.
"""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.engine.inference import XLFMReconstructor as JReconstructor

from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.rig import flagship

from test_torch_port_layers import randomize_fixed_leaves


@pytest.fixture(scope="module")
def rig():
    from __graft_entry__ import _flagship
    cfg, jmodel, params, mstate, stats, vidx, img = _flagship(small=True)
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    mstate = randomize_fixed_leaves(mstate, rng)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(jmodel.n_flow_steps + 1)]
    frames = (rng.rand(2, img, img) * 1000).astype(np.float32)
    tree = jax.tree_util.tree_map(jnp.asarray, (params, mstate))
    jrecon = JReconstructor(jmodel, *tree, stats, vidx, caches,
                            deterministic=True, use_pallas=True)
    want = np.asarray(jrecon(frames))

    tcfg, model, tstats, tvidx, timg = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert timg == img and tstats.astuple() == stats.astuple()
    for k in vidx:
        np.testing.assert_array_equal(tvidx[k], vidx[k])
    load_jax_params(model, params, mstate)
    return model, tstats, tvidx, caches, frames, want


def test_reconstruct_f32_matches_jax(rig):
    model, stats, vidx, caches, frames, want = rig
    got = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                            deterministic=True)(frames)
    assert got.shape == want.shape == (2, 16, 32, 32)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err


def test_reconstruct_bf16_close_to_f32(rig):
    model, stats, vidx, caches, frames, _ = rig
    f32 = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                            deterministic=True)(frames)
    bf16 = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                             deterministic=True,
                             compute_dtype=torch.bfloat16)(frames)
    assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
    rel = float((bf16 - f32).abs().max() / f32.abs().max())
    assert rel <= 5e-2, rel
    # the reconstructor works on its own copy of the model
    assert next(model.parameters()).dtype == torch.float32


def test_unported_options_raise(rig):
    model, stats, vidx, caches, frames, _ = rig
    views = torch.zeros(1, 4, 32, 32)
    mcs = [torch.as_tensor(c) for c in caches]
    model.eval()
    with pytest.raises(NotImplementedError):
        model.reconstruct(views, mcs, fast=False)
    with pytest.raises(ValueError):                 # nothing to draw z from
        model.reconstruct(views, mcs, z_temperature=1.0)
    # training mode is ported: BatchNorm on batch statistics moves the
    # running statistics only in a module put into training mode
    unet = copy.deepcopy(model.lrnn.unet)
    bn = unet.down[0].bn1
    x = torch.randn((1, unet.spec.in_channels, 32, 32),
                    generator=torch.Generator().manual_seed(0))
    before = bn.running_mean.clone()
    unet.eval()(x, train=True)
    assert torch.equal(bn.running_mean, before)
    unet.train()(x, train=True)
    assert not torch.equal(bn.running_mean, before)
    assert int(bn.num_batches_tracked) == 1
    model.eval()
    # the force flags are ported: force_last_step_NF builds one more step
    assert CWFAModel(dataclasses.replace(
        model.cfg, force_last_step_NF=1)).n_flow_steps == \
        model.n_flow_steps + 1
