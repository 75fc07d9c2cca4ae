"""The int8 reconstruction slice of the PyTorch port (use_int8 UNet +
use_int8_towers) on the small rig, against the JAX XLFMReconstructor with
the same flags (deterministic, use_pallas=True; on the CPU the JAX tower
kernel runs in interpret mode), with the same weights, in f32.

1. Each side calibrates for itself.  The scales then agree to ~1e-7
   relative, and an int8 level moves wherever a folded weight or an
   activation sits on a round() boundary: max|d| <= 5e-3 * max|ref|
   (9.1e-4 measured).
2. JAX's packs carried across (load_jax_int8_packs): the integer sums are
   exact, and only f32 activations rounded differently in their last ulp
   (the f32 pipelines agree to ~1e-7) can move a level: max|d| <= 1e-3 *
   max|ref| (1.5e-4 measured), and at most 2% of the voxels differ by more
   than 1e-4 * max|ref| (0.6% measured).

The port's int8 output is also held to its own f32 pipeline by the norm
ratio of tests/test_inference.py:76-77 (< 0.05, JAX's own guard).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.engine.inference import XLFMReconstructor as JReconstructor

from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.jax_params import (load_jax_int8_packs,
                                              load_jax_params)
from cwfa_tpu_torch.ops import qtower
from cwfa_tpu_torch.rig import flagship

from test_torch_port_layers import randomize_fixed_leaves

INT8 = {"use_int8": True, "use_int8_towers": True}


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
                            deterministic=True, use_pallas=True,
                            calib_frames=frames, **INT8)
    want = np.asarray(jrecon(frames))
    jpacks = jax.tree_util.tree_map(np.asarray,
                                    (jrecon._qpacks, jrecon._unet_q))
    _, model, tstats, tvidx, _ = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    load_jax_params(model, params, mstate)
    return model, tstats, tvidx, caches, frames, want, jpacks


def _recon(rig, **kw):
    model, stats, vidx, caches, frames = rig[:5]
    kw.setdefault("deterministic", True)
    return XLFMReconstructor(model, stats, vidx, caches, device="cpu", **kw)


def test_int8_reconstruct_calibrated_matches_jax(rig):
    frames, want = rig[4], rig[5]
    recon = _recon(rig, calib_frames=frames, **INT8)
    assert recon.unet_q is not None
    assert all(pk is not None for step in recon.qpacks for pk in step)
    got = recon(frames).numpy()
    assert got.shape == want.shape == (2, 16, 32, 32)
    err = float(np.abs(got - want).max())
    assert err <= 5e-3 * float(np.abs(want).max()), err


def test_int8_reconstruct_with_jax_packs_matches_jax(rig):
    model, frames, want, (jq, ju) = rig[0], rig[4], rig[5], rig[6]
    recon = _recon(rig, calib_frames=frames, **INT8)
    recon.qpacks, recon.unet_q = load_jax_int8_packs(model, jq, ju)
    launches = qtower.fused_tower.launches
    got = recon(frames).numpy()
    assert qtower.fused_tower.launches == launches   # CPU: plain versions
    ref = float(np.abs(want).max())
    d = np.abs(got - want)
    assert d.max() <= 1e-3 * ref, d.max() / ref
    assert (d > 1e-4 * ref).mean() <= 2e-2, (d > 1e-4 * ref).mean()


def test_int8_reconstruct_close_to_f32_pipeline(rig):
    frames = rig[4]
    f32 = _recon(rig)(frames).double()
    q = _recon(rig, calib_frames=frames, **INT8)(frames).double()
    rel = float(torch.linalg.norm(q - f32)
                / torch.linalg.norm(f32 - f32.mean()))
    assert rel < 0.05, rel


def test_int8_flags_raise_without_calibration_or_determinism(rig):
    frames = rig[4]
    for kw in ({"use_int8": True}, {"use_int8_towers": True}, INT8):
        with pytest.raises(ValueError, match="calib_frames"):
            _recon(rig, **kw)
    with pytest.raises(ValueError, match="deterministic"):
        _recon(rig, deterministic=False, use_int8=True, calib_frames=frames)
    with pytest.raises(ValueError, match="deterministic"):     # the default
        XLFMReconstructor(*rig[:4], device="cpu", use_int8=True,
                          calib_frames=frames)
    recon = _recon(rig)
    assert recon.unet_q is None and recon.qpacks is None
