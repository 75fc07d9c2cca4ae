"""The int8 intermediate of the cond nets' 3-D pairs (``use_int8_cond``) in
the PyTorch port, on the CPU, against the JAX package with the same weights
carried across by ``load_jax_params``:

- the packs against ``quantize_cond_networks``: int8 weights equal, the
  scales within 1e-6 relative;
- the int8 pair on JAX's packs against JAX's int8 path: the int32 sums are
  exact, so only f32 activations rounded differently in their last ulp can
  move a level: max|d| <= 1e-5 * max|ref| (0 measured);
- against the port's float path within JAX's own 0.05 relative bound
  (``tests/test_cond_net.py:142-162``);
- ``XLFMReconstructor(use_int8_cond=True)`` against JAX's on the small rig
  (each side calibrates for itself, so a level may move where a scale
  differs in its last ulp: 1e-3 of max|ref|, 2e-7 measured), and the
  warning with no calibration under ``force_all_steps_NF``;
- ``ops/int8_conv.conv2d_int8``'s im2col over several frames at once equals
  the frame-by-frame one.

One thread: some tensors pass 32768 elements.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from cwfa_tpu.engine.inference import XLFMReconstructor as JReconstructor
from cwfa_tpu.models import cond_net as jcond

from cwfa_tpu_torch.engine import inference
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.models import cond_net as tcond
from cwfa_tpu_torch.ops import int8_conv
from cwfa_tpu_torch.rig import flagship

from test_torch_port_layers import randomize_fixed_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """JAX's two nets of tests/test_cond_net.py:142-162 (K 8), randomized
    PReLU alphas, the port's nets with the same weights, and views."""
    key = jax.random.PRNGKey(7)
    rng = np.random.RandomState(7)
    plist, tnets = [], []
    for i, d in enumerate((8, 4)):
        p = jcond.init_cond_network(jax.random.fold_in(key, i), 5, d,
                                    chans_3d=8)
        p = randomize_fixed_leaves(jax.tree_util.tree_map(np.asarray, p),
                                   rng)
        net = tcond.CondNetwork(5, d, chans_3d=8).eval()
        load_jax_params(net, p, {})
        plist.append(jax.tree_util.tree_map(jnp.asarray, p))
        tnets.append(net)
    x = np.random.RandomState(3).randn(2, 5, 12, 12).astype(np.float32)
    return plist, tnets, x


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def test_packs_equal_jax(nets):
    plist, tnets, x = nets
    want = jcond.quantize_cond_networks(plist, jnp.asarray(x))
    got = tcond.quantize_cond_networks(tnets, torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["wbq"].numpy(), np.asarray(w["wbq"]))
        assert g["wbq"].dtype == torch.int8
        for k in ("sb", "inv_s"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-6, atol=0)


def test_int8_pair_matches_jax_on_its_packs(nets):
    plist, tnets, x = nets
    packs = jcond.quantize_cond_networks(plist, jnp.asarray(x))
    want = jcond.cond_networks_batched(plist, jnp.asarray(x), cond_q=packs)
    tpacks = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
              for p in packs]
    with torch.inference_mode():
        got = tcond.cond_networks_batched(tnets, torch.from_numpy(x),
                                          cond_q=tpacks)
    for g, w in zip(got, want):
        assert _rel_max(g.numpy(), w) <= 1e-5


def test_int8_pair_within_jax_bound_of_float(nets):
    _, tnets, x = nets
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        ref = tcond.cond_networks_batched(tnets, xt)
        q = tcond.cond_networks_batched(
            tnets, xt, cond_q=tcond.quantize_cond_networks(tnets, xt))
    for r, o in zip(ref, q):
        rel = float((o - r).norm() / max(float(r.norm()), 1e-9))
        assert rel < 0.05, rel


def test_int8_pair_is_inference_only(nets):
    _, tnets, x = nets
    xt = torch.from_numpy(x)
    pack = tcond.quantize_cond_networks(tnets[:1], xt)[0]
    tnets[0].train()
    try:
        with pytest.raises(ValueError, match="inference-only"):
            tnets[0](xt, cond_q=pack)
    finally:
        tnets[0].eval()


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
                            calib_frames=frames, use_int8_cond=True)
    want = np.asarray(jrecon(frames))
    _, model, tstats, tvidx, _ = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    load_jax_params(model, params, mstate)
    return model, tstats, tvidx, caches, frames, want


def test_reconstructor_int8_cond_matches_jax(rig):
    model, stats, vidx, caches, frames, want = rig
    recon = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                              deterministic=True, use_int8_cond=True,
                              calib_frames=frames)
    assert len(recon.cond_q) == model.n_flow_steps
    got = recon(frames).numpy()
    assert np.isfinite(got).all()
    assert _rel_max(got, want) <= 1e-3
    f32 = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                            deterministic=True)(frames).numpy()
    assert not np.array_equal(got, f32)        # the int8 pair ran


def test_int8_cond_needs_calibration_frames(rig):
    model, stats, vidx, caches, *_ = rig
    with pytest.raises(ValueError, match="calib_frames"):
        XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                          deterministic=True, use_int8_cond=True)


def test_force_all_steps_nf_warns_and_skips_calibration(rig, monkeypatch,
                                                        capsys):
    model, stats, vidx, caches, frames, _ = rig
    bypassed = dataclasses.replace(model.cfg, force_all_steps_NF=1)
    monkeypatch.setattr(model, "cfg", bypassed)

    def calibrate(*_):
        raise AssertionError("calibrated under force_all_steps_NF")
    monkeypatch.setattr(inference, "quantize_cond_networks", calibrate)
    recon = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                              deterministic=True, use_int8_cond=True,
                              calib_frames=frames)
    assert recon.cond_q is None
    assert ("warning: use_int8_cond has no effect with force_all_steps_NF=1"
            in capsys.readouterr().out)


@pytest.mark.parametrize("budget", [1, 3 * 100 * 40, 1 << 30])
def test_conv2d_int8_groups_frames_within_budget(budget, monkeypatch):
    """1 byte: a frame at a time; 3 frames' columns, the last group short
    (7 frames); all at once: equal to the exact integer conv."""
    monkeypatch.setattr(int8_conv, "IM2COL_BYTES", budget)
    g = torch.Generator().manual_seed(5)
    q = torch.randint(-127, 128, (7, 4, 10, 10), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (3, 4, 3, 3), generator=g).to(torch.int8)
    got = int8_conv.conv2d_int8(q, wq, 1)
    want = F.conv2d(q.double(), wq.double(), padding=1)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), want)
