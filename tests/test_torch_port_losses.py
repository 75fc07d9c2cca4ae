"""The training losses and the evaluation metrics of the port
(``engine/losses.py``) against ``cwfa_tpu.engine.losses`` on the CPU, from
the same numpy arrays: values within 1e-6 relative, and for the losses the
gradient with respect to the prediction within 1e-5 * max|ref|."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.engine import losses as JL

from cwfa_tpu_torch.engine import losses as L


def _pair(seed, shape=(2, 4, 9, 11)):
    rng = np.random.RandomState(seed)
    gt = np.abs(rng.randn(*shape)).astype(np.float32) * 3
    pred = (gt + 0.5 * rng.randn(*shape)).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("name", ["weighted_mse_loss", "mse_loss", "l1_loss",
                                  "poisson_ll_loss"])
def test_loss_matches_jax(name):
    gt, pred = _pair(1)
    out, tgt = (np.abs(pred), gt) if name == "poisson_ll_loss" else (pred, gt)
    want, jgrad = jax.value_and_grad(getattr(JL, name))(jnp.asarray(out),
                                                        jnp.asarray(tgt))
    o = torch.from_numpy(out).requires_grad_()
    got = getattr(L, name)(o, torch.from_numpy(tgt))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= \
        1e-6 * max(1.0, abs(float(want)))
    jgrad, grad = np.asarray(jgrad).ravel(), o.grad.numpy().ravel()
    if name == "poisson_ll_loss":
        # at the prediction's minimum the LL's gradient is the difference
        # of two terms of ~1e8 (log(1e-8 + 0)'s slope and the min's share),
        # which no two f32 sum orders give alike
        keep = np.arange(out.size) != out.argmin()
        jgrad, grad = jgrad[keep], grad[keep]
    assert np.abs(grad - jgrad).max() <= 1e-5 * np.abs(jgrad).max()


@pytest.mark.parametrize("kind", ["L1", "L2", "wL2", "LL"])
def test_recon_loss_menu_matches_jax(kind):
    gt, pred = _pair(2)
    pred = np.abs(pred)
    want = JL.recon_loss(kind, jnp.asarray(gt), jnp.asarray(pred))
    got = L.recon_loss(kind, torch.from_numpy(gt), torch.from_numpy(pred))
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    with pytest.raises(ValueError):
        L.recon_loss("L3", torch.from_numpy(gt), torch.from_numpy(pred))


@pytest.mark.parametrize("case", ["noisy", "equal", "zeros"])
def test_psnr_and_masked_mae_match_jax(case):
    gt, pred = _pair(3)
    if case == "equal":
        pred = gt.copy()
    elif case == "zeros":
        gt, pred = np.zeros_like(gt), np.zeros_like(gt)
    for name in ("psnr", "masked_mae_pct"):
        want = float(getattr(JL, name)(jnp.asarray(gt), jnp.asarray(pred)))
        got = float(getattr(L, name)(torch.from_numpy(gt),
                                     torch.from_numpy(pred)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (name, got, want)
