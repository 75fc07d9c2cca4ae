"""The port's flow-affine wrappers (cwfa_tpu_torch.ops.flow_affine) on CPU
tensors, against the JAX Pallas kernels in interpret mode fed the clamped s.

On the CPU a wrapper runs its plain version; the CUDA kernels are held to
the same plain versions on the card by chip_smoke.py.

Tolerances: f32 atol 1e-5, as tests/test_pallas_flow.py.  bf16 atol and
rtol 2e-2: the JAX path rounds the clamped s to bf16 before exp(-s) and the
port clamps in f32 inside the kernel, so outputs of magnitude ~10 differ by
a few bf16 ulps (relative error <= ~1.2%).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu.ops import pallas_flow as pf
from cwfa_tpu_torch.ops import flow_affine as fa

ACTS = ("ATAN", "TANH", "SIGMOID")
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5, 0.0),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2, 2e-2)}


def _np(b, c, seed, h=8, w=16):
    return np.random.RandomState(seed).randn(b, c, h, w).astype(np.float32)


def _both(a, tdt, jdt):
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("rev", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_cat_affine_matches_pallas(act, rev, dt):
    tdt, jdt, atol, rtol = DTYPES[dt]
    b, c = 2, 3
    x_t, x_j = _both(_np(b, c, 0), tdt, jdt)
    st_t, st_j = _both(_np(b, 2 * c, 1) * 2, tdt, jdt)
    s_j = pf.clamp_s(st_j[:, :c], 2.0, act).astype(jdt)
    want = pf.cat_affine(x_j, s_j, st_j[:, c:], rev=rev, interpret=True)
    launches = fa.cat_affine.launches
    got = fa.cat_affine(x_t, st_t, clamp=2.0, activation=act, rev=rev)
    assert fa.cat_affine.launches == launches      # CPU: plain, no launch
    assert got.dtype == tdt and got.shape == (b, c, 8, 16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("t_batch1", [False, True])
def test_haar_merge_affine_matches_pallas(act, dt, t_batch1):
    tdt, jdt, atol, rtol = DTYPES[dt]
    b, c = 2, 3
    z_t, z_j = _both(_np(b, c, 2), tdt, jdt)
    s_t, s_j = _both(_np(b, c, 3) * 2, tdt, jdt)
    t_np = _np(1 if t_batch1 else b, c, 4)
    t_t, t_j = _both(t_np, tdt, jdt)
    a_t, a_j = _both(_np(b, c, 5), tdt, jdt)
    t_t = t_t.expand(b, c, 8, 16)           # stride 0 over the batch if b1
    t_j = jnp.broadcast_to(t_j, (b, c, 8, 16))
    want = pf.haar_merge_affine(z_j, pf.clamp_s(s_j, 2.0, act).astype(jdt),
                                t_j, a_j, interpret=True)
    launches = fa.haar_merge_affine.launches
    got = fa.haar_merge_affine(z_t, s_t, t_t, a_t, clamp=2.0, activation=act)
    assert fa.haar_merge_affine.launches == launches
    assert got.dtype == tdt and got.shape == (b, 2 * c, 8, 16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 3, 4, 4)
    st = torch.zeros(2, 6, 4, 4)
    kw = {"clamp": 2.0, "activation": "ATAN"}
    with pytest.raises(ValueError):          # st not (B, 2C, H, W)
        fa.cat_affine(x, st[:, :5], rev=True, **kw)
    with pytest.raises(ValueError):          # non-contiguous st
        fa.cat_affine(x, st.transpose(2, 3), rev=True, **kw)
    with pytest.raises(TypeError):           # mixed dtypes
        fa.cat_affine(x, st.double(), rev=True, **kw)
    with pytest.raises(TypeError):           # unsupported dtype
        fa.cat_affine(x.half(), st.half(), rev=True, **kw)
    with pytest.raises(ValueError):          # unknown clamp
        fa.cat_affine(x, st, rev=True, clamp=2.0, activation="RELU")
    with pytest.raises(RuntimeError):        # neither CPU nor CUDA: no fallback
        fa.cat_affine(x.to("meta"), st.to("meta"), rev=True, **kw)
    with pytest.raises(ValueError):          # t broadcast along H is not taken
        fa.haar_merge_affine(x, x, torch.zeros(2, 3, 1, 4).expand(2, 3, 4, 4),
                             x, **kw)


def test_plain_versions_invert_each_other():
    """rev undoes fwd, and haar_merge_affine equals cat_affine(rev) followed
    by the inverse depth-Haar merge."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
    st = torch.from_numpy(rng.randn(2, 6, 4, 4).astype(np.float32))
    avg = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
    kw = {"clamp": 2.0, "activation": "ATAN"}
    y = fa.cat_affine(x, st, rev=False, **kw)
    np.testing.assert_allclose(fa.cat_affine(y, st, rev=True, **kw).numpy(),
                               x.numpy(), atol=1e-5)
    diff = fa.cat_affine(x, st, rev=True, **kw)
    merged = fa.haar_merge_affine(x, st[:, :3].contiguous(),
                                  st[:, 3:].contiguous(), avg, **kw)
    np.testing.assert_allclose(merged[:, 0::2].numpy(),
                               ((avg + diff) / np.sqrt(2)).numpy(), atol=1e-5)
    np.testing.assert_allclose(merged[:, 1::2].numpy(),
                               ((avg - diff) / np.sqrt(2)).numpy(), atol=1e-5)
