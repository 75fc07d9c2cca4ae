"""The port's Richardson–Lucy deconvolution (``cwfa_tpu_torch/ops/
deconv.py``) against the JAX package's (``cwfa_tpu/ops/deconv.py``) on the
CPU, in every case of ``tests/test_deconv.py``: ``fourier_sum`` both ways,
depth chunks (ragged too), a batch against independent runs (frames at
scales far apart, so the per-frame median clamp matters), the per-frame
NaN freeze, ``init_obj`` chaining, an odd canvas with ``full_hw`` and ROI
zeroing; at most 6 iterations, f32, bounds 1e-4 * max|ref| on the volume
and on ``img_est``.  The nonzero median is held exactly to JAX's sort form
and its bit descent, by hypothesis over duplicates, negatives, zeros,
all-zero rows and even and odd counts, over normal floats: XLA's CPU
backend flushes subnormals to zero, so JAX takes a subnormal for a zero,
where the reference's torch ``t[t != 0].median()`` keeps it; the port is
held to torch's expression on subnormals."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from cwfa_tpu_torch.ops import deconv as TD
from cwfa_tpu_torch.ops import fft_conv as T

J = importlib.import_module("cwfa_tpu.ops.fft_conv")
JD = importlib.import_module("cwfa_tpu.ops.deconv")
# the two JAX forms, jitted here so that each compiles once
_JBITS = jax.jit(JD._median_nonzero_batch)
_JSORT = jax.jit(jax.vmap(JD._median_nonzero_sort))


def _close(got, want, bound=1e-4):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bound * float(np.abs(want).max()), err


def _rig(seed, d, s, p, b=1, smooth=True, scale=None):
    """(JAX otf, port otf, full_hw, camera image (numpy) of b random
    volumes)."""
    rng = np.random.RandomState(seed)
    psf = np.abs(rng.rand(1, d, p, p)).astype(np.float32)
    psf /= psf.sum(axis=(-2, -1), keepdims=True)
    vol = np.abs(rng.rand(b, d, s, s)).astype(np.float32)
    if scale is not None:
        vol *= np.asarray(scale, np.float32).reshape(-1, 1, 1, 1)
    jo, hw = J.precompute_otf(jnp.asarray(psf), (s, s), smooth=smooth)
    to, thw = T.precompute_otf(torch.from_numpy(psf), (s, s), smooth=smooth)
    assert thw == hw
    img = np.array(J.xlfm_forward_project(jnp.asarray(vol), jo, hw,
                                            psf_hw=(p, p)))
    return jo, to, hw, img


def _both(jo, to, img, **kw):
    jr, je = JD.xlfm_deconvolve(jo, jnp.asarray(img), **kw)
    tr, te = TD.xlfm_deconvolve(to, torch.from_numpy(img), **kw)
    return (jr, je), (tr, te)


@pytest.mark.parametrize("fourier_sum", [True, False])
@pytest.mark.parametrize("depth_chunk", [None, 2, 3])
def test_deconv_matches_jax(fourier_sum, depth_chunk):
    d, s, p = 5, 16, 32                  # 5 depths: chunk 3 is ragged
    jo, to, hw, img = _rig(7, d, s, p)
    (jr, je), (tr, te) = _both(jo, to, img, n_iter=6, obj_hw=(s, s),
                               roi_depths=d, depth_chunk=depth_chunk,
                               full_hw=hw, fourier_sum=fourier_sum)
    assert tuple(tr.shape) == (1, d, s, s)
    assert tuple(te.shape) == (1, 1) + hw
    _close(tr, jr)
    _close(te, je)


def test_deconv_roi_zeroes_outer_depths():
    d, s, p = 6, 16, 24
    jo, to, hw, img = _rig(3, d, s, p)
    (jr, _), (tr, _) = _both(jo, to, img, n_iter=4, obj_hw=(s, s),
                             roi_depths=2, full_hw=hw)
    _close(tr, jr)
    assert not tr[:, [0, 1, 4, 5]].any() and tr[:, 2:4].all()


def test_deconv_batch_matches_independent_runs():
    d, s, p = 3, 16, 32
    jo, to, hw, img = _rig(19, d, s, p, b=2, scale=[1.0, 250.0])
    kw = dict(n_iter=6, obj_hw=(s, s), roi_depths=d, full_hw=hw)
    (jr, je), (tr, te) = _both(jo, to, img, **kw)
    _close(tr, jr)
    _close(te, je)
    for i in range(2):
        ti, tei = TD.xlfm_deconvolve(to, torch.from_numpy(img[i:i + 1]),
                                     **kw)
        _close(tr[i:i + 1], ti.numpy(), 1e-5)
        _close(te[i:i + 1], tei.numpy(), 1e-5)


def test_deconv_nan_freeze_is_per_frame():
    d, s, p = 2, 16, 32
    jo, to, hw, img = _rig(23, d, s, p)
    bad = img.copy()
    bad[0, 0, 3, 3] = np.nan
    both = np.concatenate([bad, img])
    kw = dict(n_iter=5, obj_hw=(s, s), roi_depths=d, full_hw=hw)
    (jr, _), (tr, _) = _both(jo, to, both, **kw)
    np.testing.assert_array_equal(tr[0].numpy(),
                                  np.ones((d, s, s), np.float32))
    np.testing.assert_array_equal(np.asarray(jr[0]), tr[0].numpy())
    _close(tr[1:], jr[1:])
    good, _ = TD.xlfm_deconvolve(to, torch.from_numpy(img), **kw)
    _close(tr[1:], good.numpy(), 1e-6)


def test_deconv_init_obj_chaining():
    d, s, p = 4, 16, 24
    jo, to, hw, img = _rig(5, d, s, p)
    kw = dict(obj_hw=(s, s), roi_depths=d, full_hw=hw)
    (jone, _), (tone, _) = _both(jo, to, img, n_iter=6, **kw)
    mid, _ = TD.xlfm_deconvolve(to, torch.from_numpy(img), n_iter=4, **kw)
    two, _ = TD.xlfm_deconvolve(to, torch.from_numpy(img), n_iter=2,
                                init_obj=mid, **kw)
    _close(two, jone)
    _close(two, tone.numpy(), 1e-6)
    with pytest.raises(ValueError, match="init_obj"):
        TD.xlfm_deconvolve(to, torch.from_numpy(img), n_iter=1,
                           init_obj=mid[:, :2], **kw)


@pytest.mark.parametrize("fourier_sum", [True, False])
def test_deconv_odd_canvas_with_full_hw(fourier_sum):
    d, s, p = 2, 17, 32                  # 17 + 32 = 49: odd
    jo, to, hw, img = _rig(11, d, s, p, smooth=False)
    assert hw[1] % 2 == 1
    (jr, je), (tr, te) = _both(jo, to, img, n_iter=6, obj_hw=(s, s),
                               roi_depths=d, full_hw=hw,
                               fourier_sum=fourier_sum)
    assert tuple(te.shape) == (1, 1, 49, 49)
    _close(tr, jr)
    _close(te, je)


def test_deconv_zero_iterations():
    jo, to, hw, img = _rig(2, 2, 8, 16)
    (jr, je), (tr, te) = _both(jo, to, img, n_iter=0, obj_hw=(8, 8),
                               roi_depths=2, full_hw=hw)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


_VALUES = st.one_of(st.sampled_from([0.0, -0.0, 1.5, -2.0, 3.0, 1e-3]),
                    st.floats(-1e4, 1e4, width=32, allow_nan=False,
                              allow_subnormal=False))


@settings(max_examples=60, deadline=None)
@given(rows=st.integers(1, 3).flatmap(
    lambda b: st.integers(1, 40).flatmap(
        lambda n: st.lists(st.lists(_VALUES, min_size=n, max_size=n),
                           min_size=b, max_size=b))))
def test_median_nonzero_matches_jax_exactly(rows):
    # rows zero-padded to one (3, 40) shape, so that JAX compiles once:
    # zeros are outside the median by definition
    x = np.zeros((3, 40), np.float32)
    for i, r in enumerate(rows):
        x[i, :len(r)] = r
    got = TD._median_nonzero_batch(torch.from_numpy(x)).numpy()
    want_bits = np.asarray(_JBITS(jnp.asarray(x)))
    want_sort = np.asarray(_JSORT(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want_bits)
    np.testing.assert_array_equal(got, want_sort)


@settings(max_examples=60, deadline=None)
@given(row=st.lists(st.one_of(st.just(0.0), st.floats(
    -1e4, 1e4, width=32, allow_nan=False)), min_size=1, max_size=40))
def test_median_nonzero_is_torchs_expression(row):
    """The reference's ``t[t != 0].median()``, subnormals included."""
    t = torch.tensor(row, dtype=torch.float32)
    want = t[t != 0].median() if (t != 0).any() else torch.tensor(0.0)
    got = TD._median_nonzero_batch(t[None])[0]
    assert torch.equal(got, want)
    sub = torch.tensor([[0.0, 3.4268e-40, 0.0]])
    assert TD._median_nonzero_batch(sub)[0] == sub[0, 1] != 0


def test_median_nonzero_cases():
    rows = np.stack([np.zeros(8, np.float32),
                     np.repeat(np.array([0.5, -2.0, 3.0, 3.0]), 2),
                     np.array([0, 0, 0, 0, 0, 0, 0, 5.0])]).astype(np.float32)
    got = TD._median_nonzero_batch(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, [0.0, 0.5, 5.0])
    np.testing.assert_array_equal(
        got, np.asarray(JD._median_nonzero_batch(jnp.asarray(rows))))
