"""The port's FFT convolution (``cwfa_tpu_torch/ops/fft_conv.py``, on
``torch.fft``) against the JAX package's (``cwfa_tpu/ops/fft_conv.py``, on
``jnp.fft``) on the CPU: ``fftshift2d_real`` on odd and even sizes (for odd
ones it is not ``torch.fft.fftshift``), ``shifted_crop`` against roll-then-
crop, ``_pad_center``, ``_next_smooth_same_parity`` over 1..3000,
``precompute_otf`` smooth and exact with depth chunking, ``fft_conv``, and
``xlfm_forward_project`` with ``psf_hw``, a ragged depth chunk and an odd
canvas.  Inputs from numpy seeds; f32; bounds 1e-5 * max|ref| (the
index-only functions exactly)."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu_torch.ops import fft_conv as T

J = importlib.import_module("cwfa_tpu.ops.fft_conv")


def _close(got, want, bound=1e-5):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bound * float(np.abs(want).max()), err


def _psf(rng, d, p):
    psf = np.abs(rng.rand(1, d, p, p)).astype(np.float32)
    return psf / psf.sum(axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize("hw", [(4, 6), (5, 7), (6, 5), (9, 9)])
def test_fftshift2d_real(hw):
    x = np.random.RandomState(0).randn(2, 3, *hw).astype(np.float32)
    got = T.fftshift2d_real(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(J.fftshift2d_real(jnp.asarray(x))))
    if hw[0] % 2:
        # the reference's roll is ifftshift for odd sizes
        assert not np.array_equal(
            got, torch.fft.fftshift(torch.from_numpy(x), dim=(2, 3)).numpy())


@pytest.mark.parametrize("hw", [(12, 12), (13, 11)])
def test_shifted_crop_is_roll_then_crop(hw):
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 2, *hw)
                         .astype(np.float32))
    rolled = T.fftshift2d_real(x)
    for start, size in (((0, 0), hw), ((3, 2), (5, 7)), ((6, 4), (6, 7))):
        np.testing.assert_array_equal(
            T.shifted_crop(x, start, size).numpy(),
            rolled[:, :, start[0]:start[0] + size[0],
                   start[1]:start[1] + size[1]].numpy())


@pytest.mark.parametrize("shape,target", [((1, 2, 5, 6), (9, 9)),
                                          ((2, 1, 4, 4), (7, 10))])
def test_pad_center(shape, target):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(
        T._pad_center(torch.from_numpy(x), target).numpy(),
        np.asarray(J._pad_center(jnp.asarray(x), target)))


def test_next_smooth_same_parity():
    got = [T._next_smooth_same_parity(n) for n in range(1, 3001)]
    assert got == [J._next_smooth_same_parity(n) for n in range(1, 3001)]
    assert T._next_smooth_same_parity(2760) == 2880


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("depth_chunk", [2, 24])
def test_precompute_otf(smooth, depth_chunk):
    psf = _psf(np.random.RandomState(3), 5, 14)
    jo, jhw = J.precompute_otf(jnp.asarray(psf), (15, 15), smooth=smooth,
                               depth_chunk=depth_chunk)
    to, thw = T.precompute_otf(torch.from_numpy(psf), (15, 15),
                               smooth=smooth, depth_chunk=depth_chunk)
    assert thw == jhw == ((45, 45) if smooth else (29, 29))
    assert to.dtype == torch.complex64
    _close(to, jo)


def test_fft_conv():
    rng = np.random.RandomState(4)
    psf = _psf(rng, 3, 12)
    a = rng.rand(2, 3, 10, 10).astype(np.float32)
    jo, hw = J.precompute_otf(jnp.asarray(psf), (10, 10))
    to, _ = T.precompute_otf(torch.from_numpy(psf), (10, 10))
    _close(T.fft_conv(torch.from_numpy(a), to, hw),
           J.fft_conv(jnp.asarray(a), jo, hw))


@pytest.mark.parametrize("depth_chunk", [None, 2, 3])
@pytest.mark.parametrize("psf_hw", [None, (16, 16)])
@pytest.mark.parametrize("smooth", [True, False])
def test_xlfm_forward_project(depth_chunk, psf_hw, smooth):
    rng = np.random.RandomState(5)
    d, s, p = 5, 15, 16                       # obj + psf = 31: odd canvas
    psf = _psf(rng, d, p)
    vol = rng.rand(2, d, s, s).astype(np.float32)
    jo, hw = J.precompute_otf(jnp.asarray(psf), (s, s), smooth=smooth)
    to, _ = T.precompute_otf(torch.from_numpy(psf), (s, s), smooth=smooth)
    got = T.xlfm_forward_project(torch.from_numpy(vol), to, hw,
                                 psf_hw=psf_hw, depth_chunk=depth_chunk)
    want = J.xlfm_forward_project(jnp.asarray(vol), jo, hw, psf_hw=psf_hw,
                                  depth_chunk=depth_chunk)
    assert tuple(got.shape) == (2, 1) + (psf_hw or hw)
    _close(got, want)
