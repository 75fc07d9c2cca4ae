"""The rest of the invertible-op library (counterpart of
``cwfa_tpu/flow/extra.py``).  No CWFA entry point runs these; the
reference ships them with its flow runtime, so its users find them here,
in the same convention ``op(params, x, rev) -> (y, logdet (B,) f32)`` with
params a dict of tensors.  Random draws take an explicit
``torch.Generator`` where the JAX package takes a key.

- fixed linear / 1x1-conv transforms      (FrEIA fixed_transforms.py:50-133)
- i-RevNet down/upsampling, flatten/reshape (FrEIA reshapes.py:12-193,321-446)
- 2D<->3D layout changes                  (reference INN_utils.py:18-124)
- orthogonal / householder transforms     (FrEIA orthogonal.py:7-231)
- invertible autoencoder activations/layers (FrEIA inv_auto_layers.py:12-272)
- i-ResNet layer with Hutchinson log-det  (FrEIA invertible_resnet.py:89-234)
- Gaussian mixture model head             (FrEIA gaussian_mixture.py:7-174)
- sequential INN combinator               (FrEIA framework/sequence_inn.py)
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def _zeros(x):
    return torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Fixed linear transforms
# ---------------------------------------------------------------------------


def init_fixed_linear(m, b=None):
    """{"m", "m_inv", "b", "logdet"} of the fixed map y = M x + b (f32;
    the inverse and the log-det from numpy, as in the JAX package)."""
    m = np.asarray(m, np.float32)
    _, logdet = np.linalg.slogdet(m)
    b = np.zeros(m.shape[0], np.float32) if b is None else np.asarray(b)
    return {"m": torch.as_tensor(m),
            "m_inv": torch.as_tensor(np.linalg.inv(m)),
            "b": torch.as_tensor(b, dtype=torch.float32),
            "logdet": torch.tensor(logdet, dtype=torch.float32)}


def fixed_linear(params, x, rev=False):
    """y = x M^T + b on (B, D) vectors."""
    j = params["logdet"].expand(x.shape[0])
    if rev:
        return (x - params["b"]) @ params["m_inv"].t(), -j
    return x @ params["m"].t() + params["b"], j


def fixed_1x1_conv(params, x, rev=False):
    """Per-pixel channel matmul on (B, C, H, W)."""
    n_pixels = float(math.prod(x.shape[2:]))
    j = (params["logdet"] * n_pixels).expand(x.shape[0])
    m = params["m_inv"] if rev else params["m"]
    return torch.einsum("oc,bchw->bohw", m, x), (-j if rev else j)


# ---------------------------------------------------------------------------
# Reshapes
# ---------------------------------------------------------------------------


def irevnet_downsampling(x, rev=False):
    """(B, C, H, W) <-> (B, 4C, H/2, W/2) checkerboard reshuffle; log-det 0
    (FrEIA reshapes.py:12-92)."""
    if not rev:
        b, c, h, w = x.shape
        y = x.reshape(b, c, h // 2, 2, w // 2, 2)
        y = y.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)
        return y, _zeros(x)
    b, c4, h, w = x.shape
    y = x.reshape(b, 2, 2, c4 // 4, h, w)
    return y.permute(0, 3, 4, 1, 5, 2).reshape(b, c4 // 4, 2 * h,
                                               2 * w), _zeros(x)


def irevnet_upsampling(x, rev=False):
    return irevnet_downsampling(x, rev=not rev)


def flatten(x, rev=False, shape=None):
    if rev:
        return x.reshape((x.shape[0],) + tuple(shape)), _zeros(x)
    return x.reshape(x.shape[0], -1), _zeros(x)


def reshape(x, target_shape, rev=False, input_shape=None):
    shp = input_shape if rev else target_shape
    return x.reshape((x.shape[0],) + tuple(shp)), _zeros(x)


# ---------------------------------------------------------------------------
# 2D <-> 3D layout changes
# ---------------------------------------------------------------------------


def turn_2d_to_3d(x, split_factor=3):
    """(B, C, H, W) -> (B, split, H, W, C/split) by channel groups."""
    c = x.shape[1]
    if c % split_factor:
        raise ValueError(f"channels {c} not divisible by split_factor "
                         f"{split_factor}")
    return torch.stack([p.permute(0, 2, 3, 1)
                        for p in torch.chunk(x, split_factor, dim=1)], dim=1)


def turn_3d_to_2d(x):
    """(B, S, H, W, C) -> (B, S*C, H, W) with depth-group-major channels."""
    if x.dim() == 4:
        return x
    return torch.cat([x[:, i].permute(0, 3, 1, 2)
                      for i in range(x.shape[1])], dim=1)


def inv_2d_to_3d(x, rev=False, split_factor=3):
    y = turn_3d_to_2d(x) if rev else turn_2d_to_3d(x, split_factor)
    return y, _zeros(x)


def inv_3d_to_2d(x, rev=False, split_factor=3):
    y = turn_2d_to_3d(x, split_factor) if rev else turn_3d_to_2d(x)
    return y, _zeros(x)


# ---------------------------------------------------------------------------
# Orthogonal / Householder
# ---------------------------------------------------------------------------


def householder_matrix(vs):
    """Product of Householder reflections I - 2 v v^T / (v^T v)
    (FrEIA orthogonal.py:7-63)."""
    d = vs.shape[1]
    eye = torch.eye(d, dtype=vs.dtype, device=vs.device)
    w = eye
    for i in range(vs.shape[0]):
        v = vs[i:i + 1].t()
        w = w @ (eye - 2.0 * (v @ v.t()) / (v * v).sum())
    return w


def init_householder_perm(generator, dims: int, n_reflections: int = 1):
    return {"vs": 0.2 * torch.randn((n_reflections, dims),
                                    generator=generator)}


def householder_perm(params, x, rev=False, fixed=False):
    """x @ W (rev: x @ W^T); W orthogonal, log-det 0."""
    w = householder_matrix(params["vs"].float()).to(x.dtype)
    return x @ (w.t() if rev else w), _zeros(x)


def init_orthogonal_transform(generator, dims: int):
    """A learned orthogonal matrix, initialized as the Q of a Gaussian
    matrix; training re-projects it (``stiefel_project``,
    orthogonal.py:80-231)."""
    q, _ = torch.linalg.qr(torch.randn((dims, dims), generator=generator))
    return {"w": q}


def orthogonal_transform(params, x, rev=False):
    w = params["w"].to(x.dtype)
    return x @ (w.t() if rev else w), _zeros(x)


def stiefel_project(params):
    """The weight re-orthogonalized (U V^T of its SVD); the reference does
    this in a backward hook."""
    u, _, vt = torch.linalg.svd(params["w"], full_matrices=False)
    return {"w": u @ vt}


# ---------------------------------------------------------------------------
# Invertible autoencoder layers
# ---------------------------------------------------------------------------


def inv_auto_act(params, x, rev=False):
    """y = x*a for x >= 0, x/a below, a = exp(log_alpha)."""
    a = torch.exp(torch.as_tensor(params["log_alpha"])).to(x.dtype)
    pos = x >= 0
    y = torch.where(pos, x / a, x * a) if rev else torch.where(pos, x * a,
                                                               x / a)
    s = torch.log(a).float() * torch.where(pos, 1.0, -1.0)
    j = s.reshape(x.shape[0], -1).sum(dim=1)
    return y, (-j if rev else j)


def init_inv_auto_act_two_sided(n_chans: int, init_pos: float = 2.0,
                                init_neg: float = 0.5):
    """Per-channel slopes in log space (inv_auto_layers.py:29-53)."""
    return {"alpha_pos": torch.full((n_chans,), float(np.log(init_pos))),
            "alpha_neg": torch.full((n_chans,), float(np.log(init_neg)))}


def inv_auto_act_two_sided(params, x, rev=False):
    """Leaky-ReLU-like activation with learned per-channel slopes
    (inv_auto_layers.py:12-71):
    log_slope = a_pos + 0.5*(a_neg - a_pos)*(1 - sign(x)), y = x*exp(ls);
    the reverse negates log_slope.  logdet = sum(log_slope)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    ap = params["alpha_pos"].reshape(shape)
    an = params["alpha_neg"].reshape(shape)
    ls = ap + 0.5 * (an - ap) * (1.0 - torch.sign(x).float())
    if rev:
        ls = -ls
    return x * torch.exp(ls).to(x.dtype), ls.reshape(x.shape[0],
                                                      -1).sum(dim=1)


def init_inv_auto_fc(generator, c_in: int, c_out: int | None = None):
    """W ~ N(0, 1/c_out) (c_out, c_in), bias ~ N(0, 1)
    (inv_auto_layers.py:196-198)."""
    c_out = c_in if c_out is None else c_out
    return {"w": torch.randn((c_out, c_in), generator=generator)
            * math.sqrt(1.0 / c_out),
            "b": torch.randn((c_out,), generator=generator)}


def inv_auto_fc(params, x, rev=False):
    """Fully-connected invertible-autoencoder layer (arXiv 1802.06869;
    inv_auto_layers.py:172-216): the reverse applies W^T, a true inverse
    only once W is orthogonal; the log-det is reported as 0, as the
    reference does."""
    w, b = params["w"].to(x.dtype), params["b"].to(x.dtype)
    if rev:
        return (x - b) @ w, _zeros(x)
    return x @ w.t() + b, _zeros(x)


def init_inv_auto_conv2d(generator, c_in: int, c_out: int | None = None,
                         kernel_size: int = 3):
    """W ~ U(+-1/sqrt(fan_in)) (torch's Conv2d default), bias ~ N(0, 1)."""
    c_out = c_in if c_out is None else c_out
    lim = math.sqrt(1.0 / (c_in * kernel_size * kernel_size))
    w = torch.empty((c_out, c_in, kernel_size, kernel_size))
    w.uniform_(-lim, lim, generator=generator)
    return {"w": w, "b": torch.randn((c_out,), generator=generator)}


def inv_auto_conv2d(params, x, rev=False, padding: int | None = None):
    """Convolutional invertible-autoencoder layer (inv_auto_layers.py:
    218-272): conv2d(x, W) + b; the reverse conv_transpose2d(x - b, W),
    the forward's adjoint.  log-det reported as 0."""
    w = params["w"].to(x.dtype)
    b = params["b"].to(x.dtype)[None, :, None, None]
    p = w.shape[-1] // 2 if padding is None else padding
    if not rev:
        return F.conv2d(x, w, padding=p) + b, _zeros(x)
    return F.conv_transpose2d(x - b, w, padding=p), _zeros(x)


def init_learned_elementwise_scaling(shape):
    return {"s": torch.zeros(shape)}


def learned_elementwise_scaling(params, x, rev=False):
    s = params["s"].float()
    j = s.sum().expand(x.shape[0])
    scale = torch.exp(s).to(x.dtype)
    if rev:
        return x / scale, -j
    return x * scale, j


# ---------------------------------------------------------------------------
# i-ResNet layer: y = x + g(x), Lipschitz(g) < 1
# ---------------------------------------------------------------------------


def rademacher(generator, shape, dtype=torch.float32):
    """+-1 with probability 1/2 each, drawn from ``generator`` on its
    device."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


def iresnet_forward(g: Callable, x, n_series: int = 8, generator=None):
    """y = x + g(x) with the Hutchinson power-series log-det estimate
    (invertible_resnet.py:89-234): logdet = sum_k (-1)^(k+1)/k tr(J_g^k),
    each trace from one Rademacher probe (``rademacher`` from
    ``generator``) through vector-Jacobian products.  Without a generator
    the log-det is 0."""
    y = x + g(x)
    if generator is None:
        return y, _zeros(x)
    v = rademacher(generator, x.shape, torch.float32).to(x.device, x.dtype)
    _, vjp = torch.func.vjp(g, x)
    w = v
    logdet = _zeros(x)
    for k in range(1, n_series + 1):
        (w,) = vjp(w)
        tr = (v * w).reshape(x.shape[0], -1).float().sum(dim=1)
        logdet = logdet + ((-1.0) ** (k + 1)) / k * tr
    return y, logdet


def iresnet_inverse(g: Callable, y, n_iter: int = 50):
    """The fixed point x = y - g(x), from x = y."""
    x = y
    for _ in range(n_iter):
        x = y - g(x)
    return x


# ---------------------------------------------------------------------------
# Gaussian mixture model head
# ---------------------------------------------------------------------------


def gmm_nll(z, mu, log_sigma, logit_w):
    """Negative log-likelihood of z (B, D) under a diagonal GMM
    (gaussian_mixture.py:7-174): components mu / log_sigma (K, D), weights
    softmax(logit_w) (K,)."""
    log_w = torch.log_softmax(logit_w, dim=0)
    z = z[:, None, :]
    comp = -0.5 * (((z - mu[None]) * torch.exp(-log_sigma[None])) ** 2
                   + 2 * log_sigma[None] + math.log(2 * math.pi)).sum(-1)
    return -torch.logsumexp(comp + log_w[None], dim=1)


def gmm_sample(generator, n: int, mu, log_sigma, logit_w):
    """n draws from the mixture: a component by its weight, then a normal
    around it, both from ``generator``."""
    comp = torch.multinomial(torch.softmax(logit_w.float(), dim=0), n,
                             replacement=True, generator=generator)
    eps = torch.randn((n, mu.shape[1]), generator=generator,
                      device=generator.device).to(mu.device, mu.dtype)
    comp = comp.to(mu.device)
    return mu[comp] + eps * torch.exp(log_sigma[comp])


# ---------------------------------------------------------------------------
# Sequential combinator
# ---------------------------------------------------------------------------


class SequenceINN:
    """Append-style sequential invertible net (FrEIA sequence_inn.py:10-99):
    ops are (apply, params) pairs with apply(params, x, rev) -> (y, logdet),
    or (apply, None) for apply(x, rev)."""

    def __init__(self, *ops):
        self.ops = list(ops)

    def append(self, apply_fn, params=None):
        self.ops.append((apply_fn, params))

    def __call__(self, x, rev=False):
        logdet = _zeros(x)
        for apply_fn, params in (reversed(self.ops) if rev else self.ops):
            if params is None:
                x, j = apply_fn(x, rev=rev)
            else:
                x, j = apply_fn(params, x, rev=rev)
            logdet = logdet + j
        return x, logdet
