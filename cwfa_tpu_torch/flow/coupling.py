"""Affine coupling blocks with soft-clamped scales and exact log-dets
(counterpart of ``cwfa_tpu/flow/coupling.py``):

- ``cat_transform`` / ``cat_apply``  ConditionalAffineTransform, the default
                         CWFA block: (s, t) from the condition only;
- ``two_sided_coupling`` NICE / RNVP / GLOW / GIN;
- ``one_sided_coupling`` AffineCouplingOneSided;
- ``all_in_one_block``   GLOW-style coupling + global affine + fixed 1x1
                         permutation (``init_all_in_one_block``).

Subnets are callables, as in the JAX package (there ``(apply, params)``
pairs); the blocks own no parameters but AI1's global affine and
permutation, which the caller holds.

Clamp: s = clamp * f(s_raw) with f in {ATAN: 0.636*atan, TANH,
SIGMOID: 2*(sigmoid-0.5)} (reference coupling_layers.py:50-60).  The ATAN
factor is 0.636, not 2/pi.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

# Activation codes shared with the CUDA kernels (csrc/flow_affine.cu).
CLAMP_ACTIVATIONS = ("ATAN", "TANH", "SIGMOID")


def clamp_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "ATAN":
        return lambda u: 0.636 * torch.atan(u)
    if name == "TANH":
        return torch.tanh
    if name == "SIGMOID":
        return lambda u: 2.0 * (torch.sigmoid(u) - 0.5)
    raise ValueError(f"Unknown clamp activation {name!r}")


def cat_transform(subnet, x, conds, rev=False, clamp: float = 2.0,
                  clamp_activation: str = "ATAN"):
    """Affine transform of the whole tensor from the condition only
    (coupling_layers.py:440-500).  ``conds`` is a sequence of (B, Ci, H, W)
    tensors concatenated on channels; ``subnet`` maps sum(Ci) -> 2*C.
    Returns (y, per-sample logdet in f32)."""
    cond = conds[0] if len(conds) == 1 else torch.cat(list(conds), dim=1)
    return cat_apply(subnet(cond), x, rev, clamp, clamp_activation)


def cat_apply(a, x, rev=False, clamp: float = 2.0,
              clamp_activation: str = "ATAN"):
    """The CAT's affine of x from the subnet's output ``a`` = (s_raw | t)
    (B, 2C, H, W).  Returns (y, per-sample logdet in f32)."""
    c = x.shape[1]
    s_raw, t = a[:, :c], a[:, c:]
    s = (clamp * clamp_fn(clamp_activation)(s_raw.float())).to(x.dtype)
    j = s.float().sum(dim=tuple(range(1, s.dim())))
    if rev:
        return (x - t) * torch.exp(-s), -j
    return torch.exp(s) * x + t, j


def _sum_per_sample(s):
    return s.float().sum(dim=tuple(range(1, s.dim())))


def _affine(x, s, t, rev: bool):
    """y = exp(s)*x + t (fwd) / (x - t)*exp(-s) (rev), with the per-sample
    log-det in f32."""
    j = _sum_per_sample(s)
    if rev:
        return (x - t) * torch.exp(-s), -j
    return torch.exp(s) * x + t, j


def _with_conds(u, conds):
    return torch.cat([u, *conds], dim=1) if conds else u


# ---------------------------------------------------------------------------
# Two-sided couplings (NICE / RNVP / GLOW / GIN), coupling.py:80-156
# ---------------------------------------------------------------------------


def two_sided_coupling(kind: str, subnets, x, conds=(), rev=False,
                       clamp: float = 2.0, clamp_activation: str = "ATAN"):
    """Channel-split coupling over x = [x1 | x2] (split1 = C//2,
    split2 = C - C//2, coupling_layers.py:40-41).

    kind: 'NICE' | 'RNVP' | 'GLOW' | 'GIN'
    subnets: a mapping of callables u -> output —
       NICE:        {'F': s2->s1 residual, 'G': s1->s2 residual}
       RNVP:        {'s1', 't1', 's2', 't2'}  (coupling_layers.py:192-195)
       GLOW / GIN:  {'subnet1': s1+cond -> 2*s2, 'subnet2': s2+cond -> 2*s1}

    fwd computes y1 from (x2, c), then y2 from (y1, c); rev inverts in the
    opposite order (coupling_layers.py:62-87).  GIN centres s over the
    channels and reports a zero log-det.  Returns (y, logdet (B,) f32)."""
    c = x.shape[1]
    l1 = c // 2
    x1, x2 = x[:, :l1], x[:, l1:]
    fcl = clamp_fn(clamp_activation)
    zeros = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)

    def half(y, u, rev_, nice, rnvp_s, rnvp_t, joint, n_s):
        # transforms ``y`` from ``u`` (the other half, + conditions)
        if kind == "NICE":
            f = subnets[nice](u)
            return (y - f if rev_ else y + f), zeros
        if kind == "RNVP":
            s, t = subnets[rnvp_s](u), subnets[rnvp_t](u)
        else:  # GLOW / GIN: one subnet predicts (s | t)
            a = subnets[joint](u)
            s, t = a[:, :n_s], a[:, n_s:]
        s = clamp * fcl(s.float())
        if kind == "GIN":  # volume preserving: zero-mean over channels
            s = s - s.mean(dim=1, keepdim=True)
        y, j = _affine(y, s.to(x.dtype), t, rev_)
        return y, (zeros if kind == "GIN" else j)

    def coupling1(y, u, rev_):
        return half(y, _with_conds(u, conds), rev_, "F", "s2", "t2",
                    "subnet2", l1)

    def coupling2(y, u, rev_):
        return half(y, _with_conds(u, conds), rev_, "G", "s1", "t1",
                    "subnet1", c - l1)

    if not rev:
        y1, j1 = coupling1(x1, x2, False)
        y2, j2 = coupling2(x2, y1, False)
    else:
        y2, j2 = coupling2(x2, x1, True)
        y1, j1 = coupling1(x1, y2, True)
    return torch.cat([y1, y2], dim=1), j1 + j2


def one_sided_coupling(subnet, x, conds=(), rev=False, clamp: float = 2.0,
                       clamp_activation: str = "ATAN"):
    """AffineCouplingOneSided (coupling_layers.py:384-437): x2 transformed
    from (x1, conds); x1 passes.  Returns (y, logdet (B,) f32)."""
    c = x.shape[1]
    l1 = c // 2
    x1, x2 = x[:, :l1], x[:, l1:]
    a = subnet(_with_conds(x1, conds))
    s_raw, t = a[:, :c - l1], a[:, c - l1:]
    s = (clamp * clamp_fn(clamp_activation)(s_raw.float())).to(x.dtype)
    y2, j = _affine(x2, s, t, rev)
    return torch.cat([x1, y2], dim=1), j


# ---------------------------------------------------------------------------
# AllInOneBlock (coupling + 1x1 permutation + global affine),
# coupling.py:165-257
# ---------------------------------------------------------------------------

def init_all_in_one_block(generator: torch.Generator, channels: int,
                          global_affine_init: float = 1.0,
                          global_affine_type: str = "SOFTPLUS",
                          permute_soft: bool = False,
                          rng: np.random.RandomState | None = None):
    """{"global_scale", "global_offset": (1, C, 1, 1), "w_perm": (C, C)},
    f32, for ``all_in_one_block`` (all_in_one_block.py:46-168): the global
    scale's pre-activation that gives every channel ``global_affine_init``,
    a zero offset, and a hard permutation drawn from ``generator`` or, with
    ``permute_soft``, a random rotation (scipy's ``special_ortho_group``)
    drawn from ``rng``.  Never numpy's global RNG (the JAX init draws from
    it when no ``rng`` is passed).  Subnets live with the caller."""
    if global_affine_type == "SIGMOID":
        gs = 2.0 - math.log(10.0 / global_affine_init - 1.0)
    elif global_affine_type == "SOFTPLUS":
        gs = 2.0 * math.log(math.exp(0.5 * 10.0 * global_affine_init) - 1.0)
    elif global_affine_type == "EXP":
        gs = math.log(global_affine_init)
    else:
        raise ValueError(global_affine_type)
    if permute_soft:
        if rng is None:
            raise ValueError("permute_soft draws from rng, a "
                             "np.random.RandomState")
        from scipy.stats import special_ortho_group
        w = torch.as_tensor(special_ortho_group.rvs(channels,
                                                    random_state=rng),
                            dtype=torch.float32)
    else:
        w = torch.zeros((channels, channels))
        w[torch.arange(channels),
          torch.randperm(channels, generator=generator)] = 1.0
    return {"global_scale": torch.full((1, channels, 1, 1), float(gs)),
            "global_offset": torch.zeros((1, channels, 1, 1)),
            "w_perm": w}


def _global_scale_activation(kind: str, a):
    if kind == "SIGMOID":
        return 10.0 * torch.sigmoid(a - 2.0)
    if kind == "SOFTPLUS":
        return 0.1 * (F.softplus(0.5 * a) / 0.5)
    return torch.exp(a)


def all_in_one_block(params, subnet, x, conds=(), rev=False,
                     clamp: float = 2.0, gin_block: bool = False,
                     global_affine_type: str = "SOFTPLUS"):
    """AllInOneBlock.forward (all_in_one_block.py:229-271): for fwd, split
    (l1 = C - C//2) -> affine(x2 | subnet(x1, c)) -> concat -> global
    affine -> 1x1 permutation; rev the inverse, the permutation undone with
    w^T (w is orthogonal).  The subnet's output is scaled by 0.1 before the
    tanh clamp, and GIN centres s over all non-batch axes.

    params: a mapping with "global_scale", "global_offset" (1, C, 1, 1) and
    "w_perm" (C, C).  Returns (y, logdet (B,) f32)."""
    c = x.shape[1]
    l1 = c - c // 2
    w = params["w_perm"].float()

    def permute(u, rev_):
        scale = _global_scale_activation(global_affine_type,
                                         params["global_scale"].float())
        perm_jac = torch.log(scale).sum()
        if gin_block:
            scale, perm_jac = 1.0, torch.zeros((), device=x.device)
        offset = params["global_offset"].float()
        if rev_:
            out = torch.einsum("oc,bchw->bohw", w.t(), u.float())
            out = (out - offset) / scale
        else:
            out = u.float() * scale + offset
            out = torch.einsum("oc,bchw->bohw", w, out)
        return out.to(x.dtype), perm_jac

    def affine(x2, a, rev_):
        a = a.float() * 0.1  # stability scaling (all_in_one_block.py:214)
        ch = x2.shape[1]
        sj = clamp * torch.tanh(a[:, :ch])
        if gin_block:
            sj = sj - sj.mean(dim=tuple(range(1, sj.dim())), keepdim=True)
        t, s = a[:, ch:].to(x.dtype), sj.to(x.dtype)
        if rev_:
            return (x2 - t) * torch.exp(-s), -_sum_per_sample(sj)
        return x2 * torch.exp(s) + t, _sum_per_sample(sj)

    if rev:
        xp, gjac = permute(x, True)
    else:
        xp, gjac = x, None
    x1, x2 = xp[:, :l1], xp[:, l1:]
    y2, j2 = affine(x2, subnet(_with_conds(x1, conds)), rev)
    out = torch.cat([x1, y2], dim=1)
    if not rev:
        out, gjac = permute(out, False)
    n_pixels = float(math.prod(x.shape[2:]))
    sign = -1.0 if rev else 1.0
    return out, j2 + sign * n_pixels * gjac
