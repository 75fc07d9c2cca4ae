"""The port's fused 3-D pair of the condition nets (cwfa_tpu_torch.ops.cond_pair)
on the CPU, against the JAX package's 3-D pair forms, with the same weights
carried across by load_jax_params.

- The plain version against ``_conv3d_pair_direct`` (the reference layout),
  f32, at depths 6 and 8 and an odd H x W: 1e-5 of max|ref| (the sums run
  in another order in XLA and PyTorch).
- Against the Pallas kernel ``cond_pair_fused`` in interpret mode: its dots
  are bf16, so tests/test_cond_pair.py's bound (3e-2 of max|ref|).
- The whole port ``CondNetwork`` against ``cond_network`` with
  ``conv3d_impl="pallas_fused"`` (the same bound) and ``"direct"`` (1e-5).

- The pair written as the tensor-core instance computes it (two products
  with K on one side and the shift-and-add of conv_b's 27 planes,
  ``cond_pair_products``) against the plain version: 1e-5 of max|ref| in
  f32, 2^-7 in bf16 (chip_smoke.py's bounds for the kernel), and against the
  Pallas kernel in interpret mode.

Every elementwise tensor stays under 32,768 elements (the CPU's
multithreaded elementwise kernels above that size are not steady, PERF.md).
On the CPU ``cond_pair`` runs the plain version and counts no launch; the
CUDA kernel is held to the plain version on the card by chip_smoke.py.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu import nn as cnn
from cwfa_tpu.models import cond_net as jcond
from cwfa_tpu.ops.cond_pair import cond_pair_fused

from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.models.cond_net import CondNetwork
from cwfa_tpu_torch.ops import cond_pair as tcp

from test_torch_port_layers import randomize_fixed_leaves

C_IN = 4


def _net(d, seed=0):
    """JAX params (numpy, randomized PReLU alpha) and the port's CondNetwork
    (C_IN -> d) holding the same weights."""
    params = jcond.init_cond_network(jax.random.PRNGKey(seed), C_IN, d)
    params = randomize_fixed_leaves(params, np.random.RandomState(seed))
    net = CondNetwork(C_IN, d).eval()
    load_jax_params(net, params, {})
    return params, net


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_rel(got, want, bound):
    """max|got - want| <= bound * max|want|; got a torch tensor."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= bound * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("b,d,h,w", [(2, 6, 7, 9), (2, 8, 7, 9)])
def test_reference_matches_jax_direct(b, d, h, w):
    params, net = _net(d)
    x = _x(b, d, h, w)
    act = lambda u: cnn.prelu(_jnp(params)["prelu"], u)
    with jax.default_matmul_precision("highest"):
        want = jcond._conv3d_pair_direct(_jnp(params), jnp.asarray(x), act,
                                         0.0, None)
    launches = tcp.cond_pair.launches
    got = tcp.cond_pair(torch.from_numpy(x), net.c3a, net.c3b, net.prelu)
    assert tcp.cond_pair.launches == launches       # CPU: plain, no launch
    assert got.dtype == torch.float32 and got.is_contiguous()
    _assert_rel(got, want, 1e-5)


def test_reference_matches_pallas_fused_interpret():
    params, net = _net(8, seed=2)
    x = _x(1, 8, 8, 12, seed=3)
    want = cond_pair_fused(jnp.asarray(x), _jnp(params), th=4,
                           interpret=True)
    got = tcp.cond_pair_reference(torch.from_numpy(x), net.c3a, net.c3b,
                                  net.prelu)
    _assert_rel(got, want, 3e-2)


@pytest.mark.parametrize("impl,d,bound", [("pallas_fused", 8, 3e-2),
                                          ("direct", 6, 1e-5)])
def test_cond_network_matches_jax(impl, d, bound):
    params, net = _net(d, seed=4)
    x = _x(1, C_IN, 8, 12, seed=5)
    with jax.default_matmul_precision("highest"):
        want = jcond.cond_network(_jnp(params), jnp.asarray(x),
                                  conv3d_impl=impl)
    got = net(torch.from_numpy(x))
    assert got.is_contiguous()
    _assert_rel(got, want, bound)


def test_bf16_rounds_y_and_z_only():
    """bf16: y and z are rounded to bf16 and nothing else, so the result
    equals the f32 plain version fed bf16-rounded inputs and weights within
    z's rounding and y's (2^-6 of max|ref|)."""
    _, net = _net(6, seed=6)
    x = torch.from_numpy(_x(2, 6, 7, 9, seed=7)).to(torch.bfloat16)
    net16 = CondNetwork(C_IN, 6).eval()
    net16.load_state_dict(net.state_dict())
    net16 = net16.to(torch.bfloat16)
    got = tcp.cond_pair(x, net16.c3a, net16.c3b, net16.prelu)
    assert got.dtype == torch.bfloat16
    net32 = net16.float()
    want = tcp.cond_pair(x.float(), net32.c3a, net32.c3b, net32.prelu)
    _assert_rel(got, want.detach().numpy(), 2.0 ** -6)


def test_cond_pair_rejects_what_the_kernel_does_not_take():
    _, net = _net(6)
    mods = (net.c3a, net.c3b, net.prelu)
    x = torch.from_numpy(_x(1, 6, 5, 7))
    with pytest.raises(TypeError):                  # f64
        tcp.cond_pair(x.double(), *mods)
    with pytest.raises(ValueError):                 # not (B, D, H, W)
        tcp.cond_pair(x[0], *mods)
    with pytest.raises(ValueError):                 # not contiguous
        tcp.cond_pair(x.transpose(2, 3), *mods)
    with pytest.raises(TypeError):                  # weights neither x's
        tcp.cond_pair(x.to(torch.bfloat16),           # dtype nor f32
                      *[copy.deepcopy(m).half() for m in mods])
    wide = torch.nn.Conv3d(32, 2, 3, padding=1)     # conv_b with 2 outputs
    with pytest.raises(ValueError):
        tcp.cond_pair(x, net.c3a, wide, net.prelu)
    with pytest.raises(ValueError):                 # conv_a with 2 inputs
        tcp.cond_pair(x, torch.nn.Conv3d(2, 32, 3, padding=1), net.c3b,
                      net.prelu)
    with pytest.raises(ValueError):                 # one alpha per channel
        tcp.cond_pair(x, net.c3a, net.c3b, torch.nn.PReLU(4))
    with pytest.raises(RuntimeError):               # neither CPU nor CUDA
        tcp.cond_pair(x.to("meta"), *mods)


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("b,d,h,w", [(2, 6, 7, 9), (1, 5, 3, 11)])
def test_products_form_matches_reference(dtype, bound, b, d, h, w):
    """Depth 6 (the flagship's last step) and 5, odd H x W: the SAME padding
    of both convs in all three dims, y zero outside the volume."""
    _, net = _net(d, seed=8)
    net = net.to(dtype)
    x = torch.from_numpy(_x(b, d, h, w, seed=9)).to(dtype)
    mods = (net.c3a, net.c3b, net.prelu)
    with torch.no_grad():
        want = tcp.cond_pair_reference(x, *mods)
        got = tcp.cond_pair_products(x, *mods)
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    _assert_rel(got.float(), want.float().numpy(), bound)


def test_products_form_matches_pallas_fused_interpret():
    params, net = _net(8, seed=2)
    x = _x(1, 8, 8, 12, seed=3)
    want = cond_pair_fused(jnp.asarray(x), _jnp(params), th=4,
                           interpret=True)
    with torch.no_grad():
        got = tcp.cond_pair_products(torch.from_numpy(x), net.c3a, net.c3b,
                                     net.prelu)
    _assert_rel(got, want, 3e-2)


def test_kernel_instances():
    assert tcp.kernel_instance(torch.bfloat16, 32) == tcp.TENSOR_CORES
    assert tcp.kernel_instance(torch.float32, 32) == tcp.CUDA_CORES
    assert tcp.kernel_instance(torch.bfloat16, 4) == tcp.CUDA_CORES
    assert set(tcp.cond_pair.by_instance) == {tcp.TENSOR_CORES, tcp.CUDA_CORES}
    _, net = _net(6)
    x = torch.from_numpy(_x(1, 6, 5, 7))
    with pytest.raises(ValueError):                 # not an instance to ask for
        tcp.cond_pair(x, net.c3a, net.c3b, net.prelu,
                      instance=tcp.TENSOR_CORES)
    tcp.cond_pair(x, net.c3a, net.c3b, net.prelu, instance=tcp.CUDA_CORES)
