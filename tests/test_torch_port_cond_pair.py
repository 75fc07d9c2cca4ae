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

- The pair written as the tensor-core instances compute it (two products
  with K on one side and the shift-and-add of conv_b's 27 planes,
  ``cond_pair_products``) against the plain version: 1e-5 of max|ref| in
  f32, 2^-7 in bf16 (chip_smoke.py's bounds for the kernel), and against the
  Pallas kernel in interpret mode.  In f32 (3xTF32, the kink rule) also
  against ``_conv3d_pair_direct`` at highest precision and against the f64
  pair ``cond_pair_f64``, with the Dropout3d scale: 1e-5 of max|ref|; at a
  pre of -2^-31 that is +2^-31 exactly it takes the f32 forward's branch;
  conv_b's operand order (y's sums as they sit, W_b's K permuted) walked
  lane by lane; the f32 instance's host plan fits the card at every shape
  chip_smoke.py runs.

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

from test_torch_port_bwd_wg import _kink_pair, _pair
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
    assert tcp.kernel_instance(torch.float32, 32) == tcp.TENSOR_CORES_TF32
    assert tcp.kernel_instance(torch.bfloat16, 4) == tcp.CUDA_CORES
    assert tcp.kernel_instance(torch.float32, 4) == tcp.CUDA_CORES
    assert set(tcp.cond_pair.by_instance) == {
        tcp.TENSOR_CORES, tcp.TENSOR_CORES_TF32, tcp.CUDA_CORES}
    _, net = _net(6)
    x = torch.from_numpy(_x(1, 6, 5, 7))
    with pytest.raises(ValueError):                 # not an instance to ask for
        tcp.cond_pair(x, net.c3a, net.c3b, net.prelu,
                      instance=tcp.TENSOR_CORES)
    tcp.cond_pair(x, net.c3a, net.c3b, net.prelu, instance=tcp.CUDA_CORES)


@pytest.mark.parametrize("b,d,h,w", [(2, 6, 7, 9), (1, 8, 5, 11)])
def test_products_f32_matches_jax_direct(b, d, h, w):
    """The f32 tensor-core instance's arithmetic (3xTF32, the kink rule)
    against JAX's direct pair at highest precision: 1e-5 of max|ref|."""
    params, net = _net(d, seed=10)
    x = _x(b, d, h, w, seed=11)
    act = lambda u: cnn.prelu(_jnp(params)["prelu"], u)
    with jax.default_matmul_precision("highest"):
        want = jcond._conv3d_pair_direct(_jnp(params), jnp.asarray(x), act,
                                         0.0, None)
    with torch.no_grad():
        got = tcp.cond_pair_products(torch.from_numpy(x), net.c3a, net.c3b,
                                     net.prelu)
    assert got.dtype == torch.float32 and got.is_contiguous()
    _assert_rel(got, want, 1e-5)


@pytest.mark.parametrize("shape,with_scale", [((1, 6, 8, 9), False),
                                              ((1, 6, 8, 9), True),
                                              ((2, 5, 6, 7), True)])
def test_products_f32_within_f64(shape, with_scale):
    """... and against the f64 pair (``cond_pair_f64``, PReLU's branch where
    the f32 kernels take it), with and without the Dropout3d scale: 1e-5 of
    max|ref|."""
    rng = np.random.RandomState(sum(shape) + 3 * with_scale)
    mods = _pair(32, sum(shape) + 2)
    x = torch.as_tensor(rng.randn(*shape).astype(np.float32))
    scale = None
    if with_scale:
        scale = torch.as_tensor(
            ((rng.rand(shape[0], 32) < 0.5) * 2.0).astype(np.float32))
    with torch.no_grad():
        want = tcp.cond_pair_f64(x, *mods, scale)
        got = tcp.cond_pair_products(x, *mods, scale)
    assert want.dtype == torch.float64 and want.shape == x.shape
    _assert_rel(got, want.numpy(), 1e-5)


def test_products_f32_takes_the_forward_branch_at_the_kink():
    """At a pre of 1 + 2^-30 - 1 - 2^-31 (-2^-31 as the f32 forward sums it,
    +2^-31 exactly) the 3xTF32 pre is the f32 forward's tap-order sum, so
    the forward takes the branch that the backward and ``cond_pair_f64``
    take; the result stays within 1e-5 of the f64 pair."""
    x, _, mods = _kink_pair()
    with torch.no_grad():
        pre = tcp.pre_products(x, mods[0].weight, mods[0].bias)
        taps = tcp.pre_f32_taps(x, mods[0].weight, mods[0].bias)
        exact = torch.nn.functional.conv3d(
            x.double().permute(0, 2, 3, 1).unsqueeze(1),
            mods[0].weight.double(), mods[0].bias.double(), padding=1)
        got = tcp.cond_pair_products(x, *mods)
        want = tcp.cond_pair_f64(x, *mods)
    assert pre[0, 0, 2, 2, 2].item() == taps[0, 0, 2, 2, 2].item() == -2.0 ** -31
    assert exact[0, 0, 2, 2, 2].item() > 0
    assert torch.equal(pre > 0, taps > 0)
    _assert_rel(got, want.numpy(), 1e-5)


def test_conv_b_operand_order_walked_lane_by_lane():
    """The f32 instance's conv_b (``cond_pair_tf32_kernel``): lane 4 g + q
    holds conv_a's sums of channels 8 ks + 2 q, + 1 at rows g, g + 8 and
    hands them on as the m16n8k8 A fragment (a0 = row g slot q, a1 = row
    g + 8 slot q, a2, a3 = slot q + 4); W_b's B fragment b0 / b1 of k-step
    ks holds slot q / q + 4 as channel 8 ks + 2 q / + 1.  Walked lane by
    lane, the products give y . W_b exactly (f64)."""
    rng = np.random.RandomState(12)
    y = torch.as_tensor(rng.randn(16, 32))           # a tile's 16 rows
    wb = torch.as_tensor(rng.randn(32, 32))          # [channel][tap]
    got = torch.zeros(16, 32, dtype=torch.float64)
    for ks in range(4):
        a = torch.zeros(16, 8, dtype=torch.float64)  # [row][slot]
        bm = torch.zeros(8, 32, dtype=torch.float64)  # [slot][tap]
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            # the sum fragment c0..c3 of n-tile ks: (g, 2q), (g, 2q+1),
            # (g+8, 2q), (g+8, 2q+1) -> a0 = c0, a1 = c2, a2 = c1, a3 = c3
            c = [y[g, 8 * ks + 2 * q], y[g, 8 * ks + 2 * q + 1],
                 y[g + 8, 8 * ks + 2 * q], y[g + 8, 8 * ks + 2 * q + 1]]
            a[g, q], a[g + 8, q], a[g, q + 4], a[g + 8, q + 4] = \
                c[0], c[2], c[1], c[3]
            for nt in range(4):
                n = 8 * nt + g
                for r in range(2):               # b0, b1: slot q + 4 r
                    bm[q + 4 * r, n] = wb[8 * ks + 2 * q + r, n]
        got += a @ bm
    assert (got - y @ wb).abs().max().item() < 1e-12


@pytest.mark.parametrize("b,d,h,w", [(1, 48, 512, 512), (1, 24, 512, 512),
                                     (1, 12, 512, 512), (1, 6, 512, 512),
                                     (8, 48, 512, 512), (2, 5, 37, 53),
                                     (2, 8, 19, 35), (1, 24, 96, 80)])
def test_tf32_plan_fits_the_card(b, d, h, w):
    """The f32 instance's host plan at every shape chip_smoke.py runs it:
    chunks of at most TF32_MAX_TD depths that cover D, a block's shared
    memory within the card's 227 KB, two blocks to an SM, and the grid's
    z extent within 65535."""
    plan = tcp.pair_plan(torch.float32, 32, d)
    assert plan["instance"] == tcp.TENSOR_CORES_TF32
    td, n = plan["td"], plan["nchunks"]
    assert td <= tcp.TF32_MAX_TD and td * n >= d > td * (n - 1)
    # 27 planes of 356 floats, 2 x 4 x 4 x 32 uint4 fragments, the x window
    assert plan["smem"] == (27 * 356 + 2 * 4 * 4 * 32 * 4 + (td + 4) * 432) * 4
    assert plan["smem"] <= tcp.SMEM_MAX
    assert 2 * (plan["smem"] + 1024) <= tcp.SM_SMEM
    assert b * n <= 65535
    assert tcp.pair_plan(torch.float32, 32, d, tcp.CUDA_CORES) == {
        "instance": tcp.CUDA_CORES}
    assert tcp.pair_plan(torch.bfloat16, 32, d) == {
        "instance": tcp.TENSOR_CORES}
