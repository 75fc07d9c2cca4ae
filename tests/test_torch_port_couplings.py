"""Every coupling type of the port (``--INN_block_type`` RNVP / GLOW / GIN /
NICE / AI1, and CAT beside them) against the JAX package on the CPU, from
the same numpy inputs and the same weights (``load_jax_params``):

- the coupling functions of ``flow/coupling.py`` (two-sided of each kind,
  one-sided, AI1), both directions, two clamps, an odd channel count;
- ``CWFStep.forward`` / ``reverse`` / ``reverse_fast`` of every type at 16
  depths and at 6 (c_flow 3, where the two-sided and AI1 splits differ),
  and ``reset_permutations``;
- ``CWFAModel.reconstruct`` (fast and not) and ``forward_pyramid``'s NLLs
  on a small rig of every type; ``quantize_steps`` None for a non-CAT step
  and an int8-tower reconstructor with a non-CAT model;
- one flow optimizer step of every type against JAX's (loss, gradients,
  Lion), AI1's ``w_perm`` left where it is by the port;
- an AI1 checkpoint with Lion state both ways, a tiny ``cli.train`` run
  with ``--INN_block_type RNVP``, and the reference torch-format paths
  refusing a non-CAT configuration.

f32, JAX at ``jax_default_matmul_precision=highest``; values within 1e-4 of
max|ref|, log-dets within 1e-4 * max(1, |ref|).  Tiny shapes: 16^2, two
blocks, 8-wide towers, every elementwise tensor under 32,768 elements.
The weights are drawn by the port's init and carried to JAX as numpy
trees (the JAX AI1 init would draw its permutation from numpy's global
RNG); the JAX functions run jitted (``_jit``).
"""

import contextlib
import functools
import io
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cwfa_tpu import data as jdata
from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.engine import losses as JL
from cwfa_tpu.engine.trainer import CWFATrainer as JTrainer
from cwfa_tpu.engine.trainer import make_optimizers as jmake_optimizers
from cwfa_tpu.flow import coupling as jfc
from cwfa_tpu.models import cwf as jcwf
from cwfa_tpu.models.cond_net import cond_network
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

from cwfa_tpu_torch.cli import export_torch as export_cli
from cwfa_tpu_torch.cli import train as train_cli
from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.engine import checkpoints as ckpt
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.jax_params import (export_jax_params,
                                              load_jax_params, param_tree)
from cwfa_tpu_torch.engine.torch_export import export_torch_checkpoints
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.flow import coupling as tfc
from cwfa_tpu_torch.models import cwf as tcwf
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.nn import reset_parameters_

from test_torch_port_layers import randomize_fixed_leaves

TYPES = ["CAT", "RNVP", "GLOW", "GIN", "NICE", "AI1"]
S = 16
SMALL = dict(n_depths=16, volume_side_size=S, n_lenslets=4,
             INN_max_down_steps=3, INN_n_blocks=2, INN_internal_chans=8,
             INN_cond_chans=4, use_half_precision=0)
STATS = (100.0, 50.0, 100.0, 50.0, 10.0, 5.0)
# the JAX reference programs compile at XLA's lowest backend effort: their
# numerics stay within rounding of the default's, their compile takes a
# third less on a CPU
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _rand(*shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, want, tol=1e-4):
    """|d| <= tol * max|ref|."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def assert_logdet_close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want)))


def _perturb_aio(tree, rng):
    """AI1's global scale and offset moved off their constant init, so that
    a wrong mapping shows."""
    if isinstance(tree, dict):
        if "global_scale" in tree:
            tree = dict(tree)
            gs = np.asarray(tree["global_scale"])
            tree["global_scale"] = (gs + rng.uniform(-0.5, 0.5, gs.shape)
                                    ).astype(np.float32)
            tree["global_offset"] = rng.uniform(
                -0.2, 0.2, gs.shape).astype(np.float32)
            return tree
        return {k: _perturb_aio(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_perturb_aio(v, rng) for v in tree]
    return np.asarray(tree)


# ----------------------------------------------------------- coupling fns

C_ODD = 5


def _linear(seed, c_in, c_out):
    """A 1x1 'subnet' given as the same numpy weights to both packages."""
    w = _rand(c_out, c_in, seed=seed, scale=0.4)
    return ((lambda p, u: jnp.einsum("oc,bchw->bohw", jnp.asarray(w), u),
             None),
            lambda u: torch.einsum("oc,bchw->bohw", torch.from_numpy(w), u))


def _subnets(kind, c, cond):
    l1, l2 = c // 2, c - c // 2
    shapes = {"NICE": {"F": (l2, l1), "G": (l1, l2)},
              "RNVP": {"s1": (l1, l2), "t1": (l1, l2), "s2": (l2, l1),
                       "t2": (l2, l1)},
              "GLOW": {"subnet1": (l1, 2 * l2), "subnet2": (l2, 2 * l1)}}
    shapes["GIN"] = shapes["GLOW"]
    jax_side, port = {}, {}
    for i, (name, (ci, co)) in enumerate(sorted(shapes[kind].items())):
        jax_side[name], port[name] = _linear(40 + i, ci + cond, co)
    return jax_side, port


@pytest.mark.parametrize("variant", ["ATAN", "SIGMOID"])
@pytest.mark.parametrize("kind", ["NICE", "RNVP", "GLOW", "GIN", "ONE_SIDED",
                                  "AI1"])
def test_coupling_functions_match_jax(kind, variant):
    """Both directions of each coupling on C = 5 (odd) with one condition;
    ``variant`` is the clamp activation, for AI1 ``gin_block`` off / on."""
    x, cond = _rand(2, C_ODD, 6, 6, seed=1), _rand(2, 3, 6, 6, seed=2)
    kw = {"clamp": 1.7}
    if kind == "AI1":
        rng = np.random.RandomState(3)
        w = np.linalg.qr(rng.randn(C_ODD, C_ODD))[0].astype(np.float32)
        params = {"global_scale": rng.uniform(0.5, 2.0, (1, C_ODD, 1, 1)),
                  "global_offset": rng.uniform(-0.3, 0.3, (1, C_ODD, 1, 1)),
                  "w_perm": w}
        params = {k: np.asarray(v, np.float32) for k, v in params.items()}
        jsub, tsub = _linear(7, C_ODD - C_ODD // 2 + 3, 2 * (C_ODD // 2))
        kw["gin_block"] = variant == "SIGMOID"

        def jfn(u, rev):
            return jfc.all_in_one_block(_jnp(params), jsub, u,
                                        (jnp.asarray(cond),), rev=rev, **kw)

        def tfn(u, rev):
            return tfc.all_in_one_block(
                {k: torch.from_numpy(v) for k, v in params.items()}, tsub, u,
                (torch.from_numpy(cond),), rev=rev, **kw)
    elif kind == "ONE_SIDED":
        l1 = C_ODD // 2
        jsub, tsub = _linear(8, l1 + 3, 2 * (C_ODD - l1))
        kw["clamp_activation"] = variant

        def jfn(u, rev):
            return jfc.one_sided_coupling(jsub, u, (jnp.asarray(cond),),
                                          rev=rev, **kw)

        def tfn(u, rev):
            return tfc.one_sided_coupling(tsub, u, (torch.from_numpy(cond),),
                                          rev=rev, **kw)
    else:
        jsubs, tsubs = _subnets(kind, C_ODD, 3)
        kw["clamp_activation"] = variant

        def jfn(u, rev):
            return jfc.two_sided_coupling(kind, jsubs, u,
                                          (jnp.asarray(cond),), rev=rev, **kw)

        def tfn(u, rev):
            return tfc.two_sided_coupling(kind, tsubs, u,
                                          (torch.from_numpy(cond),), rev=rev,
                                          **kw)
    for rev in (False, True):
        want, want_j = jfn(jnp.asarray(x), rev)
        got, got_j = tfn(torch.from_numpy(x), rev)
        assert_close(got, want)
        assert_logdet_close(got_j, want_j)
    # the port's own round trip, its log-dets cancelling
    y, jf = tfn(torch.from_numpy(x), False)
    back, jr = tfn(y, True)
    assert_close(back, x, 1e-5)
    assert float((jf + jr).abs().max()) <= 1e-4 * max(1.0, float(jf.abs().max()))


@pytest.mark.parametrize("affine", ["SIGMOID", "SOFTPLUS", "EXP"])
def test_init_all_in_one_block(affine):
    """The global scale is JAX's; the hard permutation is a permutation
    matrix drawn from the generator (the same seed, the same matrix), and
    the soft one JAX's for the same RandomState, which it needs; numpy's
    global RNG is not touched."""
    state = np.random.get_state()
    jp = jfc.init_all_in_one_block(None, 7, 0.7, affine, permute_soft=True,
                                   rng=np.random.RandomState(4))
    soft = tfc.init_all_in_one_block(torch.Generator().manual_seed(1), 7,
                                     0.7, affine, permute_soft=True,
                                     rng=np.random.RandomState(4))
    hard = [tfc.init_all_in_one_block(torch.Generator().manual_seed(s), 7,
                                      0.7, affine) for s in (2, 2, 3)]
    for a, b in zip(np.random.get_state(), state):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="rng"):
        tfc.init_all_in_one_block(torch.Generator(), 7, permute_soft=True)
    for p in (soft, *hard):
        np.testing.assert_allclose(p["global_scale"].numpy(),
                                   np.asarray(jp["global_scale"]), rtol=1e-6)
        assert not p["global_offset"].any()
    np.testing.assert_allclose(soft["w_perm"].numpy(),
                               np.asarray(jp["w_perm"]), atol=1e-6)
    w = hard[0]["w_perm"]
    assert sorted(w.sum(0).tolist()) == sorted(w.sum(1).tolist()) == [1.0] * 7
    assert torch.equal(w @ w.t(), torch.eye(7))
    assert torch.equal(w, hard[1]["w_perm"])
    assert not torch.equal(w, hard[2]["w_perm"])


# ---------------------------------------------------------------- CWF step


def _step_pair(bt, n_depths):
    """(JAX spec, params as numpy, the port's step with them); the weights
    drawn by the port's init, AI1's global affine moved off its init."""
    args = dict(n_depths=n_depths, spatial=S, n_flow_steps=1, n_blocks=2,
                block_type=bt, internal_ch=8, use_bias=True,
                use_final_perm=True, disable_low_res_input=False,
                global_seed=364898)
    jspec = jcwf.build_step_specs(**args)[0]
    step = tcwf.CWFStep(tcwf.build_step_specs(**args)[0])
    reset_parameters_(step, torch.Generator().manual_seed(n_depths))
    params, _ = export_jax_params(step)
    params = _perturb_aio(params, np.random.RandomState(12))
    load_jax_params(step, params, {})
    return jspec, params, step


def _jit_step(jspec, fn):
    return _jit(lambda p, *a: fn(jspec, p, *a))


def _jax_step_both(jspec):
    """JAX's forward and (non-fast) reverse of the step as one program."""
    @_jit
    def both(p, v, cv, cm, zn, up):
        return (jcwf.cwf_step_forward(jspec, p, v, cv, cm),
                jcwf.cwf_step_reverse(jspec, p, zn, up, cv, cm))
    return both


@pytest.mark.parametrize("n_depths", [16, 6], ids=["c_flow8", "c_flow3"])
@pytest.mark.parametrize("bt", TYPES)
def test_step_matches_jax(bt, n_depths):
    """forward (z, avg, logdet), reverse (volume, logdet) and reverse_fast
    against JAX's ``cwf_step_forward`` / ``cwf_step_reverse``; the port's
    round trip returns the volume."""
    jspec, params, step = _step_pair(bt, n_depths)
    c = n_depths // 2
    v, cv, cm = (_rand(2, n_depths, S, S, seed=20),
                 _rand(2, c, S, S, seed=21), _rand(2, c, S, S, seed=22))
    zn, up = _rand(2, c, S, S, seed=23), _rand(2, c, S, S, seed=24)
    targs = tuple(map(torch.from_numpy, (v, cv, cm)))
    (jz, javg, jld), (jv, jrld) = _jax_step_both(jspec)(params, v, cv, cm,
                                                        zn, up)
    z, avg, ld = step(*targs)
    assert_close(z, jz)
    assert_close(avg, javg)
    assert_logdet_close(ld, jld)
    got, rld = step.reverse(torch.from_numpy(zn), torch.from_numpy(up),
                            *targs[1:])
    assert_close(got, jv)
    assert_logdet_close(rld, jrld)
    fast = step.reverse_fast(torch.from_numpy(zn), torch.from_numpy(up),
                             *targs[1:])
    assert_close(fast, jv)
    with torch.no_grad():
        back, bld = step.reverse(z, avg, *targs[1:])
    assert_close(back, v, 1e-4)
    assert float((bld + ld).abs().max()) <= 1e-3 * max(1.0, float(
        ld.abs().max()))
    if bt != "CAT":
        with pytest.raises(ValueError, match=bt):
            step.towers(targs[1])


def test_reset_permutations_matches_jax():
    """The reset spec's permutations are JAX's, and a step that takes it
    (``set_spec``) matches JAX's forward under the reset spec."""
    jspec, params, step = _step_pair("GLOW", 16)
    jnew = jcwf.reset_permutations(jspec, seed=77)
    new = tcwf.reset_permutations(step.spec, seed=77)
    assert len(new.perms) == len(jnew.perms) == len(jspec.perms)
    for a, b, old in zip(new.perms, jnew.perms, jspec.perms):
        assert a[0] == b[0] == old[0]
        assert all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
    spatial = [e for e in new.perms if e[0] == "spatial"]
    assert spatial and not any(
        np.array_equal(e[-2], o[-2]) for e, o in zip(
            spatial, [e for e in jspec.perms if e[0] == "spatial"]))
    step.set_spec(new)
    v, cv, cm = (_rand(1, 16, S, S, seed=30), _rand(1, 8, S, S, seed=31),
                 _rand(1, 8, S, S, seed=32))
    jz, _, jld = _jit_step(jnew, jcwf.cwf_step_forward)(
        params, *map(jnp.asarray, (v, cv, cm)))
    z, _, ld = step(*map(torch.from_numpy, (v, cv, cm)))
    assert_close(z, jz)
    assert_logdet_close(ld, jld)


# ------------------------------------------------------------------ model


@functools.lru_cache(maxsize=None)
def _rig(bt):
    """(JAX model, params, mstate as numpy, the port's model with them);
    the weights drawn by the port's init, the fixed-init leaves (and AI1's
    global affine) randomized so that a wrong mapping shows."""
    jmodel = JModel.build(JConfig(**SMALL, INN_block_type=bt).decode_lrs())
    model = CWFAModel.build(
        CWFAConfig(**SMALL, INN_block_type=bt).decode_lrs(),
        torch.Generator().manual_seed(0)).eval()
    params, mstate = export_jax_params(model)
    rng = np.random.RandomState(0)
    params = _perturb_aio(randomize_fixed_leaves(params, rng), rng)
    mstate = randomize_fixed_leaves(mstate, rng)
    load_jax_params(model, params, mstate)
    return jmodel, params, mstate, model


@pytest.mark.parametrize("bt", TYPES)
def test_model_matches_jax(bt):
    """reconstruct (deterministic, fast and non-fast), the per-frame NLLs
    of ``forward_pyramid`` and ``param_counts`` against JAX."""
    jmodel, params, mstate, model = _rig(bt)
    nf = jmodel.n_flow_steps
    views = _rand(2, 4, S, S, seed=40)
    caches = [_rand(1, 16 // 2 ** (k + 1), S, S, seed=41 + k, scale=0.3)
              for k in range(nf + 1)]
    gt = _rand(2, 16, S, S, seed=45)

    @_jit
    def jax_side(p, s, v, c, g):
        return (jmodel.reconstruct(p, s, v, c, fast=False),
                jmodel.forward_pyramid(p, g, per_sample=True)[0])

    want, jnlls = jax_side(params, mstate, views, caches, gt)
    for fast in (True, False):
        got = model.reconstruct(torch.from_numpy(views),
                                [torch.from_numpy(c) for c in caches],
                                fast=fast)
        assert_close(got, want)
    nlls = model.forward_pyramid(torch.from_numpy(gt), per_sample=True)[0]
    for got, want in zip(nlls, jnlls):
        assert_logdet_close(got, want)
    assert model.param_counts() == jmodel.param_counts(_jnp(params))


@pytest.mark.parametrize("bt", ["RNVP", "AI1"])
def test_int8_towers_with_a_non_cat_model(bt):
    """JAX quantizes CAT steps only: ``quantize_steps`` gives None for every
    step, and a reconstructor asked for int8 towers reconstructs as the
    float one does."""
    _, _, _, model = _rig(bt)
    views = torch.from_numpy(_rand(2, 4, S, S, seed=50))
    assert model.quantize_steps(views) == [None] * model.n_flow_steps
    coords = np.array([[8, 8], [8, 24], [24, 8], [24, 24]])
    vidx = make_view_indices(coords, (32, 32), (S, S))
    caches = [_rand(1, 16 // 2 ** (k + 1), S, S, seed=51 + k)
              for k in range(model.n_flow_steps + 1)]
    frames = np.random.RandomState(55).rand(2, 32, 32).astype(np.float32)
    stats = DatasetStatistics(*STATS)
    plain = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                              deterministic=True)
    int8 = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                             deterministic=True, use_int8_towers=True,
                             calib_frames=frames)
    assert int8.qpacks == [None] * model.n_flow_steps
    assert torch.equal(int8(frames), plain(frames))


# -------------------------------------------------------------- training


@pytest.mark.parametrize("bt", TYPES)
def test_flow_step_matches_jax(bt):
    """One optimizer step of flow step 0: the loss and its two terms, every
    gradient, and the parameters after the Lion updates against JAX's
    ``flow_step`` (``trainer.py:296-342``: value_and_grad, then optax's
    Lion for the flow and the cond groups).  Where JAX's gradient is
    within 1e-3 of its group's largest of 0, its sign, and so Lion's step,
    is decided by roundoff: there the two may differ by one step of each
    sign (2 lr).  AI1's ``w_perm`` stays where it was (JAX's Lion moves it:
    not compared)."""
    jmodel, params, mstate, model = _rig(bt)
    load_jax_params(model, params, mstate)            # undo earlier steps
    cfg, k, b = jmodel.cfg, 0, 2
    spec, nf = jmodel.step_specs[k], jmodel.n_flow_steps
    d = spec.d_in
    views = _rand(b, 4, S, S, seed=60)
    mean_c = _rand(b, d // 2, S, S, seed=61, scale=0.3)
    gt = _rand(b, d, S, S, seed=62)
    up = _rand(b, d // 2, S, S, seed=63)

    def loss_fn(args):
        fk, ck = args
        c_views = cond_network(ck, jnp.asarray(views), train=True, rng=None)
        z = jnp.zeros((b, spec.c_flow, S, S), jnp.float32)
        recon, _ = jcwf.cwf_step_reverse(spec, fk, z, jnp.asarray(up),
                                         c_views, jnp.asarray(mean_c))
        loss_c = JL.recon_loss(cfg.loss_func_reg, jnp.asarray(gt), recon)
        pseudo = {"flow": [fk if i == k else None for i in range(nf)]}
        nll, _ = jmodel.step_nll(pseudo, k, jnp.asarray(gt), c_views,
                                 jnp.asarray(mean_c))
        full = loss_c * cfg.INN_cond_weight + nll * (1 - cfg.INN_cond_weight)
        return full, (loss_c, nll)

    jp = _jnp((params["flow"][k], params["cond"][k]))
    (jfull, (jloss_c, jnll)), grads = _jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)
    tx_flow, tx_cond, _ = jmake_optimizers(jmodel)
    new = []
    for tx, p, g in zip((tx_flow, tx_cond), jp, grads):
        u, _ = tx.update(g, tx.init(p), p)
        new.append(optax.apply_updates(p, u))

    tr = CWFATrainer(model, DatasetStatistics(*STATS), view_indices=None,
                     device="cpu")
    tr.generator = None                                # nothing drawn
    w_perms = [t.clone() for n, t in model.named_buffers()
               if n.endswith("w_perm")]
    assert len(w_perms) == (2 * nf if bt == "AI1" else 0)
    full, loss_c, nll, _ = tr._flow_step(k, *map(torch.from_numpy, (
        views, mean_c, gt, up)))
    for got, want in ((full, jfull), (loss_c, jloss_c), (nll, jnll)):
        assert abs(float(got) - float(want)) <= 1e-5 * max(1.0,
                                                           abs(float(want)))
    lr = {0: cfg.learning_rate, 1: cfg.learning_rate_cond}
    for i, module in enumerate((model.flow[k], model.cond[k])):
        got = param_tree(module, lambda p: p.detach().numpy())
        gflat = jax.tree_util.tree_leaves_with_path(got)
        want = dict(jax.tree_util.tree_leaves_with_path(_np(new[i])))
        gmax = max(float(np.abs(np.asarray(v)).max())
                   for v in jax.tree_util.tree_leaves(grads[i]))
        gdict = dict(jax.tree_util.tree_leaves_with_path(_np(grads[i])))
        assert len(gflat) == len(want)
        for path, value in gflat:
            if path[-1].key == "w_perm":
                continue
            w, g = want[path], np.abs(gdict[path])
            d = np.abs(value - w)
            sure = g > 1e-3 * gmax
            assert float(d[sure].max(initial=0)) <= 1e-6, path
            assert float(d.max()) <= 2 * lr[i] + 1e-6, path
    for before, (n, after) in zip(w_perms, [
            (n, t) for n, t in model.named_buffers() if n.endswith("w_perm")]):
        assert torch.equal(before, after), n
    if bt == "AI1":
        names = {n for n, _ in model.named_parameters()}
        assert not any(n.endswith("w_perm") for n in names)
        assert "flow.0.blocks.0.aio.w_perm" in model.state_dict()


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def test_ai1_checkpoint_both_ways(tmp_path, monkeypatch):
    """An AI1 model with Lion state written by the port loads into the JAX
    trainer (parameters and w_perm equal; the momenta equal, w_perm's
    zero), and the JAX trainer's files back into the port.  (The JAX
    trainer starts from the rig's weights plus 1 instead of its random
    init, which the load overwrites and which compiles for tens of
    seconds on a CPU.)"""
    jmodel, params, mstate, model = _rig("AI1")
    monkeypatch.setattr(JModel, "init", lambda self, key: (
        jax.tree_util.tree_map(lambda a: jnp.asarray(a) + 1.0, params),
        _jnp(mstate)))
    load_jax_params(model, params, mstate)
    tr = CWFATrainer(model, DatasetStatistics(*STATS), view_indices=None,
                     device="cpu")
    rng = np.random.RandomState(70)
    for lion in (*tr.opt_flow, *tr.opt_cond, tr.opt_lrnn):
        for m in lion.mu:
            m.copy_(torch.from_numpy(rng.randn(*m.shape).astype(np.float32)))
        lion.count = 4
    path = str(tmp_path / "port")
    tr.save_checkpoints(3, path)
    jcfg = JConfig(**SMALL, INN_block_type="AI1").decode_lrs()
    jt = JTrainer(JModel.build(jcfg), JStats(*STATS), None)
    assert jt.load_checkpoints(path) == [1, 2, 3]
    want_p, _ = export_jax_params(model)
    assert (jax.tree_util.tree_structure(_np(jt.params))
            == jax.tree_util.tree_structure(want_p))
    for g, w in zip(_leaves(jt.params), _leaves(want_p)):
        np.testing.assert_array_equal(g, w)
    for k in range(model.n_flow_steps):
        mu = tr.opt_flow[k].state_tree()["0"]["mu"]
        for g, w in zip(_leaves(jt.opt_flow[k][0].mu), _leaves(mu)):
            np.testing.assert_array_equal(g, w)
        for blk in mu["blocks"]:
            assert not blk["aio"]["w_perm"].any()
        assert int(jt.opt_flow[k][0].count) == 4

    jt.output_path = str(tmp_path / "jax")
    jt.save_checkpoints(5)
    back = CWFAModel.build(CWFAConfig(**SMALL, INN_block_type="AI1")
                           .decode_lrs(), torch.Generator().manual_seed(9))
    tb = CWFATrainer(back, None, view_indices=None, device="cpu")
    assert tb.load_checkpoints(str(tmp_path / "jax")) == [1, 2, 3]
    for g, w in zip(_leaves(export_jax_params(back)[0]), _leaves(want_p)):
        np.testing.assert_array_equal(g, w)
    for k in range(back.n_flow_steps):
        for g, w in zip(_leaves(tb.opt_flow[k].state_tree()["0"]["mu"]),
                        _leaves(tr.opt_flow[k].state_tree()["0"]["mu"])):
            np.testing.assert_array_equal(g, w)


def test_torch_format_refuses_non_cat(tmp_path):
    """The reference torch-file paths hold the CAT graph only: with an RNVP
    configuration the reader, the writer and ``cli.export_torch`` raise a
    ValueError naming the type, and nothing is written."""
    _, _, _, model = _rig("RNVP")
    tr = CWFATrainer(model, DatasetStatistics(*STATS), view_indices=None,
                     device="cpu")
    src = tmp_path / "msgpack"
    ckpt.save_model_checkpoints(model, str(src), 1, DatasetStatistics(*STATS))
    before = sorted(os.listdir(src))
    with pytest.raises(ValueError, match="RNVP"):
        tr.load_torch_checkpoints(str(src))
    out = tmp_path / "torch"
    with pytest.raises(ValueError, match="RNVP"):
        export_torch_checkpoints(str(out), model)
    assert not out.exists()
    with pytest.raises(ValueError, match="RNVP"):
        export_cli.main(["--pretrain_models_path", str(src),
                         "--output_path", str(out)])
    assert not out.exists()
    assert sorted(os.listdir(src)) == before


def test_train_cli_with_rnvp(tmp_path):
    """``cli.train.main --INN_block_type RNVP`` end to end on a tiny tree:
    finite losses and NLLs, the step checkpoints written, and they hold
    RNVP blocks."""
    info = jdata.make_synthetic_dataset(str(tmp_path / "data"), n_fish=2,
                                        n_frames=2, n_depths=8, vol_side=S,
                                        img_size=48, n_lenslets=4,
                                        view_size=S)
    argv = ["--main_data_path", str(tmp_path / "data"), "--lenslet_file",
            info["lenslet_file"], "--output_testing_path",
            str(tmp_path / "runs") + "/", "--n_depths", "8",
            "--volume_side_size", str(S), "--INN_max_down_steps", "2",
            "--INN_n_blocks", "2", "--INN_internal_chans", "4",
            "--INN_cond_chans", "2", "--use_half_precision", "0",
            "--img_size", "48", "--INN_block_type", "RNVP", "--epochs", "2",
            "--eval_every", "2", "--max_samples", "1",
            "--cross_validation_nFold", "0", "--save_tiff_volumes", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        results = train_cli.main(argv, device="cpu")
    for res in results.values():
        assert np.isfinite(np.asarray(res["nll"])).all()
        assert np.isfinite(np.asarray(res["psnr"])).all()
    (run_dir,) = list((tmp_path / "runs").iterdir())
    payload, cfg, _ = ckpt.load_step_checkpoint(
        str(run_dir / "model_step_1__ep_1.msgpack"))
    assert cfg.INN_block_type == "RNVP"
    assert set(payload["INN_state_dict"]["blocks"]["0"]) == {"s1", "t1", "s2",
                                                             "t2"}
