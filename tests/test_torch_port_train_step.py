"""The port's two optimizer steps against the JAX trainer's, on the CPU:
the LRNN step's and every flow step's loss and gradients against
``jax.value_and_grad`` of the JAX trainer's own loss (assembled here as
``trainer.py:268-322`` builds it, from ``run_lrnn``, ``cond_network(train=
True, rng=None)``, ``cwf_step_reverse``, ``step_nll`` and ``recon_loss``),
the BatchNorm running statistics against JAX's ``new_state``, the port's
Lion fed JAX's gradients against ``make_optimizers`` (optax) over three
updates, ``stage_for_epoch`` against JAX's, and the float tower's weight
pack rebuilt after an optimizer step.

f32, nothing drawn (``generator=None``, ``rng=None``), JAX at
``jax_default_matmul_precision=highest``.  Losses within 1e-5 relative;
every gradient within 1e-4 * max|ref| over the group's gradients (convs and
reductions sum in another order; a PReLU alpha's or a bias's gradient is a
sum over every position with cancellation, so it is held to the group's
scale, not its own).  The small rig is 16 depths at 16^2, two flow steps
of two 8-wide blocks; its UNet is 256 channels wide at 16^2, above the
32,768-element grain where this CPU's multithreaded elementwise ops are not
steady, so the module runs torch on one thread.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.engine import losses as JL
from cwfa_tpu.engine.trainer import CWFATrainer as JTrainer
from cwfa_tpu.engine.trainer import make_optimizers as jmake_optimizers
from cwfa_tpu.models.cond_net import cond_network
from cwfa_tpu.models.cwf import cwf_step_reverse
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.engine import losses as TL
from cwfa_tpu_torch.engine.jax_params import (
    export_jax_params, load_jax_params, param_tree, param_values)
from cwfa_tpu_torch.engine.optim import make_optimizers
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.ops import btower

from test_torch_port_layers import randomize_fixed_leaves

SMALL = dict(n_depths=16, volume_side_size=16, n_lenslets=4,
             INN_max_down_steps=3, INN_n_blocks=2, INN_internal_chans=8,
             INN_cond_chans=4, use_half_precision=0)
B, S = 2, 16


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(*shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.fixture(scope="module")
def rig():
    jmodel = JModel.build(JConfig(**SMALL).decode_lrs())
    params, mstate = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(params, rng)
    mstate = randomize_fixed_leaves(mstate, rng)
    model = CWFAModel.build(CWFAConfig(**SMALL).decode_lrs(),
                            torch.Generator().manual_seed(0))
    load_jax_params(model, params, mstate)
    stats = DatasetStatistics(100.0, 50.0, 100.0, 50.0, 10.0, 5.0)
    return jmodel, params, mstate, model, stats


def _trainer(rig):
    _, params, mstate, model, stats = rig
    load_jax_params(model, params, mstate)      # undo earlier tests' steps
    model.zero_grad(set_to_none=True)           # ... and their gradients
    return CWFATrainer(model, stats, view_indices=None, device="cpu")


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def assert_loss_close(got, want):
    got, want = float(got.detach()), float(want)
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


def assert_grads_close(module, jgrads):
    """Every parameter's .grad of ``module`` against the JAX gradient tree,
    leaf by leaf in the tree's order: |d| <= 1e-4 * max|ref| of the tree."""
    got = _leaves(param_tree(module, lambda p: p.grad.detach().numpy()))
    want = _leaves(jgrads)
    assert len(got) == len(want)
    bound = 1e-4 * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= bound, (
            float(np.abs(g - w).max()), bound, w.shape)


def _lrnn_inputs():
    d = SMALL["n_depths"] // 4
    return (_rand(B, 4, S, S, seed=1), _rand(B, d, S, S, seed=2, scale=0.3),
            _rand(B, d, S, S, seed=3))


def test_lrnn_step_matches_jax(rig):
    """The LRNN stage's loss, every LRNN gradient, and the UNet BatchNorm
    running statistics (momentum 0.1, unbiased variance, count + 1) after
    the step's forward."""
    jmodel, params, mstate, _, _ = rig
    cfg = jmodel.cfg
    views, mean_c, gt = _lrnn_inputs()

    def loss_fn(lrnn_params):
        p = {**_jnp(params), "lrnn": lrnn_params}
        out, new_state = jmodel.run_lrnn(p, _jnp(mstate), jnp.asarray(views),
                                         jnp.asarray(mean_c), train=True,
                                         rng=None)
        loss = JL.recon_loss(cfg.loss_func_first_step, jnp.asarray(gt),
                             out.astype(jnp.float32))
        return loss, new_state

    (jloss, new_state), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        _jnp(params["lrnn"]))

    tr = _trainer(rig)
    lrnn = tr.model.lrnn.train()
    loss, _ = tr.lrnn_loss(*map(torch.from_numpy, (views, mean_c, gt)),
                           generator=None)
    loss.backward()
    lrnn.eval()
    assert_loss_close(loss, jloss)
    assert_grads_close(lrnn, jgrads)
    _, state = export_jax_params(tr.model)
    got, want = _leaves(state["lrnn"]), _leaves(new_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [0, 1])
def test_flow_step_matches_jax(rig, k):
    """Flow step k's loss (recon x INN_cond_weight + NLL x the rest), its
    two terms and every gradient of the step's flow parameters and of its
    cond net."""
    jmodel, params, _, _, _ = rig
    cfg, spec, nf = jmodel.cfg, jmodel.step_specs[k], jmodel.n_flow_steps
    d = spec.d_in
    views = _rand(B, 4, S, S, seed=10 + k)
    mean_c = _rand(B, d // 2, S, S, seed=20 + k, scale=0.3)
    gt = _rand(B, d, S, S, seed=30 + k)
    up = _rand(B, d // 2, S, S, seed=40 + k)

    def loss_fn(args):
        fk, ck = args
        c_views = cond_network(ck, jnp.asarray(views), train=True, rng=None)
        z = jnp.zeros((B, spec.c_flow, S, S), jnp.float32)
        recon, _ = cwf_step_reverse(spec, fk, z, jnp.asarray(up), c_views,
                                    jnp.asarray(mean_c))
        loss_c = JL.recon_loss(cfg.loss_func_reg, jnp.asarray(gt), recon)
        pseudo = {"flow": [fk if i == k else None for i in range(nf)]}
        nll, _ = jmodel.step_nll(pseudo, k, jnp.asarray(gt), c_views,
                                 jnp.asarray(mean_c))
        full = loss_c * cfg.INN_cond_weight + nll * (1 - cfg.INN_cond_weight)
        return full, (loss_c, nll)

    (jfull, (jloss_c, jnll)), (gf, gc) = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))((_jnp(params["flow"][k]),
                                _jnp(params["cond"][k])))

    tr = _trainer(rig)
    cond = tr.model.cond[k].train()
    full, loss_c, nll, _ = tr.flow_loss(
        k, *map(torch.from_numpy, (views, mean_c, gt, up)), generator=None)
    full.backward()
    cond.eval()
    assert_loss_close(full, jfull)
    assert_loss_close(loss_c, jloss_c)
    assert_loss_close(nll, jnll)
    assert_grads_close(tr.model.flow[k], gf)
    assert_grads_close(tr.model.cond[k], gc)


def test_lion_matches_optax_given_the_same_gradients(rig):
    """Three updates of the flow group (weight decay) and of the cond group
    (none) of step 0, both fed the same gradients: parameters within 1e-6
    of optax's after each, and the momenta and the count after the last."""
    jmodel, params, _, _, _ = rig
    tr = _trainer(rig)
    tx_flow, tx_cond, _ = jmake_optimizers(jmodel)
    flow, cond, _ = make_optimizers(tr.model)
    rng = np.random.RandomState(5)
    for tx, lion, jp in ((tx_flow, flow[0], params["flow"][0]),
                         (tx_cond, cond[0], params["cond"][0])):
        jp = _jnp(jp)
        state = tx.init(jp)
        for _ in range(3):
            grads = jax.tree_util.tree_map(
                lambda v: jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                      * 1e-2), jp)
            updates, state = tx.update(grads, state, jp)
            jp = optax.apply_updates(jp, updates)
            named = param_values(lion.module,
                                 jax.tree_util.tree_map(np.array, grads))
            for name, p in lion.module.named_parameters():
                p.grad = torch.from_numpy(named[name])
            lion.step()
            got = _leaves(param_tree(lion.module,
                                     lambda p: p.detach().numpy()))
            for g, w in zip(got, _leaves(jp)):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        mine = lion.state_tree()
        for g, w in zip(_leaves(mine["0"]["mu"]), _leaves(state[0].mu)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
        assert int(mine["0"]["count"]) == int(state[0].count) == 3


@pytest.mark.parametrize("max_down", [2, 3, 5])
def test_stage_for_epoch_matches_jax(rig, max_down):
    _, _, _, model, stats = rig
    for epochs in (1, 2, 3, 5, 7, 10, 100):
        cfg = CWFAConfig(**{**SMALL, "INN_max_down_steps": max_down,
                            "epochs": epochs})
        jcfg = JConfig(**{**SMALL, "INN_max_down_steps": max_down,
                          "epochs": epochs})
        port = types.SimpleNamespace(
            cfg=cfg, model=types.SimpleNamespace(n_flow_steps=max_down - 1))
        jax_side = types.SimpleNamespace(
            cfg=jcfg, model=types.SimpleNamespace(n_flow_steps=max_down - 1))
        for epoch in range(epochs + 3):
            assert CWFATrainer.stage_for_epoch(port, epoch) == \
                JTrainer.stage_for_epoch(jax_side, epoch), (epochs, epoch)


def test_tower_changes_after_one_lion_step(rig):
    """The kernel's weight pack is keyed on the parameters' versions: Lion's
    in-place update rebuilds it, and the tower's output moves."""
    tr = _trainer(rig)
    tower = tr.model.flow[0].blocks[0]["subnet"]
    x = torch.from_numpy(_rand(1, tower.b1.in_channels, 8, 8, seed=7))
    with torch.no_grad():
        before = tower.tower(x)
    pack = btower.pack_float_tower(tower, torch.bfloat16)
    for p in tower.parameters():
        p.grad = torch.ones_like(p)
    tr.opt_flow[0].step()
    with torch.no_grad():
        after = tower.tower(x)
    assert not torch.equal(before, after)
    repacked = btower.pack_float_tower(tower, torch.bfloat16)
    assert repacked[0] is not pack[0]
    assert not torch.equal(repacked[0], pack[0])


def test_flow_step_runs_each_tower_once(rig, monkeypatch):
    """A flow step's five towers (here three: the input block and two
    coupling blocks) run once each, forward and backward, for both
    directions, and its gradients equal those of the two directions each
    running its own towers."""
    k = 0
    spec = rig[0].step_specs[k]
    calls = {"forward": 0, "backward": 0}

    def counted(fn, key):
        def run(*args):
            calls[key] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(btower, "fused_float_tower",
                        counted(btower.fused_float_tower, "forward"))
    monkeypatch.setattr(btower, "float_tower_backward",
                        counted(btower.float_tower_backward, "backward"))
    d = spec.d_in
    views, mean_c, gt, up = map(torch.from_numpy, (
        _rand(B, 4, S, S, seed=50), _rand(B, d // 2, S, S, seed=51, scale=0.3),
        _rand(B, d, S, S, seed=52), _rand(B, d // 2, S, S, seed=53)))
    tr = _trainer(rig)
    step, cond = tr.model.flow[k], tr.model.cond[k]
    full, _, _, _ = tr.flow_loss(k, views, mean_c, gt, up, generator=None)
    full.backward()
    assert calls == {"forward": spec.n_blocks + 1,
                     "backward": spec.n_blocks + 1}
    shared = [p.grad.clone() for p in step.parameters()]

    step.zero_grad()
    cond.zero_grad()
    c_views = cond(views, generator=None)
    z = torch.zeros((B, spec.c_flow, S, S))
    recon, _ = step.reverse(z, up, c_views, mean_c)
    nll, _ = tr.model.step_nll(k, gt, c_views, mean_c)
    cfg = tr.cfg
    loss = (TL.recon_loss(cfg.loss_func_reg, gt, recon) * cfg.INN_cond_weight
            + nll * (1.0 - cfg.INN_cond_weight))
    loss.backward()
    assert calls["forward"] == 3 * (spec.n_blocks + 1)
    for g, p in zip(shared, step.parameters()):
        bound = 1e-5 * max(1.0, float(p.grad.abs().max()))
        assert float((g - p.grad).abs().max()) <= bound
