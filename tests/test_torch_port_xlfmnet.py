"""The XLFMNet baseline (``--INN_net_type 2``) in the port against the JAX
package, on the CPU, in f32, JAX at ``highest`` precision:

- the UNet with each of its four activations (PReLU, ELU, LeakyReLU,
  Softplus), eval and train mode, output and BatchNorm state within 1e-5 of
  max|ref|; a non-PReLU site has no parameter on either side;
- ``XLFMNet`` forward in eval and in train mode, with the BatchNorm state
  after it, within 1e-5 of max|ref|;
- three ``train_xlfmnet`` steps from one bridged init on the same batches:
  losses within 1e-4 relative, parameters and BatchNorm statistics within
  1e-4 of each tree's max|ref|;
- ``cli.train.main(..., device="cpu")`` with ``--INN_net_type 2`` on two
  tiny synthetic fish: it trains, evaluates and saves; its checkpoint loads
  through JAX's ``load_xlfmnet`` and the JAX CLI's through the port's
  ``load_xlfmnet``, each with the other package's forward within 1e-5 of
  max|ref|.

Every tensor of an elementwise op stays under the 32,768-element grain
where this CPU's multithreaded elementwise ops are not steady, and torch
runs on one thread besides.
"""

import contextlib
import io
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cwfa_tpu import data as jdata
from cwfa_tpu.cli import train as jtrain
from cwfa_tpu.engine import xlfmnet_train as jxt
# cwfa_tpu.models exports functions named xlfmnet and unet, which shadow
# the submodules of the same names: import the names themselves
from cwfa_tpu.models.unet import UNetSpec as JUNetSpec, init_unet, unet as junet
from cwfa_tpu.models.xlfmnet import (XLFMNetSpec as JXLFMNetSpec,
                                     init_xlfmnet, xlfmnet as jxlfmnet)

from cwfa_tpu_torch.cli import train
from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.engine import xlfmnet_train as xt
from cwfa_tpu_torch.engine.jax_params import export_jax_params, load_jax_params
from cwfa_tpu_torch.models import unet as tunet
from cwfa_tpu_torch.models import xlfmnet as tx

from test_torch_port_layers import randomize_fixed_leaves

ACTIVATIONS = ("prelu", "elu", "leaky_relu", "softplus")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(_np(tree))]


def _close(got, want, share=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= share * float(np.abs(want).max()), err


def _close_trees(got, want, share):
    """Leaf by leaf, |d| <= share * max|ref| over the whole tree."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    bound = share * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= bound


def _state(tree):
    """The JAX state tree without the BatchNorm counts (JAX counts in int32,
    the port's BatchNorm in int64: compared apart)."""
    if isinstance(tree, dict):
        return {k: _state(v) for k, v in tree.items() if k != "count"}
    if isinstance(tree, (list, tuple)):
        return [_state(v) for v in tree]
    return tree


def _counts(tree):
    return [int(x) for p, x in jax.tree_util.tree_leaves_with_path(_np(tree))
            if jax.tree_util.keystr(p).endswith("['count']")]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_unet_activation_matches_jax(activation):
    kw = dict(in_channels=3, n_classes=2, depth=2, wf=2, batch_norm=True,
              skip_conn=True, drop_out=0.0, activation=activation)
    params, state = init_unet(jax.random.PRNGKey(1), JUNetSpec(**kw))
    rng = np.random.RandomState(1)
    params = randomize_fixed_leaves(_np(params), rng)
    state = randomize_fixed_leaves(_np(state), rng)
    net = tunet.UNet(tunet.UNetSpec(**kw))
    load_jax_params(net, params, state)
    n_alpha = sum(k.endswith("act1.weight") or k.endswith("act.weight")
                  for k in net.state_dict())
    assert n_alpha == (4 if activation == "prelu" else 0)
    x = _x(2, 3, 8, 8)
    want, _ = junet(JUNetSpec(**kw), params, state, jnp.asarray(x))
    with torch.no_grad():
        _close(net.eval()(torch.as_tensor(x)), want)
    want, new_state = junet(JUNetSpec(**kw), params, state, jnp.asarray(x),
                            train=True)
    with torch.no_grad():
        got = net.train()(torch.as_tensor(x), train=True)
    _close(got, want)
    _, got_state = export_jax_params(net)
    _close_trees(_state(got_state), _state(new_state), 1e-5)
    assert _counts(got_state) == _counts(new_state)


def _small_spec(activation="elu"):
    kw = dict(in_channels=6, n_classes=6, depth=2, wf=3, batch_norm=True,
              skip_conn=False, drop_out=0.0, activation=activation)
    return (JXLFMNetSpec(in_views=4, out_depths=6, unet=JUNetSpec(**kw)),
            tx.XLFMNetSpec(in_views=4, out_depths=6,
                           unet=tunet.UNetSpec(**kw)))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_xlfmnet_forward_and_batchnorm_state_match_jax(mode):
    jspec, spec = _small_spec()
    params, state = init_xlfmnet(jax.random.PRNGKey(2), jspec)
    rng = np.random.RandomState(2)
    params = randomize_fixed_leaves(_np(params), rng)
    state = randomize_fixed_leaves(_np(state), rng)
    model = tx.XLFMNet(spec)
    load_jax_params(model, params, state)
    x = _x(2, 4, 16, 16, seed=2)
    train_mode = mode == "train"
    want, new_state = jxlfmnet(jspec, params, state, jnp.asarray(x),
                                 train=train_mode)
    model.train(train_mode)
    with torch.no_grad():
        got = model(torch.as_tensor(x), train=train_mode)
    _close(got, want)
    _, got_state = export_jax_params(model)
    _close_trees(_state(got_state), _state(new_state), 1e-5)
    assert _counts(got_state) == _counts(new_state)


def test_default_spec_is_the_reference_layout():
    spec = tx.XLFMNetSpec()
    assert (spec.in_views, spec.out_depths, spec.use_bias) == (29, 96, False)
    assert spec.unet == tunet.UNetSpec(
        in_channels=96, n_classes=96, depth=5, wf=6, batch_norm=True,
        skip_conn=False, drop_out=0.0, activation="elu")
    cfg = CWFAConfig(n_depths=8, volume_side_size=16, n_lenslets=4)
    assert xt.build_xlfmnet_spec(cfg).unet.depth == 2
    assert xt.build_xlfmnet_spec(CWFAConfig()).unet.depth == 5
    for c in (cfg, CWFAConfig()):
        j = jxt.build_xlfmnet_spec(c)
        t = xt.build_xlfmnet_spec(c)
        assert (j.in_views, j.out_depths, j.unet.depth, j.unet.wf,
                j.unet.activation) == (t.in_views, t.out_depths, t.unet.depth,
                                       t.unet.wf, t.unet.activation)


def test_three_lion_steps_match_jax():
    """JAX's ``train_xlfmnet`` from its own seeded init; the port's from the
    same weights (bridged), on the same batches of the same stream."""
    cfg = CWFAConfig(n_depths=8, volume_side_size=16, n_lenslets=4)
    jspec, spec = jxt.build_xlfmnet_spec(cfg), xt.build_xlfmnet_spec(cfg)
    views, vols = _x(5, 4, 16, 16, seed=3), _x(5, 8, 16, 16, seed=4)
    lr, seed = 3e-3, 7
    jp, js, jl = jxt.train_xlfmnet(jspec, views, vols, n_steps=3,
                                   learning_rate=lr, seed=seed, batch_size=2)
    _, k_init = jax.random.split(jax.random.PRNGKey(seed))
    p0, s0 = init_xlfmnet(k_init, jspec)
    model = tx.XLFMNet(spec)
    load_jax_params(model, _np(p0), _np(s0))
    model, losses = xt.train_xlfmnet(spec, views, vols, n_steps=3,
                                     learning_rate=lr, seed=seed,
                                     batch_size=2, model=model, device="cpu")
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    params, state = xt.xlfmnet_trees(model)
    _close_trees(params, jp, 1e-4)
    _close_trees(_state(state), _state(js), 1e-4)
    assert _counts(state) == _counts(js) == [3] * len(_counts(js))
    # every parameter moved, the BatchNorm affines too (the weight decay
    # reaches them)
    for a, b in zip(_leaves(params), _leaves(p0)):
        assert not np.array_equal(a, b)


SMALL = ["--n_depths", "8", "--volume_side_size", "16", "--img_size", "48",
         "--INN_net_type", "2", "--epochs", "2", "--max_samples", "2",
         "--cross_validation_nFold", "0", "--batch_size", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("xlfmnet_cli")
    info = jdata.make_synthetic_dataset(str(root / "data"), n_fish=2,
                                        n_frames=2, n_depths=8, vol_side=16,
                                        img_size=48, n_lenslets=4,
                                        view_size=16)
    out = {}
    for name, main, kw in (("port", train.main, {"device": "cpu"}),
                           ("jax", jtrain.main, {})):
        buf = io.StringIO()
        argv = ["--main_data_path", str(root / "data"), "--lenslet_file",
                info["lenslet_file"], "--output_testing_path",
                str(root / name) + "/", *SMALL]
        with contextlib.redirect_stdout(buf):
            results = main(argv, **kw)
        (run_dir,) = list((root / name).iterdir())
        out[name] = (results, buf.getvalue().splitlines(), str(run_dir))
    return out


def test_cli_trains_evaluates_and_saves(runs):
    results, lines, run_dir = runs["port"]
    assert sorted(results) == ["test", "train"]
    for tag in ("train", "test"):
        res = results[tag]
        assert len(res["psnr"]) == len(res["MAPE"]) == len(res["times"]) == 2
        assert np.isfinite(np.asarray(res["psnr"])).all()
        assert res["nll"] == []
    assert lines[0].startswith("XLFMNet: 2 steps, loss ")
    assert [ln.split(" PSNR ")[0] for ln in lines[1:3]] == [
        "[train] XLFMNet level-0", "[test] XLFMNet level-0"]
    assert lines[-1] == f"Saving directory: {run_dir}"
    assert os.listdir(run_dir) == ["xlfmnet_step_0__ep_1.msgpack"]
    assert [ln.split(" PSNR ")[0] for ln in runs["jax"][1][1:3]] == [
        ln.split(" PSNR ")[0] for ln in lines[1:3]]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_in_both_packages(runs, writer):
    run_dir = runs[writer][2]
    jspec, jparams, jstate, jcfg, _ = jxt.load_xlfmnet(run_dir)
    model, cfg, _ = xt.load_xlfmnet(run_dir, device="cpu")
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.INN_net_type == 2 and not model.training
    x = _x(2, 4, 16, 16, seed=5)
    want, _ = jxlfmnet(jspec, jparams, jstate, jnp.asarray(x))
    with torch.no_grad():
        _close(model(torch.as_tensor(x)), want)
    # the trees are the same, leaf by leaf
    params, state = xt.xlfmnet_trees(model)
    for a, b in zip(_leaves(params), _leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    _close_trees(_state(state), _state(jstate), 0.0)
