"""The port's data-parallel trainer (``CWFATrainer(mesh=...)``) on the CPU,
on two gloo ranks (``tests/_torch_port_dist_worker.py``):

- JAX's ``test_trainer_on_mesh_matches_single_device`` configuration (8
  depths at 16^2, 64^2 frames, 4 lenslets, two flow steps of two 8-wide
  blocks, batch 2 over 3 frames: a full and a ragged mini-batch; 3 epochs:
  the LRNN stage and both flow stages), f32, with JAX's weights and mean
  caches, against JAX's ``CWFATrainer(mesh=make_mesh(n_data=2,
  n_space=1))``: every epoch's loss within rtol 2e-3, every parameter
  within 6 lr (Lion steps by a sign, which roundoff may flip near 0), and
  the two ranks' parameters and BatchNorm statistics equal to the bit;
  then ``evaluate`` on the two ranks against the port in one process:
  volumes within 1e-3 of max, PSNRs within 0.01 dB, NLLs within 1e-3
  relative.  Both packages draw nothing (the patches of
  ``tests/test_torch_port_ood_cli.py``).
- The same on a (2, 2) mesh of four ranks (16 rows: 8 a rank, a multiple
  of the UNet's 4, so the rows split; the ragged last batch computed whole
  on both data ranks, its rows split): JAX's (2, 2) trainer holds its
  (2, 2) mesh to one device, and the port's four ranks are held to JAX's
  trainer on the same weights (epoch losses within rtol 2e-3, parameters
  within 6 lr), the four ranks equal to the bit, and ``evaluate`` to the
  port in one process as above.
- With every draw on (input noise, dropout, ``drop_path``, Dropout3d), one
  LRNN step and one flow step on two ranks x 2 frames against one process
  x 4 frames, with the L2 losses and with LL and wL2 (which read the global
  batch's min and max): the losses within 1e-5 relative, each optimizer's
  all-reduced gradient within 1e-5 of its largest (or twice its loss's own
  f32 roundoff, where that is coarser: LL), every parameter within 6 lr,
  the two ranks equal to the bit.  The same on a (1, 2) ``space`` mesh,
  two ranks x 2 frames (8 rows each) against one process x 2 frames, with
  L2, LL / wL2 and wL2 / LL (the extremes and means of the whole image);
  and on a 12-row rig whose 6 rows a rank do not divide by the UNet's 4
  (every rank computes all rows): equal to one process, its gradient not
  doubled.
- Train-mode BatchNorm on two ranks x 1 frame against one process x 2
  frames, the global batch's statistics: output, input gradient, parameter
  gradients and running statistics within 1e-5.
- The LL and wL2 losses alone, f64, with ties at the min on both ranks:
  two ranks against one process within 1e-12 relative, loss and
  gradient.
"""

import numpy as np
import jax
import pytest
import torch

from cwfa_tpu import data as jdata
from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.parallel import make_mesh

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.engine import losses as L
from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.nn import batch_norm_batch_stats

from _torch_port_dist_worker import (extremes_inputs, start_ranks,
                                     state_digest, step_case_inputs,
                                     two_steps)
from test_torch_port_ood_cli import QuietJTrainer, _quiet, _ZeroDropJModel

ND, SIDE, IMG, NL, VIEW = 8, 16, 64, 4, 16
CFG = dict(n_depths=ND, volume_side_size=VIEW, n_lenslets=NL,
           INN_max_down_steps=3, INN_n_blocks=2, INN_internal_chans=8,
           INN_cond_chans=4, epochs=3, eval_every=100, save_tiff_volumes=0,
           batch_size=2, use_half_precision=0, add_noise=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_dict_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


STEP_CFG = dict(CFG, add_noise=1)
# the losses that read the batch's min and max: under a shard, the global
# batch's (LL in the LRNN step and wL2 in the flow step, then the other way)
LOSSES = {"L2": STEP_CFG,
          "LL-wL2": dict(STEP_CFG, loss_func_first_step="LL",
                         loss_func_reg="wL2"),
          "wL2-LL": dict(STEP_CFG, loss_func_first_step="wL2",
                         loss_func_reg="LL")}
# name: (config, (data, space) mesh, frames, side of the inputs)
STEP_CFGS = {**{name: (cfg, (2, 1), 4, VIEW) for name, cfg in LOSSES.items()},
             **{f"space-{name}": (cfg, (1, 2), 2, VIEW)
                for name, cfg in LOSSES.items()},
             "space-fallback": (dict(STEP_CFG, volume_side_size=12), (1, 2),
                                2, 12)}


def _step_inputs():
    rng = np.random.RandomState(11)
    b, nf = 4, 2
    views = rng.randn(b, NL, VIEW, VIEW).astype(np.float32)
    gt = [rng.randn(b, ND // 2 ** k, VIEW, VIEW).astype(np.float32)
          for k in range(nf + 1)]
    mcs = [rng.randn(b, ND // 2 ** (k + 1), VIEW, VIEW).astype(np.float32)
           for k in range(nf + 1)]
    return views, gt, mcs


def _bn_inputs():
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 5, 6, 6) * 3 + 2).astype(np.float32)
    weight = rng.rand(5).astype(np.float32) + 0.5
    bias = rng.randn(5).astype(np.float32)
    running = (rng.randn(5).astype(np.float32),
               rng.rand(5).astype(np.float32) + 0.5)
    return dict(x=x, weight=weight, bias=bias, running=running)


@pytest.fixture(scope="module")
def steps_ranks():
    """The two ranks of the step and BatchNorm cases, started first so that
    they run beside the JAX trainer."""
    views, gt, mcs = _step_inputs()
    return start_ranks("steps", n=2, cfgs=STEP_CFGS, seed=4, views=views,
                       gt=gt, mcs=mcs, bn=_bn_inputs())


@pytest.fixture(scope="module")
def trained(tmp_path_factory, steps_ranks):
    mp = pytest.MonkeyPatch()
    _quiet(mp)
    try:
        root = str(tmp_path_factory.mktemp("sharded_train"))
        info = jdata.make_synthetic_dataset(root, n_fish=1, n_frames=3,
                                            n_depths=ND, vol_side=SIDE,
                                            img_size=IMG, n_lenslets=NL,
                                            view_size=VIEW)
        kw = dict(vol_shape=(SIDE, SIDE, ND), img_shape=(IMG, IMG),
                  images_to_use=[0, 1, 2], n_depths_to_fill=ND,
                  ds_id="fish_0")
        fish = info["fish_dirs"][0] + "/SLNet_preprocessed"
        cat = jdata.ConcatXLFMDataset(jdata.load_xlfm_data(
            fish, info["lenslet_file"], **kw))
        vidx = jdata.make_view_indices(cat.datasets[0].lenslet_coords,
                                       (IMG, IMG), (VIEW, VIEW))
        jcfg = JConfig(**CFG).decode_lrs()
        jt = QuietJTrainer(_ZeroDropJModel.build(jcfg),
                           JStats(*cat.get_statistics().astuple()), vidx,
                           mesh=make_mesh(n_data=2, n_space=1))
        jt.ensure_mean_caches(cat)
        tree = jax.tree_util.tree_map(np.asarray, (jt.params, jt.mstate))
        caches = [np.asarray(c) for c in jt.mean_caches[0]]
        args = dict(cfg=CFG, params=tree[0], mstate=tree[1],
                    mean_caches=caches, epochs=3,
                    root={"fish": fish, "lenslets": info["lenslet_file"],
                          "kw": kw, "img": (IMG, IMG), "view": (VIEW, VIEW)})
        wait = start_ranks("train", n=2, **args)
        wait_one = start_ranks("train", n=1, **args)
        wait_four = start_ranks("train", n=4, mesh_shape=(2, 2), **args)
        jlosses = [float(jt.train_epoch(cat, ep)) for ep in range(3)]
        ranks = wait(120)
        one, = wait_one(120)
        four = wait_four(180)
        final = jax.tree_util.tree_map(np.asarray, (jt.params, jt.mstate))
    finally:
        mp.undo()
    return ranks, jlosses, final, jcfg, one, four


def _check_against_jax(ranks, trained):
    _, jlosses, (params, mstate), jcfg, *_ = trained
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=2e-3)
    model = CWFAModel.build(CWFAConfig(**CFG).decode_lrs(),
                            torch.Generator().manual_seed(0))
    load_jax_params(model, params, mstate)
    want = {k: v.detach().numpy() for k, v in model.named_parameters()}
    lr = max(jcfg.learning_rate, jcfg.learning_rate_cond,
             jcfg.learning_rate_first_step)
    for name, w in want.items():
        np.testing.assert_allclose(ranks[0]["state"][name], w, atol=6 * lr,
                                   rtol=0, err_msg=name)


def test_two_ranks_match_jax_mesh_trainer(trained):
    _check_against_jax(trained[0], trained)


def test_four_ranks_on_a_data_space_mesh_match_jax_trainer(trained):
    """A (2, 2) mesh: each step's rows split (8 of 16 a rank), the full
    batch over ``data`` and the ragged one whole on both data ranks; the
    four ranks against JAX's trainer, equal to the bit to each other, and
    their ``evaluate`` (batch and rows gathered) against one process."""
    four, one = trained[5], trained[4]
    assert [r["rows"] for r in four] == [(0, 8), (8, 16)] * 2
    _check_against_jax(four, trained)
    for r in four[1:]:
        _state_dict_equal(four[0]["state"], r["state"])
        assert r["losses"] == four[0]["losses"]
    for r in four:
        np.testing.assert_allclose(r["volumes"], one["volumes"], rtol=0,
                                   atol=1e-3 * np.abs(one["volumes"]).max())
        np.testing.assert_allclose(r["psnr"], one["psnr"], atol=1e-2)
        np.testing.assert_allclose(r["nll"], one["nll"], rtol=1e-3,
                                   atol=1e-4)


def test_two_ranks_stay_equal_to_the_bit(trained):
    ranks = trained[0]
    _state_dict_equal(ranks[0]["state"], ranks[1]["state"])
    assert ranks[0]["losses"] == ranks[1]["losses"]


def test_evaluate_on_two_ranks_matches_one_process(trained):
    """``evaluate`` splits each mini-batch over the ranks and gathers the
    volumes and NLLs on both; the one-process port run is the reference."""
    ranks, *_, one, _ = trained
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-4)
    for r in ranks:
        assert r["volumes"].shape == one["volumes"].shape == (3, ND, VIEW,
                                                               VIEW)
        np.testing.assert_allclose(r["volumes"], one["volumes"], rtol=0,
                                   atol=1e-3 * np.abs(one["volumes"]).max())
        np.testing.assert_allclose(r["psnr"], one["psnr"], atol=1e-2)
        np.testing.assert_allclose(r["nll"], one["nll"], rtol=1e-3,
                                   atol=1e-4)
    np.testing.assert_array_equal(ranks[0]["volumes"], ranks[1]["volumes"])


@pytest.fixture(scope="module")
def steps(steps_ranks):
    views, gt, mcs = _step_inputs()
    one = {}
    for name, (cfg, _, frames, side) in STEP_CFGS.items():
        if name.startswith("space-") and name != "space-fallback":
            continue        # the ranks run their one-process reference
        model = CWFAModel.build(CWFAConfig(**cfg).decode_lrs(),
                                torch.Generator().manual_seed(4))
        tr = CWFATrainer(model, None, {}, device="cpu")
        one[name] = two_steps(tr, *step_case_inputs(views, gt, mcs, frames,
                                                    side))
    ranks = steps_ranks(180)
    for name in STEP_CFGS:
        one.setdefault(name, ranks[0][name].get("one"))
    return ranks, one, tr.cfg


def _loss_grad_roundoff(kind, gt, out):
    """The f32 roundoff of ``recon_loss(kind)``'s gradient at (gt, out),
    relative to its largest: the f32 gradient against the f64 one."""
    grads = []
    for dt in (torch.float32, torch.float64):
        o = torch.from_numpy(out).to(dt).requires_grad_(True)
        L.recon_loss(kind, torch.from_numpy(gt).to(dt), o).backward()
        grads.append(o.grad.double())
    return float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())


def _check_steps(steps, name):
    """Two ranks x 2 frames against one process x 4 frames: the losses
    within 1e-5 relative; each optimizer's all-reduced gradient within 1e-5
    of its largest (only the order of the sums differs), or within twice
    the f32 roundoff of its loss's own gradient where that is coarser (LL's
    min-shift cancels terms of size gt / 1e-8 at the min, so its f32
    gradient is itself that far from the exact one, on one process too);
    every parameter within 6 lr (JAX's bound); the two ranks equal to the
    bit."""
    ranks, ones, cfg = steps
    one = ones[name]
    lr = max(cfg.learning_rate, cfg.learning_rate_cond,
             cfg.learning_rate_first_step)
    cfg_kw, _, frames, side = STEP_CFGS[name]
    _, gt, _ = step_case_inputs(*_step_inputs(), frames, side)
    gt = [g.numpy() for g in gt]
    nf = len(gt) - 1
    first = _loss_grad_roundoff(cfg_kw.get(
        "loss_func_first_step", "L2"), gt[nf], one["outs"]["lrnn"])
    reg = _loss_grad_roundoff(cfg_kw.get("loss_func_reg", "L2"),
                              gt[0], one["outs"]["flow"])
    bound = {"lrnn": max(1e-5, 2 * first), "flow": max(1e-5, 2 * reg),
             "cond": max(1e-5, 2 * reg)}
    r = ranks[0][name]
    for rk in ranks:
        np.testing.assert_allclose(rk[name]["losses"], one["losses"],
                                   rtol=1e-5)
    assert r["grads"].keys() == one["grads"].keys()
    for tag, g in one["grads"].items():
        err = float(np.abs(r["grads"][tag] - g).max())
        assert err <= bound[tag] * float(np.abs(g).max()), (tag, err)
    for pname, w in one["state"].items():
        np.testing.assert_allclose(r["state"][pname], w, atol=6 * lr,
                                   rtol=1e-5, err_msg=pname)
    assert state_digest(r["state"]) == ranks[1][name]["state_digest"]


def test_steps_with_draws_match_one_process(steps):
    _check_steps(steps, "L2")


@pytest.mark.parametrize("name", ["L2", "LL-wL2", "wL2-LL"])
def test_space_mesh_steps_match_one_process(steps, name):
    """A (1, 2) space mesh: each rank computes 8 of the 16 rows of both
    frames (halos, row permutations and windows on the way; the losses'
    extremes and means over the whole image); its all-reduced gradients,
    losses and parameters against one process on the same 2 frames, which
    the ranks run first and whose max-pool choices they replay
    (``pool_choices``: a near-tie that roundoff tips the other way would
    route a gradient elsewhere)."""
    _check_steps(steps, f"space-{name}")


def test_space_fallback_rows_match_one_process(steps):
    """12 rows on a (1, 2) mesh: 6 a rank do not divide by the UNet's 4, so
    every rank computes all rows and no gradient is summed over the space
    group (a sum would double it): equal to one process."""
    _check_steps(steps, "space-fallback")


@pytest.mark.parametrize("name", ["LL-wL2", "wL2-LL"])
def test_steps_with_global_extreme_losses_match_one_process(steps, name):
    """The LL and wL2 losses shift and mask by the global batch's min and
    max under a shard, and hand the min's gradient to the rank that holds
    it."""
    _check_steps(steps, name)


def test_batch_norm_takes_the_global_statistics(steps):
    a = _bn_inputs()
    x, weight, bias, running = a["x"], a["weight"], a["bias"], a["running"]
    ranks = [r["bn"] for r in steps[0]]
    bn = torch.nn.BatchNorm2d(5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(running[0]))
        bn.running_var.copy_(torch.from_numpy(running[1]))
    xt = torch.from_numpy(x).requires_grad_(True)
    probe = torch.from_numpy(
        np.random.RandomState(5).randn(*x.shape).astype(np.float32))
    y = batch_norm_batch_stats(bn, xt)
    (y * probe).sum().backward()
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["y"], y.detach().numpy()[r:r + 1],
                                   atol=1e-5)
        np.testing.assert_allclose(rk["dx"], xt.grad.numpy()[r:r + 1],
                                   atol=1e-5)
        np.testing.assert_allclose(rk["dw"], bn.weight.grad.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(rk["db"], bn.bias.grad.numpy(), atol=1e-5)
        np.testing.assert_allclose(rk["rm"], bn.running_mean.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(rk["rv"], bn.running_var.numpy(),
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["LL", "wL2"])
def test_losses_take_the_global_batch_extremes(steps, kind):
    """LL and wL2 on two ranks x 2 rows against one process x 4 rows, in
    f64, with ties at the min spread over both ranks: the summed loss and
    each row's gradient within 1e-12 of the largest (the min's gradient
    shared among its ties over the ranks as ``torch.min`` shares it in one
    process)."""
    pred, gt = extremes_inputs()
    p = torch.from_numpy(pred).requires_grad_(True)
    want = L.recon_loss(kind, torch.from_numpy(gt), p)
    want.backward()
    ranks = [r["extremes"][kind] for r in steps[0]]
    assert sum(loss for loss, _ in ranks) == pytest.approx(want.item(),
                                                           rel=1e-12)
    got = np.concatenate([g for _, g in ranks])
    want_grad = p.grad.numpy()
    np.testing.assert_allclose(got, want_grad, rtol=0,
                               atol=1e-12 * np.abs(want_grad).max())
