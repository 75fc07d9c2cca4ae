"""The ``space`` axis's row windows and exchanges (``parallel/halo.py``) in
one process: a tensor's rows are split over 2 and 4 places of an in-process
stand-in group (``ThreadRowGroup``: one thread a place, exchanges, gathers
and sums through shared memory, put in place of the package's transport —
``halo._p2p``, ``halo.gather_rows`` and the all-reduce of ``nn`` — for
these tests only), each place runs a module on its rows or its window
inside ``row_shard``, its result is cropped, and the places' rows,
concatenated, are held to the whole-tensor run within 1e-6 of max, in f32
(``test_torch_port_space_recon.py`` runs the real transport on gloo):

- the derived reaches: a ``ConvBlock`` 2, a cond net 4, a tower 4, the
  windowed cond -> tower chain 8, and one row less spoils the result;
- the UNet in eval mode, in train mode (BatchNorm on the statistics of the
  whole batch and image) and in int8, its halo exchanges simulated;
- a cond net (float and its int8 pair), a tower;
- a whole CAT ``reverse_fast`` step with an axis-2 ``PermuteDim`` (and with
  int8 towers), and ``permute_rows``; a non-CAT step and training's
  directions raise naming ROADMAP A20;
- ``CWFAModel.reconstruct`` on the small rig, deterministic and in the
  default stochastic mode (the draws of every place in step).

Every elementwise tensor stays under 32,768 elements.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from cwfa_tpu_torch import nn as tnn
from cwfa_tpu_torch.models import cond_net as tcond
from cwfa_tpu_torch.models.cwf import (CWFStep, CWFStepSpec,
                                      quantize_cat_step, tower_reach)
from cwfa_tpu_torch.models.unet import (ConvBlock, UNet, UNetSpec,
                                        quantize_unet, unet_calibrate,
                                        unet_quantized)
from cwfa_tpu_torch.nn import reset_parameters_
from cwfa_tpu_torch.parallel import halo
from cwfa_tpu_torch.parallel.halo import (gather_image_rows, halo_rows,
                                          permute_rows)
from cwfa_tpu_torch.parallel.mesh import RowShard, row_shard
from cwfa_tpu_torch.rig import flagship

SPLITS = [2, 4]


class ThreadRowGroup:
    """Place ``index`` of an in-process group of ``hub.n`` places, each a
    thread: what a place posts is read by the others after a barrier."""

    class Hub:
        def __init__(self, n):
            self.n = n
            self.barrier = threading.Barrier(n, timeout=60)
            self.box = {}

    def __init__(self, hub, index):
        self.hub, self.index = hub, index

    def _swap(self, post: dict, take):
        self.hub.box.update(post)
        self.hub.barrier.wait()
        out = take(self.hub.box)
        self.hub.barrier.wait()
        for k in post:
            self.hub.box.pop(k, None)
        return out

    def exchange(self, sends, recv_shapes, like):
        me = self.index
        got = self._swap({(me, j): t.clone() for j, t in sends.items()},
                         lambda box: {j: box[(j, me)] for j in recv_shapes})
        for j, shape in recv_shapes.items():
            assert tuple(got[j].shape) == tuple(shape), (got[j].shape, shape)
        return got

    def all_gather(self, t):
        return self._swap({("all", self.index): t.clone()},
                          lambda box: [box[("all", j)]
                                       for j in range(self.hub.n)])

    def all_reduce(self, t):
        return torch.stack(self.all_gather(t)).sum(0)


@pytest.fixture(autouse=True)
def _stand_in_transport(monkeypatch):
    """The stand-in's exchanges, gathers and sums where the package calls
    its transport on a ``ThreadRowGroup``."""
    reduce = tnn.all_reduce_sum
    monkeypatch.setattr(halo, "_p2p", lambda group, sends, shapes, like:
                        group.exchange(sends, shapes, like))
    monkeypatch.setattr(halo, "gather_rows", lambda t, group:
                        torch.cat(group.all_gather(t), dim=0))
    monkeypatch.setattr(tnn, "all_reduce_sum", lambda t, group=None: (
        group.all_reduce(t) if isinstance(group, ThreadRowGroup)
        else reduce(t, group)))


def run_split(n: int, total: int, fn):
    """fn(rows) on each of n places (threads) inside ``row_shard(rows)`` and
    inference mode; returns the places' results in place order."""
    hub = ThreadRowGroup.Hub(n)
    out, errs = [None] * n, []

    def place(i):
        try:
            rs = RowShard(ThreadRowGroup(hub, i), i, n, total)
            with torch.inference_mode(), row_shard(rs):
                out[i] = fn(rs)
        except BaseException as e:     # handed to the test
            errs.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=place, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def joined(parts):
    return torch.cat(parts, dim=2)


def close(got, want, bound=1e-6):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float((got - want).abs().max())
    assert err <= bound * float(want.abs().max()), err


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(module, seed):
    reset_parameters_(module, torch.Generator().manual_seed(seed))
    return module


def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _randomize_bn(module, seed):
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=g) + 0.5)
        if isinstance(m, torch.nn.PReLU):
            m.weight.data.uniform_(0.05, 0.5, generator=g)


def test_reaches_are_derived_from_the_modules():
    net = tcond.CondNetwork(4, 8, chans_3d=4)
    step = CWFStep(_spec(axis=2))
    assert tcond.cond_reach(net) == 4
    assert tower_reach(step.blocks[0]["subnet"]) == 4
    assert step.tower_reach == 4
    assert tcond.cond_reach(net) + step.tower_reach == 8
    assert ConvBlock(3, 4, True, False, "prelu").reach == 2


@pytest.mark.parametrize("reach, exact", [(8, True), (7, False)],
                         ids=["reach8", "reach7"])
def test_cond_then_tower_window_needs_reach_8(reach, exact):
    """The cond net then a tower on a window of ``reach`` rows, cropped: 8
    rows give the whole run's rows, 7 do not."""
    net = _init(tcond.CondNetwork(4, 4, chans_3d=4), 1).eval()
    _randomize_bn(net, 1)
    step = _init(CWFStep(_spec(axis=2)), 2).eval()
    tower = step.blocks[0]["subnet"]
    x = _randn(1, 4, 32, 12, seed=3)
    with torch.inference_mode():
        want = tower(net(x))
    parts = run_split(2, 32, lambda rs: rs.crop(
        tower(net(rs.take_window(x, reach))), reach))
    err = float((joined(parts) - want).abs().max())
    if exact:
        close(joined(parts), want)
    else:
        # the rows past the reach are off by more than roundoff
        assert err > 5e-6 * float(want.abs().max()), err


def _unet(seed=4):
    unet = _init(UNet(UNetSpec(in_channels=3, n_classes=3, depth=3, wf=2,
                               use_bias=True, skip_conn=True)), seed).eval()
    _randomize_bn(unet, seed)
    return unet


@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("mode", ["eval", "train", "int8"])
def test_unet_with_halo_exchanges(n, mode):
    unet = _unet()
    x = _randn(2, 3, 32, 16, seed=5)
    with torch.inference_mode():
        if mode == "int8":
            scales = unet_calibrate(unet, x)
            pack = quantize_unet(unet, scales)
            fn = lambda v: unet_quantized(unet, v, pack, scales)
        else:
            fn = lambda v: unet(v, train=mode == "train")
        want = fn(x)
    parts = run_split(n, 32, lambda rs: fn(rs.own(x)))
    close(joined(parts), want)


@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_cond_net_on_windows(n, int8):
    net = _init(tcond.CondNetwork(4, 8, chans_3d=4), 6).eval()
    _randomize_bn(net, 6)
    x = _randn(1, 4, 32, 12, seed=7)
    q = tcond.quantize_cond_networks([net], x)[0] if int8 else None
    r = tcond.cond_reach(net)
    with torch.inference_mode():
        want = net(x, cond_q=q)
    parts = run_split(n, 32, lambda rs: rs.crop(
        net(rs.take_window(x, r), cond_q=q), r))
    close(joined(parts), want)


@pytest.mark.parametrize("n", SPLITS)
def test_tower_on_windows(n):
    step = _init(CWFStep(_spec(axis=2)), 8).eval()
    tower = step.blocks[1]["subnet"]
    c = _randn(2, 4, 32, 12, seed=9)
    r = tower_reach(tower)
    with torch.inference_mode():
        want = tower(c)
    parts = run_split(n, 32, lambda rs: rs.crop(tower(rs.take_window(c, r)),
                                                r))
    close(joined(parts), want)


def _spec(axis: int, side: int = 32, c_flow: int = 4) -> CWFStepSpec:
    """A CAT step of 2 blocks whose PermuteDim runs over ``axis``."""
    rng = np.random.RandomState(11)
    cp = rng.permutation(c_flow)
    sp = rng.permutation(side)
    perms = (("channel", cp, np.argsort(cp)),
             ("spatial", axis, sp, np.argsort(sp)),
             ("channel", cp[::-1].copy(), np.argsort(cp[::-1])))
    return CWFStepSpec(step=0, d_in=2 * c_flow, spatial=side, n_blocks=2,
                       internal_ch=8, perms=perms)


@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_cat_reverse_fast_step_with_a_row_permutation(n, int8):
    step = _init(CWFStep(_spec(axis=2)), 12).eval()
    assert [e[1] for e in step.spec.perms if e[0] == "spatial"] == [2]
    b, c, side = 1, 4, 32
    z, avg = _randn(b, c, side, 12, seed=13), _randn(b, c, side, 12, seed=14)
    cv, cm = _randn(b, c, side, 12, seed=15), _randn(1, c, side, 12, seed=16)
    qp = quantize_cat_step(step, cv) if int8 else None
    r = step.tower_reach
    want = step.reverse_fast(z, avg, cv, cm, qpack=qp)
    parts = run_split(n, side, lambda rs: step.reverse_fast(
        rs.own(z), rs.own(avg), rs.take_window(cv, r), rs.own(cm),
        qpack=qp, c_reach=r))
    close(joined(parts), want)


def test_non_cat_step_and_training_paths_name_the_next_slice():
    """A non-CAT step's towers read x, and training's forward / reverse are
    not ported on rows: under a row shard each raises naming ROADMAP A20,
    never computing rows wrong."""
    spec = _spec(axis=2)
    rnvp = _init(CWFStep(dataclasses.replace(spec, block_type="RNVP")),
                 21).eval()
    cat = _init(CWFStep(spec), 22).eval()
    x = _randn(1, 4, 16, 12, seed=23)
    calls = [lambda: rnvp.reverse_fast(x, x, x, x, c_reach=4),
             lambda: cat.forward(torch.cat([x, x], 1), x, x),
             lambda: cat.reverse(x, x, x, x)]
    for call in calls:
        with pytest.raises(ValueError, match="A20"):
            run_split(2, 32, lambda rs: call())


@pytest.mark.parametrize("n", SPLITS)
def test_permute_rows_and_halo_rows(n):
    x = _randn(2, 3, 16, 5, seed=17)
    perm = np.random.RandomState(18).permutation(16)
    got = run_split(n, 16, lambda rs: permute_rows(rs.own(x), perm, rs))
    assert torch.equal(joined(got), x.index_select(2, torch.as_tensor(perm)))
    halos = run_split(n, 16, lambda rs: (rs.window(3),
                                         halo_rows(rs.own(x), 3, rs)))
    for (lo, hi), h in halos:
        assert torch.equal(h, x[:, :, lo:hi])
    whole = run_split(n, 16, lambda rs: gather_image_rows(rs.own(x), rs))
    assert all(torch.equal(w, x) for w in whole)


@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["deterministic", "stochastic"])
def test_reconstruct_on_the_small_rig(n, stochastic):
    """``reconstruct`` on each place's rows (the views and mean caches
    whole): the model's own steps include an axis-2 PermuteDim.  The
    stochastic case draws z at T 0.7, 2 samples, the LRNN in train mode
    with its dropout and drop_path, from one seed on every place."""
    cfg, model, _, _, _ = flagship(True, "cpu",
                                   torch.Generator().manual_seed(0))
    model.eval()
    assert any(e[0] == "spatial" and e[1] == 2
               for s in model.step_specs for e in s.perms)
    side = cfg.volume_side_size
    views = _randn(1, cfg.n_lenslets, side, side, seed=19)
    caches = [_randn(1, cfg.n_depths // 2 ** (k + 1), side, side, seed=20 + k)
              for k in range(model.n_flow_steps + 1)]
    kw = (dict(z_temperature=0.7, n_samples=2, lrnn_train=True)
          if stochastic else {})

    def call():
        g = torch.Generator().manual_seed(5) if stochastic else None
        return model.reconstruct(views, caches, generator=g, **kw)

    with torch.inference_mode():
        want = call()
    parts = run_split(n, side, lambda rs: call())
    close(joined(parts), want)
