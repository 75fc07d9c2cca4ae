"""The ``space`` axis's row windows and exchanges (``parallel/halo.py``) in
one process: a tensor's rows are split over 2 and 4 places of an in-process
stand-in group (``ThreadRowGroup``: one thread a place, exchanges, gathers
and sums through shared memory, put in place of the package's transport —
``halo._p2p``, ``halo.gather_rows`` and ``mesh._all_reduce`` — for these
tests only), each place runs a module on its rows or its window inside
``row_shard``, its result is cropped, and the places' rows, concatenated,
are held to the whole-tensor run within 1e-6 of max, in f32
(``test_torch_port_space_recon.py`` runs the real transport on gloo):

- the derived reaches: a ``ConvBlock`` 2, a cond net 4, a tower 4, the
  windowed cond -> tower chain 8, and one row less spoils the result;
- the UNet in eval mode, in train mode (BatchNorm on the statistics of the
  whole batch and image) and in int8, its halo exchanges simulated;
- a cond net (float and its int8 pair), a tower;
- a whole CAT ``reverse_fast`` step with an axis-2 ``PermuteDim`` (and with
  int8 towers), and ``permute_rows``; a non-CAT ``reverse_fast`` and a CAT
  step's ``forward`` / ``reverse`` on rows;
- ``CWFAModel.reconstruct`` on the small rig, deterministic and in the
  default stochastic mode (the draws of every place in step), through
  either step call.

Training on rows (gradients): each place backpropagates its part of a
probe loss, on its own copy of the module, and the places' input gradients
(joined, or summed where every place reads the whole input) and parameter
gradients (summed) are held to the whole-tensor run's within 1e-5 of max:
the backward of ``halo_rows`` and ``permute_rows`` (each row's gradient
back to its owner), the UNet in train mode (its running statistics too), a
CAT step's ``forward`` / ``reverse`` with their log-dets, each non-CAT type
(``forward`` / ``reverse``, and ``reverse_fast``'s values), and the four
losses (their extremes and means over the whole image).

Every elementwise tensor stays under 32,768 elements.
"""

import copy
import dataclasses
import threading

import numpy as np
import pytest
import torch

from cwfa_tpu_torch.engine import losses as L
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
from cwfa_tpu_torch.parallel import mesh as M
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

    def all_reduce_(self, t, op):
        """In place, over the places: the same stacked reduction on every
        place, so every place gets the same bits."""
        st = torch.stack(self.all_gather(t))
        red = {torch.distributed.ReduceOp.SUM: lambda: st.sum(0),
               torch.distributed.ReduceOp.MIN: lambda: st.amin(0),
               torch.distributed.ReduceOp.MAX: lambda: st.amax(0)}[op]()
        t.copy_(red)


@pytest.fixture(autouse=True)
def _stand_in_transport(monkeypatch):
    """The stand-in's exchanges, gathers and reductions where the package
    calls its transport on a ``ThreadRowGroup``."""
    reduce = M._all_reduce
    monkeypatch.setattr(halo, "_p2p", lambda group, sends, shapes, like:
                        group.exchange(sends, shapes, like))
    monkeypatch.setattr(halo, "gather_rows", lambda t, group:
                        torch.cat(group.all_gather(t), dim=0))
    monkeypatch.setattr(M, "_all_reduce", lambda t, group, op=torch.
                        distributed.ReduceOp.SUM: (
                            group.all_reduce_(t, op)
                            if isinstance(group, ThreadRowGroup)
                            else reduce(t, group, op)))


def run_split(n: int, total: int, fn, grad: bool = False):
    """fn(rows) on each of n places (threads) inside ``row_shard(rows)`` and
    inference mode (with ``grad``: grad mode); returns the places' results
    in place order."""
    hub = ThreadRowGroup.Hub(n)
    out, errs = [None] * n, []

    def place(i):
        try:
            rs = RowShard(ThreadRowGroup(hub, i), i, n, total)
            mode = (torch.enable_grad() if grad
                    else torch.inference_mode())
            with mode, row_shard(rs):
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
    """The calls that a row shard refused before training on ``space``:
    a non-CAT step's ``reverse_fast`` (its towers read x, so x gets a halo
    before each) and a CAT step's ``forward`` / ``reverse`` (training's
    directions) now run on each place's rows, equal to the whole run."""
    spec = _spec(axis=2)
    rnvp = _init(CWFStep(dataclasses.replace(spec, block_type="RNVP")),
                 21).eval()
    cat = _init(CWFStep(spec), 22).eval()
    x, c = _randn(1, 4, 32, 12, seed=23), _randn(1, 4, 32, 12, seed=24)
    r = cat.tower_reach
    calls = [lambda f: rnvp.reverse_fast(*f(x, x, c, x), c_reach=r),
             lambda f: cat.forward(*f(torch.cat([x, x], 1), None, c, x),
                                   c_reach=r)[0],
             lambda f: cat.reverse(*f(x, x, c, x), c_reach=r)[0]]
    for call in calls:
        with torch.inference_mode():
            want = call(lambda *t: [u for u in t if u is not None])
        parts = run_split(2, 32, lambda rs: call(lambda *t: [
            rs.own(u) if i != 2 else rs.take_window(u, r)
            for i, u in enumerate(t) if u is not None]))
        close(joined(parts), want)


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


# ---------------------------------------------------------------------------
# Training on rows: gradients
# ---------------------------------------------------------------------------


def _probe(shape, seed):
    return _randn(*shape, seed=1000 + seed)


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _param_grads(module):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad)
            for k, p in module.named_parameters()}


def _summed(dicts):
    return {k: sum(d[k] for d in dicts) for k in dicts[0]}


def close_grads(got: dict, want: dict, bound=1e-5):
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], bound)


@pytest.mark.parametrize("n", SPLITS)
def test_halo_and_permute_rows_send_gradients_back(n):
    """Each place's halo window and permuted rows times its own probe: the
    gradient of every row (a halo row is read by two places, each adds its
    part) comes back to the place that owns it."""
    x = _randn(2, 3, 16, 5, seed=30)
    perm = np.random.RandomState(31).permutation(16)
    reach = 3

    def place(rs):
        xo = _leaf(rs.own(x))
        h = halo_rows(xo, reach, rs)
        p = permute_rows(xo, perm, rs)
        lo, hi = rs.window(reach)
        loss = ((h * _probe(h.shape, rs.index)).sum()
                + (p * _probe(x.shape, 99)[:, :, rs.start:rs.stop]).sum())
        loss.backward()
        return xo.grad

    got = joined(run_split(n, 16, place, grad=True))
    xw = _leaf(x)
    loss = (xw.index_select(2, torch.as_tensor(perm))
            * _probe(x.shape, 99)).sum()
    for i in range(n):
        lo, hi = RowShard(None, i, n, 16).window(reach)
        loss = loss + (xw[:, :, lo:hi] * _probe(
            (2, 3, hi - lo, 5), i)).sum()
    loss.backward()
    close(got, xw.grad)


@pytest.mark.parametrize("n", SPLITS)
def test_unet_train_mode_gradients_on_rows(n):
    """The UNet in train mode on each place's rows (halo exchanges before
    each conv block, BatchNorm on the whole batch and image): the output,
    the input's gradient, the parameters' gradients summed over the places
    and every running statistic match the whole run."""
    unet = _unet().train()
    x = _randn(2, 3, 32, 16, seed=32)
    probe = _probe((2, 3, 32, 16), 1)

    def place(rs):
        u = copy.deepcopy(unet)
        xo = _leaf(rs.own(x))
        y = u(xo, train=True)
        (y * rs.own(probe)).sum().backward()
        return y.detach(), xo.grad, _param_grads(u), u.state_dict()

    parts = run_split(n, 32, place, grad=True)
    whole = copy.deepcopy(unet)
    xw = _leaf(x)
    y = whole(xw, train=True)
    (y * probe).sum().backward()
    close(joined([p[0] for p in parts]), y.detach())
    close(joined([p[1] for p in parts]), xw.grad, 1e-5)
    close_grads(_summed([p[2] for p in parts]), _param_grads(whole))
    want = whole.state_dict()
    for _, _, _, state in parts:
        for k, v in want.items():
            if v.is_floating_point():
                close(state[k], v)
            else:
                assert torch.equal(state[k], v), k


def _step_grads(n, step, direction, with_towers=False, seed=40):
    """``direction`` ("forward" / "reverse") of ``step`` on each place's rows
    (c_views on the towers' window), a probe loss on its outputs and
    log-det, backpropagated: (outputs joined, log-det summed, input
    gradients joined / summed, parameter gradients summed) of the places
    and of the whole run."""
    c, side = step.spec.c_flow, step.spec.spatial
    b = 2
    r = step.tower_reach
    xin = _randn(b, 2 * c if direction == "forward" else c, side, 6,
                 seed=seed)
    avg = _randn(b, c, side, 6, seed=seed + 1)
    cv = _randn(b, c, side, 6, seed=seed + 2)
    cm = _randn(1, c, side, 6, seed=seed + 3)
    q = _probe((b,), 7)

    def run(st, xs, cvs, cms, avgs, rs=None):
        kw = {"c_reach": r} if rs is not None else {}
        towers = (st.towers(cvs, **kw) if with_towers else None)
        if direction == "forward":
            z, a, ld = st(xs, cvs, cms, towers, **kw)
            outs = [z, a]
        else:
            v, ld = st.reverse(xs, avgs, cvs, cms, towers, **kw)
            outs = [v]
        return outs, ld

    def probes(outs):
        return [_probe(o.shape[:2] + (side,) + o.shape[3:], i)
                for i, o in enumerate(outs)]

    def place(rs):
        st = copy.deepcopy(step)
        xs, cvs, cms, avgs = (_leaf(rs.own(xin)), _leaf(cv), _leaf(cm),
                              _leaf(rs.own(avg)))
        outs, ld = run(st, xs, rs.take_window(cvs, r), rs.own(cms), avgs, rs)
        loss = (ld * q).sum() + sum(
            (o * rs.own(p)).sum() for o, p in zip(outs, probes(outs)))
        loss.backward()
        return ([o.detach() for o in outs], ld.detach(),
                [xs.grad, avgs.grad], [cvs.grad, cms.grad], _param_grads(st))

    parts = run_split(n, side, place, grad=True)
    st = copy.deepcopy(step)
    xs, cvs, cms, avgs = _leaf(xin), _leaf(cv), _leaf(cm), _leaf(avg)
    outs, ld = run(st, xs, cvs, cms, avgs)
    loss = (ld * q).sum() + sum((o * p).sum()
                                for o, p in zip(outs, probes(outs)))
    loss.backward()
    got = ([joined([p[0][i] for p in parts]) for i in range(len(outs))],
           sum(p[1] for p in parts),
           [None if parts[0][2][i] is None
            else joined([p[2][i] for p in parts]) for i in range(2)],
           [sum(p[3][i] for p in parts) for i in range(2)],
           _summed([p[4] for p in parts]))
    want = ([o.detach() for o in outs], ld.detach(), [xs.grad, avgs.grad],
            [cvs.grad, cms.grad], _param_grads(st))
    return got, want


def _check_step(got, want):
    for g, w in zip(got[0], want[0]):
        close(g, w)
    close(got[1], want[1])
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        if w is None:
            assert g is None or float(g.abs().max()) == 0.0
        else:
            close(g, w, 1e-5)
    close_grads(got[4], want[4])


@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("direction", ["forward", "reverse"])
@pytest.mark.parametrize("towers", [False, True], ids=["chain", "towers"])
def test_cat_step_gradients_on_rows(n, direction, towers):
    """A CAT step with an axis-2 ``PermuteDim`` on rows, its towers inside
    the chain or run once on the window and cropped (``towers``, as
    training runs them): values, log-dets and every gradient."""
    step = _init(CWFStep(_spec(axis=2)), 41)
    _check_step(*_step_grads(n, step, direction, towers))


@pytest.mark.parametrize("block_type", ["RNVP", "GLOW", "GIN", "NICE",
                                        "AI1"])
@pytest.mark.parametrize("n", SPLITS)
def test_non_cat_step_on_rows(block_type, n):
    """Each non-CAT type on rows (x's half gets a differentiable halo before
    each tower): ``forward`` and ``reverse`` with their log-dets and every
    gradient, and ``reverse_fast``'s values."""
    step = _init(CWFStep(dataclasses.replace(_spec(axis=2),
                                             block_type=block_type)), 42)
    if block_type == "AI1":
        for blk in step.blocks:
            blk["aio"].init_override_(torch.Generator().manual_seed(43))
    for direction in ("forward", "reverse"):
        _check_step(*_step_grads(n, step, direction, seed=44))
    c, side = step.spec.c_flow, step.spec.spatial
    z, avg = _randn(1, c, side, 6, seed=45), _randn(1, c, side, 6, seed=46)
    cv, cm = _randn(1, c, side, 6, seed=47), _randn(1, c, side, 6, seed=48)
    r = step.tower_reach
    want = step.reverse_fast(z, avg, cv, cm)
    parts = run_split(n, side, lambda rs: step.reverse_fast(
        rs.own(z), rs.own(avg), rs.take_window(cv, r), rs.own(cm),
        c_reach=r))
    close(joined(parts), want)


@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("kind", ["L1", "L2", "wL2", "LL"])
def test_losses_on_rows(n, kind):
    """Each place's loss is its part of the whole image's (its mean times
    its row share; wL2's and LL's extremes over every place): the parts sum
    to the whole loss and the prediction's gradient joins to the whole
    one's."""
    gt = torch.relu(_randn(2, 3, 16, 8, seed=50)) + 0.1
    pred = torch.relu(_randn(2, 3, 16, 8, seed=51))

    def place(rs):
        p = _leaf(rs.own(pred))
        loss = L.recon_loss(kind, rs.own(gt), p)
        loss.backward()
        return loss.detach(), p.grad

    parts = run_split(n, 16, place, grad=True)
    p = _leaf(pred)
    want = L.recon_loss(kind, gt, p)
    want.backward()
    close(sum(x[0] for x in parts), want.detach())
    close(joined([x[1] for x in parts]), p.grad, 1e-5)
