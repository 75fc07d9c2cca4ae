"""Ranks of the port's multi-process tests: ``run_ranks`` starts N processes
of this file, each joins a gloo group through ``CWFA_COORDINATOR`` /
``CWFA_NUM_PROCESSES`` / ``CWFA_PROCESS_ID`` (``parallel.
initialize_from_env``) and runs one case on the CPU, on one thread.

This module imports neither JAX nor ``cwfa_tpu``: a worker pays torch's
import alone (the test files that start them import both).  A case takes
the keyword arguments its test pickled and returns a picklable result,
which ``run_ranks`` hands back, one per rank.  A run that does not end
within its timeout fails with every rank's output.
"""

import contextlib
import os
import hashlib
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(case: str, n: int = 2, timeout: float = 120.0, **kwargs):
    """Run ``case`` in n processes; returns [rank 0's result, ...].  Fails
    (AssertionError, with the ranks' output) on a timeout or a rank that
    exits non-zero."""
    return start_ranks(case, n, **kwargs)(timeout)


def start_ranks(case: str, n: int = 2, **kwargs):
    """Start ``case`` in n processes and return ``wait(timeout=120)``,
    which gives ``run_ranks``' results (the caller works meanwhile) and
    removes the ranks' work directory."""
    work = tempfile.mkdtemp(prefix=f"port_dist_{case}_")
    with open(os.path.join(work, "args.pkl"), "wb") as f:
        pickle.dump(kwargs, f)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "CWFA_DISTRIBUTED")}
    env.update(CWFA_COORDINATOR=f"localhost:{port}",
               CWFA_NUM_PROCESSES=str(n), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, HERE,
                                           env.get("PYTHONPATH", "")]))
    procs = []
    t0 = time.monotonic()
    for r in range(n):
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, case, work],
            env={**env, "CWFA_PROCESS_ID": str(r)}, stdout=log,
            stderr=subprocess.STDOUT, cwd=work), log))
    return lambda timeout=120.0: _wait(case, work, procs, t0 + timeout,
                                       timeout)


def _wait(case, work, procs, deadline, timeout):
    n = len(procs)
    timed_out = False
    for p, _ in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    try:
        outs = [open(os.path.join(work, f"rank{r}.log")).read()
                for r in range(n)]
        report = "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{o[-4000:]}"
            for r, ((p, _), o) in enumerate(zip(procs, outs)))
        assert not timed_out, f"{case}: timed out after {timeout} s\n{report}"
        assert all(p.returncode == 0 for p, _ in procs), f"{case}\n{report}"
        results = []
        for r in range(n):
            with open(os.path.join(work, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- the cases


def case_distributed(rank, world):
    """The bootstrap, the split, the gather and the placement fallbacks."""
    import torch

    from cwfa_tpu_torch.parallel import (assemble_global, batch_sharding,
                                         global_batch_array,
                                         host_local_indices,
                                         initialize_from_env, is_primary,
                                         make_mesh, replicate, to_host)
    from cwfa_tpu_torch.parallel.distributed import world_size
    from cwfa_tpu_torch.parallel.mesh import data_group

    assert initialize_from_env("cpu") is True
    assert initialize_from_env("cpu") is True          # idempotent
    mesh = make_mesh(n_data=world, n_space=1)
    group = data_group(mesh)
    out = {"world": world_size(), "primary": is_primary(),
           "mesh": tuple(mesh.mesh.shape)}
    rng = np.random.RandomState(7)
    x = rng.randn(4, 3, 8, 8).astype(np.float32)
    w = (np.arange(x.size, dtype=np.float64).reshape(x.shape) % 13
         ).astype(np.float32)
    shd, rep = batch_sharding(mesh), replicate(mesh)
    # assemble_global keeps this rank's rows; the position-weighted sum
    # over the ranks is the whole batch's only where each rank holds the
    # right rows
    gx = assemble_global(x, shd)
    gw = assemble_global(w, shd)
    part = torch.stack([(gx.double() ** 2).sum(), (gx.double() * gw).sum()])
    torch.distributed.all_reduce(part, group=group)
    out["checksums"] = part.numpy()
    out["gathered"] = to_host(gx, group)
    # host-local feeding: each rank has only its block
    idx = host_local_indices(4)
    gb = global_batch_array(np.ascontiguousarray(x[idx]), shd)
    out["gathered_local"] = to_host(gb, group)
    # ragged row counts gather in rank order
    out["ragged"] = to_host(torch.arange(rank + 1.0), group)
    # placement per leaf: shardable, ragged (replicated), 0-d, non-array
    out["places"] = {
        str(shape): tuple(shd.place(np.zeros(shape, np.float32)).shape)
        for shape in [(4, 3, 8, 8), (3, 3, 8, 8), (1, 3, 7, 8)]}
    out["places_rep"] = tuple(rep.place(np.zeros((4, 3), np.float32)).shape)
    out["scalar"] = shd.place(np.float32(2.0))
    out["static"] = shd.place(5)
    return out


def _deconv_inputs(path):
    import torch

    d = np.load(path)
    return torch.from_numpy(d["psf"]), torch.from_numpy(d["img"])


def case_deconv(rank, world, data, n_iter, obj_hw, roi_depths):
    """Depth-sharded RL on this rank's depths of the OTF, gathered."""
    from cwfa_tpu_torch.ops.deconv import gather_depths, \
        xlfm_deconvolve_sharded
    from cwfa_tpu_torch.ops.fft_conv import precompute_otf
    from cwfa_tpu_torch.parallel import initialize_from_env

    assert initialize_from_env("cpu")
    psf, img = _deconv_inputs(data)
    d_local = psf.shape[1] // world
    otf, full_hw = precompute_otf(
        psf[:, rank * d_local:(rank + 1) * d_local].contiguous(), obj_hw)
    vol, est = xlfm_deconvolve_sharded(otf, img, n_iter=n_iter,
                                       obj_hw=obj_hw, roi_depths=roi_depths,
                                       full_hw=full_hw)
    return {"local": vol.numpy(), "vol": gather_depths(vol).numpy(),
            "est": est.numpy()}


def case_cli(rank, world, module, argv):
    """A CLI's ``main(argv, device="cpu")`` under the group."""
    import importlib

    from cwfa_tpu_torch.parallel import initialize_from_env

    assert initialize_from_env("cpu")
    out = importlib.import_module(module).main(argv, device="cpu")
    return out if isinstance(out, (str, dict)) else None


def case_clis(rank, world, module, argvs):
    """A CLI's ``main(argv, device="cpu")`` for each of ``argvs`` in turn,
    under the group; an entry (module, argv) runs that module's."""
    import importlib

    from cwfa_tpu_torch.parallel import initialize_from_env

    assert initialize_from_env("cpu")
    runs = [a if isinstance(a, tuple) else (module, a) for a in argvs]
    return [importlib.import_module(m).main(argv, device="cpu")
            for m, argv in runs]


def case_bn(rank, world, x, weight, bias, running):
    """Train-mode BatchNorm on this rank's rows under a batch shard: the
    output, the input's gradient, the parameters' gradients summed over the
    ranks and the running statistics."""
    import torch

    from cwfa_tpu_torch.nn import batch_norm_batch_stats
    from cwfa_tpu_torch.parallel import initialize_from_env
    from cwfa_tpu_torch.parallel.mesh import BatchShard, data_shard

    assert initialize_from_env("cpu")
    bn = torch.nn.BatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(running[0]))
        bn.running_var.copy_(torch.from_numpy(running[1]))
    b = x.shape[0] // world
    xl = torch.from_numpy(x[rank * b:(rank + 1) * b]).requires_grad_(True)
    probe = torch.from_numpy(
        np.random.RandomState(5).randn(*x.shape).astype(np.float32))
    with data_shard(BatchShard(None, rank * b, (rank + 1) * b, x.shape[0])):
        y = batch_norm_batch_stats(bn, xl)
        (y * probe[rank * b:(rank + 1) * b]).sum().backward()
    for p in (bn.weight, bn.bias):
        torch.distributed.all_reduce(p.grad)
    return {"y": y.detach().numpy(), "dx": xl.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "rm": bn.running_mean.numpy(), "rv": bn.running_var.numpy()}


def extremes_inputs():
    """f64 (4, 30) predictions with ties at the min (a ReLU's zeros, on
    both ranks' rows) and targets."""
    rng = np.random.RandomState(9)
    return np.maximum(rng.randn(4, 30), 0.0), rng.randn(4, 30)


def case_extremes(rank, world):
    """The LL and wL2 losses of this rank's rows under a batch shard (its
    part of the global batch's loss: its mean times its share), and their
    gradient at the predictions."""
    import torch

    from cwfa_tpu_torch.engine import losses as L
    from cwfa_tpu_torch.parallel.mesh import BatchShard, data_shard

    pred, gt = extremes_inputs()
    b = pred.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for kind in ("LL", "wL2"):
        p = torch.from_numpy(pred[rows]).requires_grad_(True)
        with data_shard(BatchShard(None, rows.start, rows.stop,
                                   pred.shape[0])):
            loss = L.recon_loss(kind, torch.from_numpy(gt[rows]), p)
            loss.backward()
        out[kind] = (float(loss), p.grad.numpy())
    return out


def _zero_drop_model(cfg, seed):
    import dataclasses

    import torch

    from cwfa_tpu_torch.models.cwfa_model import CWFAModel

    model = CWFAModel.build(cfg, torch.Generator().manual_seed(seed))
    spec = model.lrnn.spec
    spec = dataclasses.replace(
        spec, unet=dataclasses.replace(spec.unet, drop_out=0.0),
        convnext_drop=0.0, unet_drop=0.0)
    model.lrnn.spec = spec
    model.lrnn.unet.spec = spec.unet
    return model


def case_train(rank, world, root, cfg, params, mstate, mean_caches, epochs,
               mesh_shape=None):
    """The port's trainer on a ``(data, space)`` mesh over the group
    (``mesh_shape``; by default (world, 1); no mesh in one process): JAX's
    weights and mean caches, nothing drawn (the LRNN's drop rates 0, the
    cond nets' Dropout3d off, the GT pyramids without noise), the epochs'
    losses, every parameter and BatchNorm statistic, then ``evaluate``'s
    PSNRs, NLLs and volumes, and the image rows of this rank's steps."""
    import torch

    from cwfa_tpu_torch.config import CWFAConfig
    from cwfa_tpu_torch.data.dataset import (ConcatXLFMDataset,
                                             load_xlfm_data)
    from cwfa_tpu_torch.data.views import make_view_indices
    from cwfa_tpu_torch.engine import trainer as ttrainer
    from cwfa_tpu_torch.engine.jax_params import load_jax_params
    from cwfa_tpu_torch.engine.ood import PyramidScorer
    from cwfa_tpu_torch.models.cond_net import CondNetwork
    from cwfa_tpu_torch.parallel import initialize_from_env, make_mesh

    assert world == 1 or initialize_from_env("cpu")

    class QuietScorer(PyramidScorer):
        def __init__(self, *args, generator=None, **kw):
            super().__init__(*args, generator=None, **kw)
    ttrainer.PyramidScorer = QuietScorer
    CondNetwork.dropout3d_rate = 0.0

    ds = load_xlfm_data(root["fish"], root["lenslets"], **root["kw"])
    cat = ConcatXLFMDataset(ds)
    vidx = make_view_indices(ds.lenslet_coords, root["img"], root["view"])
    model = _zero_drop_model(CWFAConfig(**cfg).decode_lrs(), 0)
    load_jax_params(model, params, mstate)
    shape = mesh_shape or (world, 1)
    tr = ttrainer.CWFATrainer(model, cat.get_statistics(), vidx,
                              device="cpu",
                              mesh=make_mesh(*shape) if world > 1 else None)
    rows = tr.step_shards(cfg["batch_size"])[1]
    tr.mean_caches = {0: [torch.from_numpy(c) for c in mean_caches]}
    losses = [tr.train_epoch(cat, epoch) for epoch in range(epochs)]
    state = {k: v.detach().numpy().copy()
             for k, v in tr.model.state_dict().items()}
    res = tr.evaluate(cat, "train", save_volumes=False)
    return {"losses": losses, "state": state,
            "psnr": np.asarray(res["psnr"]), "nll": np.asarray(res["nll"]),
            "volumes": np.asarray(res["volumes_pred"]),
            "rows": None if rows is None else (rows.start, rows.stop)}


def case_recon(rank, world, cfg_kw, seed, params, mstate, caches, frames,
               deterministic, temperature, n_samples):
    """``XLFMReconstructor(mesh=...)`` on the small rig: the gathered
    volumes on this rank."""
    import dataclasses

    import torch

    from cwfa_tpu_torch.engine.inference import XLFMReconstructor
    from cwfa_tpu_torch.engine.jax_params import load_jax_params
    from cwfa_tpu_torch.parallel import initialize_from_env, make_mesh
    from cwfa_tpu_torch.rig import flagship

    assert initialize_from_env("cpu")
    cfg, model, stats, vidx, _ = flagship(
        True, "cpu", torch.Generator().manual_seed(seed))
    model.cfg = dataclasses.replace(cfg, **cfg_kw)
    if params is not None:
        load_jax_params(model, params, mstate)
    recon = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                              deterministic=deterministic,
                              mesh=make_mesh(world, 1))
    return {"vol": recon(frames).numpy()}




def case_space_recon(rank, world, params, mstate, caches, frames, stoch_kw,
                     caches36, serve_dir):
    """``XLFMReconstructor(mesh=make_mesh(1, world))`` on the small rig, the
    image rows over ``space``: deterministic with JAX's weights (then
    ``serve_reads_failing_once`` with it), the default stochastic mode from
    seed 3 with ``stoch_kw``, and a 36-row rig whose 18 rows a rank do not
    divide by the UNet's 4 (the fallback: all rows on every rank, said
    once).  The gathered volumes on this rank."""
    import contextlib
    import dataclasses
    import io

    import torch

    from cwfa_tpu_torch.engine.inference import XLFMReconstructor
    from cwfa_tpu_torch.engine.jax_params import load_jax_params
    from cwfa_tpu_torch.parallel import initialize_from_env, make_mesh
    from cwfa_tpu_torch.rig import flagship

    assert initialize_from_env("cpu")
    mesh = make_mesh(1, world)
    out = {}
    cfg, model, stats, vidx, _ = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    load_jax_params(model, params, mstate)
    recon = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                              deterministic=True, mesh=mesh)
    out["rows"] = recon.shards(len(frames))[1].bounds(rank)
    out["det"] = recon(frames).numpy()
    out["serve"] = serve_reads_failing_once(rank, recon, mesh, serve_dir,
                                            frames.shape[1:])
    cfg, model, stats, vidx, _ = flagship(
        True, "cpu", torch.Generator().manual_seed(3))
    model.cfg = dataclasses.replace(cfg, **stoch_kw)
    out["stoch"] = XLFMReconstructor(model, stats, vidx, caches,
                                     device="cpu", mesh=mesh)(frames).numpy()
    model, stats, vidx = side36_rig()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        recon = XLFMReconstructor(model, stats, vidx, caches36, device="cpu",
                                  deterministic=True, mesh=mesh)
        out["fallback"] = [recon(frames).numpy() for _ in range(2)]
    out["fallback_said"] = said.getvalue()
    return out


def serve_reads_failing_once(rank, recon, mesh, root, img_hw):
    """``serve_directory`` on the space group of ``mesh``, 2 frames a call,
    from ``root/frames`` into ``root/served`` (``--limit 3``, polling),
    where a TIFF read fails the first time as a file still being written
    would: rank 1's first read of every file and rank 0's of
    ``cam_1.tif``.  Returns the summary, the names this rank read, and the
    direct call on the frames in name order."""
    import torch

    from cwfa_tpu_torch.engine import serving
    from cwfa_tpu_torch.parallel.mesh import space_group

    in_dir = os.path.join(root, "frames")
    real = serving.tiffio.read_tiff_stack
    reads = []

    def read(path, **kw):
        name = os.path.basename(path)
        reads.append(name)
        if reads.count(name) == 1 and (rank == 1 or name == "cam_1.tif"):
            raise OSError(f"{name}: cut short")
        return real(path, **kw)

    serving.tiffio.read_tiff_stack = read
    try:
        summary = serving.serve_directory(
            recon, 2, tuple(img_hw), in_dir, os.path.join(root, "served"),
            poll_seconds=0.05, limit=3, verbose=False,
            group=torch.distributed.group.WORLD,
            space_group=space_group(mesh))
    finally:
        serving.tiffio.read_tiff_stack = real
    frames = np.stack([real(os.path.join(in_dir, n))
                       for n in sorted(os.listdir(in_dir))])
    return {"summary": summary, "reads": reads,
            "direct": recon(frames.astype(np.float32)).numpy()}


def side36_rig():
    """The small rig at 36 rows and columns, from seed 4: (model, stats,
    view indices) for 128-row frames."""
    import dataclasses

    import torch

    from cwfa_tpu_torch.data.views import make_view_indices
    from cwfa_tpu_torch.models.cwfa_model import CWFAModel
    from cwfa_tpu_torch.rig import flagship, lenslet_coords

    cfg, _, stats, _, img = flagship(True, "cpu", torch.Generator())
    cfg = dataclasses.replace(cfg, volume_side_size=36)
    model = CWFAModel.build(cfg, torch.Generator().manual_seed(4))
    vidx = make_view_indices(lenslet_coords(cfg.n_lenslets, 36, img),
                             (img, img), (36, 36))
    return model, stats, vidx


def two_steps(tr, views, gt, mcs):
    """One LRNN step and one step-0 flow step (its stage input the GT's
    level 1) of ``tr`` on this rank's rows of the batch and of the image
    (the trainer's ``step_shards``), drawing from the trainer's generator:
    (the losses [lrnn, flow, flow NLL], the state, each optimizer's
    gradient as it steps: after the all-reduce on a mesh, flat f32, and the
    two steps' outputs: this rank's rows)."""
    from cwfa_tpu_torch.parallel.mesh import data_shard, row_shard

    grads = {}

    def record(opt, tag):
        step = opt.step

        def recorded():
            grads[tag] = np.concatenate([
                (np.zeros(p.shape, np.float32) if p.grad is None
                 else p.grad.detach().float().numpy()).ravel()
                for p in opt.params])
            step()
        opt.step = recorded

    record(tr.opt_lrnn, "lrnn")
    record(tr.opt_flow[0], "flow")
    record(tr.opt_cond[0], "cond")
    nf = tr.model.n_flow_steps
    shard, rows = tr.step_shards(views.shape[0])
    sl = slice(None) if shard is None else slice(shard.start, shard.stop)
    own = (lambda t: t[sl]) if rows is None else (lambda t: rows.own(t[sl]))
    with data_shard(shard), row_shard(rows):
        l0, out = tr._lrnn_step(views[sl], mcs[nf - 1][sl], own(gt[nf]))
        l1, _, nll, recon = tr._flow_step(0, views[sl], mcs[0][sl],
                                          own(gt[0]), own(gt[1]))
    return {"losses": [float(l0), float(l1), float(nll)], "grads": grads,
            "outs": {"lrnn": out.numpy(), "flow": recon.numpy()},
            "state": {k: v.detach().numpy().copy()
                      for k, v in tr.model.state_dict().items()}}


def state_digest(state: dict) -> dict:
    """A SHA-1 of each array's bytes, by name."""
    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in state.items()}


def step_case_inputs(views, gt, mcs, frames, side):
    """The first ``frames`` frames of the step inputs, cut to ``side`` rows
    and columns, as tensors."""
    import torch

    def cut(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[:frames, :, :side, :side]))
    return cut(views), [cut(g) for g in gt], [cut(m) for m in mcs]


@contextlib.contextmanager
def pool_choices(record=None, replay=None):
    """The UNet's 2x2 max-pools (``models.unet.adaptive_max_pool2d_half``)
    with their choices kept: each call's argmax indices (over the whole
    image) appended to ``record``; or, with ``replay``, each call takes the
    element that the recorded one chose, on this rank's rows.  A window
    whose two largest values are within roundoff of each other picks either
    one, and the rows of a space mesh are summed in another order than one
    process sums them (the BatchNorm statistics): replaying one process's
    choices keeps such a tie from routing a gradient elsewhere, so the
    comparison sees the exchanges and sums alone."""
    import torch.nn.functional as F

    from cwfa_tpu_torch.models import unet
    from cwfa_tpu_torch.parallel.mesh import current_rows

    calls = iter(replay or ())

    def pool(x):
        if record is not None:
            y, idx = F.max_pool2d(x, 2, 2, return_indices=True)
            record.append(idx)
            return y
        idx = next(calls)
        rows = current_rows()
        h2 = x.shape[2] // 2
        if rows is not None:
            # this rank's output rows; its input rows start at index * H
            idx = (idx[:, :, rows.index * h2:(rows.index + 1) * h2]
                   - rows.index * x.shape[2] * x.shape[3])
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    saved = unet.adaptive_max_pool2d_half
    unet.adaptive_max_pool2d_half = pool
    try:
        yield
    finally:
        unet.adaptive_max_pool2d_half = saved


def case_steps(rank, world, cfgs, seed, views, gt, mcs, bn):
    """``two_steps`` of a trainer on a mesh over the group, for each of
    ``cfgs`` (a name: (config keywords, the (data, space) mesh, the frames
    and the side of the inputs it takes); rank 0 returns it whole, the
    others their losses and state digest; where the rows split over
    ``space``, rank 0 also returns the one-process run under ``"one"``, its
    max-pool choices replayed by the mesh run: ``pool_choices``), then
    ``case_bn`` on ``bn``'s arguments and ``case_extremes``."""
    import torch

    from cwfa_tpu_torch.config import CWFAConfig
    from cwfa_tpu_torch.engine.trainer import CWFATrainer
    from cwfa_tpu_torch.models.cwfa_model import CWFAModel
    from cwfa_tpu_torch.parallel import initialize_from_env, make_mesh

    assert initialize_from_env("cpu")
    meshes = {}
    out = {}
    for name, (cfg, shape, frames, side) in cfgs.items():
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        inputs = step_case_inputs(views, gt, mcs, frames, side)

        def trainer(mesh):
            model = CWFAModel.build(CWFAConfig(**cfg).decode_lrs(),
                                    torch.Generator().manual_seed(seed))
            return CWFATrainer(model, None, {}, device="cpu", mesh=mesh)
        tr = trainer(meshes[shape])
        if tr.step_shards(frames)[1] is None:
            out[name] = two_steps(tr, *inputs)
        else:
            # rows over space: the one-process run here first, its
            # max-pool choices kept, then the mesh run on them
            pools = []
            with pool_choices(record=pools):
                one = two_steps(trainer(None), *inputs)
            with pool_choices(replay=pools):
                out[name] = two_steps(tr, *inputs)
            if not rank:
                out[name]["one"] = one
        if rank:
            # the other ranks' states are held to rank 0's by their digests
            # (the LRNN alone is 27 M parameters)
            out[name] = {"losses": out[name]["losses"],
                         "state_digest": state_digest(out[name]["state"])}
    out["bn"] = case_bn(rank, world, **bn)
    out["extremes"] = case_extremes(rank, world)
    return out


def main():
    case, work = sys.argv[1], sys.argv[2]
    import torch

    torch.set_num_threads(1)
    rank = int(os.environ["CWFA_PROCESS_ID"])
    world = int(os.environ["CWFA_NUM_PROCESSES"])
    with open(os.path.join(work, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    result = globals()[f"case_{case}"](rank, world, **kwargs)
    with open(os.path.join(work, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
