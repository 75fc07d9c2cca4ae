"""CWFA training engine, coarse to fine (counterpart of
``cwfa_tpu/engine/trainer.py``: ``__init__``, the LRNN and flow optimizer
steps ``:115-347``, the caches, the NLL cache and the stage scheduler
``:386-685``, ``evaluate`` ``:750-1002``, ``finalize_results`` and ``fit``
``:1004-1142``, ``save_checkpoints`` / ``load_checkpoints``
``:1144-1306``).

- Stages (CWFA.py:748-771): with E epochs and S pyramid steps each stage
  trains for E // S epochs, coarsest first: the LRNN, then flow steps
  S-2 .. 0 (``stage_for_epoch``).
- The LRNN step minimises ``recon_loss(loss_func_first_step)`` of the
  coarsest GT level; the flow step k minimises ``recon_loss(loss_func_reg)
  x INN_cond_weight + step_nll x (1 - INN_cond_weight)`` over the step's
  flow parameters and its cond net, each group with its own Lion
  (``engine/optim``).  Each optimizer step changes only its stage's groups.
- The last epoch of a stage keeps its outputs per frame for the next, finer
  stage (``_capture_upsampled``); a frame missing there is reconstructed
  down to the level (``_stage_inputs``).
- Per-frame caches on the device: normalized views, GT pyramids (built with
  the empty-depth guard and 1e-3 noise, ``engine/ood.PyramidScorer``) and
  per-fish mean-volume conditions.  The views and GT caches are keyed on the
  dataset's ``cache_tag`` (a unique id and its mutation versions), so an
  in-place change of a dataset or another dataset object never hits a stale
  entry (the reference's fault, ROADMAP C).  Volumes go to the card as the
  dataset stores them, float16.

Precision (``use_half_precision``, JAX's AMP, ``trainer.py:257-266``):
master parameters, gradients, Lion state, losses, log-dets and BatchNorm
statistics stay f32; activations ride bf16.  The cond nets' 2-D stacks and
the LRNN run under ``torch.autocast``; the flow's towers, CAT affines and
3-D pairs go through their ``torch.autograd.Function``s, which cast the f32
master weights for the kernels and return f32 weight gradients.

Randomness: every draw (the LRNN's input noise ``add_noise``, Dropout2d,
``drop_path``, the cond nets' Dropout3d, the GT pyramids' guard and noise,
the mean caches' noise) comes from ``self.generator``, a ``torch.Generator``
on the device seeded with the configuration's seed; ``generator=None`` in the
loss functions draws nothing, as ``rng=None`` in JAX.

Evaluation (``evaluate``) reconstructs through the non-fast chain
(``reconstruct(fast=False)``, the LRNN in train mode, the cond nets and the
flow in eval mode, in the compute dtype), takes per-level PSNR / MAPE and
the neural-trace correlation on the host (``engine/metrics``), dumps
volume TIFFs on a background thread and logs to TensorBoard
(``utils/tb_writer``, PNGs by ``utils/png``).  Per-frame NLLs come from a
cache stamped with ``_params_version``: the port updates its parameters in
place, so every optimizer step and checkpoint load bumps the stamp
explicitly.  The OOD finetune over these caches is
``engine/ood.finetune_on_novel``.  ``load_torch_checkpoints`` reads the
reference's own PyTorch checkpoints (``engine/torch_convert``); the reverse
is ``engine/torch_export``.

More than one device (``mesh=``, a ``parallel.make_mesh`` ``(data,
space)`` mesh; one process per device, JAX's ``trainer.py:117-128,
371-381``): every rank holds the same weights (checked over the whole mesh
at construction and after a load).  ``step_shards`` takes the one decision
of a call: the rank's contiguous rows of the mini-batch on ``data``
(``data_shard``) and its image rows on ``space`` (``row_shard``,
``parallel/halo.py``).  The step runs inside both: the views and mean
caches stay whole (the windows of the cond nets and towers, the input
noise, the LRNN's mean branch read them), the GT levels, the stage inputs
and the captured stage outputs are the rank's rows; each loss is the
rank's part of the one-process loss (``engine/losses``, ``step_nll``: its
own mean times its batch x row share, with the call's extremes), the
train-mode BatchNorm statistics are the call's, every draw over the batch
is made for the global batch from ``self.generator`` (in step on every
rank) and sliced, the exchanges send their gradients back to the rows'
owners, and one flat all-reduce over ``sum_group()`` sums the gradients of
the stage's groups and the loss values, so Lion moves every rank alike, to
the bit.  A mini-batch that does not divide the ``data`` axis (a ragged
last one) is computed whole on every data rank (its sums over the space
group alone); rows that do not split (``space_rows``' fallback, said once)
are computed whole on every space rank (sums over the ``data`` group
alone); with neither split, no all-reduce.  Evaluation splits the frames
and rows the same way and gathers them on every rank; the NLL refresh and
the GT pyramids run whole on every rank of a space group.  The draws that depend
on what one rank caches (the GT pyramids' guard and noise, a stage input
reconstructed on a cache miss) come from ``self.local_generator``, the
rank's own, for frames the rank owns, and from ``self.generator`` for the
frames every rank computes, after the ranks agree which to redo; with no
mesh the two generators are one.
"""

from __future__ import annotations

import copy
import csv
import fnmatch
import math
import os
import zipfile

import numpy as np
import torch

from cwfa_tpu_torch.data.dataset import ConcatXLFMDataset
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.data.tiff import BackgroundTiffWriter, write_tiff_stack
from cwfa_tpu_torch.data.views import extract_views
from cwfa_tpu_torch.engine import checkpoints
from cwfa_tpu_torch.engine import losses as L
from cwfa_tpu_torch.engine import torch_convert as tc
from cwfa_tpu_torch.engine.inference import device_timer
from cwfa_tpu_torch.engine.jax_params import load_jax_params
from cwfa_tpu_torch.engine.metrics import (RoiTraceAccumulator,
                                           compute_step_performance)
from cwfa_tpu_torch.engine.ood import PyramidScorer, sentinel
from cwfa_tpu_torch.engine.optim import make_optimizers
from cwfa_tpu_torch.models.cond_net import cond_networks_batched, cond_reach
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.parallel.distributed import (check_same_on_ranks,
                                                 gather_rows,
                                                 host_local_indices)
from cwfa_tpu_torch.parallel.halo import gather_image_rows
from cwfa_tpu_torch.parallel.mesh import (batch_shard, current_rows,
                                          data_group, data_rank, data_shard,
                                          data_size, draw_rows, row_shard,
                                          space_rows, space_size, sum_group)
from cwfa_tpu_torch.utils.png import write_png
from cwfa_tpu_torch.utils.projections import (create_image_pyramid,
                                              volume_2_projections)
from cwfa_tpu_torch.utils.tb_writer import SummaryWriter


class TrainLog:
    """Scalars by tag: [(epoch, value)], each also written to the
    TensorBoard writer where there is one."""

    def __init__(self, tb_writer: SummaryWriter | None = None):
        self.scalars: dict = {}
        self.tb_writer = tb_writer

    def add(self, tag: str, value, step: int):
        self.scalars.setdefault(tag, []).append((step, float(value)))
        if self.tb_writer is not None:
            self.tb_writer.add_scalar(tag, value, step)

    def last(self, tag: str):
        return self.scalars[tag][-1][1] if self.scalars.get(tag) else None


def snapshot_sources(output_path: str, pattern: str = "*.py"):
    """Zip the package's sources into ``<output_path>/files.zip``
    (reference CWFA.py:558-563, ``--files_to_store``): the files whose
    base name matches ``pattern``, and for the default pattern the C++ /
    CUDA sources and docs too (``trainer.py:81-97``)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    extra = (".cpp", ".cu", ".cuh", ".md") if pattern == "*.py" else ()
    with zipfile.ZipFile(os.path.join(output_path, "files.zip"), "w") as zf:
        for root, _, files in os.walk(pkg_root):
            for f in files:
                if fnmatch.fnmatch(f, pattern) or f.endswith(extra):
                    full = os.path.join(root, f)
                    zf.write(full, os.path.relpath(
                        full, os.path.dirname(pkg_root)))


class _BoundedCache:
    """A dict of device tensors (or lists of them) under a byte bound,
    oldest entry evicted first, the newest never."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.entries: dict = {}

    @staticmethod
    def _bytes(v) -> int:
        vs = v if isinstance(v, (list, tuple)) else [v]
        return sum(t.numel() * t.element_size() for t in vs)

    def get(self, key):
        return self.entries.get(key)

    def put(self, key, value):
        self.entries.pop(key, None)
        self.entries[key] = value
        total = sum(self._bytes(v) for v in self.entries.values())
        while total > self.max_bytes and len(self.entries) > 1:
            old = next(iter(self.entries))
            total -= self._bytes(self.entries.pop(old))


def _detached(t):
    """A normal tensor (not an inference tensor) that autograd may save."""
    return t.detach().clone()


class CWFATrainer:
    """Stage-scheduled trainer of a ``CWFAModel`` on one device, or over a
    ``(data, space)`` ``mesh`` (one process per device; module docstring).

    The model is moved to ``device`` in f32 (its master weights) and kept in
    eval mode; an optimizer step puts its stage's modules into training mode
    (BatchNorm running statistics, Dropout3d) for the step only.  With an
    ``output_path`` the run directory gets a TensorBoard event file (the
    configuration as text, the z temperature) and ``files.zip``."""

    def __init__(self, model: CWFAModel, stats: DatasetStatistics,
                 view_indices: dict, output_path: str | None = None,
                 seed: int | None = None, device="cuda", mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        self._group = data_group(mesh)
        self._n_data = data_size(mesh)
        self._n_ranks = data_size(mesh) * space_size(mesh)
        self.model = model.to(device=self.device, dtype=torch.float32).eval()
        self.cfg = model.cfg
        self.stats = stats
        self.view_indices = view_indices
        self.output_path = output_path
        self.generator = torch.Generator(device=self.device)
        seed = self.cfg.seed if seed is None else seed
        self.generator.manual_seed(seed)
        self.local_generator = self.generator
        if self._n_data > 1:
            # keyed on the data rank: the ranks of a space group draw alike
            self.local_generator = torch.Generator(device=self.device)
            self.local_generator.manual_seed(
                (seed + 1) * 1_000_003 + data_rank(mesh))
        self.check_replicas()
        self.compute_dtype = (torch.bfloat16 if self.cfg.use_half_precision
                              else torch.float32)
        self.opt_flow, self.opt_cond, self.opt_lrnn = make_optimizers(
            self.model)
        tb = None
        if output_path:
            os.makedirs(output_path, exist_ok=True)
            tb = SummaryWriter(output_path)
            tb.add_text("arguments_general", str(self.cfg.to_dict()), 0)
            tb.add_scalar("sampling_temperature",
                          self.cfg.INN_z_temperature, 0)
            snapshot_sources(output_path, pattern=str(self.cfg.files_to_store))
        self.log = TrainLog(tb)
        self.views_cache = _BoundedCache(2 << 30)
        self.gt_cache = _BoundedCache(4 << 30)
        self.upsampled_cache = _BoundedCache(4 << 30)
        # (tag, dataset.cache_tag, ix) -> (parameter version, NLLs (nf,))
        self.nll_cache: dict = {}
        self._params_version = 0
        self.mean_caches: dict = {}      # dataset index -> levels
        self.transfer_log = {"frame_uploads": 0, "volume_uploads": 0,
                             "h2d_bytes": 0}

    # ------------------------------------------------------------ caches
    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.compute_dtype == torch.bfloat16)

    def check_replicas(self):
        """Raise unless every rank holds the same weights and BatchNorm
        statistics (a checksum gathered over the whole mesh, which
        ``make_mesh`` makes the world)."""
        if self._n_ranks > 1:
            check_same_on_ranks(self.model.state_dict(),
                                torch.distributed.group.WORLD,
                                "the model's weights")

    def _any_rank(self, flags: list) -> list:
        """Each flag OR-ed over the whole mesh (one small all-reduce)."""
        if self._n_ranks == 1 or not flags:
            return list(flags)
        t = torch.tensor([float(f) for f in flags], device=self.device)
        torch.distributed.all_reduce(t, group=torch.distributed.group.WORLD)
        return [bool(v > 0) for v in t.tolist()]

    def step_shards(self, n: int):
        """(batch shard, row shard) of a step or an evaluation call on an
        n-frame mini-batch: the one decision per call, the same on every
        rank (``batch_shard``; ``space_rows`` over the volume's rows at the
        UNet's 2^(depth - 1), its sums over the whole mesh when the batch is
        split too).  Either may be None: a ragged batch computed whole on
        every data rank, rows that fall back to all of them."""
        shard = batch_shard(self.mesh, n)
        return shard, self._rows(shard is not None)

    def _rows(self, batch_split: bool = False):
        """This rank's row shard (``space_rows``), or None."""
        depth = self.model.lrnn_spec.unet.depth
        return space_rows(self.mesh, self.cfg.volume_side_size,
                          2 ** (depth - 1), batch_split)

    def ensure_mean_caches(self, dataset: ConcatXLFMDataset):
        """Per-fish mean-volume conditioning pyramids (CWFA.py:625-655)."""
        s = self.stats
        for di in range(len(dataset.datasets)):
            if di in self.mean_caches:
                continue
            mv = torch.as_tensor(dataset.mean_volume(di)).to(self.device)
            mv = (mv - s.mean_vols) / s.std_vols
            caches = self.model.make_mean_caches(mv, generator=self.generator)
            self.mean_caches[di] = [_detached(c) for c in caches]

    def save_mean_caches(self, path: str | None = None):
        path = path or self.output_path
        return checkpoints.save_mean_caches(path, {
            di: [c.cpu().numpy() for c in cs]
            for di, cs in self.mean_caches.items()})

    def _views_for(self, dataset: ConcatXLFMDataset, tag: str, ix: int):
        """Normalized device views (1, n_lenslets, S, S) of one frame, read
        and uploaded once."""
        key = (tag, dataset.cache_tag, ix)
        cached = self.views_cache.get(key)
        if cached is not None:
            return cached
        di, li = dataset.locate(ix)
        raw = np.asarray(dataset.datasets[di].stacked_views[li][None])
        self.transfer_log["frame_uploads"] += 1
        self.transfer_log["h2d_bytes"] += raw.nbytes
        s = self.stats
        views = extract_views(torch.as_tensor(raw).to(self.device),
                              self.view_indices)
        views = (views - s.mean_imgs) / s.std_imgs
        self.views_cache.put(key, views)
        return views

    def _gt_pyramids(self, dataset: ConcatXLFMDataset, tag: str, ixs: list,
                     replicated: bool = False):
        """The frames' GT pyramids [(1, D/2^l, S, S) f32 for every level l],
        each built once, frame by frame: normalize, empty-depth guard, 1e-3
        noise, the forward pyramid (``pyramid_fn``, ``trainer.py:233-255``).
        ``replicated``: every rank builds these frames (a ragged batch), so a
        frame missing on any rank is built again on all, from the shared
        generator; a rank's own frames draw from its own."""
        keys = [(tag, dataset.cache_tag, ix) for ix in ixs]
        missing = [self.gt_cache.get(k) is None for k in keys]
        shared = replicated and self._n_data > 1
        if shared:
            missing = self._any_rank(missing)
        g = self.generator if shared else self.local_generator
        for ix, miss in zip(ixs, missing):
            if miss:
                self._score_volumes(dataset, tag, [ix], g)
        return [self.gt_cache.get(k) for k in keys]

    def _score_volumes(self, dataset: ConcatXLFMDataset, tag: str,
                       ixs: list, generator=None):
        """Upload the frames' volumes, run ``pyramid_fn`` on them as one
        batch (its draws from ``generator``, by default the rank's own),
        and cache each frame's GT pyramid and its NLLs under the current
        parameter version (``trainer.py:551-565,592-605``).  Returns the
        NLLs (n_flow_steps, len(ixs))."""
        vols = self._gather_vols(dataset, ixs)
        self.transfer_log["volume_uploads"] += len(ixs)
        self.transfer_log["h2d_bytes"] += vols.nbytes
        scorer = PyramidScorer(
            self.model, self.stats, device=self.device,
            generator=self.local_generator if generator is None
            else generator)
        nlls, pyramid, _, _ = scorer(torch.as_tensor(vols).to(self.device))
        nlls = nlls.cpu().numpy()
        for j, ix in enumerate(ixs):
            key = (tag, dataset.cache_tag, ix)
            self.nll_cache[key] = (self._params_version, nlls[:, j])
            self.gt_cache.put(key, [_detached(lvl[j:j + 1])
                                    for lvl in pyramid])
        return nlls

    @staticmethod
    def _gather_vols(dataset: ConcatXLFMDataset, ixs: list) -> np.ndarray:
        """(len(ixs), D, S, S) GT volumes from the dataset, as stored
        (float16), on the host."""
        vols = []
        for ix in ixs:
            di, li = dataset.locate(ix)
            vols.append(np.asarray(dataset.datasets[di].vols[li]))
        return np.stack(vols)

    def _refresh_nlls(self, dataset: ConcatXLFMDataset, tag: str,
                      ixs: list):
        """Recompute the frames' NLLs whose cache entry is missing or older
        than the parameters (``trainer.py:520-565``): a frame whose GT
        pyramid is on the device goes through ``nll_from_pyramid`` with
        no host transfer (the levels are parameter-independent Haar
        averages), the rest through ``pyramid_fn``, which primes their GT
        pyramids too.
        With a mesh the ranks agree on the stale frames, each computes its
        contiguous share of them, and the NLLs are gathered into every
        rank's cache."""
        stale = self._any_rank([
            self.nll_cache.get((tag, dataset.cache_tag, ix), (None,))[0]
            != self._params_version for ix in ixs])
        stale = [ix for ix, st in zip(ixs, stale) if st]
        if not stale:
            return
        mine = stale
        if self._n_data > 1:
            mine = [stale[i] for i in host_local_indices(
                len(stale), data_rank(self.mesh), self._n_data)]
        cached = [ix for ix in mine
                  if self.gt_cache.get((tag, dataset.cache_tag, ix))
                  is not None]
        missing = [ix for ix in mine if ix not in cached]
        nf = self.model.n_flow_steps
        got = {}
        if cached:
            pyrs = [self.gt_cache.get((tag, dataset.cache_tag, ix))
                    for ix in cached]
            batch = [torch.cat([p[lvl] for p in pyrs])
                     for lvl in range(len(pyrs[0]))]
            nlls = sentinel(self.model.nll_from_pyramid(batch)).cpu().numpy()
            got.update({ix: nlls[:, j] for j, ix in enumerate(cached)})
        if missing:
            nlls = self._score_volumes(dataset, tag, missing)
            got.update({ix: nlls[:, j] for j, ix in enumerate(missing)})
        if self._n_data > 1:
            local = torch.as_tensor(np.stack(
                [got[ix] for ix in mine]) if mine
                else np.zeros((0, nf), np.float32)).to(self.device)
            every = gather_rows(local, self._group).cpu().numpy()
            got = {ix: every[j] for j, ix in enumerate(stale)}
        for ix, v in got.items():
            self.nll_cache[(tag, dataset.cache_tag, ix)] = (
                self._params_version, v)

    def _frame_nll(self, dataset: ConcatXLFMDataset, tag: str, ix: int):
        """The frame's NLLs (n_flow_steps,) under the current parameters,
        from the cache or recomputed (``trainer.py:567-574``)."""
        key = (tag, dataset.cache_tag, ix)
        entry = self.nll_cache.get(key)
        if entry is None or entry[0] != self._params_version:
            self._refresh_nlls(dataset, tag, [ix])
            entry = self.nll_cache[key]
        return entry[1]

    def clear_gt_cache(self, tag: str):
        """Drop every GT pyramid cached under ``tag``."""
        for key in [k for k in self.gt_cache.entries if k[0] == tag]:
            del self.gt_cache.entries[key]

    def _batches(self, dataset: ConcatXLFMDataset):
        """Mini-batches of ``cfg.batch_size`` frame indices, each of one fish
        (they share its mean caches)."""
        bs = max(int(self.cfg.batch_size), 1)
        by_ds: dict = {}
        for ix in range(len(dataset)):
            by_ds.setdefault(dataset.locate(ix)[0], []).append(ix)
        return [(di, ixs[i:i + bs]) for di in sorted(by_ds)
                for ixs in [by_ds[di]] for i in range(0, len(ixs), bs)]

    def _batch_inputs(self, dataset: ConcatXLFMDataset, di: int, ixs: list,
                      tag: str, replicated: bool = False):
        """(normalized views (B, n, S, S), GT pyramid levels, the fish's
        mean caches broadcast to the batch); ``replicated`` as in
        ``_gt_pyramids``."""
        views = torch.cat([self._views_for(dataset, tag, ix) for ix in ixs])
        pyrs = self._gt_pyramids(dataset, tag, ixs, replicated)
        gt = [torch.cat([p[lvl] for p in pyrs]) for lvl in range(len(pyrs[0]))]
        mcs = [c.expand((len(ixs),) + tuple(c.shape[1:]))
               for c in self.mean_caches[di]]
        return views, gt, mcs

    # ------------------------------------------------------------ stages
    def stage_for_epoch(self, epoch: int) -> int:
        """steps_to_optimize (CWFA.py:748-752): n_flow_steps is the LRNN
        stage, n_flow_steps-1 .. 0 the flow steps, coarsest first."""
        cfg = self.cfg
        eps = max(cfg.epochs // cfg.INN_max_down_steps, 1)
        step = int(cfg.INN_max_down_steps - epoch // eps) - 1
        return max(min(step, self.model.n_flow_steps), 0)

    def _stage_inputs(self, dataset, ixs, views_n, mean_caches, stage,
                      replicated: bool = False):
        """The coarser stage's output for each frame, (B, D_{stage+1}, S, S):
        the captured one, or the chain reconstructed down to level stage + 1
        frame by frame (CWFA.py:848-851; draws as ``_gt_pyramids``).  On a
        space mesh both are this rank's rows: a reconstruction runs on the
        space group's row shard."""
        want = self.cfg.n_depths // (2 ** (stage + 1))
        cached = [self.upsampled_cache.get((dataset.cache_tag, ix))
                  for ix in ixs]
        missing = [c is None or c.shape[1] != want for c in cached]
        shared = replicated and self._n_data > 1
        if shared:
            missing = self._any_rank(missing)
        g = self.generator if shared else self.local_generator
        outs = []
        for j, miss in enumerate(missing):
            if not miss:
                outs.append(cached[j])
                continue
            with row_shard(self._rows()):
                _, pyramid = self.model.reconstruct(
                    views_n[j:j + 1], mean_caches,
                    z_temperature=self.cfg.INN_z_temperature, generator=g,
                    lrnn_train=True, return_pyramid=True)
            outs.append(_detached(pyramid[stage + 1]))
        return torch.cat(outs)

    def _capture_upsampled(self, dataset, ix, out):
        self.upsampled_cache.put((dataset.cache_tag, ix), _detached(out))

    # ------------------------------------------------------------ losses
    def lrnn_loss(self, views_n, mean_c, gt_coarse, generator):
        """The LRNN stage's loss (``trainer.py:268-282``): the views with
        N(0, 0.5^2) noise where ``add_noise`` (and a generator), the LRNN in
        train mode, ``recon_loss(loss_func_first_step)`` against the
        coarsest GT level in f32.  Under a row shard the views are whole
        (the noise is drawn over them) and the LRNN runs on the rank's rows
        of them; gt_coarse and the output are the rank's rows.  Returns
        (loss, the LRNN's output f32)."""
        dt = self.compute_dtype
        vin = views_n
        if self.cfg.add_noise == 1 and generator is not None:
            vin = vin + 0.5 * draw_rows(lambda sh: torch.randn(
                sh, generator=generator, device=generator.device),
                vin.shape).to(vin.device)
        rows = current_rows()
        if rows is not None:
            vin = rows.own(vin)
        with self._autocast():
            out = self.model.lrnn(vin.to(dt), mean_vol=mean_c.to(dt),
                                  train=True, generator=generator)
        out = out.float()
        return L.recon_loss(self.cfg.loss_func_first_step, gt_coarse, out), out

    def flow_loss(self, k: int, views_n, mean_c_k, gt_k, upsampled_in,
                  generator):
        """Flow step k's loss (``trainer.py:293-322``): the step reversed
        from z = 0 and the stage input under the cond net's condition (in
        train mode: Dropout3d from ``generator``), ``recon_loss
        (loss_func_reg)`` against the GT level, and ``step_nll`` of the GT
        level under the same conditions; a CAT step's towers run once, for
        both directions (the other types' towers read x, so each direction
        runs its own, as JAX's ``flow_step``).  Under a row shard the views
        and mean_c_k are whole, gt_k and upsampled_in the rank's rows: the
        cond net runs on the views' window of ``cond_reach`` + the towers'
        reach, cropped to the towers' window, and the losses are the rank's
        parts.  Returns (full loss, recon loss, NLL, reconstruction f32)."""
        cfg, dt = self.cfg, self.compute_dtype
        spec = self.model.step_specs[k]
        step = self.model.flow[k]
        rows = current_rows()
        tr = 0 if rows is None else step.tower_reach
        b, h = gt_k.shape[0], gt_k.shape[2]
        lo, hi = (0, h) if rows is None else rows.window(tr)
        if cfg.force_all_steps_NF:
            # a zero views condition (CWFA.py:892-894); the cond net is
            # unused and receives no update
            c_views = torch.zeros((b, spec.c_flow, hi - lo, spec.spatial),
                                  dtype=dt, device=gt_k.device)
        else:
            cond = self.model.cond[k]
            r = 0 if rows is None else cond_reach(cond) + tr
            views = views_n if rows is None else rows.take_window(views_n, r)
            with self._autocast():
                c_views = cond(views.to(dt), generator=generator)
            if rows is not None:
                c_views = rows.crop(c_views, r, tr)
        z = torch.zeros((b, spec.c_flow, h, spec.spatial), dtype=dt,
                        device=gt_k.device)
        mean_c = (mean_c_k if rows is None else rows.own(mean_c_k)).to(dt)
        # a CAT step's five towers read c_views alone: run once, read by
        # both directions
        towers = step.towers(c_views, c_reach=tr) if step.is_cat else None
        recon, _ = step.reverse(z, upsampled_in.to(dt), c_views, mean_c,
                                towers, tr)
        recon = recon.float()
        loss_c = L.recon_loss(cfg.loss_func_reg, gt_k, recon)
        nll, _ = self.model.step_nll(k, gt_k.to(dt), c_views, mean_c, towers,
                                     tr)
        full = (loss_c * cfg.INN_cond_weight
                + nll * (1.0 - cfg.INN_cond_weight))
        return full, loss_c, nll, recon

    # ------------------------------------------------------- optimizer steps
    def _sum_over_ranks(self, modules, values: list) -> list:
        """Under a shard: one flat all-reduce over ``sum_group()`` (the
        ranks that computed distinct parts of the step) of the gradients of
        every parameter of ``modules`` (a missing one as zeros, which Lion
        takes it for) and of the loss ``values`` (each rank's part); each
        gradient gets its sum back.  Returns the values summed (as they are
        outside a shard)."""
        group = sum_group()
        if group is None:
            return values
        params = [p for m in modules for p in m.parameters()]
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1).float() for p in params]
            + [torch.stack([v.float() for v in values])])
        torch.distributed.all_reduce(flat, group=group)
        off = 0
        for p in params:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p).to(p.dtype)
            off += n
        return list(flat[off:])

    def _lrnn_step(self, views_n, mean_c, gt_coarse):
        lrnn = self.model.lrnn
        self.opt_lrnn.zero_grad()
        lrnn.train()
        try:
            loss, out = self.lrnn_loss(views_n, mean_c, gt_coarse,
                                       self.generator)
            loss.backward()
        finally:
            lrnn.eval()
        loss, = self._sum_over_ranks([lrnn], [loss.detach()])
        self.opt_lrnn.step()
        self._params_version += 1
        return loss.detach(), out.detach()

    def _flow_step(self, k: int, views_n, mean_c_k, gt_k, upsampled_in):
        cond = self.model.cond[k]
        self.opt_flow[k].zero_grad()
        self.opt_cond[k].zero_grad()
        cond.train()
        try:
            full, loss_c, nll, recon = self.flow_loss(
                k, views_n, mean_c_k, gt_k, upsampled_in, self.generator)
            full.backward()
        finally:
            cond.eval()
        full, loss_c, nll = self._sum_over_ranks(
            [self.model.flow[k], cond],
            [full.detach(), loss_c.detach(), nll.detach()])
        # as JAX, the cond group steps even under force_all_steps_NF, on
        # zero gradients (the parameters stay, the count moves)
        self.opt_flow[k].step()
        self.opt_cond[k].step()
        self._params_version += 1
        return full.detach(), loss_c.detach(), nll.detach(), recon.detach()

    def train_epoch(self, dataset: ConcatXLFMDataset, epoch: int,
                    tag: str = "train") -> float:
        """One epoch at the scheduled stage; returns the per-sample mean
        loss.  Raises ValueError on a NaN / Inf loss (CWFA.py:989-994)."""
        self.ensure_mean_caches(dataset)
        cfg = self.cfg
        nf = self.model.n_flow_steps
        stage = self.stage_for_epoch(epoch)
        eps = max(cfg.epochs // cfg.INN_max_down_steps, 1)
        capture = (epoch + 1) % eps == 0 and stage > 0
        losses = []
        for di, all_ixs in self._batches(dataset):
            # with a mesh: this rank's rows, or all of a ragged batch; on a
            # space mesh the rank's image rows of the GT and stage inputs
            shard, rows = self.step_shards(len(all_ixs))
            ixs = (all_ixs if shard is None
                   else all_ixs[shard.start:shard.stop])
            replicated = shard is None
            views_n, gt, mcs = self._batch_inputs(dataset, di, ixs, tag,
                                                  replicated)
            if rows is not None:
                gt = [rows.own(g) for g in gt]
            if stage != nf:
                k = stage
                # train_with_gt_low_res (CWFA.py:866-869): the GT level as
                # the stage input, for every step (1) or only the
                # coarsest-but-one (2)
                if cfg.train_with_gt_low_res == 1 or (
                        cfg.train_with_gt_low_res == 2
                        and k == cfg.INN_max_down_steps - 2):
                    upsampled = gt[k + 1]
                else:
                    upsampled = self._stage_inputs(
                        dataset, ixs, views_n, self.mean_caches[di], k,
                        replicated)
            with data_shard(shard), row_shard(rows):
                if stage == nf:
                    loss, out = self._lrnn_step(views_n, mcs[nf - 1],
                                                gt[nf])
                else:
                    loss, _, nll, out = self._flow_step(
                        k, views_n, mcs[k], gt[k], upsampled)
                    self.log.add(f"loss_LL/step_{k}", nll, epoch)
            if capture:
                for j, ix in enumerate(ixs):
                    self._capture_upsampled(dataset, ix, out[j:j + 1])
            value = float(loss)
            losses.append((value, len(all_ixs)))
            if not math.isfinite(value):
                raise ValueError(f"Nan/Inf loss found in {tag} at epoch "
                                 f"{epoch}, batch {all_ixs} "
                                 "(CWFA.py:989-994)")
        total = sum(n for _, n in losses)
        mean_loss = sum(v * n for v, n in losses) / max(total, 1)
        self.log.add(f"fine_tune/loss/{tag}", mean_loss, epoch)
        self.log.add("step_to_optimize", stage, epoch)
        return mean_loss

    # ------------------------------------------------------- checkpoints
    def _optimizers(self):
        return self.opt_flow, self.opt_cond, self.opt_lrnn

    def save_checkpoints(self, epoch: int, path: str | None = None) -> list:
        """One file per pyramid step (CWFA.py:1171-1174,1280-1284) with the
        step's parameters, its Lion momenta and, for the LRNN step, the
        UNet's BatchNorm statistics; then the mean caches.  Returns the
        files written."""
        path = path or self.output_path
        written = checkpoints.save_model_checkpoints(
            self.model, path, epoch, self.stats,
            optimizers=self._optimizers())
        return written + self.save_mean_caches(path)

    def load_checkpoints(self, path: str, steps=None,
                         max_epoch: int | None = None):
        """Parameters, BatchNorm statistics and Lion state of the
        highest-epoch file of each step in ``path`` (the port's or the JAX
        trainer's) up to epoch ``cfg.max_test_load_epoch`` (or
        ``max_epoch``), only the file steps in ``steps`` where given, and
        the mean caches beside them (``trainer.py:1227-1306``).  Under
        ``cfg.fine_tune_use_model_args`` each loaded flow step's Lion takes
        the learning rate stored in that step's checkpoint (CWFA.py:599-600;
        a Lion state does not depend on it).  Returns the steps loaded."""
        for di, levels in checkpoints.load_mean_caches(path).items():
            self.mean_caches[di] = [torch.as_tensor(np.asarray(c)).to(
                self.device, torch.float32) for c in levels]
        if max_epoch is None:
            max_epoch = int(self.cfg.max_test_load_epoch)
        configs: dict = {}
        stats, loaded = checkpoints.load_model_checkpoints(
            self.model, path, max_epoch=max_epoch,
            optimizers=self._optimizers(), steps=steps, configs=configs)
        if self.stats is None:
            self.stats = stats
        if self.cfg.fine_tune_use_model_args:
            for step, cfg in configs.items():
                if step - 1 < self.model.n_flow_steps:
                    self.opt_flow[step - 1].lr = \
                        cfg.decode_lrs().learning_rate
        self._params_version += 1
        self.check_replicas()
        return loaded

    def load_torch_checkpoints(self, path: str, steps=None) -> list:
        """The reference's own PyTorch checkpoints (``trainer.py:1169-1225``):
        the highest-epoch ``model_step_*__ep_*`` torch file of each step in
        ``path`` up to epoch ``cfg.max_test_load_epoch`` (only the file steps
        in ``steps``, where given), read by ``engine/torch_convert`` into
        the flow steps (with the file's permutations, each spatial one on
        the axis the step replayed; the input subnet's variant from the
        step's ``disable_low_res_input``), the cond nets and the LRNN (its
        BatchNorm statistics, each count at 0).  Only torch files are
        discovered, before the highest epoch is picked: a ``.msgpack`` file
        beside them never hides a step (the JAX trainer filters after
        picking).  The statistics come from the first file that has them
        when the trainer has none.  The Lion states are not touched (the
        reference's files carry none it reads).  Returns the steps loaded.
        The files are pickles: load them only from a source you trust.
        Raises ValueError, before any file is read, when the configuration's
        ``INN_block_type`` is not CAT (the files hold the CAT graph)."""
        tc.require_cat(self.cfg.INN_block_type, "load_torch_checkpoints")
        nf = self.model.n_flow_steps
        found = checkpoints.discover_checkpoints(
            path, checkpoints.TORCH_GLOB,
            max_epoch=int(self.cfg.max_test_load_epoch))
        loaded = []
        for step, (_, fname) in sorted(found.items()):
            if steps is not None and step not in steps:
                continue
            payload = tc.load_torch_state_dict(fname)
            ts = payload.get("training_statistics")
            if self.stats is None and ts and len(ts) == 6:
                self.stats = DatasetStatistics(*[float(t) for t in ts])
            ix = step - 1
            if ix < nf and payload["INN_state_dict"]:
                spec = self.model.step_specs[ix]
                flow, perms = tc.convert_graph_inn(
                    payload["INN_state_dict"], n_blocks=self.cfg.INN_n_blocks,
                    use_final_perm=self.cfg.INN_use_perm == 1,
                    first=not spec.disable_low_res_input)
                load_jax_params(self.model.flow[ix], flow, {})
                self.model.set_step_spec(
                    ix, tc.apply_perm_overrides(spec, perms))
            cond = payload["condition_state_dict"]
            if cond and ix >= nf:
                load_jax_params(self.model.lrnn, *tc.convert_lrnn(cond))
            elif cond:
                load_jax_params(self.model.cond[ix],
                                tc.convert_cond_network(cond), {})
            loaded.append(step)
        self._params_version += 1
        self.check_replicas()
        return loaded

    # ------------------------------------------------------------ evaluation
    def _eval_model(self) -> CWFAModel:
        """The model that evaluation runs: the trainer's in f32, else a copy
        in the compute dtype (as ``XLFMReconstructor`` computes), made once
        per ``evaluate``."""
        if self.compute_dtype == torch.float32:
            return self.model
        return copy.deepcopy(self.model).to(self.compute_dtype)

    def _recon_eval(self, model: CWFAModel, views_n, mean_caches):
        """The evaluation reconstruction (``recon_eval``,
        ``trainer.py:349-358``) by ``model`` (``_eval_model``): the
        non-fast chain, the LRNN in train mode drawing from the generator,
        z at ``INN_z_temperature``, the mean over ``INN_n_samples``.  The
        modules stay in eval mode, so no BatchNorm running statistic moves.
        Returns the pyramid {level: (B, D_l, S, S)}."""
        cfg, dt = self.cfg, self.compute_dtype
        with torch.inference_mode():
            _, pyramid = model.reconstruct(
                views_n.to(dt), [c.to(dt) for c in mean_caches],
                z_temperature=cfg.INN_z_temperature, generator=self.generator,
                lrnn_train=True, n_samples=cfg.INN_n_samples, fast=False,
                return_pyramid=True)
        return pyramid

    def evaluate(self, dataset: ConcatXLFMDataset, tag: str = "val",
                 neural_coords=None, epoch: int | None = None,
                 save_volumes: bool | None = None, keep_volumes: int = 16):
        """Reconstruction of every frame, per-level metrics and timing
        (CWFA.py:1033-1169, ``trainer.py:750-949``).  Returns the results
        dict of the JAX trainer: per frame ``psnr`` / ``MAPE`` (one value
        a level), ``times`` (seconds of the reconstruction a frame: CUDA
        events on a card, the host clock on the CPU) and ``nll`` (the
        NLLs of every flow step); ``CC``; the first ``keep_volumes``
        un-normalized volume pairs; the level-0 MIPs (first 10 frames, or
        all when ``stack_MIP_*.tif`` will be written) and, under
        ``save_images``, the per-level MIPs of the first 10.

        Frames go in ``cfg.batch_size`` mini-batches of one fish.  Under
        ``save_tiff_volumes`` the volumes go to ``stacks/{tag}/{gt,pred}``
        through a background writer.  neural_coords: per-fish lists of
        (x, y, z); with more than one frame the traces' correlation
        (``RoiTraceAccumulator``) gives ``CC`` and
        ``Neural_activity_{tag}.csv``."""
        nf = self.model.n_flow_steps
        cfg = self.cfg
        res = {"psnr": [], "MAPE": [], "times": [], "volumes_pred": [],
               "volumes_gt": [], "nll": [], "CC": None,
               "projections_gt": [], "projections_predicted": [],
               "projections_pred_steps": [], "projections_gt_steps": [],
               "projections_diff_steps": []}
        if len(dataset) == 0:
            return res
        self.ensure_mean_caches(dataset)
        if save_volumes is None:
            save_volumes = bool(cfg.save_tiff_volumes) and \
                self.output_path is not None
        # the level-0 MIPs of every frame, exactly when finalize_results
        # writes the stack_MIP files from them
        keep_all_mips = bool(cfg.save_tiff_volumes and not cfg.fine_tune
                             and self.output_path)
        accs: dict = {}
        if neural_coords is not None and len(dataset) > 1:
            for di in range(len(dataset.datasets)):
                coords = neural_coords[di] if di < len(neural_coords) else []
                if len(coords):
                    accs[di] = RoiTraceAccumulator(coords)
        writer = None
        if save_volumes and self.output_path:
            for sub in ("gt", "pred"):
                os.makedirs(os.path.join(self.output_path, "stacks", tag,
                                         sub), exist_ok=True)
            writer = BackgroundTiffWriter(maxsize=16)
        last_pyr_np = last_gt_np = views_n = None
        frame_no = 0
        model = self._eval_model()
        try:
            for di, all_ixs in self._batches(dataset):
                # with a mesh: this rank's rows (batch and image), gathered
                # after
                shard, rows = self.step_shards(len(all_ixs))
                ixs = (all_ixs if shard is None
                       else all_ixs[shard.start:shard.stop])
                views_n, gt, mean_caches = self._batch_inputs(
                    dataset, di, ixs, tag, shard is None)
                self._refresh_nlls(dataset, tag, all_ixs)
                stop = device_timer(self.device)
                with data_shard(shard), row_shard(rows):
                    pyramid = self._recon_eval(model, views_n, mean_caches)
                dt = stop() / len(ixs)

                def host(t, own_rows=False):
                    if own_rows and rows is not None:
                        t = gather_image_rows(t, rows)
                    t = t if shard is None else gather_rows(t, shard.group)
                    return t.cpu().numpy()
                pyr_np = [host(pyramid[lvl].float(), True)
                          for lvl in range(nf + 1)]
                gt_np = [host(g) for g in gt]
                last_pyr_np, last_gt_np = pyr_np, gt_np
                for j, ix in enumerate(all_ixs):
                    res["times"].append(dt)
                    gt_out, pred_out = self._frame_metrics(
                        res, gt_np, pyr_np, j, frame_no, keep_volumes,
                        keep_all_mips)
                    if writer is not None:
                        for sub, vol in (("gt", gt_out), ("pred", pred_out)):
                            writer.put(os.path.join(
                                self.output_path, "stacks", tag, sub,
                                f"stack_{frame_no:03d}.tif"),
                                np.maximum(vol, 0).astype(np.float32))
                    if di in accs:
                        accs[di].add(gt_out, pred_out)
                    res["nll"].append(self._frame_nll(dataset, tag, ix))
                    frame_no += 1
        finally:
            if writer is not None:
                writer.close()
        if accs:
            self._trace_correlation(dataset, tag, accs, res)
        step = epoch if epoch is not None else 0
        self._log_eval_images(model, tag, res, last_gt_np, last_pyr_np,
                              step, views_n=views_n)
        for lvl in range(nf + 1):
            self.log.add(f"fine_tune/psnr/{tag}/step_{lvl}",
                         float(np.mean([r[lvl] for r in res["psnr"]])), step)
            self.log.add(f"fine_tune/masked_psnr/{tag}/step_{lvl}",
                         float(np.mean([r[lvl] for r in res["MAPE"]])), step)
        self.log.add(f"time/mean/{tag}", float(np.mean(res["times"])), step)
        self.log.add(f"time/min/{tag}", float(np.min(res["times"])), step)
        if res["CC"] is not None:
            self.log.add(f"corr_coeff_mean_{tag}/pred", res["CC"], step)
        if self.log.tb_writer is not None:
            self.log.tb_writer.flush()
        return res

    def _frame_metrics(self, res, gt_np, pyr_np, j, frame_no, keep_volumes,
                       keep_all_mips):
        """Frame j of a batch: PSNR / MAPE of every level
        (``compute_step_performance``), the MIPs kept by the retention
        rules of ``trainer.py:843-889``, and its un-normalized volumes
        (``* std + mean``; the GT shifted to a minimum of 0), kept while
        fewer than ``keep_volumes`` are.  Returns the volumes (gt, pred)."""
        s, cfg = self.stats, self.cfg
        keep_steps = frame_no < 10 and bool(cfg.save_images)
        psnrs, mapes, proj_p, proj_g, proj_d = [], [], [], [], []
        gt_t0 = pr_t0 = None
        for lvl in range(len(pyr_np)):
            p, m, gt_t, pr_t = compute_step_performance(
                gt_np[lvl][j:j + 1], pyr_np[lvl][j:j + 1], lvl,
                s.mean_vols, s.std_vols)
            psnrs.append(p)
            mapes.append(m)
            if lvl == 0:
                gt_t0, pr_t0 = gt_t, pr_t
            if keep_steps:
                proj_p.append(volume_2_projections(pr_t)[0])
                proj_g.append(volume_2_projections(gt_t)[0])
                proj_d.append(volume_2_projections(pr_t - gt_t)[0])
        if keep_steps:
            res["projections_pred_steps"].append(proj_p)
            res["projections_gt_steps"].append(proj_g)
            res["projections_diff_steps"].append(proj_d)
        res["psnr"].append(psnrs)
        res["MAPE"].append(mapes)
        gt_out = gt_np[0][j] * s.std_vols + s.mean_vols
        gt_out = gt_out - gt_out.min()
        pred_out = pyr_np[0][j] * s.std_vols + s.mean_vols
        if len(res["volumes_gt"]) < keep_volumes:
            res["volumes_gt"].append(gt_out)
            res["volumes_pred"].append(pred_out)
        if frame_no < 10 or keep_all_mips:
            # float16 with a finite clip, as the reference's stack concat
            # casts (CWFA.py:1266), without its overflow to inf
            def to_f16(a):
                return np.clip(a, -65504, 65504).astype(np.float16)
            res["projections_gt"].append(
                to_f16(volume_2_projections(gt_t0)[0]))
            res["projections_predicted"].append(
                to_f16(volume_2_projections(pr_t0)[0]))
        return gt_out, pred_out

    def _trace_correlation(self, dataset, tag, accs, res):
        """``CC`` = the mean over fish of the mean trace correlation, and
        the traces as ``Neural_activity_{tag}.csv`` (CWFA.py:1095-1117,
        1272-1273)."""
        ccs, records = [], []
        for di, acc in accs.items():
            if acc.n_frames <= 1:
                continue
            cc, recs = acc.finalize(
                filter_width=int(self.cfg.neural_activation_filter_width))
            ccs.append(float(np.mean(cc)) if len(cc) else 0.0)
            for r in recs:
                r["sample_id"] = dataset.datasets[di].dataset_id
            records.extend(recs)
        res["CC"] = float(np.mean(ccs)) if ccs else 0.0
        if self.output_path and records:
            keys = sorted({k for r in records for k in r},
                          key=lambda k: (k.startswith("t"), k))
            with open(os.path.join(self.output_path,
                                   f"Neural_activity_{tag}.csv"), "w",
                      newline="") as f:
                wr = csv.DictWriter(f, fieldnames=keys)
                wr.writeheader()
                wr.writerows(records)

    def _log_eval_images(self, model, tag, res, gt_np, pyr_np, step,
                         views_n=None):
        """TensorBoard images of an evaluation (CWFA.py:1070-1072,1144-1169,
        ``trainer.py:951-1002``): ``projections_pred/{tag}`` always;
        under ``save_images`` ``projections_gt/{tag}``, the last batch's
        first frame's recon / GT MIPs of every level, the finest step's
        condition map and, under ``create_dist_plots``, the GT-vs-recon
        histograms (skipped where matplotlib is missing)."""
        tb = self.log.tb_writer
        if tb is None or not res["projections_predicted"]:
            return
        cfg = self.cfg

        def norm_img(im):
            return im / max(float(np.max(im)), 1e-9)
        tb.add_image(f"projections_pred/{tag}",
                     norm_img(res["projections_predicted"][0]), step)
        if cfg.save_images:
            tb.add_image(f"projections_gt/{tag}",
                         norm_img(res["projections_gt"][0]), step)
        if not cfg.save_images or gt_np is None:
            return
        for lvl in range(len(pyr_np)):
            tb.add_image(f"fine_tune/recon_{tag}_step{lvl}",
                         norm_img(volume_2_projections(
                             pyr_np[lvl][:1], add_scale_bars=True)[0]), step)
            tb.add_image(f"fine_tune/GT_{tag}_step{lvl}",
                         norm_img(volume_2_projections(
                             gt_np[lvl][:1], add_scale_bars=True)[0]), step)
        if views_n is not None and not cfg.force_all_steps_NF:
            with torch.inference_mode():
                cond = cond_networks_batched(
                    model.cond[:1], views_n[:1].to(self.compute_dtype))[0]
            tb.add_image(f"condition/{tag}_step0",
                         norm_img(volume_2_projections(
                             np.abs(cond.float().cpu().numpy()),
                             add_scale_bars=True)[0]), step)
        if cfg.create_dist_plots:
            try:
                from cwfa_tpu_torch.utils.plots import plot_distributions
                for lvl in range(len(pyr_np)):
                    fig = plot_distributions(gt_np[lvl][:1], pyr_np[lvl][:1])
                    tb.add_figure(f"posterior/{tag}/step{lvl}", fig, step)
            except ImportError:
                pass        # no matplotlib on this host: no histograms

    def finalize_results(self, results: dict, output_posfix: str = ""):
        """The reference's final results block (CWFA.py:1182-1288,
        ``trainer.py:1004-1097``) over the ``train`` results (else the
        first tag's): the per-level mean PSNR / MAPE table on the console
        and as TB scalars ``{psnr,MAPE}/step_k``; ``corr_coeff_mean/{tag}``,
        ``time/mean``, ``time/min``; under ``save_images`` the GT | pred |
        diff pyramid composites of the first 10 frames as the TB image
        ``Output`` and PNG files; under ``save_tiff_volumes`` (not
        fine-tune) ``stack_MIP_gt.tif`` / ``stack_MIP_prediction.tif``."""
        if not results:
            return
        stage_tag = "train" if "train" in results else next(iter(results))
        res = results.get(stage_tag)
        if not res or not res["psnr"]:
            return
        cfg = self.cfg
        tb = self.log.tb_writer
        n_images = len(res["psnr"])
        n_steps = len(res["psnr"][0])
        print("\n" + 40 * "#" + "  Results  " + 40 * "#")
        print(40 * "#" + 40 * "#")
        print(40 * "-" + "  Per Layer  " + 40 * "-")
        print("metric", end="\t\t")
        for k in range(n_steps):
            print(k + 1, end="\t")
        for metric in ("psnr", "MAPE"):
            print(f"\nMean {metric} ", end="\t")
            for k in range(n_steps):
                v = float(np.mean([res[metric][i][k]
                                   for i in range(n_images)]))
                print(f"{v:.3f}", end="\t")
                if tb is not None:
                    tb.add_scalar(f"{metric}/step_{k}", v, 0)
        cc = res.get("CC")
        print("\n\n\t Mean CC: \t\t{:.4f}".format(cc if cc is not None
                                                  else 0.0))
        print("\t Mean runtime: \t\t{:.4f}".format(
            float(np.mean(res["times"]))))
        print("\t Min runtime: \t\t{:.4f}".format(
            float(np.min(res["times"]))))
        if tb is not None:
            for tag, r in results.items():
                tb.add_scalar(f"corr_coeff_mean/{tag}",
                              float(r["CC"]) if r.get("CC") else 0.0, 0)
            tb.add_scalar("time/mean", float(np.mean(res["times"])), 0)
            tb.add_scalar("time/min", float(np.min(res["times"])), 0)

        def norm01(im):
            return (im - im.min()) / max(float(im.max() - im.min()), 1e-9)

        def to_png(a, name):
            write_png(os.path.join(self.output_path, name),
                      (norm01(a) * 255).astype(np.uint8))
        if cfg.save_images and res["projections_pred_steps"]:
            for i in range(min(10, len(res["projections_pred_steps"]))):
                canvas = np.concatenate([
                    norm01(create_image_pyramid(res[key][i]))
                    for key in ("projections_gt_steps",
                                "projections_pred_steps",
                                "projections_diff_steps")], axis=1)
                if tb is not None:
                    tb.add_image("Output", canvas, i)
                if self.output_path:
                    to_png(res["projections_pred_steps"][i][0],
                           f"_output_image_pred{i}.png")
                    to_png(res["projections_gt_steps"][i][0],
                           f"_output_image_gt{i}.png")
                    to_png(canvas, f"_output_{output_posfix}_image_{i}.png")
        if (cfg.save_tiff_volumes and not cfg.fine_tune and self.output_path
                and res["projections_gt"]):
            for name, key in (("gt", "projections_gt"),
                              ("prediction", "projections_predicted")):
                write_tiff_stack(
                    os.path.join(self.output_path, f"stack_MIP_{name}.tif"),
                    np.stack(res[key]).astype(np.float32))
        if tb is not None:
            tb.flush()

    # ------------------------------------------------------------------ fit
    def fit(self, train_ds: ConcatXLFMDataset, val_ds=None, test_ds=None,
            eval_every: int | None = None, start_epoch: int = 0,
            end_epoch: int | None = None, verbose: bool = False,
            neural_coords: dict | None = None):
        """The coarse-to-fine training loop (run_CWFA's main loop,
        ``trainer.py:1100-1142``): an epoch at a time; every
        ``eval_every`` epochs and at the last, ``evaluate`` on train / val
        / test and, under ``save_model``, the checkpoints; between them
        the checkpoints every ``save_every`` epochs.  neural_coords:
        {'train' | 'val' | 'test': per-fish coordinate lists}.  Returns
        {tag: the last ``evaluate`` results}."""
        cfg = self.cfg
        eval_every = eval_every or cfg.eval_every
        end_epoch = cfg.epochs if end_epoch is None else end_epoch
        nc = neural_coords or {}
        results = {}
        for epoch in range(start_epoch, end_epoch):
            loss = self.train_epoch(train_ds, epoch)
            if verbose:
                print(f"epoch {epoch + 1}/{end_epoch} "
                      f"stage={self.stage_for_epoch(epoch)} loss={loss:.5f}")
            if (epoch + 1) % eval_every == 0 or epoch + 1 == end_epoch:
                for tag, ds in (("train", train_ds), ("val", val_ds),
                                ("test", test_ds)):
                    if ds is not None:
                        results[tag] = self.evaluate(
                            ds, tag, neural_coords=nc.get(tag), epoch=epoch)
                if self.output_path and cfg.save_model:
                    self.save_checkpoints(epoch)
            elif (self.output_path and cfg.save_model and cfg.save_every
                    and (epoch + 1) % int(cfg.save_every) == 0):
                self.save_checkpoints(epoch)
        return results
