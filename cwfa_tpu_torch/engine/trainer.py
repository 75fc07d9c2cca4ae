"""CWFA training engine, coarse to fine (counterpart of
``cwfa_tpu/engine/trainer.py``: ``__init__``, the LRNN and flow optimizer
steps ``:115-347``, the caches and the stage scheduler ``:386-685``,
``save_checkpoints`` ``:1144-1168``).

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
  down to the level (``_stage_input``).
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

Not here yet: ``evaluate``, ``fit``, ``finalize_results``, metrics,
TensorBoard, the OOD finetune.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cwfa_tpu_torch.data.dataset import ConcatXLFMDataset
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.data.views import extract_views
from cwfa_tpu_torch.engine import checkpoints
from cwfa_tpu_torch.engine import losses as L
from cwfa_tpu_torch.engine.ood import PyramidScorer
from cwfa_tpu_torch.engine.optim import make_optimizers
from cwfa_tpu_torch.models.cwfa_model import CWFAModel


class TrainLog:
    """Scalars by tag: [(epoch, value)]."""

    def __init__(self):
        self.scalars: dict = {}

    def add(self, tag: str, value, step: int):
        self.scalars.setdefault(tag, []).append((step, float(value)))

    def last(self, tag: str):
        return self.scalars[tag][-1][1] if self.scalars.get(tag) else None


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
    """Stage-scheduled trainer of a ``CWFAModel`` on one device.

    The model is moved to ``device`` in f32 (its master weights) and kept in
    eval mode; an optimizer step puts its stage's modules into training mode
    (BatchNorm running statistics, Dropout3d) for the step only."""

    def __init__(self, model: CWFAModel, stats: DatasetStatistics,
                 view_indices: dict, output_path: str | None = None,
                 seed: int | None = None, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(device=self.device, dtype=torch.float32).eval()
        self.cfg = model.cfg
        self.stats = stats
        self.view_indices = view_indices
        self.output_path = output_path
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.cfg.seed if seed is None else seed)
        self.compute_dtype = (torch.bfloat16 if self.cfg.use_half_precision
                              else torch.float32)
        self.opt_flow, self.opt_cond, self.opt_lrnn = make_optimizers(
            self.model)
        self.log = TrainLog()
        self.views_cache = _BoundedCache(2 << 30)
        self.gt_cache = _BoundedCache(4 << 30)
        self.upsampled_cache = _BoundedCache(4 << 30)
        self.mean_caches: dict = {}      # dataset index -> levels
        self.transfer_log = {"frame_uploads": 0, "volume_uploads": 0,
                             "h2d_bytes": 0}

    # ------------------------------------------------------------ caches
    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.compute_dtype == torch.bfloat16)

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

    def _gt_pyramid(self, dataset: ConcatXLFMDataset, tag: str, ix: int):
        """The frame's GT pyramid [(1, D/2^l, S, S) f32 for every level l],
        built once: normalize, empty-depth guard, 1e-3 noise, the forward
        pyramid (``pyramid_fn``, ``trainer.py:233-255``)."""
        key = (tag, dataset.cache_tag, ix)
        cached = self.gt_cache.get(key)
        if cached is not None:
            return cached
        di, li = dataset.locate(ix)
        vol = np.asarray(dataset.datasets[di].vols[li][None])
        self.transfer_log["volume_uploads"] += 1
        self.transfer_log["h2d_bytes"] += vol.nbytes
        scorer = PyramidScorer(self.model, self.stats, device=self.device,
                               generator=self.generator)
        _, pyramid, _, _ = scorer(torch.as_tensor(vol).to(self.device))
        levels = [_detached(lvl) for lvl in pyramid]
        self.gt_cache.put(key, levels)
        return levels

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
                      tag: str):
        """(normalized views (B, n, S, S), GT pyramid levels, the fish's
        mean caches broadcast to the batch)."""
        views = torch.cat([self._views_for(dataset, tag, ix) for ix in ixs])
        pyrs = [self._gt_pyramid(dataset, tag, ix) for ix in ixs]
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

    def _stage_input(self, dataset, ix, views_n, mean_caches, stage):
        """The coarser stage's output for frame ix: the captured one, or the
        chain reconstructed down to level stage + 1 (CWFA.py:848-851)."""
        cached = self.upsampled_cache.get((dataset.cache_tag, ix))
        want = self.cfg.n_depths // (2 ** (stage + 1))
        if cached is not None and cached.shape[1] == want:
            return cached
        _, pyramid = self.model.reconstruct(
            views_n, mean_caches, z_temperature=self.cfg.INN_z_temperature,
            generator=self.generator, lrnn_train=True, return_pyramid=True)
        return _detached(pyramid[stage + 1])

    def _capture_upsampled(self, dataset, ix, out):
        self.upsampled_cache.put((dataset.cache_tag, ix), _detached(out))

    # ------------------------------------------------------------ losses
    def lrnn_loss(self, views_n, mean_c, gt_coarse, generator):
        """The LRNN stage's loss (``trainer.py:268-282``): the views with
        N(0, 0.5^2) noise where ``add_noise`` (and a generator), the LRNN in
        train mode, ``recon_loss(loss_func_first_step)`` against the
        coarsest GT level in f32.  Returns (loss, the LRNN's output f32)."""
        dt = self.compute_dtype
        vin = views_n
        if self.cfg.add_noise == 1 and generator is not None:
            vin = vin + 0.5 * torch.randn(
                vin.shape, generator=generator,
                device=generator.device).to(vin.device)
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
        level under the same conditions; the step's towers run once, for
        both directions.  Returns (full loss, recon loss, NLL,
        reconstruction f32)."""
        cfg, dt = self.cfg, self.compute_dtype
        spec = self.model.step_specs[k]
        b = gt_k.shape[0]
        shape = (b, spec.c_flow, spec.spatial, spec.spatial)
        if cfg.force_all_steps_NF:
            # a zero views condition (CWFA.py:892-894); the cond net is
            # unused and receives no update
            c_views = torch.zeros(shape, dtype=dt, device=gt_k.device)
        else:
            with self._autocast():
                c_views = self.model.cond[k](views_n.to(dt),
                                             generator=generator)
        z = torch.zeros(shape, dtype=dt, device=gt_k.device)
        mean_c = mean_c_k.to(dt)
        # the five towers read c_views alone: run once, read by both
        # directions
        towers = self.model.flow[k].towers(c_views)
        recon, _ = self.model.flow[k].reverse(z, upsampled_in.to(dt),
                                              c_views, mean_c, towers)
        recon = recon.float()
        loss_c = L.recon_loss(cfg.loss_func_reg, gt_k, recon)
        nll, _ = self.model.step_nll(k, gt_k.to(dt), c_views, mean_c, towers)
        full = (loss_c * cfg.INN_cond_weight
                + nll * (1.0 - cfg.INN_cond_weight))
        return full, loss_c, nll, recon

    # ------------------------------------------------------- optimizer steps
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
        self.opt_lrnn.step()
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
        # as JAX, the cond group steps even under force_all_steps_NF, on
        # zero gradients (the parameters stay, the count moves)
        self.opt_flow[k].step()
        self.opt_cond[k].step()
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
        for di, ixs in self._batches(dataset):
            views_n, gt, mcs = self._batch_inputs(dataset, di, ixs, tag)
            if stage == nf:
                loss, out = self._lrnn_step(views_n, mcs[nf - 1], gt[nf])
            else:
                k = stage
                # train_with_gt_low_res (CWFA.py:866-869): the GT level as
                # the stage input, for every step (1) or only the
                # coarsest-but-one (2)
                if cfg.train_with_gt_low_res == 1 or (
                        cfg.train_with_gt_low_res == 2
                        and k == cfg.INN_max_down_steps - 2):
                    upsampled = gt[k + 1]
                else:
                    upsampled = torch.cat([
                        self._stage_input(dataset, ix, views_n[j:j + 1],
                                          self.mean_caches[di], k)
                        for j, ix in enumerate(ixs)])
                loss, _, nll, out = self._flow_step(
                    k, views_n, mcs[k], gt[k], upsampled)
                self.log.add(f"loss_LL/step_{k}", nll, epoch)
            if capture:
                for j, ix in enumerate(ixs):
                    self._capture_upsampled(dataset, ix, out[j:j + 1])
            value = float(loss)
            losses.append((value, len(ixs)))
            if not math.isfinite(value):
                raise ValueError(f"Nan/Inf loss found in {tag} at epoch "
                                 f"{epoch}, batch {ixs} (CWFA.py:989-994)")
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

    def load_checkpoints(self, path: str, max_epoch: int | None = None):
        """Parameters, BatchNorm statistics and Lion state of the
        highest-epoch file of each step in ``path`` (the port's or the JAX
        trainer's), and the mean caches beside them.  Returns the steps
        loaded."""
        stats, loaded = checkpoints.load_model_checkpoints(
            self.model, path, max_epoch=max_epoch,
            optimizers=self._optimizers())
        if self.stats is None:
            self.stats = stats
        for di, levels in checkpoints.load_mean_caches(path).items():
            self.mean_caches[di] = [torch.as_tensor(np.asarray(c)).to(
                self.device, torch.float32) for c in levels]
        return loaded
