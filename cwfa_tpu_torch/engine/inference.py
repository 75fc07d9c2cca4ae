"""Batched inference pipeline — the production 3D-reconstruction path
(counterpart of ``cwfa_tpu/engine/inference.py:22-139``).

The whole chain — lenslet view extraction, normalization, LRNN, four inverse
CWF steps through the CUDA flow kernels, un-normalization — runs batched over
frames on one device.  The default mode is the reference's: the LRNN in
train mode (BatchNorm on batch statistics, dropout), z sampled at
``cfg.INN_z_temperature``, the mean over ``cfg.INN_n_samples``, every draw
from one generator seeded with ``cfg.seed``.  ``deterministic=True`` runs
the LRNN in eval mode and draws nothing; its mean-volume branch is then
computed once, at construction.  Three int8 options, as in JAX:
``use_int8`` (the LRNN UNet; deterministic only), ``use_int8_towers`` (the
coupling towers, through the CUDA int8 tower kernel) and ``use_int8_cond``
(the cond nets' 3-D pairs with an int8 intermediate, on cuBLAS; calibrated
on the first two calibration frames, and skipped with a warning under
``force_all_steps_NF``, where the cond nets never run), all calibrated on
``calib_frames``.  ``warmup``, ``throughput`` and ``latency_ms`` time the
reconstructor on CUDA events.

With a ``mesh`` (``parallel.make_mesh(n_data, n_space)``; one process per
device) ``__call__`` returns the whole batch on every rank
(``sharded_reconstruct`` in JAX): each rank reconstructs its rows of the
batch on ``data`` (``split_batch``; off, every rank of a data index serves
its own frames, as the serve CLI does) and its image rows on ``space``
(``parallel/halo.py``), and the rows and the batch are gathered.  In the
default mode every rank draws the whole batch's and image's noise and masks
from the shared seeded generator and keeps its part, and the LRNN's
train-mode BatchNorm takes the global batch's and image's statistics, so N
ranks compute what one does.  A batch that does not divide the ``data``
axis, or rows that do not split into ``n_space`` shards of a multiple of
the UNet's 2^(depth - 1) rows, are computed whole on every rank.  The int8
packs are calibrated on every rank on the same frames and checked equal.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.data.views import extract_views
from cwfa_tpu_torch.models.cond_net import quantize_cond_networks
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.models.lrnn import lrnn_mean_branch
from cwfa_tpu_torch.parallel.distributed import check_same_on_ranks, \
    gather_rows
from cwfa_tpu_torch.parallel.halo import gather_image_rows
from cwfa_tpu_torch.parallel.mesh import (batch_shard, data_shard, row_shard,
                                          space_rows)


def device_timer(device: torch.device):
    """Starts a timer; returns stop() -> seconds since: CUDA events on a
    card (the device's time from the first launch after the start to the
    last one's end), the host clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()

        def stop():
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return stop
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


class XLFMReconstructor:
    """Callable: raw camera frames (B, H, W) -> volumes (B, D, S, S), f32.

    The model is copied to ``device`` in ``compute_dtype`` (the caller's
    model is left as it is); frames are normalized in f32 and cast to
    ``compute_dtype`` for the networks.

    int8 packs (``unet_q``, ``qpacks``, ``cond_q``) are calibrated at
    construction on ``calib_frames`` (raw frames): the calibration forwards
    run in ``compute_dtype`` (the tower trace and the cond pairs' in f32),
    and the weights are quantized from the caller's f32 weights, not from
    the cast copy."""

    def __init__(self, model: CWFAModel, stats: DatasetStatistics,
                 view_indices: dict, mean_caches, *, device,
                 deterministic: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 use_int8: bool = False, use_int8_towers: bool = False,
                 use_int8_cond: bool = False, calib_frames=None, mesh=None,
                 split_batch: bool = True):
        if (use_int8 or use_int8_towers or use_int8_cond) \
                and calib_frames is None:
            raise ValueError("int8 paths require calib_frames "
                             "(a batch of raw camera frames)")
        if use_int8 and not deterministic:
            raise ValueError("use_int8 requires deterministic=True "
                             "(the int8 UNet folds eval-mode BN stats)")
        self.device = torch.device(device)
        self.mesh = mesh
        self.split_batch = split_batch
        self.deterministic = deterministic
        self.compute_dtype = compute_dtype
        self.stats = stats
        self.view_indices = view_indices
        self.model = copy.deepcopy(model).to(
            device=self.device, dtype=compute_dtype).eval()
        self.mean_caches = [
            torch.as_tensor(c).to(device=self.device, dtype=compute_dtype)
            for c in mean_caches]
        nf = self.model.n_flow_steps
        self.unet_q = self.qpacks = self.cond_q = self.mean_branch = None
        # a rank's rows on ``space`` divide by the UNet's pooling factor
        self.row_multiple = 2 ** (self.model.lrnn.spec.unet.depth - 1)
        # every random draw of the stochastic mode, on the model's device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.model.cfg.seed)
        with torch.inference_mode():
            if deterministic and not self.model.cfg.force_last_step_NF:
                # a pure function of the per-dataset mean cache in eval
                # mode; in train mode the LRNN computes it per call
                self.mean_branch = lrnn_mean_branch(self.model.lrnn,
                                                    self.mean_caches[nf - 1])
            if use_int8_cond and self.model.cfg.force_all_steps_NF:
                print("warning: use_int8_cond has no effect with "
                      "force_all_steps_NF=1 (cond nets are bypassed); "
                      "skipping calibration", flush=True)
                use_int8_cond = False
            if use_int8 or use_int8_towers or use_int8_cond:
                master = (self.model if compute_dtype == torch.float32 else
                          copy.deepcopy(model).to(
                              device=self.device, dtype=torch.float32).eval())
                calib = self._normalized_views(calib_frames)
                if use_int8:
                    self.unet_q = self.model.quantize_unet_pack(
                        calib, master=master)
                if use_int8_cond:
                    self.cond_q = quantize_cond_networks(master.cond,
                                                         calib[:2])
                if use_int8_towers:
                    self.qpacks = self.model.quantize_steps(
                        calib, master=master)
                if mesh is not None:
                    # every rank of the mesh, both axes
                    check_same_on_ranks((self.unet_q, self.qpacks,
                                         self.cond_q), None, "the int8 packs")

    def _normalized_views(self, raw_images):
        s = self.stats
        raw = torch.as_tensor(raw_images).to(self.device, torch.float32)
        views = extract_views(raw, self.view_indices)
        return ((views - s.mean_imgs) / s.std_imgs).to(self.compute_dtype)

    def shards(self, n: int):
        """(batch shard, row shard) of an n-frame call on the mesh, either
        None where every rank computes all of it."""
        if self.mesh is None:
            return None, None
        shard = batch_shard(self.mesh, n) if self.split_batch else None
        rows = space_rows(self.mesh, self.model.cfg.volume_side_size,
                          self.row_multiple, batch_split=shard is not None)
        return shard, rows

    @torch.inference_mode()
    def __call__(self, raw_images) -> torch.Tensor:
        shard, rows = self.shards(len(raw_images))
        if shard is None and rows is None:
            return self.reconstruct_local(raw_images)
        if shard is not None:
            raw_images = raw_images[shard.start:shard.stop]
        with data_shard(shard), row_shard(rows):
            vol = self.reconstruct_local(raw_images)
        if rows is not None:
            vol = gather_image_rows(vol, rows)
        return vol if shard is None else gather_rows(vol, shard.group)

    @torch.inference_mode()
    def reconstruct_local(self, raw_images) -> torch.Tensor:
        """The reconstruction of ``raw_images`` on this device alone (inside
        ``parallel.mesh.data_shard``: this rank's rows of a global batch;
        inside ``row_shard``: this rank's image rows of it, from the whole
        frames)."""
        s, cfg = self.stats, self.model.cfg
        vol = self.model.reconstruct(
            self._normalized_views(raw_images), self.mean_caches,
            z_temperature=cfg.INN_z_temperature,
            generator=None if self.deterministic else self.generator,
            lrnn_train=not self.deterministic, n_samples=cfg.INN_n_samples,
            lrnn_mean_branch=self.mean_branch, unet_q=self.unet_q,
            qpacks=self.qpacks, cond_q=self.cond_q)
        return vol.float() * s.std_vols + s.mean_vols

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batch_size: int, img_hw):
        """One call on a zero batch, waited for (in the default mode it
        draws from the generator like any other call)."""
        self(torch.zeros((batch_size,) + tuple(img_hw), device=self.device))
        self._sync()

    def throughput(self, raw_images, n_repeats: int = 10) -> float:
        """Frames per second over ``n_repeats`` calls enqueued back to back
        on ``raw_images`` (moved to the device first), after one call that
        is waited for (``inference.py:149-172``)."""
        frames = torch.as_tensor(raw_images).to(self.device, torch.float32)
        self(frames)
        self._sync()
        stop = device_timer(self.device)
        for _ in range(n_repeats):
            self(frames)
        return frames.shape[0] * n_repeats / stop()

    def latency_ms(self, raw_image, n: int = 20):
        """(p50, min) in ms of ``n`` batch-1 calls, each timed on its own
        and waited for, after one warm call (``inference.py:174-191``)."""
        frames = torch.as_tensor(raw_image).to(self.device, torch.float32)
        if frames.shape[0] != 1:
            raise ValueError(f"latency_ms takes one frame, got "
                             f"{tuple(frames.shape)}")
        self(frames)
        self._sync()
        times = []
        for _ in range(n):
            stop = device_timer(self.device)
            self(frames)
            times.append(stop() * 1e3)
        return float(np.percentile(times, 50)), float(np.min(times))

