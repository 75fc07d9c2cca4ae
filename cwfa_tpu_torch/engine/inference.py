"""Batched inference pipeline — the production 3D-reconstruction path
(counterpart of ``cwfa_tpu/engine/inference.py:22-139``).

The whole chain — lenslet view extraction, normalization, LRNN, four inverse
CWF steps through the CUDA flow kernels, un-normalization — runs batched over
frames on one device.  The default mode is the reference's: the LRNN in
train mode (BatchNorm on batch statistics, dropout), z sampled at
``cfg.INN_z_temperature``, the mean over ``cfg.INN_n_samples``, every draw
from one generator seeded with ``cfg.seed``.  ``deterministic=True`` runs
the LRNN in eval mode and draws nothing; its mean-volume branch is then
computed once, at construction.  Two int8 options, as in JAX: ``use_int8``
(the LRNN UNet; deterministic only) and ``use_int8_towers`` (the coupling
towers, through the CUDA int8 tower kernel), both calibrated on
``calib_frames``.  ``use_int8_cond`` and meshes are not ported.
"""

from __future__ import annotations

import copy

import torch

from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.data.views import extract_views
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.models.lrnn import lrnn_mean_branch


class XLFMReconstructor:
    """Callable: raw camera frames (B, H, W) -> volumes (B, D, S, S), f32.

    The model is copied to ``device`` in ``compute_dtype`` (the caller's
    model is left as it is); frames are normalized in f32 and cast to
    ``compute_dtype`` for the networks.

    int8 packs (``unet_q``, ``qpacks``) are calibrated at construction on
    ``calib_frames`` (raw frames): the calibration forwards run in
    ``compute_dtype`` (the tower trace in f32), and the weights are
    quantized from the caller's f32 weights, not from the cast copy."""

    def __init__(self, model: CWFAModel, stats: DatasetStatistics,
                 view_indices: dict, mean_caches, *, device,
                 deterministic: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 use_int8: bool = False, use_int8_towers: bool = False,
                 calib_frames=None):
        if (use_int8 or use_int8_towers) and calib_frames is None:
            raise ValueError("int8 paths require calib_frames "
                             "(a batch of raw camera frames)")
        if use_int8 and not deterministic:
            raise ValueError("use_int8 requires deterministic=True "
                             "(the int8 UNet folds eval-mode BN stats)")
        self.device = torch.device(device)
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
        self.unet_q = self.qpacks = self.mean_branch = None
        # every random draw of the stochastic mode, on the model's device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.model.cfg.seed)
        with torch.inference_mode():
            if deterministic and not self.model.cfg.force_last_step_NF:
                # a pure function of the per-dataset mean cache in eval
                # mode; in train mode the LRNN computes it per call
                self.mean_branch = lrnn_mean_branch(self.model.lrnn,
                                                    self.mean_caches[nf - 1])
            if use_int8 or use_int8_towers:
                master = (self.model if compute_dtype == torch.float32 else
                          copy.deepcopy(model).to(
                              device=self.device, dtype=torch.float32).eval())
                calib = self._normalized_views(calib_frames)
                if use_int8:
                    self.unet_q = self.model.quantize_unet_pack(
                        calib, master=master)
                if use_int8_towers:
                    self.qpacks = self.model.quantize_steps(
                        calib, master=master)

    def _normalized_views(self, raw_images):
        s = self.stats
        raw = torch.as_tensor(raw_images).to(self.device, torch.float32)
        views = extract_views(raw, self.view_indices)
        return ((views - s.mean_imgs) / s.std_imgs).to(self.compute_dtype)

    @torch.inference_mode()
    def __call__(self, raw_images) -> torch.Tensor:
        s, cfg = self.stats, self.model.cfg
        vol = self.model.reconstruct(
            self._normalized_views(raw_images), self.mean_caches,
            z_temperature=cfg.INN_z_temperature,
            generator=None if self.deterministic else self.generator,
            lrnn_train=not self.deterministic, n_samples=cfg.INN_n_samples,
            lrnn_mean_branch=self.mean_branch, unet_q=self.unet_q,
            qpacks=self.qpacks)
        return vol.float() * s.std_vols + s.mean_vols
