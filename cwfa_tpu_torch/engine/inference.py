"""Batched inference pipeline — the production 3D-reconstruction path
(counterpart of ``cwfa_tpu/engine/inference.py:22-139``), deterministic mode.

The whole chain — lenslet view extraction, normalization, LRNN, four inverse
CWF steps through the CUDA flow kernels, un-normalization — runs batched over
frames on one device.  The LRNN's mean-volume branch is computed once, at
construction.  int8 packs, meshes and stochastic sampling are not ported.
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
    ``compute_dtype`` for the networks."""

    def __init__(self, model: CWFAModel, stats: DatasetStatistics,
                 view_indices: dict, mean_caches, *, device,
                 deterministic: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        if not deterministic:
            raise NotImplementedError("only deterministic=True is ported")
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.stats = stats
        self.view_indices = view_indices
        self.model = copy.deepcopy(model).to(
            device=self.device, dtype=compute_dtype).eval()
        self.mean_caches = [
            torch.as_tensor(c).to(device=self.device, dtype=compute_dtype)
            for c in mean_caches]
        nf = self.model.n_flow_steps
        with torch.inference_mode():
            self.mean_branch = lrnn_mean_branch(self.model.lrnn,
                                                self.mean_caches[nf - 1])

    @torch.inference_mode()
    def __call__(self, raw_images) -> torch.Tensor:
        s = self.stats
        raw = torch.as_tensor(raw_images).to(self.device, torch.float32)
        views = extract_views(raw, self.view_indices)
        views_n = ((views - s.mean_imgs) / s.std_imgs).to(self.compute_dtype)
        vol = self.model.reconstruct(views_n, self.mean_caches,
                                     lrnn_mean_branch=self.mean_branch)
        return vol.float() * s.std_vols + s.mean_vols
