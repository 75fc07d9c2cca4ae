"""Full CWFA model: LRNN + chain of CWF flow steps + condition networks
(counterpart of ``cwfa_tpu/models/cwfa_model.py:72-113,230-339``).

Structure for the default config (n_depths=96, 5 pyramid steps):
  flow steps k=0..3 on volumes of 96/2^k depth-channels,
  cond nets k=0..3 mapping the views -> 96/2^{k+1} channels,
  LRNN producing the coarsest 6-depth volume from views + mean-volume prior.

Two paths are ported, both without gradients.  Deterministic inference:
``reconstruct`` at temperature 0, one sample, through the CUDA flow kernels
(the JAX ``fast=True`` path), optionally with the int8 UNet (``unet_q``) and
int8 coupling towers (``qpacks``); any other flag raises.  Exact likelihood:
``forward_pyramid`` / ``nll_from_pyramid`` (every flow step in the
normalizing direction, per-frame NLLs) and ``make_mean_caches``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.models.cond_net import CondNetwork, cond_networks_batched
from cwfa_tpu_torch.models.cwf import (CWFStep, build_step_specs,
                                      quantize_cat_step)
from cwfa_tpu_torch.models.lrnn import LRNN, LRNNSpec
from cwfa_tpu_torch.models.unet import quantize_unet, unet_calibrate
from cwfa_tpu_torch.nn import reset_parameters_


def sample_z_truncated(generator: torch.Generator, shape,
                       temperature: float):
    """z sampling (``sample_z_truncated``, ``cwfa_model.py:32-38``): zeros at
    temperature 0, else a std-1 normal truncated to [-T, T], drawn from
    ``generator`` (on its device) by inverting the normal CDF.  f32."""
    if temperature == 0:
        return torch.zeros(shape, device=generator.device)
    lo = 0.5 * (1.0 + math.erf(-temperature / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    return z.clamp(-temperature, temperature).float()


def check_empty_depths(generator: torch.Generator, vol):
    """Add sigma = 1e-3 noise (drawn from ``generator`` on its device) to the
    all-constant depth slices of ``vol`` (B, D, H, W) and to no other
    (``check_empty_depths``, ``cwfa_model.py:57-62``)."""
    empty = vol.std(dim=(2, 3), keepdim=True, correction=0) == 0
    noise = 0.001 * torch.randn(vol.shape, generator=generator,
                                dtype=vol.dtype, device=generator.device)
    return torch.where(empty, vol + noise.to(vol.device), vol)


class CWFAModel(nn.Module):
    def __init__(self, cfg: CWFAConfig):
        super().__init__()
        for flag in ("force_last_step_NF", "force_all_steps_NF"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"{flag} is not ported")
        self.cfg = cfg
        n_flow = cfg.INN_max_down_steps - 1
        self.step_specs = tuple(build_step_specs(
            n_depths=cfg.n_depths, spatial=cfg.volume_side_size,
            n_flow_steps=n_flow, n_blocks=cfg.INN_n_blocks,
            block_type=cfg.INN_block_type, internal_ch=cfg.INN_internal_chans,
            use_bias=bool(cfg.INN_use_bias),
            use_final_perm=cfg.INN_use_perm == 1,
            disable_low_res_input=bool(cfg.disable_low_res_input),
            global_seed=cfg.seed))
        self.lrnn_spec = LRNNSpec(
            ch_in=cfg.n_lenslets,
            n_depths=cfg.n_depths // (2 ** (cfg.INN_max_down_steps - 1)),
            spatial=cfg.volume_side_size, use_bias=bool(cfg.INN_use_bias))
        self.flow = nn.ModuleList(CWFStep(s) for s in self.step_specs)
        self.cond = nn.ModuleList(
            CondNetwork(cfg.n_lenslets, cfg.n_depths // (2 ** (k + 1)),
                        chans_3d=cfg.INN_cond_chans)
            for k in range(n_flow))
        self.lrnn = LRNN(self.lrnn_spec)

    @classmethod
    def build(cls, cfg: CWFAConfig,
              generator: torch.Generator) -> "CWFAModel":
        """Construct and initialize on the CPU, every random draw from
        ``generator``."""
        model = cls(cfg)
        reset_parameters_(model, generator)
        return model

    @property
    def n_flow_steps(self) -> int:
        return len(self.step_specs)

    @torch.inference_mode()
    def quantize_unet_pack(self, cond_input, master=None):
        """int8 pack of the LRNN UNet (``cwfa_model.py:214-228``), calibrated
        on every frame of ``cond_input`` (normalized views) in this model's
        dtype: the 1x1 proj, then ``unet_calibrate``.  The weights are
        quantized from ``master`` (default: this model), the f32 model when
        this one computes in bf16.  Returns {"qpack", "scales"} for
        ``reconstruct(unet_q=...)``."""
        master = self if master is None else master
        scales = unet_calibrate(self.lrnn.unet, self.lrnn.proj(cond_input))
        return {"qpack": quantize_unet(master.lrnn.unet, scales),
                "scales": scales}

    @torch.inference_mode()
    def quantize_steps(self, cond_input, master=None,
                       max_calib_frames: int = 2):
        """int8 packs of every step's coupling towers (``cwfa_model.py:
        352-375``): this model's cond nets on at most ``max_calib_frames``
        frames of ``cond_input``, then ``quantize_cat_step`` on ``master``'s
        (default: this model's) f32 towers.  Returns a list indexed by step
        (None where a step has fewer than two blocks)."""
        master = self if master is None else master
        c_views_all = cond_networks_batched(
            self.cond, cond_input[:max_calib_frames])
        return [quantize_cat_step(master.flow[k], c_views_all[k])
                if spec.n_blocks >= 2 else None
                for k, spec in enumerate(self.step_specs)]

    def _step_nll(self, k: int, v, c_mean=None):
        """Flow step k forward on ``v`` with zero views condition (and zero
        mean condition unless given).  Returns (avg, per-sample prior (B,),
        logdet (B,), numel of avg)."""
        spec = self.step_specs[k]
        zeros = torch.zeros((v.shape[0], spec.c_flow) + tuple(v.shape[2:]),
                            dtype=v.dtype, device=v.device)
        z, avg, logdet = self.flow[k](v, zeros,
                                      zeros if c_mean is None else c_mean)
        prior_b = 0.5 * (z.float() ** 2).sum(dim=(1, 2, 3))
        return avg, prior_b, logdet, float(avg.numel())

    @torch.inference_mode()
    def forward_pyramid(self, gt_volume, mean_caches=None,
                        per_sample: bool = False):
        """Every flow step in the normalizing direction with ZERO views
        conditions (``forward_pyramid``, ``cwfa_model.py:116-162``);
        ``mean_caches[k]``, where given, is step k's mean condition.

        gt_volume: (B, n_depths, H, W).  Returns (nlls, gt_cache, priors,
        log_jacobians), one entry per flow step; gt_cache[k] is the pyramid
        volume at level k (gt_cache[0] the input, one entry more).

        per_sample=True gives (B,)-shaped per-frame values, (0.5*||z_i||^2 -
        logdet_i) / (numel(avg) / B); False the reference's batch scalars
        (CWFA.py:189-192)."""
        b = gt_volume.shape[0]
        gt_cache = [gt_volume]
        nlls, priors, logjacs = [], [], []
        v = gt_volume
        for k in range(self.n_flow_steps):
            v, prior_b, logdet, numel = self._step_nll(
                k, v, None if mean_caches is None else mean_caches[k])
            if per_sample:
                nlls.append((prior_b - logdet) / (numel / b))
                priors.append(prior_b / (numel / b))
                logjacs.append(logdet / (numel / b))
            else:
                prior = prior_b.sum()
                nlls.append(((prior - logdet) / numel).mean())
                priors.append(prior / numel)
                logjacs.append(logdet.mean() / numel)
            gt_cache.append(v)
        return nlls, gt_cache, priors, logjacs

    @torch.inference_mode()
    def nll_from_pyramid(self, gt_cache):
        """Per-sample NLLs from an existing wavelet pyramid
        (``nll_from_pyramid``, ``cwfa_model.py:164-187``): the levels are
        parameter-independent Haar averages, so ``gt_cache[k]`` is what
        ``forward_pyramid`` feeds step k.  Returns a list of (B,) tensors."""
        b = gt_cache[0].shape[0]
        nlls = []
        for k in range(self.n_flow_steps):
            _, prior_b, logdet, numel = self._step_nll(k, gt_cache[k])
            nlls.append((prior_b - logdet) / (numel / b))
        return nlls

    @torch.inference_mode()
    def make_mean_caches(self, mean_volume, generator=None):
        """Mean-volume conditioning pyramid (``make_mean_caches``,
        ``cwfa_model.py:342-350``): the forward pyramid of the (normalized)
        mean volume, each level as depth-pair differences ``g[:, ::2] -
        g[:, 1::2]``; with a ``generator``, sigma = 1e-3 noise is added
        first."""
        v = mean_volume
        if generator is not None:
            v = v + 0.001 * torch.randn(
                v.shape, generator=generator, dtype=v.dtype,
                device=generator.device).to(v.device)
        _, gt_cache, _, _ = self.forward_pyramid(v)
        return [g[:, ::2] - g[:, 1::2] for g in gt_cache]

    @torch.inference_mode()
    def reconstruct(self, cond_input, mean_caches, *,
                    z_temperature: float = 0.0, n_samples: int = 1,
                    fast: bool = True, lrnn_mean_branch=None, unet_q=None,
                    qpacks=None):
        """Full generative chain (CWFA.py:865-927): LRNN at the coarsest
        level, then invert flow steps k = n-1..0, doubling depth each time.

        cond_input: normalized views (B, n_lenslets, H, W).
        mean_caches: per-level mean-volume difference caches, (1 or B, C_k,
          H, W); entry k is the flow condition at step k and entry
          [n_flow-1] feeds the LRNN (reference CWFA.py:882).
        lrnn_mean_branch: optional precomputed LRNN mean-branch output.
        unet_q: optional int8 UNet pack (``quantize_unet_pack``).
        qpacks: optional per-step int8 tower packs (``quantize_steps``).
        """
        if z_temperature != 0 or n_samples != 1 or not fast:
            raise NotImplementedError(
                "only z_temperature=0, n_samples=1, fast=True are ported")
        nf = self.n_flow_steps
        b = cond_input.shape[0]
        up = self.lrnn(cond_input, mean_vol=mean_caches[nf - 1],
                       mean_branch=lrnn_mean_branch, unet_q=unet_q)
        c_views_all = cond_networks_batched(self.cond, cond_input)
        for k in range(nf - 1, -1, -1):
            spec = self.step_specs[k]
            z = torch.zeros((b, spec.c_flow, spec.spatial, spec.spatial),
                            dtype=up.dtype, device=up.device)
            up = self.flow[k].reverse_fast(
                z, up, c_views_all[k], mean_caches[k],
                qpack=None if qpacks is None else qpacks[k])
        return up
