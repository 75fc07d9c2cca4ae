"""Full CWFA model: LRNN + chain of CWF flow steps + condition networks
(counterpart of ``cwfa_tpu/models/cwfa_model.py:72-113,230-339``).

Structure for the default config (n_depths=96, 5 pyramid steps):
  flow steps k=0..3 on volumes of 96/2^k depth-channels,
  cond nets k=0..3 mapping the views -> 96/2^{k+1} channels,
  LRNN producing the coarsest 6-depth volume from views + mean-volume prior.

Three paths are ported.  Reconstruction, without gradients:
``reconstruct``, deterministic (temperature 0, the LRNN in eval mode,
optionally with the int8 UNet ``unet_q`` and int8 coupling towers
``qpacks``) or stochastic (z sampled at a temperature, the mean over
``n_samples``, the LRNN in train mode), every draw from one
``torch.Generator``; each step through ``CWFStep.reverse_fast`` (the JAX
``fast=True`` path: the input affine fused with the inverse Haar) or, with
``fast=False``, ``CWFStep.reverse`` (the exact inverse of the forward, its
log-det dropped; what evaluation runs).
Both force flags of the configuration are honoured: ``force_last_step_NF``
builds one more flow step and starts the chain from zeros at the coarsest
level (no LRNN call, no mean branch); ``force_all_steps_NF`` gives every
step a zero views condition and runs no cond net.  Exact likelihood, without
gradients: ``forward_pyramid`` / ``nll_from_pyramid`` (every flow step in
the normalizing direction, per-frame NLLs) and ``make_mean_caches``.
Training (``engine/trainer.py``), with gradients: ``step_nll`` and the
modules themselves (``CWFStep.reverse``, ``CondNetwork``, ``LRNN``).
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


def sample_z_rev_like(generator, x, temperature: float = 0.0,
                      same_size: bool = False):
    """Reverse-direction z sampling helper (``sample_z_rev_like``,
    ``cwfa_model.py:41-54``; reference CWFA.py:66-82): zeros at temperature
    0, else a std-1 normal scaled by the temperature, drawn from
    ``generator`` on its device.  The shape is ``x`` itself when it is a
    tuple or list, x's shape with ``same_size``, else the (B, 3*W, H, W)
    layout variant.  f32."""
    if isinstance(x, (tuple, list)):
        shape = tuple(x)
    elif same_size:
        shape = tuple(x.shape)
    else:
        shape = (x.shape[0], 3 * x.shape[-1], x.shape[2], x.shape[3])
    if temperature == 0:
        device = generator.device if generator is not None else None
        return torch.zeros(shape, device=device)
    return torch.randn(shape, generator=generator,
                       device=generator.device) * temperature


def check_empty_depths(generator: torch.Generator, vol):
    """Add sigma = 1e-3 noise (drawn from ``generator`` on its device) to the
    all-constant depth slices of ``vol`` (B, D, H, W) and to no other
    (``check_empty_depths``, ``cwfa_model.py:57-62``); without a generator
    nothing is drawn and ``vol`` is returned as it is."""
    if generator is None:
        return vol
    empty = vol.std(dim=(2, 3), keepdim=True, correction=0) == 0
    noise = 0.001 * torch.randn(vol.shape, generator=generator,
                                dtype=vol.dtype, device=generator.device)
    return torch.where(empty, vol + noise.to(vol.device), vol)


class CWFAModel(nn.Module):
    def __init__(self, cfg: CWFAConfig):
        super().__init__()
        self.cfg = cfg
        # force_last_step_NF (CWFA.py:489-510,781,880): the coarsest level
        # comes from one more flow step instead of the LRNN, which is still
        # built (the reference keeps it as cond_nets[-1])
        n_flow = cfg.INN_max_down_steps - 1 + (1 if cfg.force_last_step_NF
                                               else 0)
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

    def set_step_spec(self, k: int, spec):
        """Flow step k takes ``spec`` (its permutations replaced by a
        checkpoint's, ``engine/torch_convert.apply_perm_overrides``)."""
        self.flow[k].set_spec(spec)
        specs = list(self.step_specs)
        specs[k] = spec
        self.step_specs = tuple(specs)

    def param_counts(self) -> dict:
        """Parameters of the flow steps, the cond nets and the LRNN, printed
        at start-up by the training CLI (``cwfa_model.py:377``).  AI1's
        fixed permutation matrices count, as in the reference (a parameter
        there, without gradient) and in JAX (a params leaf)."""
        def cnt(m):
            fixed = sum(getattr(sub, name).numel() for sub in m.modules()
                        for name in getattr(sub, "JAX_PARAM_BUFFERS", ()))
            return sum(p.numel() for p in m.parameters()) + fixed
        return {"WF": cnt(self.flow), "Omega": cnt(self.cond),
                "LRNN": cnt(self.lrnn)}

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
        (None where a step is not CAT or has fewer than two blocks)."""
        master = self if master is None else master
        if self.cfg.force_all_steps_NF:
            # the towers' condition is zero and the cond nets never run
            return [None] * self.n_flow_steps
        c_views_all = cond_networks_batched(
            self.cond, cond_input[:max_calib_frames])
        return [quantize_cat_step(master.flow[k], c_views_all[k])
                if spec.block_type == "CAT" and spec.n_blocks >= 2 else None
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

    def step_nll(self, k: int, gt_level, c_views, c_mean, towers=None):
        """Conditioned NLL of flow step k for training (``step_nll``,
        ``cwfa_model.py:189-202``): the GT level encoded with the real
        conditions, (0.5 ||z||^2 - sum of the per-sample log-dets) / numel of
        the level, f32; the log-dets are summed over the batch like the
        prior.  towers: None or the step's ``CWFStep.towers(c_views)``.
        Returns (nll, (z, avg))."""
        z, avg, logdet = self.flow[k](gt_level, c_views, c_mean, towers)
        prior = 0.5 * (z.float() ** 2).sum()
        return (prior - logdet.sum()) / float(gt_level.numel()), (z, avg)

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
                    z_temperature: float = 0.0, generator=None,
                    lrnn_train: bool | None = None, n_samples: int = 1,
                    fast: bool = True, lrnn_mean_branch=None, unet_q=None,
                    qpacks=None, return_pyramid: bool = False):
        """Full generative chain (CWFA.py:865-927): LRNN at the coarsest
        level, then invert flow steps k = n-1..0, doubling depth each time.

        cond_input: normalized views (B, n_lenslets, H, W).
        mean_caches: per-level mean-volume difference caches, (1 or B, C_k,
          H, W); entry k is the flow condition at step k and entry
          [n_flow-1] feeds the LRNN (reference CWFA.py:882).
        z_temperature: 0 gives z = 0; above 0 every step's z is one draw of
          ``sample_z_truncated`` from ``generator``.
        generator: the ``torch.Generator`` of every random draw, in the
          order of ``cwfa_model.py:246-317``: the LRNN's (its UNet's
          dropouts, then the two ``drop_path`` of its mean branch), then one
          z per step, coarsest first.  None: nothing is drawn.
        lrnn_train: the LRNN in train mode (BatchNorm on batch statistics,
          dropout where there is a generator); the reference keeps it so at
          evaluation (CWFA.py:531-532).  Default: whether there is a
          generator.  The cond nets and the flow stay in eval mode.
        n_samples: above 1 every step reverses n_samples z for each frame
          and hands the mean over them down (``cwfa_model.py:320-330``).
        lrnn_mean_branch: optional precomputed LRNN mean-branch output.
        unet_q: optional int8 UNet pack (``quantize_unet_pack``); unused
          when the LRNN is in train mode.
        fast: each step through ``CWFStep.reverse_fast``; False through
          ``CWFStep.reverse`` (``cwf_step_reverse(fast=False)``), the
          log-det dropped.  The two differ only in the step call.
        qpacks: optional per-step int8 tower packs (``quantize_steps``).
        return_pyramid: also return {level: volume} of every level the chain
          passes (n_flow_steps: the coarsest, 0: the result), as JAX's.
        """
        if z_temperature != 0 and generator is None:
            raise ValueError("z_temperature > 0 needs a generator")
        if lrnn_train is None:
            lrnn_train = generator is not None
        nf = self.n_flow_steps
        b = cond_input.shape[0]
        if self.cfg.force_last_step_NF:
            # the chain starts from zeros at the coarsest level: no LRNN
            last = self.step_specs[nf - 1]
            up = torch.zeros((b, last.c_flow, last.spatial, last.spatial),
                             dtype=cond_input.dtype, device=cond_input.device)
        else:
            mean_vol = mean_caches[nf - 1]
            if lrnn_train:
                # as JAX broadcasts the caches at entry: drop_path draws per
                # frame
                mean_vol = mean_vol.expand((b,) + tuple(mean_vol.shape[1:]))
            up = self.lrnn(cond_input, mean_vol=mean_vol,
                           mean_branch=lrnn_mean_branch, unet_q=unet_q,
                           train=lrnn_train, generator=generator)
        pyramid = {nf: up}
        # force_all_steps_NF (CWFA.py:892-894): a zero views condition, and
        # the cond nets do not run
        c_views_all = (None if self.cfg.force_all_steps_NF
                       else cond_networks_batched(self.cond, cond_input))
        for k in range(nf - 1, -1, -1):
            spec = self.step_specs[k]
            zshape = (b * n_samples, spec.c_flow, spec.spatial, spec.spatial)
            if z_temperature == 0:
                z = torch.zeros(zshape, dtype=up.dtype, device=up.device)
            else:
                z = sample_z_truncated(generator, zshape, z_temperature).to(
                    device=up.device, dtype=up.dtype)
            c_views = (torch.zeros((b,) + zshape[1:], dtype=cond_input.dtype,
                                   device=cond_input.device)
                       if c_views_all is None else c_views_all[k])
            c_mean = mean_caches[k]
            if n_samples > 1:
                tile = (n_samples, 1, 1, 1)
                up, c_views = up.repeat(tile), c_views.repeat(tile)
                if c_mean.shape[0] != 1:
                    c_mean = c_mean.repeat(tile)
            qpack = None if qpacks is None else qpacks[k]
            if fast:
                v = self.flow[k].reverse_fast(z, up, c_views, c_mean,
                                              qpack=qpack)
            else:
                towers = (None if qpack is None
                          else self.flow[k].towers(c_views, qpack))
                v, _ = self.flow[k].reverse(z, up, c_views, c_mean, towers)
            if n_samples > 1:
                v = v.reshape((n_samples, b) + tuple(v.shape[1:])).mean(0)
            up = pyramid[k] = v
        return (up, pyramid) if return_pyramid else up
