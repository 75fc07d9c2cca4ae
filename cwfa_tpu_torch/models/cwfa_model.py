"""Full CWFA model: LRNN + chain of CWF flow steps + condition networks
(counterpart of ``cwfa_tpu/models/cwfa_model.py:72-113,230-339``).

Structure for the default config (n_depths=96, 5 pyramid steps):
  flow steps k=0..3 on volumes of 96/2^k depth-channels,
  cond nets k=0..3 mapping the views -> 96/2^{k+1} channels,
  LRNN producing the coarsest 6-depth volume from views + mean-volume prior.

Only deterministic inference is ported: ``reconstruct`` at temperature 0,
one sample, through the CUDA flow kernels (the JAX ``fast=True`` path).  Any
other flag raises.
"""

from __future__ import annotations

import torch
from torch import nn

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.models.cond_net import CondNetwork, cond_networks_batched
from cwfa_tpu_torch.models.cwf import CWFStep, build_step_specs
from cwfa_tpu_torch.models.lrnn import LRNN, LRNNSpec
from cwfa_tpu_torch.nn import reset_parameters_


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
    def reconstruct(self, cond_input, mean_caches, *,
                    z_temperature: float = 0.0, n_samples: int = 1,
                    fast: bool = True, lrnn_mean_branch=None):
        """Full generative chain (CWFA.py:865-927): LRNN at the coarsest
        level, then invert flow steps k = n-1..0, doubling depth each time.

        cond_input: normalized views (B, n_lenslets, H, W).
        mean_caches: per-level mean-volume difference caches, (1 or B, C_k,
          H, W); entry k is the flow condition at step k and entry
          [n_flow-1] feeds the LRNN (reference CWFA.py:882).
        lrnn_mean_branch: optional precomputed LRNN mean-branch output.
        """
        if z_temperature != 0 or n_samples != 1 or not fast:
            raise NotImplementedError(
                "only z_temperature=0, n_samples=1, fast=True are ported")
        nf = self.n_flow_steps
        b = cond_input.shape[0]
        up = self.lrnn(cond_input, mean_vol=mean_caches[nf - 1],
                       mean_branch=lrnn_mean_branch)
        c_views_all = cond_networks_batched(self.cond, cond_input)
        for k in range(nf - 1, -1, -1):
            spec = self.step_specs[k]
            z = torch.zeros((b, spec.c_flow, spec.spatial, spec.spatial),
                            dtype=up.dtype, device=up.device)
            up = self.flow[k].reverse_fast(z, up, c_views_all[k],
                                           mean_caches[k])
        return up
