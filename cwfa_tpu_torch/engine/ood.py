"""Out-of-distribution detection by exact likelihood (counterpart of
``cwfa_tpu/engine/ood.py:25-71``).

The forward pass of each pyramid step yields an exact per-frame NLL; a
threshold on step ``cfg.step_LL_to_use`` at ``cfg.step_LL_ths_to_use``
flags novel samples.  Decision rule: NLL above the threshold (lower
likelihood than the threshold) => out-of-distribution.

``PyramidScorer`` is the scoring function the JAX trainer builds as
``pyramid_fn`` (``cwfa_tpu/engine/trainer.py:233-255``) and nothing else of
the trainer.  It keeps no per-frame cache, so there is no cache tag that two
datasets could share.  The finetune loop and the CLI are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.models.cwfa_model import CWFAModel, check_empty_depths

NLL_SENTINEL = 1e15       # the reference's stand-in for a NaN / Inf step loss


@dataclass
class OODResult:
    nll_per_frame: np.ndarray        # (n_frames, n_flow_steps)
    scores: np.ndarray               # (n_frames,) NLL at step_used
    is_ood: np.ndarray               # (n_frames,) bool
    threshold: float
    step_used: int


def _sentinel(values):
    return torch.nan_to_num(torch.stack(values), nan=NLL_SENTINEL,
                            posinf=NLL_SENTINEL, neginf=NLL_SENTINEL)


class PyramidScorer:
    """Raw volumes -> per-frame NLLs of every flow step, in f32.

    ``model`` is used where it lies (move it to ``device`` first); the noise
    is drawn from ``generator`` on the generator's device, so one CPU
    generator gives a card and the CPU the same noise.  ``noise_std`` is the
    reference's 1e-3 dequantization noise."""

    def __init__(self, model: CWFAModel, stats: DatasetStatistics, *, device,
                 generator: torch.Generator, batch_size: int = 1,
                 noise_std: float = 1e-3):
        self.model = model.eval()
        self.stats = stats
        self.device = torch.device(device)
        self.generator = generator
        self.batch_size = max(int(batch_size), 1)
        self.noise_std = noise_std

    @torch.inference_mode()
    def __call__(self, vol_raw):
        """``pyramid_fn``: volumes to f32, ``(v - mean) / std``, the
        empty-depth guard, + ``noise_std`` noise, then the forward pyramid
        per sample; NaN / Inf NLLs and priors become 1e15.

        vol_raw: (B, n_depths, H, W), any float dtype.  Returns (nlls
        (n_steps, B), gt_cache, priors (n_steps, B), log-jacobians (n_steps,
        B))."""
        s = self.stats
        v = torch.as_tensor(vol_raw).to(self.device, torch.float32)
        v = (v - s.mean_vols) / s.std_vols
        v = check_empty_depths(self.generator, v)
        noise = torch.randn(v.shape, generator=self.generator, dtype=v.dtype,
                            device=self.generator.device)
        v = v + self.noise_std * noise.to(v.device)
        nlls, cache, priors, ljs = self.model.forward_pyramid(
            v, per_sample=True)
        return _sentinel(nlls), cache, _sentinel(priors), torch.stack(ljs)

    def score(self, volumes) -> np.ndarray:
        """(n_frames, n_flow_steps) NLLs of ``volumes`` (n_frames, n_depths,
        H, W), scored in mini-batches of ``batch_size``."""
        out = [self(volumes[i:i + self.batch_size])[0].T.cpu().numpy()
               for i in range(0, len(volumes), self.batch_size)]
        return np.concatenate(out).astype(np.float32)


def detect_ood(scorer: PyramidScorer, volumes,
               step_ll_to_use: int | None = None,
               threshold: float | None = None) -> OODResult:
    """Score every frame's forward NLL and threshold it.

    volumes: (n_frames, n_depths, H, W) raw volumes (numpy or tensor; may be
    empty).  ``step_ll_to_use`` and ``threshold`` default to the model
    config's ``step_LL_to_use`` and ``step_LL_ths_to_use``."""
    cfg = scorer.model.cfg
    step = cfg.step_LL_to_use if step_ll_to_use is None else step_ll_to_use
    ths = cfg.step_LL_ths_to_use if threshold is None else threshold
    if len(volumes) == 0:
        empty = np.zeros((0, scorer.model.n_flow_steps), np.float32)
        return OODResult(nll_per_frame=empty, scores=empty[:, 0],
                         is_ood=empty[:, 0] > ths, threshold=ths,
                         step_used=step)
    nlls = scorer.score(volumes)
    scores = nlls[:, step]
    return OODResult(nll_per_frame=nlls, scores=scores, is_ood=scores > ths,
                     threshold=ths, step_used=step)
