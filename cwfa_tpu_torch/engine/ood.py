"""Out-of-distribution detection by exact likelihood (counterpart of
``cwfa_tpu/engine/ood.py:25-71``).

The forward pass of each pyramid step yields an exact per-frame NLL; a
threshold on step ``cfg.step_LL_to_use`` at ``cfg.step_LL_ths_to_use``
flags novel samples.  Decision rule: NLL above the threshold (lower
likelihood than the threshold) => out-of-distribution.

``PyramidScorer`` is the scoring function the JAX trainer builds as
``pyramid_fn`` (``cwfa_tpu/engine/trainer.py:233-255``); it keeps no
per-frame cache.  ``detect_ood`` scores either raw volumes through a
scorer, or a dataset through a ``CWFATrainer``'s version-stamped NLL cache
(``cwfa_tpu/engine/ood.py:34-71``), under a cache tag of the dataset's own
``cache_tag`` (never ``id()``, which CPython reuses).  ``finetune_on_novel``
is the fast adaptation to the flagged frames (``cwfa_tpu/engine/ood.py:
74-123``); ``python -m cwfa_tpu_torch.cli.ood`` drives the two.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.models.cwfa_model import CWFAModel, check_empty_depths
from cwfa_tpu_torch.parallel.mesh import draw_rows

NLL_SENTINEL = 1e15       # the reference's stand-in for a NaN / Inf step loss


@dataclass
class OODResult:
    nll_per_frame: np.ndarray        # (n_frames, n_flow_steps)
    scores: np.ndarray               # (n_frames,) NLL at step_used
    is_ood: np.ndarray               # (n_frames,) bool
    threshold: float
    step_used: int


def sentinel(values):
    """The (n_steps, B) stack of per-step NLLs (or priors) with NaN / Inf
    replaced by the reference's 1e15 (CWFA.py:825-828)."""
    return torch.nan_to_num(torch.stack(values), nan=NLL_SENTINEL,
                            posinf=NLL_SENTINEL, neginf=NLL_SENTINEL)


class PyramidScorer:
    """Raw volumes -> per-frame NLLs of every flow step, in f32.

    ``model`` is used where it lies (move it to ``device`` first); the noise
    is drawn from ``generator`` on the generator's device, so one CPU
    generator gives a card and the CPU the same noise; None draws nothing
    (no guard noise, no dequantization noise).  ``noise_std`` is the
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
        if self.generator is not None:
            g = self.generator
            noise = draw_rows(lambda sh: torch.randn(
                sh, generator=g, dtype=v.dtype, device=g.device), v.shape)
            v = v + self.noise_std * noise.to(v.device)
        nlls, cache, priors, ljs = self.model.forward_pyramid(
            v, per_sample=True)
        return sentinel(nlls), cache, sentinel(priors), torch.stack(ljs)

    def score(self, volumes) -> np.ndarray:
        """(n_frames, n_flow_steps) NLLs of ``volumes`` (n_frames, n_depths,
        H, W), scored in mini-batches of ``batch_size``."""
        out = [self(volumes[i:i + self.batch_size])[0].T.cpu().numpy()
               for i in range(0, len(volumes), self.batch_size)]
        return np.concatenate(out).astype(np.float32)


def _result(nlls: np.ndarray, step: int, ths: float) -> OODResult:
    scores = nlls[:, step]
    return OODResult(nll_per_frame=nlls, scores=scores, is_ood=scores > ths,
                     threshold=ths, step_used=step)


def detect_ood(source, data, step_ll_to_use: int | None = None,
               threshold: float | None = None,
               tag: str | None = None) -> OODResult:
    """Score every frame's forward NLL and threshold it.

    ``detect_ood(scorer, volumes)``: a ``PyramidScorer`` and (n_frames,
    n_depths, H, W) raw volumes (numpy or tensor; may be empty).

    ``detect_ood(trainer, dataset)``: a ``CWFATrainer`` and a
    ``ConcatXLFMDataset``; the frames are scored in the trainer's
    mini-batches through its NLL cache under ``tag`` (default
    ``"ood:<dataset.cache_tag>"``, one per dataset object and version;
    pass ``"train"`` to share the caches of a training loop over the same
    dataset), so a first pass uploads each volume once and primes its GT
    pyramid, and a pass after an optimizer step recomputes from the cached
    pyramids.

    ``step_ll_to_use`` and ``threshold`` default to the model config's
    ``step_LL_to_use`` and ``step_LL_ths_to_use``."""
    scorer = isinstance(source, PyramidScorer)
    cfg = source.model.cfg
    step = cfg.step_LL_to_use if step_ll_to_use is None else step_ll_to_use
    ths = cfg.step_LL_ths_to_use if threshold is None else threshold
    if len(data) == 0:
        return _result(np.zeros((0, source.model.n_flow_steps), np.float32),
                       step, ths)
    if scorer:
        if tag is not None:
            raise ValueError("a PyramidScorer keeps no cache: no tag")
        return _result(source.score(data), step, ths)
    if tag is None:
        tag = f"ood:{data.cache_tag}"
    source.ensure_mean_caches(data)
    for _, ixs in source._batches(data):
        source._refresh_nlls(data, tag, ixs)
    nlls = np.stack([source._frame_nll(data, tag, ix)
                     for ix in range(len(data))])
    return _result(nlls, step, ths)


def finetune_on_novel(trainer, dataset, optimize_steps=(1, 2, 3, 4, 5),
                      epochs_per_step: int = 2, verbose: bool = False,
                      reuse_caches: bool = False) -> dict:
    """The ~5-minute adaptation loop: retrain the selected pyramid steps of
    a ``CWFATrainer`` on ``dataset``, coarsest selected step first
    (reference --fine_tune_optimize_steps, CWFA.py:403-412,586-613,748-771).

    ``optimize_steps`` is 1-based as in the reference: step S =
    INN_max_down_steps is the LRNN, 1 the finest flow step.  Each step runs
    ``epochs_per_step`` epochs of ``trainer.train_epoch`` inside its stage's
    epoch window.  The stage-handoff cache depends on the parameters and is
    always dropped.  reuse_caches: keep the ``"train"`` views, GT pyramids
    and NLL entries, as after ``detect_ood(trainer, dataset, tag="train")``
    on the same dataset: the pyramids are parameter-independent Haar
    averages, so the epochs and a re-score run without uploading a volume
    again.  Returns {step: [mean loss of each epoch]}."""
    cfg = trainer.cfg
    n_steps = cfg.INN_max_down_steps
    trainer.upsampled_cache.entries.clear()
    if not reuse_caches:
        trainer.clear_gt_cache("train")
        for cache in (trainer.nll_cache, trainer.views_cache.entries):
            for key in [k for k in cache if k[0] == "train"]:
                del cache[key]
    eps = max(cfg.epochs // n_steps, 1)
    losses = {}
    for s in sorted(set(optimize_steps), reverse=True):
        # base_epoch puts stage_for_epoch on the stage of step s (the LRNN
        # for s == n_steps); e % eps stays inside that stage's window
        base_epoch = (n_steps - s) * eps
        stage_losses = []
        for e in range(epochs_per_step):
            loss = trainer.train_epoch(dataset, base_epoch + (e % eps))
            stage_losses.append(loss)
            if verbose:
                print(f"finetune step {s} epoch {e}: loss={loss:.5f}")
        losses[s] = stage_losses
    return losses
