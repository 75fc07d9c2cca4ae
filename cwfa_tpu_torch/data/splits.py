"""Split / image-index resolution — the reference's frame-selection rules
(a copy of ``cwfa_tpu/data/splits.py:30-113``).

Reference: main.py:195-233.  The CLI flags ``--images_to_use``,
``--images_to_use_test`` and ``--images_to_use_fine_tune_val`` accept either
explicit index lists or counts; counts are resolved to index lists with
very specific semantics:

- train (``images_to_use`` int n): frames are sampled with an INTERLEAVED
  STRIDE over the first max(500, n) frames —
  ``range(0, n_samples, n_samples // n)[:n]`` (main.py:214-216) — so a
  50-frame training request spreads over the first 500 frames rather than
  taking the first 50.  Before that, when the CV fold index is < 30 (the
  multi-fish folds) the count is divided by the number of datasets
  (main.py:213-214), and folds >= 5 rescale by the fold's train-group size
  ratio (main.py:195-196).
- test / finetune-val (int n): a CONTIGUOUS WINDOW STARTING AT FRAME 500 —
  ``range(500, 500 + n)`` (main.py:219-231) — i.e. evaluation frames come
  after the region training sampled from.
- a single-element list collapses to its int and follows the count path
  (main.py:209-210,220-221,226-227); a longer list is used verbatim
  (offset by start_sample = 0).
"""

from __future__ import annotations

START_SAMPLE = 0
N_SAMPLES = 500


def _as_count(v):
    """A 1-element list collapses to its int (main.py:209-210)."""
    if isinstance(v, (list, tuple)) and len(v) == 1:
        return int(v[0])
    return v


def resolve_train_indices(images_to_use, cv: int = 1, n_datasets: int = 1,
                          group_ratio=None):
    """Training frame indices per dataset (main.py:195-216).

    group_ratio: the fold-size rescale for folds >= 5 (main.py:195-196).
    Pass the pair ``(len(groups[0].train), len(groups[cv].train))`` for the
    reference's exact floor arithmetic ``n*len0 // lenCV``; a bare float
    ratio is accepted too but can round one lower near integer boundaries
    (e.g. n=3, ratio 1/3: int(3*0.333...) = 0 vs the reference's 1).
    """
    return resolve_train(images_to_use, cv=cv, n_datasets=n_datasets,
                         group_ratio=group_ratio)[0]


def resolve_train(images_to_use, cv: int = 1, n_datasets: int = 1,
                  group_ratio=None):
    """Like :func:`resolve_train_indices` but also returns the resolved
    ``n_samples`` — the reference mutates its module-level ``n_samples``
    to ``max(500, count)`` in the int branch (main.py:215) and the test/
    finetune-val windows START there (main.py:219-231), keeping large
    train runs and the eval windows disjoint.  Explicit index lists leave
    it at 500, exactly as in the reference."""
    v = _as_count(images_to_use)
    if isinstance(v, (list, tuple)):
        return [int(i) + START_SAMPLE for i in v], N_SAMPLES
    n = int(v)
    if cv >= 5 and group_ratio:
        if isinstance(group_ratio, (tuple, list)):
            len0, len_cv = group_ratio
            n = n * int(len0) // max(int(len_cv), 1)
        else:
            n = int(n * group_ratio)
    if cv < 30:
        n = n // max(int(n_datasets), 1)
    n = max(n, 1)       # guard EVERY path: n=0 (count 0, or the fold
                        # rescale flooring to 0) would divide by zero in
                        # the stride below (the reference crashes there)
    n_samples = max(N_SAMPLES, n)
    return list(range(START_SAMPLE, START_SAMPLE + n_samples,
                      n_samples // n))[:n], n_samples


def resolve_eval_indices(images_to_use,
                         n_datasets_test: int = 1,
                         group0_train_len: int | None = None,
                         window_start: int = N_SAMPLES,
                         rescale: bool = False):
    """Test / finetune-val frame indices (main.py:198-231): a contiguous
    window starting at ``window_start`` (= the train resolution's
    ``n_samples``, see :func:`resolve_train`).

    rescale=True replays main.py:198-201 — a single-element TEST list is
    multiplied by ``len(groups[0].train) // n_datasets_test``.  The
    reference applies it at EVERY fold (it sits directly under the
    ``cross_validation_nFold is not None`` guard) and only to
    ``images_to_use_test``, never to ``images_to_use_fine_tune_val``
    (main.py:224-227 has no rescale)."""
    v = images_to_use
    if (rescale and isinstance(v, (list, tuple)) and len(v) == 1
            and group0_train_len):
        v = [int(v[0]) * group0_train_len // max(int(n_datasets_test), 1)]
    v = _as_count(v)
    if isinstance(v, (list, tuple)):
        return [int(i) for i in v]
    n = int(v)
    return list(range(window_start, window_start + n))[:n]


def clamp_indices(indices, n_available: int):
    """Host-side guard for small local datasets: the reference assumes >500
    frames exist; on smaller datasets keep in-range indices and fall back to
    a contiguous prefix when the window misses entirely (TPU-repo extension,
    no reference counterpart — the reference would crash)."""
    kept = [i for i in indices if 0 <= i < n_available]
    if kept:
        return kept
    return list(range(min(len(indices), n_available)))
