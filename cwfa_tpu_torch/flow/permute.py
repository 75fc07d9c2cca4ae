"""Fixed permutations with log-det 0 and reference-seed parity.

Counterpart of ``cwfa_tpu/flow/permute.py``: the permutation constructors and
``ReferencePermReplayer`` are numpy copies (they decide the random-init
model's permutations from ``cfg.seed``, so they must replay the same numpy
call sequence); applying a permutation is an ``index_select``.

Two kinds are used by the CWF step graph (reference networks.py:341-357):

- channel permutation (FrEIA PermuteRandom, fixed_transforms.py:11-47):
  a numpy-seeded permutation of the channel/depth axis;
- spatial permutation (reference PermuteDim, INN_utils.py:46-87): a seeded
  permutation of rows (axis 2) or columns (axis 3).

PermuteDim draws the *axis choice* from the global numpy RNG state BEFORE
applying the given seed (INN_utils.py:61-64), so the axis depends on
everything constructed earlier; the replayer walks that sequence.
"""

from __future__ import annotations

import numpy as np
import torch


def make_channel_perm(n: int, seed: int | None, rng: np.random.RandomState | None = None):
    """Seeded channel permutation exactly like FrEIA PermuteRandom: if a seed
    is given the *global-style* RNG is reseeded first. Returns (perm, inv)."""
    rng = rng or np.random
    if seed is not None:
        rng.seed(seed)
    perm = rng.permutation(n)
    inv = np.argsort(perm)
    return perm.astype(np.int32), inv.astype(np.int32)


def make_spatial_perm(spatial_size: int, seed: int | None,
                      rng: np.random.RandomState | None = None):
    """PermuteDim: axis drawn pre-seed from [rows, cols]; perm drawn post-seed
    (reference INN_utils.py:58-64). Returns (axis, perm, inv) with axis in
    {2 (rows/H), 3 (cols/W)} for (B, C, H, W) tensors."""
    rng = rng or np.random
    axis = [2, 3][int(rng.randint(0, 2))]
    if seed is not None:
        rng.seed(seed)
    perm = rng.permutation(spatial_size)
    inv = np.argsort(perm)
    return axis, perm.astype(np.int32), inv.astype(np.int32)


def apply_channel_perm(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return x.index_select(1, perm)


def apply_spatial_perm(x: torch.Tensor, axis: int,
                       perm: torch.Tensor) -> torch.Tensor:
    return x.index_select(axis, perm)


class ReferencePermReplayer:
    """Replays the numpy RNG call sequence of the reference's network construction.

    The reference seeds numpy once via set_all_seeds(args.seed)
    (utils.py:266-279, called at main.py:246) and then, inside
    ``conditional_wavelet_flow`` (networks.py:305-357), constructs for each
    down-step k and block nn=1..n_blocks:

        nn odd  -> PermuteRandom(seed=k+nn): np.seed(k+nn); np.permutation(C)
        nn even -> PermuteDim(seed=k+nn):    np.randint(0,2) [pre-seed!];
                                             np.seed(k+nn); np.permutation(S)
        finally (use_permutations) -> PermuteRandom(seed=None): np.permutation(C)

    run_CWFA builds one such factory call per pyramid step ix with
    n_down_steps=ix+1 (CWFA.py:478-510) and keeps only the deepest graph, so
    the RNG walks through all shallower steps' draws too.
    """

    def __init__(self, global_seed: int):
        self.rng = np.random.RandomState(global_seed)

    def build_factory_call(self, n_down_steps: int, n_depths: int,
                           spatial_size: int, n_blocks: int,
                           use_final_perm: bool):
        """Replays one conditional_wavelet_flow(...) call; returns the perm
        specs of its deepest step graph.  Each spec is ('channel', perm, inv)
        or ('spatial', axis, perm, inv); the final entry (if use_final_perm)
        is a channel perm."""
        k = n_down_steps - 1
        c_flow = (n_depths // (2 ** k)) // 2  # differences channel count
        specs = []
        for nn in range(1, n_blocks + 1):
            if nn % 2 == 0:  # PermuteDim (networks.py:343-346)
                axis, perm, inv = make_spatial_perm(
                    spatial_size, seed=k + nn, rng=self.rng)
                specs.append(("spatial", axis, perm, inv))
            else:  # Fm.PermuteRandom with seed=k+nn
                perm, inv = make_channel_perm(c_flow, seed=k + nn, rng=self.rng)
                specs.append(("channel", perm, inv))
        if use_final_perm:  # unseeded PermuteRandom (networks.py:353-357)
            perm, inv = make_channel_perm(c_flow, seed=None, rng=self.rng)
            specs.append(("channel", perm, inv))
        return specs
