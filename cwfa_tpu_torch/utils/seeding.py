"""Global seeding (reference set_all_seeds, utils.py:266-279; counterpart
of ``cwfa_tpu/utils/seeding.py:14``).

The port's model inits and every draw of the trainer come from explicit
``torch.Generator``s; the global state seeded here is numpy's and
Python's (the permutation replay, host-side data) and torch's default
generator, which the reference seeds too."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_all_seeds(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
