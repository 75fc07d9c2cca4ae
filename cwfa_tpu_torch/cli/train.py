"""The training CLI's flags (counterpart of ``cwfa_tpu/cli/train.py:69-87``).

Only ``build_parser`` is ported: every ``CWFAConfig`` field as a flag, plus
``--img_size`` and ``--max_samples``, which the serving CLI inherits.  The
training ``main`` (cross-validation groups, the coarse-to-fine schedule)
comes with the port's trainer (ROADMAP A10).
"""

from __future__ import annotations

import argparse
import dataclasses

from cwfa_tpu_torch.config import CWFAConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    for f in dataclasses.fields(CWFAConfig):
        name = f"--{f.name}"
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.default_factory is not dataclasses.MISSING:  # type: ignore
            default = f.default_factory()                 # type: ignore
        if isinstance(default, bool):
            p.add_argument(name, type=int, default=int(default))
        elif isinstance(default, (int, float, str)) or default is None:
            p.add_argument(name, type=type(default) if default is not None
                           else str, default=default)
        else:
            p.add_argument(name, nargs="*", type=float, default=list(default)
                           if isinstance(default, (tuple, list)) else default)
    p.add_argument("--img_size", type=int, default=2160,
                   help="camera frame side (reference psf_size_real)")
    p.add_argument("--max_samples", type=int, default=None)
    return p
