"""Invertibility oracles for testing flow ops (counterpart of
``cwfa_tpu/flow/core.py``; reference FrEIA/framework/graph_inn.py:369-407
and the contract of FrEIA/modules/base.py:17-31).
"""

from __future__ import annotations

import numpy as np
import torch


def numerical_logdet(fn, x) -> float:
    """log|det J| of a bijection y = fn(x) for one sample (no batch axis),
    from the full autograd Jacobian (``torch.autograd.functional.jacobian``)
    and an f64 ``slogdet``: an oracle independent of the closed-form
    log-dets the flow ops report.  ``fn`` maps a (1, *x.shape) f32 tensor
    to its output.  O(N^2) memory: tiny shapes only."""
    x = torch.as_tensor(np.asarray(x, np.float32))

    def flat_fn(xf):
        return fn(xf.reshape((1,) + tuple(x.shape))).reshape(-1)

    jac = torch.autograd.functional.jacobian(flat_fn, x.reshape(-1))
    _, ld = torch.linalg.slogdet(jac.double())
    return float(ld)


def check_inverse(fwd, rev, x, atol: float = 1e-4):
    """Round trip: rev(fwd(x)) == x and jac_fwd == -jac_rev, each within
    ``atol``.  Returns (ok_x, ok_jac, max|x - rev(fwd(x))|)."""
    y, j_fwd = fwd(x)
    x2, j_rev = rev(y)
    x, x2 = np.asarray(torch.as_tensor(x).detach()), x2.detach().numpy()
    ok_x = np.allclose(x, x2, atol=atol)
    ok_j = np.allclose(j_fwd.detach().numpy(), -j_rev.detach().numpy(),
                       atol=atol)
    return ok_x, ok_j, np.max(np.abs(x - x2))
