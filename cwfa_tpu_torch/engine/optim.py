"""Lion, written out, and the trainer's optimizer groups (counterpart of
``cwfa_tpu/engine/trainer.py:51-66`` ``make_optimizers``, which builds
``optax.lion``; the card's host has no optax and no lion_pytorch).

One ``Lion`` per group, as JAX has one optax transformation per params
subtree: each flow step and each cond net, and the LRNN.  The update is
optax's ``chain(scale_by_lion(b1, b2), add_decayed_weights(wd),
scale_by_learning_rate(lr))`` term by term, with f32 momenta:

    u  = sign((1 - b1) g + b1 m)
    m  = (1 - b2) g + b2 m
    p  = p + (-lr) (u + wd p)

The state is stored in optax's layout, ``{"0": {"count", "mu"}, "1": {},
"2": {}}`` with mu a JAX-keyed tree of the group's parameters, so that the
JAX trainer resumes from the port's checkpoints and the port from JAX's
(``engine/checkpoints``).

Parameters are updated in place under ``torch.no_grad()`` (``add_``), which
bumps their version counters: the float tower's weight pack, keyed on those
versions (``ops/btower.pack_float_tower``), is rebuilt after every step.
"""

from __future__ import annotations

import numpy as np
import torch

from cwfa_tpu_torch.engine.jax_params import param_tree, param_values


class Lion:
    """optax.lion(lr, b1, b2, weight_decay) over ``module``'s parameters,
    reading their ``.grad``."""

    def __init__(self, module: torch.nn.Module, lr: float, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 0.0):
        self.module = module
        self.lr, self.b1, self.b2, self.weight_decay = lr, b1, b2, weight_decay
        self.params = list(module.parameters())
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        """One update from the parameters' gradients; a parameter without a
        gradient takes a zero one (as an optax tree leaf would)."""
        b1, b2 = self.b1, self.b2
        for p, m in zip(self.params, self.mu):
            g = torch.zeros_like(m) if p.grad is None else p.grad.float()
            u = torch.sign((1.0 - b1) * g + b1 * m)
            m.copy_((1.0 - b2) * g + b2 * m)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            p.add_((-self.lr * u).to(p.dtype))
        self.count += 1

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_tree(self):
        """The state in optax's layout, numpy."""
        mu = dict(zip((id(p) for p in self.params), self.mu))
        return {"0": {"count": np.asarray(self.count, np.int32),
                      "mu": param_tree(self.module, lambda p: mu[id(p)]
                                       .detach().cpu().numpy().copy())},
                "1": {}, "2": {}}

    @torch.no_grad()
    def load_state_tree(self, tree):
        """Restore a state written by ``state_tree`` or by the JAX trainer.
        Raises KeyError / ValueError when it does not fit the group."""
        values = param_values(self.module, tree["0"]["mu"])
        by_name = dict(zip((n for n, _ in self.module.named_parameters()),
                           self.mu))
        for name, arr in values.items():
            src = (arr.detach().cpu() if isinstance(arr, torch.Tensor)
                   else torch.as_tensor(np.asarray(arr)))
            by_name[name].copy_(src)
        self.count = int(np.asarray(tree["0"]["count"]))


def make_optimizers(model):
    """Per-group Lion with the reference's hyperparameters (CWFA.py:24,
    586-613: betas (0.9, 0.99); the flow and LRNN groups carry weight decay,
    the cond nets none).  Returns (flow: one per step, cond: one per step,
    lrnn)."""
    cfg = model.cfg
    flow = [Lion(step, cfg.learning_rate, weight_decay=cfg.learning_weight_decay)
            for step in model.flow]
    cond = [Lion(net, cfg.learning_rate_cond) for net in model.cond]
    lrnn = Lion(model.lrnn, cfg.learning_rate_first_step,
                weight_decay=cfg.learning_weight_decay)
    return flow, cond, lrnn
