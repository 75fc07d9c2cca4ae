"""Deprecation shims (counterpart of ``cwfa_tpu/flow/deprecated.py``).

The reference ships two backward-compatibility aliases kept only so old
FrEIA user code imports cleanly:

- ``ReversibleSequential`` -> ``SequenceINN``
  (reference FrEIA/framework/reversible_sequential_net.py:1-12)
- ``ReversibleGraphNet`` -> ``GraphINN``
  (reference FrEIA/framework/reversible_graph_net.py:1-37)

The flow runtime has no dynamic ``GraphINN`` interpreter (the CWF step graph
is fixed and composed statically), so both shims delegate to the sequential combinator, which is the composition
surface old linear-graph code maps onto.  The reference's shim semantics
are replayed exactly: a ``DeprecationWarning`` at construction, a
``ValueError`` for the removed ``ind_in``/``ind_out`` arguments, and a
per-call ``DeprecationWarning`` about the (output, jacobian) tuple return.
"""

from __future__ import annotations

import warnings

from cwfa_tpu_torch.flow.extra import SequenceINN


class ReversibleSequential(SequenceINN):
    """Deprecated alias of ``SequenceINN``
    (reference reversible_sequential_net.py:6-12)."""

    def __init__(self, *ops):
        warnings.warn(
            "ReversibleSequential is deprecated in favour of SequenceINN.",
            DeprecationWarning, stacklevel=2)
        super().__init__(*ops)


class ReversibleGraphNet(SequenceINN):
    """Deprecated alias of the graph executor
    (reference reversible_graph_net.py:9-37).

    The reference forwards to ``GraphINN``; here the static-composition
    design has no graph interpreter, so the shim accepts the same
    linear-chain usage through the sequential combinator.  The removed
    ``ind_in``/``ind_out`` arguments raise exactly as in the reference
    (reversible_graph_net.py:15-24).
    """

    def __init__(self, ops=(), ind_in=None, ind_out=None, verbose=True):
        warnings.warn(
            "ReversibleGraphNet is deprecated in favour of static flow "
            "composition (cwfa_tpu_torch.flow) or SequenceINN.",
            DeprecationWarning, stacklevel=2)
        if ind_in is not None:
            raise ValueError(
                "ReversibleGraphNet's ind_in was removed. Use the static "
                "flow composition API instead.")
        if ind_out is not None:
            raise ValueError(
                "ReversibleGraphNet's ind_out was removed. Use the static "
                "flow composition API instead.")
        del verbose
        super().__init__(*ops)

    def __call__(self, x, rev=False):
        warnings.warn(
            "ReversibleGraphNet's __call__ returns a tuple "
            "(output, jacobian).", DeprecationWarning, stacklevel=2)
        return super().__call__(x, rev=rev)
