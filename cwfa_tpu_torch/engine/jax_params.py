"""The weight bridge: JAX ``params`` / ``mstate`` pytrees into the port.

``cwfa_tpu`` keeps a model's weights as nested dicts and lists
(``CWFAModel.init`` -> ``params``, ``mstate``).  The port's modules carry the
same attribute names, so a pytree path maps to a state-dict key by joining
its parts with '.' and renaming the leaf:

    params: w -> weight, b -> bias, alpha (PReLU) -> weight,
            scale / bias (BatchNorm, LayerNorm) -> weight / bias
    state:  mean -> running_mean, var -> running_var,
            count -> num_batches_tracked

The UNet keeps an up block's BatchNorm state at ``up[i]`` in the JAX tree;
its module is ``up[i].conv_block``.  Conv weights are OIHW (OIDHW, OIK) on
both sides and a transposed conv's is (I, O, kH, kW) on both sides, so
nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_PARAM_LEAF = {"w": "weight", "b": "bias", "alpha": "weight",
               "scale": "weight", "bias": "bias"}
_STATE_LEAF = {"mean": "running_mean", "var": "running_var",
               "count": "num_batches_tracked"}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _key(path, leaf_names):
    if path[-1] not in leaf_names:
        raise KeyError(f"unknown leaf {'/'.join(path)}")
    return ".".join(path[:-1] + (leaf_names[path[-1]],))


def load_jax_params(model: nn.Module, params, state) -> None:
    """Copy JAX ``params`` and ``state`` trees (nested dicts/lists of numpy
    arrays) into ``model``'s parameters and buffers, in place.

    Raises KeyError if a tree key has no counterpart in the model's state
    dict or a state-dict entry gets no value, and ValueError on a shape
    mismatch."""
    incoming = {}
    for path, arr in _flatten(params):
        incoming[_key(path, _PARAM_LEAF)] = arr
    for path, arr in _flatten(state):
        if len(path) >= 4 and path[-4] == "up":
            path = path[:-2] + ("conv_block",) + path[-2:]
        incoming[_key(path, _STATE_LEAF)] = arr
    target = model.state_dict()
    unused = sorted(set(incoming) - set(target))
    missing = sorted(set(target) - set(incoming))
    if unused or missing:
        raise KeyError(f"JAX keys with no module entry: {unused}; "
                       f"module entries with no JAX key: {missing}")
    with torch.no_grad():
        for key, arr in incoming.items():
            src = torch.tensor(np.asarray(arr))
            dst = target[key]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: JAX shape {tuple(src.shape)} != "
                                 f"module shape {tuple(dst.shape)}")
            dst.copy_(src)
