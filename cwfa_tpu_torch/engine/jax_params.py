"""The weight bridge: JAX ``params`` / ``mstate`` pytrees into the port.

``cwfa_tpu`` keeps a model's weights as nested dicts and lists
(``CWFAModel.init`` -> ``params``, ``mstate``).  The port's modules carry the
same attribute names, so a pytree path maps to a state-dict key by joining
its parts with '.' and renaming the leaf:

    params: w -> weight, b -> bias, alpha (PReLU) -> weight,
            scale / bias (BatchNorm, LayerNorm) -> weight / bias;
            AI1's global_scale / global_offset / w_perm keep their names
    state:  mean -> running_mean, var -> running_var,
            count -> num_batches_tracked

The UNet keeps an up block's BatchNorm state at ``up[i]`` in the JAX tree;
its module is ``up[i].conv_block``.  Conv weights are OIHW (OIDHW, OIK) on
both sides and a transposed conv's is (I, O, kH, kW) on both sides, so
nothing is transposed.

A module may list buffers that the JAX package keeps among its params
(``JAX_PARAM_BUFFERS``: AI1's fixed permutation ``w_perm``, a persistent
buffer of ``models/cwf.AllInOneParams``).  The bridge carries them both
ways in the params tree; an optimizer state's tree (``param_tree``) has a
leaf for each, which the port writes as zeros and drops on read
(``param_values``), as no optimizer of the port moves them.

``export_jax_params`` is the reverse: the port's modules as JAX-keyed numpy
trees, the form the JAX package's checkpoints carry (``engine/checkpoints``).

``load_jax_int8_packs`` carries the JAX package's int8 packs across: the
paired 128-wide tower packs are split into the port's 64-wide tower packs
(in the layouts of the port's own kernels, ``ops/qtower.pack_convs``),
and the UNet's packs are keyed by the same site tuples.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cwfa_tpu_torch.engine.msgpack_io import restore_lists
from cwfa_tpu_torch.models.unet import unet_site_conv
from cwfa_tpu_torch.ops.qtower import pack_convs

_PARAM_LEAF = {"w": "weight", "b": "bias", "alpha": "weight",
               "scale": "weight", "bias": "bias",
               "global_scale": "global_scale",
               "global_offset": "global_offset", "w_perm": "w_perm"}
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
            src = (arr.detach().cpu() if isinstance(arr, torch.Tensor)
                   else torch.tensor(np.asarray(arr)))
            dst = target[key]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: JAX shape {tuple(src.shape)} != "
                                 f"module shape {tuple(dst.shape)}")
            dst.copy_(src)


_NORMS = (nn.BatchNorm2d, nn.LayerNorm)


def _param_leaf(module: nn.Module, name: str) -> str:
    """The JAX leaf name of ``module``'s parameter ``name``."""
    if isinstance(module, nn.PReLU):
        return "alpha"
    if isinstance(module, _NORMS):
        return {"weight": "scale", "bias": "bias"}[name]
    return {"weight": "w", "bias": "b"}.get(name, name)


def _jax_param_buffers(module: nn.Module):
    """(name, buffer) of each of ``module``'s own buffers that JAX keeps
    among its params."""
    return [(name, getattr(module, name))
            for name in getattr(module, "JAX_PARAM_BUFFERS", ())]


def _jax_param_buffer_keys(model: nn.Module) -> set:
    return {".".join(filter(None, (mname, name)))
            for mname, m in model.named_modules()
            for name, _ in _jax_param_buffers(m)}


def _put(tree: dict, path, value):
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def param_tree(module: nn.Module, value_of):
    """``value_of(p)`` for every parameter p of ``module``, as a JAX-keyed
    tree (the layout of ``export_jax_params``'s params; lists as lists),
    and f32 zeros of its shape for every buffer that JAX keeps among its
    params (JAX's optimizer state has a leaf there)."""
    tree = {}
    for name, sub in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        for pname, p in sub.named_parameters(recurse=False):
            _put(tree, path + (_param_leaf(sub, pname),), value_of(p))
        for bname, b in _jax_param_buffers(sub):
            _put(tree, path + (bname,), np.zeros(tuple(b.shape), np.float32))
    return restore_lists(tree)


def param_values(module: nn.Module, tree) -> dict:
    """The reverse of ``param_tree``: {parameter name: array} of ``tree``
    for ``module``'s parameters; the leaves of buffers that JAX keeps among
    its params are dropped.  Raises KeyError on a key left unused on
    either side and ValueError on a shape mismatch."""
    fixed = _jax_param_buffer_keys(module)
    incoming = {key: arr for key, arr in (
        (_key(path, _PARAM_LEAF), arr) for path, arr in _flatten(tree))
        if key not in fixed}
    params = dict(module.named_parameters())
    unused = sorted(set(incoming) - set(params))
    missing = sorted(set(params) - set(incoming))
    if unused or missing:
        raise KeyError(f"tree keys with no parameter: {unused}; parameters "
                       f"with no tree key: {missing}")
    for name, arr in incoming.items():
        if tuple(np.shape(arr)) != tuple(params[name].shape):
            raise ValueError(f"{name}: tree shape {tuple(np.shape(arr))} != "
                             f"parameter shape {tuple(params[name].shape)}")
    return incoming


def export_jax_params(model: nn.Module):
    """The reverse of ``load_jax_params``: ``model``'s parameters and
    persistent buffers (those JAX keeps among its params in ``params``) as
    JAX ``(params, state)`` trees of numpy arrays,
    nested dicts and lists as ``CWFAModel.init`` builds them (the BatchNorm
    count as an int32 scalar, as JAX keeps it).  Arrays keep the module's
    dtype; a bfloat16 one stays a torch tensor (numpy has no bfloat16)."""
    def host(t):
        t = t.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy().copy()

    params, state = {}, {}
    for name, module in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        for pname, p in module.named_parameters(recurse=False):
            _put(params, path + (_param_leaf(module, pname),), host(p))
        as_params = dict(_jax_param_buffers(module))
        for bname, b in as_params.items():
            _put(params, path + (bname,), host(b))
        skip = getattr(module, "_non_persistent_buffers_set", set())
        for bname, b in module.named_buffers(recurse=False):
            if bname in skip or bname in as_params:
                continue
            leaf = {v: k for k, v in _STATE_LEAF.items()}[bname]
            spath = path
            if len(spath) >= 4 and spath[-2] == "conv_block" \
                    and spath[-4] == "up":
                spath = spath[:-2] + spath[-1:]
            value = (np.asarray(int(b), np.int32) if leaf == "count"
                     else host(b))
            _put(state, spath + (leaf,), value)
    return restore_lists(params), restore_lists(state)


def _take(d: dict, keys, what: str):
    """The values of ``keys`` in ``d``; raises KeyError on a key left over."""
    left = sorted(map(str, set(d) - set(keys)))
    if left:
        raise KeyError(f"{what}: keys with no counterpart in the port: {left}")
    return [d[k] for k in keys]


def _unet_sites(spec):
    sites = []
    for i in range(spec.depth):
        sites += [("down", i, "conv1"), ("down", i, "conv2")]
    for i in range(spec.depth - 1):
        sites += [("up", i, "upconv"), ("up", i, "conv1"), ("up", i, "conv2")]
    return sites + [("last",)]


def split_jax_tower_pair(pair: dict, cin: int, what: str = "pair"):
    """One JAX paired-tower pack ({"qw", "scales"} of ``quantize_cat_step``,
    2C wide) -> the two C-wide tower packs of the port, taking the diagonal
    blocks of w2a..w7 and b1's column halves, with scale row 0 cut to the
    Cin input channels.  Raises if an off-diagonal block is not zero (then
    the towers were not paired) or a key is left over."""
    qw, scales = _take(pair, ("qw", "scales"), what)
    names = ("w1", "w2a", "w2b", "w4a", "w4b", "w6a", "w6b", "w7")
    vals = dict(zip(names + ("sw", "bias", "sw7", "bias7"),
                    _take(qw, names + ("sw", "bias", "sw7", "bias7"),
                          what + " qw")))
    t = {k_: torch.tensor(np.asarray(v)) for k_, v in vals.items()}
    scales = torch.tensor(np.asarray(scales)).float()
    c = t["sw"].shape[1] // 2
    nout = t["sw7"].shape[0] // 2

    def oihw(w):                     # (9, I, O) or (I, O) -> OIHW
        if w.dim() == 2:
            return w.t()[:, :, None, None]
        return w.reshape(3, 3, w.shape[1], w.shape[2]).permute(3, 2, 0, 1)

    towers = []
    for h in range(2):
        ch = slice(h * c, (h + 1) * c)
        oh = slice(h * nout, (h + 1) * nout)
        other = slice((1 - h) * c, (2 - h) * c)
        convs = {"w1": oihw(t["w1"][:cin, ch])}
        for name in names[1:]:
            w = t[name]
            cols = oh if name == "w7" else ch
            if bool(w[..., other, cols].any()):
                raise ValueError(f"{what} {name}: off-diagonal block is not "
                                 "zero")
            convs[name] = oihw(w[..., ch, cols])
        qwt = pack_convs(convs)
        qwt["sw"] = t["sw"][:, ch].float().contiguous()
        qwt["bias"] = t["bias"][:, ch].float().contiguous()
        qwt["sw7"] = t["sw7"][oh].float().contiguous()
        qwt["bias7"] = t["bias7"][oh].float().contiguous()
        s = scales[:, ch].clone()
        s[0] = 1.0
        s[0, :cin] = scales[0, :cin]
        towers.append({"qw": qwt, "scales": s})
    return towers


def load_jax_unet_pack(unet: nn.Module, unet_q):
    """JAX ``quantize_unet_pack`` output {"qpack": {site: {"wq", "sw"}},
    "scales": {site: (Cin,)}} (numpy) -> the port's pack for ``unet``, with
    the f32 biases from ``unet``.  Raises KeyError on a site or key left
    unused or missing, ValueError on a shape mismatch."""
    qpack, scales = _take(unet_q, ("qpack", "scales"), "unet_q")
    sites = _unet_sites(unet.spec)
    _take(qpack, sites, "unet_q qpack")
    _take(scales, sites, "unet_q scales")
    out = {"qpack": {}, "scales": {}}
    for site in sites:
        wq, sw = _take(qpack[site], ("wq", "sw"), f"unet_q {site}")
        conv = unet_site_conv(unet, site)
        wq = torch.tensor(np.asarray(wq))
        if tuple(wq.shape) != tuple(conv.weight.shape):
            raise ValueError(f"{site}: JAX shape {tuple(wq.shape)} != "
                             f"module shape {tuple(conv.weight.shape)}")
        pk = {"wq": wq, "sw": torch.tensor(np.asarray(sw)).float()}
        if conv.bias is not None:
            pk["b"] = conv.bias.detach().float().clone()
        out["qpack"][site] = pk
        out["scales"][site] = torch.tensor(np.asarray(scales[site])).float()
    return out


def load_jax_int8_packs(model: nn.Module, qpacks=None, unet_q=None):
    """JAX int8 packs (given as numpy) -> the port's packs, on the CPU.

    qpacks: ``CWFAModel.quantize_steps`` output of the JAX package — per
      step None or a list of paired-tower packs {"qw", "scales"}; each pair
      is split into its two 64-wide towers (the port's per-block list).
    unet_q: ``quantize_unet_pack`` output {"qpack": {site: {"wq", "sw"}},
      "scales": {site: (Cin,)}}; the f32 biases come from ``model``.

    Returns (qpacks, unet_q) in the port's format (None where not given).
    Raises KeyError on any key left unused or missing."""
    port_q = None
    if qpacks is not None:
        if len(qpacks) != model.n_flow_steps:
            raise KeyError(f"{len(qpacks)} step packs for "
                           f"{model.n_flow_steps} steps")
        port_q = []
        for k, (spec, step) in enumerate(zip(model.step_specs, qpacks)):
            if step is None:
                port_q.append(None)
                continue
            blocks = [None] * spec.n_blocks
            if 2 * len(step) > spec.n_blocks:
                raise KeyError(f"step {k}: {len(step)} pairs for "
                               f"{spec.n_blocks} blocks")
            for j, pair in enumerate(step):
                blocks[2 * j:2 * j + 2] = split_jax_tower_pair(
                    pair, spec.c_flow, f"step {k} pair {j}")
            port_q.append(blocks)
    port_u = None if unet_q is None else load_jax_unet_pack(
        model.lrnn.unet, unet_q)
    return port_q, port_u
