"""The reference's PyTorch checkpoints, read into JAX-keyed trees
(counterpart of ``cwfa_tpu/engine/torch_convert.py``).

The reference writes one torch file per pyramid step (networks.py:708-730)
holding the FrEIA ``GraphINN`` state dict ("INN_state_dict") and the
condition net's or the LRNN's ("condition_state_dict").  The functions here
map those names onto the JAX package's parameter trees (nested dicts and
lists of f32 numpy arrays), which ``engine/jax_params.load_jax_params``
copies into the port's modules: one name map for the JAX trees, in both
directions, and this module only between the trees and the reference.

GraphINN (CAT default graph, networks.py:305-366):
  module_list.<i>.subnet.block1 / block12      -> input / blocks b1
  module_list.<i>.subnet.block{2,4,6}.{0,2}    -> b{2,4,6}{a,b}
  module_list.<i>.subnet.block7.1 / block72.1  -> b7
  module_list.<i>.perm / perm_inv              -> the step's permutations

cond_network (networks.py:165-242):
  subnetworks.0.conv1.0 -> conv1 ; subnetworks.0.conv1.1 (PReLU) -> prelu
  subnetworks.0.conv2.0 -> conv2 ; subnetworks.0.downsample.0 -> down
  subnetworks.0.conv3d.0 -> c3a  ; subnetworks.0.conv3d.3 -> c3b

Encoder / LRNN (networks.py:505-584):
  net.deconv.0 -> proj ; net.deconv.1.* (UNet) -> unet.* ;
  net.conv3d.{0,1}.* (ConvNeXt) -> cnx{1,2}.* ; net.attention_3d.m.{0,2} -> attn

The files are pickles (they carry an ``argparse.Namespace``), read with
``torch.load(weights_only=False)`` as the JAX package reads them: load them
only from a source you trust.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _t(sd, name):
    return np.asarray(sd[name], np.float32)


def _conv(sd, prefix):
    p = {"w": _t(sd, prefix + ".weight")}
    if prefix + ".bias" in sd:
        p["b"] = _t(sd, prefix + ".bias")
    return p


def convert_subnet(sd, prefix, first: bool) -> dict:
    """One wavelet_flow_subnetwork2D(_first) (networks.py:608-638)."""
    b1 = "block1" if first else "block12"
    b7 = "block7.1" if first else "block72.1"
    return {
        "b1": _conv(sd, f"{prefix}.{b1}"),
        "b2a": _conv(sd, f"{prefix}.block2.0"),
        "b2b": _conv(sd, f"{prefix}.block2.2"),
        "b4a": _conv(sd, f"{prefix}.block4.0"),
        "b4b": _conv(sd, f"{prefix}.block4.2"),
        "b6a": _conv(sd, f"{prefix}.block6.0"),
        "b6b": _conv(sd, f"{prefix}.block6.2"),
        "b7": _conv(sd, f"{prefix}.{b7}"),
    }


def _module_index(prefix: str) -> int:
    return int(prefix.split(".")[1])


def convert_graph_inn(sd, n_blocks: int, use_final_perm: bool, first: bool):
    """One CAT step's GraphINN state dict -> (flow params, [(perm, inv)]).

    The graph's modules are Haar, Split, CAT_first, then n_blocks x
    (Permute, CAT) and the optional final PermuteRandom; the coupling
    subnets and the permutations are found by name, in module order.
    ``first``: the input subnet is the ``first`` variant (block1 /
    block7.1), i.e. the step has the low-res input
    (``not spec.disable_low_res_input``).  It is the caller's, not the
    keys': every reference subnet holds both variants' keys, so the JAX
    reader's test for ``block1`` keys takes every input subnet as ``first``
    and reads a ``disable_low_res_input`` step's zeros (ROADMAP C).
    Raises ValueError when the subnet or permutation count does not fit
    ``n_blocks`` / ``use_final_perm``."""
    subnet_prefixes = sorted(
        {k.rsplit(".subnet.", 1)[0] + ".subnet" for k in sd
         if ".subnet." in k}, key=_module_index)
    if len(subnet_prefixes) != n_blocks + 1:
        raise ValueError(
            f"expected {n_blocks + 1} coupling subnets, found "
            f"{len(subnet_prefixes)} — --INN_n_blocks disagrees with the "
            "checkpoint's architecture")
    params = {
        "input_block": {"subnet": convert_subnet(sd, subnet_prefixes[0],
                                                 first=first)},
        "blocks": [{"subnet": convert_subnet(sd, p, first=False)}
                   for p in subnet_prefixes[1:]],
    }
    perm_prefixes = sorted({k.rsplit(".perm", 1)[0] for k in sd
                            if k.endswith(".perm")}, key=_module_index)
    perms = [(np.asarray(sd[p + ".perm"], np.int64).astype(np.int32),
              np.asarray(sd[p + ".perm_inv"], np.int64).astype(np.int32))
             for p in perm_prefixes]
    expected = n_blocks + (1 if use_final_perm else 0)
    if len(perms) != expected:
        raise ValueError(
            f"checkpoint carries {len(perms)} permutation modules but the "
            f"config (n_blocks={n_blocks}, use_final_perm={use_final_perm}) "
            f"expects {expected} — --INN_n_blocks/--INN_use_perm disagree "
            "with the checkpoint's architecture")
    return params, perms


def apply_perm_overrides(spec, perms):
    """``spec`` (a ``CWFStepSpec``) with its permutation tables replaced by
    the checkpoint's ``perms``.  The reference does not serialize a
    PermuteDim's axis (only perm / perm_inv, INN_utils.py:70-71), so each
    entry keeps the axis the spec replayed.  Raises ValueError on a count
    mismatch (a silent zip would apply wrong permutations).  The step module
    takes the new spec with ``CWFAModel.set_step_spec``."""
    if len(perms) != len(spec.perms):
        raise ValueError(
            f"checkpoint has {len(perms)} permutation buffers but the "
            f"configured architecture expects {len(spec.perms)} — the "
            "checkpoint was built with different --INN_n_blocks/"
            "--INN_use_perm settings")
    new = []
    for entry, (perm, inv) in zip(spec.perms, perms):
        if entry[0] == "channel":
            new.append(("channel", perm, inv))
        else:
            new.append(("spatial", entry[1], perm, inv))
    return dataclasses.replace(spec, perms=tuple(new))


def convert_cond_network(sd, prefix: str = "subnetworks.0") -> dict:
    """The cond net's tree; its one PReLU alpha is read from ``conv1.1``
    (the other two aliased sites carry the same value)."""
    return {
        "conv1": _conv(sd, f"{prefix}.conv1.0"),
        "conv2": _conv(sd, f"{prefix}.conv2.0"),
        "down": _conv(sd, f"{prefix}.downsample.0"),
        "c3a": _conv(sd, f"{prefix}.conv3d.0"),
        "c3b": _conv(sd, f"{prefix}.conv3d.3"),
        "prelu": {"alpha": _t(sd, f"{prefix}.conv1.1.weight")},
    }


def _convert_unet_block(sd, prefix):
    p = {"conv1": _conv(sd, f"{prefix}.block.0"),
         "act1": {"alpha": _t(sd, f"{prefix}.block.1.weight")},
         "conv2": _conv(sd, f"{prefix}.block.3"),
         "act2": {"alpha": _t(sd, f"{prefix}.block.4.weight")}}
    s = {}
    for ix, tag in ((2, "bn1"), (5, "bn2")):
        p[tag] = {"scale": _t(sd, f"{prefix}.block.{ix}.weight"),
                  "bias": _t(sd, f"{prefix}.block.{ix}.bias")}
        s[tag] = {"mean": _t(sd, f"{prefix}.block.{ix}.running_mean"),
                  "var": _t(sd, f"{prefix}.block.{ix}.running_var"),
                  "count": np.zeros((), np.int32)}
    return p, s


def convert_unet(sd, prefix, depth=3):
    """The LRNN UNet's (params, state); each BatchNorm's count starts at 0,
    as JAX's ``load_torch_checkpoints`` leaves it."""
    params = {"down": [], "up": []}
    state = {"down": [], "up": []}
    for i in range(depth):
        p, s = _convert_unet_block(sd, f"{prefix}.down_path.{i}")
        params["down"].append(p)
        state["down"].append(s)
    for i in range(depth - 1):
        up = {"up": _conv(sd, f"{prefix}.up_path.{i}.up")}
        up["conv_block"], s = _convert_unet_block(
            sd, f"{prefix}.up_path.{i}.conv_block")
        params["up"].append(up)
        state["up"].append(s)
    params["last"] = {"conv": _conv(sd, f"{prefix}.last.0"),
                      "act": {"alpha": _t(sd, f"{prefix}.last.1.weight")}}
    return params, state


def _convert_convnext(sd, prefix):
    return {"inp": _conv(sd, f"{prefix}.input"),
            "dw": _conv(sd, f"{prefix}.m.0"),
            "ln": {"scale": _t(sd, f"{prefix}.m.1.weight"),
                   "bias": _t(sd, f"{prefix}.m.1.bias")},
            "pw": _conv(sd, f"{prefix}.m.2")}


def convert_lrnn(sd, unet_depth=3):
    """Encoder state dict (keys rooted at 'net.') -> (params, state)."""
    params = {
        "proj": _conv(sd, "net.deconv.0"),
        "cnx1": _convert_convnext(sd, "net.conv3d.0"),
        "cnx2": _convert_convnext(sd, "net.conv3d.1"),
        "attn": {"c1": _conv(sd, "net.attention_3d.m.0"),
                 "c2": _conv(sd, "net.attention_3d.m.2")},
    }
    params["unet"], unet_state = convert_unet(sd, "net.deconv.1",
                                              depth=unet_depth)
    return params, {"unet": unet_state}


def load_torch_state_dict(path: str) -> dict:
    """One reference checkpoint file: {"INN_state_dict",
    "condition_state_dict" (each {name: numpy} or None), "epoch",
    "training_statistics"}.  A pickle (module docstring)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for key in ("INN_state_dict", "condition_state_dict"):
        sd = payload.get(key)
        out[key] = ({k: v.detach().cpu().numpy() for k, v in sd.items()}
                    if sd else None)
    out["epoch"] = payload.get("epoch")
    out["training_statistics"] = payload.get("training_statistics")
    return out
