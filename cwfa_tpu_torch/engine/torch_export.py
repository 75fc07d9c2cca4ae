"""The port's models written as the reference's PyTorch checkpoints
(counterpart of ``cwfa_tpu/engine/torch_export.py``).

The reverse of ``engine/torch_convert``: a model trained or finetuned on the
card becomes the reference's ``model_step_<s>__ep_<e>`` files
(networks.py:708-730), which its ``load_INN_steps`` + strict
``load_state_dict`` read.  The model is read through the JAX-keyed trees of
``engine/jax_params.export_jax_params`` and its Lion momenta through
``engine/optim.Lion.state_tree``, so the name map to the reference is this
module's and the one to the modules is the bridge's, in both directions.

- GraphINN: modules 0 / 1 (Haar, Split) carry no parameters; the input
  subnet is ``module_list.2``; block i puts its permutation at
  ``module_list.<3+2i>`` and its subnet at ``module_list.<4+2i>``; the final
  PermuteRandom (``INN_use_perm``) is ``module_list.<3+2*n_blocks>``.
- Every reference subnet owns both variants (networks.py:608-638): the used
  half comes from the model (first: block1 / block7.1; normal: block12 /
  block72.1, by ``spec.disable_low_res_input`` for the input subnet), the
  unused half and ``block_grad_up`` are zeros at the constructor shapes.
- The cond net's one PReLU alpha is written under its three aliased sites
  (conv1.1, conv3d.1, relu).
- BatchNorm ``num_batches_tracked`` buffers are int64 zeros.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cwfa_tpu_torch.engine.jax_params import export_jax_params


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def _conv_out(sd, prefix, p):
    sd[prefix + ".weight"] = _np(p["w"])
    if "b" in p:
        sd[prefix + ".bias"] = _np(p["b"])


def _zeros(sd, prefix, shape, bias=True):
    sd[prefix + ".weight"] = np.zeros(shape, np.float32)
    if bias:
        sd[prefix + ".bias"] = np.zeros((shape[0],), np.float32)


def export_subnet(sub: dict, first: bool) -> dict:
    """One wavelet_flow_subnetwork2D(_first) -> its module-local state
    dict."""
    sd: dict = {}
    n_ch = sub["b2a"]["w"].shape[0]
    b1_in = sub["b1"]["w"].shape[1]
    b7_out = sub["b7"]["w"].shape[0]
    if first:
        _conv_out(sd, "block1", sub["b1"])
        _conv_out(sd, "block7.1", sub["b7"])
        # the unused variant at its constructor shapes (networks.py:621-639)
        _zeros(sd, "block12", (n_ch, 2 * b1_in, 1, 1))
        _zeros(sd, "block72.1", (2 * b7_out, n_ch, 3, 3))
        _zeros(sd, "block_grad_up", (2 * b1_in, b1_in, 3, 3))
    else:
        _conv_out(sd, "block12", sub["b1"])
        _conv_out(sd, "block72.1", sub["b7"])
        _zeros(sd, "block1", (n_ch, b1_in // 2, 1, 1))
        _zeros(sd, "block7.1", (b7_out // 2, n_ch, 3, 3))
        _zeros(sd, "block_grad_up", (b1_in, b1_in // 2, 3, 3))
    for blk, a, b in (("block2", "b2a", "b2b"), ("block4", "b4a", "b4b"),
                      ("block6", "b6a", "b6b")):
        _conv_out(sd, f"{blk}.0", sub[a])
        _conv_out(sd, f"{blk}.2", sub[b])
    return sd


def export_graph_inn(spec, flow_params: dict) -> dict:
    """One flow step's tree and its ``CWFStepSpec`` -> the reference
    GraphINN state dict (CAT default graph, networks.py:305-366), its
    permutations from ``spec.perms``."""
    sd: dict = {}
    first = not spec.disable_low_res_input
    for k, v in export_subnet(flow_params["input_block"]["subnet"],
                              first=first).items():
        sd[f"module_list.2.subnet.{k}"] = v
    for i, blk in enumerate(flow_params["blocks"]):
        for k, v in export_subnet(blk["subnet"], first=False).items():
            sd[f"module_list.{4 + 2 * i}.subnet.{k}"] = v
    perm_idx = [3 + 2 * i for i in range(spec.n_blocks)]
    if spec.use_final_perm:
        perm_idx.append(3 + 2 * spec.n_blocks)
    if len(perm_idx) != len(spec.perms):
        raise ValueError(f"{len(spec.perms)} permutations for "
                         f"{len(perm_idx)} permutation modules")
    for mi, entry in zip(perm_idx, spec.perms):
        sd[f"module_list.{mi}.perm"] = np.asarray(entry[-2], np.int64)
        sd[f"module_list.{mi}.perm_inv"] = np.asarray(entry[-1], np.int64)
    return sd


def export_cond_network(p: dict, prefix: str = "subnetworks.0") -> dict:
    sd: dict = {}
    _conv_out(sd, f"{prefix}.conv1.0", p["conv1"])
    _conv_out(sd, f"{prefix}.conv2.0", p["conv2"])
    _conv_out(sd, f"{prefix}.downsample.0", p["down"])
    _conv_out(sd, f"{prefix}.conv3d.0", p["c3a"])
    _conv_out(sd, f"{prefix}.conv3d.3", p["c3b"])
    alpha = _np(p["prelu"]["alpha"]).reshape(1)
    for site in ("conv1.1", "conv3d.1", "relu"):
        sd[f"{prefix}.{site}.weight"] = alpha
    return sd


def _export_unet_block(sd, prefix, p, s):
    _conv_out(sd, f"{prefix}.block.0", p["conv1"])
    sd[f"{prefix}.block.1.weight"] = _np(p["act1"]["alpha"]).reshape(1)
    _conv_out(sd, f"{prefix}.block.3", p["conv2"])
    sd[f"{prefix}.block.4.weight"] = _np(p["act2"]["alpha"]).reshape(1)
    for ix, tag in ((2, "bn1"), (5, "bn2")):
        if tag not in p:
            continue
        sd[f"{prefix}.block.{ix}.weight"] = _np(p[tag]["scale"])
        sd[f"{prefix}.block.{ix}.bias"] = _np(p[tag]["bias"])
        st = (s or {}).get(tag, {})
        n = p[tag]["scale"].shape[0]
        sd[f"{prefix}.block.{ix}.running_mean"] = _np(
            st.get("mean", np.zeros(n)))
        sd[f"{prefix}.block.{ix}.running_var"] = _np(
            st.get("var", np.ones(n)))
        sd[f"{prefix}.block.{ix}.num_batches_tracked"] = np.zeros(
            (), np.int64)


def _export_convnext(sd, prefix, p):
    _conv_out(sd, f"{prefix}.input", p["inp"])
    _conv_out(sd, f"{prefix}.m.0", p["dw"])
    sd[f"{prefix}.m.1.weight"] = _np(p["ln"]["scale"])
    sd[f"{prefix}.m.1.bias"] = _np(p["ln"]["bias"])
    _conv_out(sd, f"{prefix}.m.2", p["pw"])


def export_lrnn(p: dict, mstate: dict | None = None) -> dict:
    """The LRNN's tree (and its BatchNorm statistics, ``{"unet": ...}``)
    -> the reference Encoder state dict (keys rooted at 'net.')."""
    sd: dict = {}
    _conv_out(sd, "net.deconv.0", p["proj"])
    _export_convnext(sd, "net.conv3d.0", p["cnx1"])
    _export_convnext(sd, "net.conv3d.1", p["cnx2"])
    _conv_out(sd, "net.attention_3d.m.0", p["attn"]["c1"])
    _conv_out(sd, "net.attention_3d.m.2", p["attn"]["c2"])
    un = p["unet"]
    ust = (mstate or {}).get("unet")
    for i, blk in enumerate(un["down"]):
        _export_unet_block(sd, f"net.deconv.1.down_path.{i}", blk,
                           ust["down"][i] if ust else None)
    for i, up in enumerate(un["up"]):
        _conv_out(sd, f"net.deconv.1.up_path.{i}.up", up["up"])
        _export_unet_block(sd, f"net.deconv.1.up_path.{i}.conv_block",
                           up["conv_block"], ust["up"][i] if ust else None)
    _conv_out(sd, "net.deconv.1.last.0", un["last"]["conv"])
    sd["net.deconv.1.last.1.weight"] = _np(
        un["last"]["act"]["alpha"]).reshape(1)
    return sd


# --------------------------------------------------------------- optimizer
#
# The reference's own serialize calls always pass optimizer=None
# (CWFA.py:1173,1283) and its resume builds fresh optimizers
# (CWFA.py:586-613).  The Lion momenta are written all the same, in
# lion_pytorch's state-dict layout keyed by torch ``parameters()`` order, so
# that a reference-side fork that does resume starts from them.

_SUBNET_PARAM_ORDER = (
    # wavelet_flow_subnetwork registration order (networks.py:620-639)
    "block_grad_up", "block1", "block12", "block2.0", "block2.2",
    "block4.0", "block4.2", "block6.0", "block6.2", "block7.1", "block72.1")


def graph_param_names(sd: dict) -> list:
    """Keys of a GraphINN state dict in the reference's ``parameters()``
    order: module_list index ascending, each subnet in its registration
    order, weight before bias.  FrEIA registers the permutation index
    vectors as ``nn.Parameter(requires_grad=False)`` (perm before
    perm_inv), so they hold parameter positions but never carry state."""
    def key(name):
        parts = name.split(".")
        mi = int(parts[1])
        if parts[2] in ("perm", "perm_inv"):
            return (mi, 0, parts[2] == "perm_inv")
        base, leaf = ".".join(parts[3:]).rsplit(".", 1)
        return (mi, _SUBNET_PARAM_ORDER.index(base), leaf != "weight")
    return sorted(sd, key=key)


def lrnn_param_names(sd: dict) -> list:
    """Keys of an Encoder state dict in the reference's ``parameters()``
    order (conv3d (2x ConvNeXt), attention_3d, deconv = [proj, UNet]:
    networks.py:505-541), buffers left out."""
    bufs = (".running_mean", ".running_var", ".num_batches_tracked")

    def key(name):
        base, leaf = name.rsplit(".", 1)
        wl = 0 if leaf == "weight" else 1
        p = base.split(".")
        if p[1] == "conv3d":                # ConvNeXt: input, m.0, m.1, m.2
            inner = 0 if p[3] == "input" else 1 + int(p[4])
            return (0, int(p[2]), 0, inner, 0, wl)
        if p[1] == "attention_3d":
            return (1, 0, 0, int(p[3]), 0, wl)
        if p[2] == "0":                     # the projection conv
            return (2, 0, 0, 0, 0, wl)
        if p[3] == "down_path":
            return (2, 1, 0, int(p[4]), int(p[6]), wl)
        if p[3] == "up_path":               # up before conv_block
            j = -1 if p[5] == "up" else int(p[7])
            return (2, 1, 1, int(p[4]), j, wl)
        if p[3] == "last":
            return (2, 1, 2, int(p[4]), 0, wl)
        raise KeyError(f"unranked LRNN param {name}")
    return sorted((k for k in sd if not k.endswith(bufs)), key=key)


def export_lion_state(momenta_sd: dict, names: list, lr: float,
                      weight_decay: float) -> dict:
    """lion_pytorch's optimizer state dict: one group, ``exp_avg`` per
    parameter index of ``names`` (none at the fixed index parameters);
    ``param_names`` rides along, which torch's ``load_state_dict``
    ignores."""
    state = {i: {"exp_avg": torch.from_numpy(
        np.ascontiguousarray(momenta_sd[n]))} for i, n in enumerate(names)
        if not n.endswith((".perm", ".perm_inv"))}
    return {"state": state,
            "param_groups": [{"lr": float(lr), "betas": (0.9, 0.99),
                              "weight_decay": float(weight_decay),
                              "params": list(range(len(names)))}],
            "param_names": list(names)}


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def export_torch_checkpoints(out_dir: str, model, stats=None, epoch: int = 0,
                             opt_momenta=None) -> list:
    """Write the reference's checkpoint set of ``model`` (a
    ``CWFAModel``): ``model_step_<s>__ep_<epoch>`` for s = 1 ..
    n_flow_steps + 1, the flow steps with their INN_state_dict and cond
    net, the last with the Encoder and its BatchNorm statistics.  "args" is
    an ``argparse.Namespace`` of ``model.cfg`` with the step's
    ``INN_down_steps`` (CWFA.py:485-486); "training_statistics" the six
    scalars of ``stats`` when given.

    opt_momenta: ``{"flow": [mu tree or None per step], "lrnn": mu tree or
    None}`` (JAX-keyed, ``Lion.state_tree()["0"]["mu"]``); a step with
    momenta gets an "optimizer_state_dict" in lion_pytorch's layout (the
    flow optimizer's for a flow step, the LRNN's for the last), the unused
    subnet halves' momenta as zeros; without, None, as the reference
    writes.  Returns the files written."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = model.cfg
    params, state = export_jax_params(model)
    nf = model.n_flow_steps
    momenta = opt_momenta or {}
    ts = None
    if stats is not None:
        ts = [torch.tensor(float(v)) for v in stats.astuple()]
    written = []
    for s in range(1, nf + 2):
        ix = s - 1
        opt_sd = None
        if ix < nf:
            spec = model.step_specs[ix]
            inn_np = export_graph_inn(spec, params["flow"][ix])
            inn_sd = _tensors(inn_np)
            cond_sd = _tensors(export_cond_network(params["cond"][ix]))
            mu = momenta.get("flow", [None] * nf)[ix]
            if mu is not None:
                opt_sd = export_lion_state(
                    export_graph_inn(spec, mu), graph_param_names(inn_np),
                    lr=cfg.learning_rate,
                    weight_decay=cfg.learning_weight_decay)
        else:
            inn_sd = None
            cond_np = export_lrnn(params["lrnn"], state["lrnn"])
            cond_sd = _tensors(cond_np)
            mu = momenta.get("lrnn")
            if mu is not None:
                opt_sd = export_lion_state(
                    export_lrnn(mu), lrnn_param_names(cond_np),
                    lr=cfg.learning_rate_first_step,
                    weight_decay=cfg.learning_weight_decay)
        path = os.path.join(out_dir, f"model_step_{s}__ep_{epoch}")
        torch.save({
            "epoch": epoch,
            "args": argparse.Namespace(**{**cfg.to_dict(),
                                          "INN_down_steps": s}),
            "INN_state_dict": inn_sd,
            "condition_state_dict": cond_sd,
            "optimizer_state_dict": opt_sd,
            "training_statistics": ts,
        }, path)
        written.append(path)
    return written
