"""The JAX package's checkpoint directory, read and written by the port.

Counterpart of ``cwfa_tpu/engine/checkpoints.py:36-156`` and of the
trainer's ``save_checkpoints`` / ``load_checkpoints`` / mean-cache files
(``trainer.py:397-430,1144-1166,1227-1306``).  One msgpack file per pyramid
step, ``model_step_<s>__ep_<e>.msgpack``, holding {"epoch", "args" (the
step's ``CWFAConfig`` as JSON), "INN_state_dict", "condition_state_dict",
"optimizer_state_dict", "model_state_dict", "training_statistics"}, and one
``mean_vols_cache_ds_<i>.msgpack`` per dataset, ``{"0": level 0, ...}``.
The trees are JAX-keyed (``engine/jax_params``) with lists as
``{"0": ...}`` maps, so a directory written by either package loads in the
other.  The codec is ``engine/msgpack_io``.

Step convention (``restore_params_from_payloads``): file step s fills flow
step and cond net s-1; a step s > n_flow_steps fills the LRNN from its
"condition_state_dict" and the UNet BatchNorm statistics from its
"model_state_dict"; a step missing from the directory keeps the model's
weights as they are.  The optimizer state is optax's Lion state in the
JAX trainer's layout (``engine/optim.Lion.state_tree``): for a flow step
{"flow": ..., "cond": ...}, for the LRNN step the LRNN's; the JAX trainer
resumes from the port's files and the port from JAX's.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.stats import DatasetStatistics
from cwfa_tpu_torch.engine.jax_params import (export_jax_params,
                                              load_jax_params)
from cwfa_tpu_torch.engine.msgpack_io import packb, to_state_dict, unpackb


def _write_atomic(fname: str, data: bytes):
    """Publish through a dot-prefixed temp file, so a crash mid-write
    leaves no partial file that discovery's glob could pick."""
    tmp = os.path.join(os.path.dirname(fname),
                       "." + os.path.basename(fname) + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, fname)


def save_step_checkpoint(path: str, step: int, epoch: int, cfg: CWFAConfig,
                         inn_params=None, cond_params=None,
                         train_statistics: DatasetStatistics | None = None,
                         model_state=None, opt_state=None,
                         prefix: str = "model_step_") -> str:
    """Write ``<path>/<prefix><step>__ep_<epoch>.msgpack``.  The trees
    are JAX-keyed (nested dicts and lists of numpy arrays); "args" is the
    JSON of ``cfg.to_dict()``, which ``CWFAConfig.from_dict`` of either
    package reads; ``opt_state`` None writes an empty optimizer state, which
    both packages read as absent.  A model other than the CWFA (the XLFMNet
    baseline) takes its own ``prefix``, so that the CWFA's discovery never
    maps its file onto a flow step.  Returns the file name."""
    os.makedirs(path, exist_ok=True)

    def tree(t):
        return to_state_dict(t) if t is not None else {}

    payload = {
        "epoch": epoch,
        "args": json.dumps(cfg.to_dict()),
        "INN_state_dict": tree(inn_params),
        "condition_state_dict": tree(cond_params),
        "optimizer_state_dict": tree(opt_state),
        "model_state_dict": tree(model_state),
        "training_statistics": (list(train_statistics.astuple())
                                if train_statistics is not None else []),
    }
    fname = os.path.join(path, f"{prefix}{step}__ep_{epoch}.msgpack")
    _write_atomic(fname, packb(payload))
    return fname


def discover_checkpoints(path: str, prefix: str = "model_step_*__ep_*",
                         max_epoch: int | None = None) -> dict:
    """The highest-epoch file per step among those matching the glob
    ``prefix`` (reference load_INN_steps, networks.py:732-756):
    {step: (epoch, filename)}.  Epochs above ``max_epoch`` are ignored, and
    so is a CWFA step below 1 (flow steps are 1-based; another family's
    prefix, ``xlfmnet_step_*``, keeps its step 0).  The default glob
    matches both formats; ``MSGPACK_GLOB`` and ``TORCH_GLOB`` one each."""
    best = {}
    for m in glob.glob(os.path.join(path, prefix)):
        nums = re.findall(r"\d+", os.path.basename(m))
        if len(nums) < 2:
            continue
        step, ep = int(nums[0]), int(nums[1])
        if step < 1 and prefix.startswith("model_step_"):
            continue
        if max_epoch is not None and ep > max_epoch:
            continue
        if step not in best or ep > best[step][0]:
            best[step] = (ep, m)
    return best


# the port's and the JAX package's files; the reference's torch files,
# whose names end in the epoch's digits
MSGPACK_GLOB = "model_step_*__ep_*.msgpack"
TORCH_GLOB = "model_step_*__ep_*[0-9]"


def load_step_checkpoint(fname: str):
    """(payload, the step's CWFAConfig, DatasetStatistics or None)."""
    with open(fname, "rb") as f:
        payload = unpackb(f.read())
    cfg = CWFAConfig.from_dict(json.loads(payload["args"]))
    stats = None
    ts = payload.get("training_statistics")
    if ts is not None and len(ts) == 6:
        stats = DatasetStatistics(*[float(t) for t in ts])
    return payload, cfg, stats


def _opt_state(optimizers, step: int, is_lrnn: bool):
    if optimizers is None:
        return None
    flow, cond, lrnn = optimizers
    if is_lrnn:
        return lrnn.state_tree()
    return {"flow": flow[step].state_tree(), "cond": cond[step].state_tree()}


def save_model_checkpoints(model, path: str, epoch: int,
                           stats: DatasetStatistics, optimizers=None) -> list:
    """The files of the JAX trainer's ``save_checkpoints`` for ``model``:
    steps 1..INN_max_down_steps, each with its flow step and cond net, the
    step past the last flow step with the LRNN and its BatchNorm
    statistics; each with the step's config and ``stats``, and with
    ``optimizers`` ((flow Lions, cond Lions, LRNN Lion) of
    ``engine/optim.make_optimizers``) their Lion state."""
    params, state = export_jax_params(model)
    cfg, nf = model.cfg, model.n_flow_steps
    written = []
    for step in range(cfg.INN_max_down_steps):
        is_lrnn = step >= nf
        written.append(save_step_checkpoint(
            path, step + 1, epoch, cfg.step_config(step),
            inn_params=None if is_lrnn else params["flow"][step],
            cond_params=params["lrnn"] if is_lrnn else params["cond"][step],
            model_state=state["lrnn"] if is_lrnn else None,
            opt_state=_opt_state(optimizers, step, is_lrnn),
            train_statistics=stats))
    return written


def load_model_checkpoints(model, path: str, max_epoch: int | None = None,
                           optimizers=None, steps=None, configs=None):
    """Fill ``model`` in place from the highest-epoch ``.msgpack`` file of
    each step in ``path`` (a reference torch file beside them is not
    read; epochs above ``max_epoch`` ignored; only the file steps in
    ``steps``, where given), by the convention of the module docstring,
    and with ``optimizers`` ((flow Lions, cond Lions, LRNN Lion)) their
    Lion state where a file has one.  ``configs``, where a dict is given,
    receives {step: the step's CWFAConfig}.  Returns (the first statistics
    found in step order or None, the steps loaded).  Raises KeyError /
    ValueError when a file's tree does not fit the model (a key left over
    or missing, a shape that differs)."""
    nf = model.n_flow_steps
    params, state = (to_state_dict(t) for t in export_jax_params(model))
    stats, loaded, opts = None, [], []
    found = discover_checkpoints(path, MSGPACK_GLOB, max_epoch=max_epoch)
    for step, (_, fname) in sorted(found.items()):
        if steps is not None and step not in steps:
            continue
        payload, cfg, st = load_step_checkpoint(fname)
        if configs is not None:
            configs[step] = cfg
        stats = stats or st
        ix = step - 1
        if ix < nf and payload["INN_state_dict"]:
            params["flow"][str(ix)] = payload["INN_state_dict"]
        if payload["condition_state_dict"]:
            if ix >= nf:
                params["lrnn"] = payload["condition_state_dict"]
            else:
                params["cond"][str(ix)] = payload["condition_state_dict"]
        if payload.get("model_state_dict") and ix >= nf:
            state = {"lrnn": payload["model_state_dict"]}
        opt = payload.get("optimizer_state_dict")
        if optimizers is not None and opt:
            flow, cond, lrnn = optimizers
            if ix >= nf:
                opts.append((lrnn, opt))
            else:
                opts += [(flow[ix], opt["flow"]), (cond[ix], opt["cond"])]
        loaded.append(step)
    load_jax_params(model, params, state)
    for lion, tree in opts:
        lion.load_state_tree(tree)
    return stats, loaded


def save_mean_caches(path: str, mean_caches: dict) -> list:
    """``mean_vols_cache_ds_<i>.msgpack`` = {"0": level 0, ...} for each
    dataset i of ``mean_caches`` ({i: [level arrays]}).  Returns the files."""
    os.makedirs(path, exist_ok=True)
    written = []
    for di, caches in mean_caches.items():
        fname = os.path.join(path, f"mean_vols_cache_ds_{di}.msgpack")
        _write_atomic(fname, packb({str(i): np.asarray(c)
                                    for i, c in enumerate(caches)}))
        written.append(fname)
    return written


def load_mean_caches(path: str) -> dict:
    """{dataset i: [level arrays]} of every ``mean_vols_cache_ds_*.msgpack``
    in ``path``, in the sorted order of the file names."""
    out = {}
    for fname in sorted(glob.glob(
            os.path.join(path, "mean_vols_cache_ds_*.msgpack"))):
        di = int(re.findall(r"ds_(\d+)", os.path.basename(fname))[0])
        with open(fname, "rb") as f:
            payload = unpackb(f.read())
        out[di] = [payload[str(i)] for i in range(len(payload))]
    return out
