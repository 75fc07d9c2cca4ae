"""Training, evaluation and checkpoints of the XLFMNet baseline
(``--INN_net_type 2``; counterpart of ``cwfa_tpu/engine/xlfmnet_train.py``).

The reference keeps XLFMNet as the SLNet_XLFMNet predecessor model
(networks.py:758-787) and never constructs it; as in the JAX package, a
supervised trainer (views -> volume regression with the first-step loss
menu) makes it a working baseline.

- Minibatches follow the JAX trainer's ``np.random.RandomState(seed)``
  permutation stream, so both packages see the same batches.
- The optimizer is Lion with weight decay 1e-3 on every parameter: JAX calls
  ``optax.lion(lr, b1=0.9, b2=0.99)`` with no mask, and optax's Lion
  defaults ``weight_decay=1e-3``; the decay reaches the BatchNorm scales
  and biases too.  One ``engine/optim.Lion`` group, f32.
- The checkpoint is the JAX package's ``xlfmnet_step_0__ep_<epochs-1>.msgpack``
  (own prefix, so the CWFA's discovery never maps it onto a flow step) with
  the parameters as "condition_state_dict" and the BatchNorm statistics as
  "model_state_dict"; each activation site without a parameter is an empty
  map, as JAX's tree has it, so the file loads in either package.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from cwfa_tpu_torch.data.views import extract_views
from cwfa_tpu_torch.engine import checkpoints
from cwfa_tpu_torch.engine import losses as L
from cwfa_tpu_torch.engine.jax_params import export_jax_params, load_jax_params
from cwfa_tpu_torch.engine.metrics import compute_step_performance
from cwfa_tpu_torch.engine.optim import Lion
from cwfa_tpu_torch.models.unet import UNetSpec
from cwfa_tpu_torch.models.xlfmnet import XLFMNet, XLFMNetSpec
from cwfa_tpu_torch.nn import reset_parameters_

# optax.lion's default weight decay, which the JAX trainer takes unmasked
LION_WEIGHT_DECAY = 1e-3
CHECKPOINT_PREFIX = "xlfmnet_step_"
_PARAMLESS_ACTS = (nn.ELU, nn.LeakyReLU, nn.Softplus)


def build_xlfmnet_spec(cfg) -> XLFMNetSpec:
    """The CLI baseline's spec from a ``CWFAConfig`` (``:122-143``), shared
    by ``run_xlfmnet`` and ``load_xlfmnet``.  The UNet depth is capped so a
    small volume keeps >= 2 px at the bottleneck (the flagship's 512 keeps
    5); dropout 0 (``models/xlfmnet.py``)."""
    depth = max(1, min(5, int(np.log2(max(cfg.volume_side_size, 4))) - 2))
    return XLFMNetSpec(
        in_views=cfg.n_lenslets, out_depths=cfg.n_depths,
        unet=UNetSpec(in_channels=cfg.n_depths, n_classes=cfg.n_depths,
                      depth=depth, wf=6, batch_norm=True,
                      skip_conn=False, drop_out=0.0, activation="elu"))


def build_xlfmnet(spec: XLFMNetSpec, generator: torch.Generator) -> XLFMNet:
    """A randomly initialized XLFMNet on the CPU (torch's default conv
    init, drawn from ``generator``), in eval mode."""
    model = XLFMNet(spec)
    reset_parameters_(model, generator)
    return model.eval()


def train_xlfmnet(spec: XLFMNetSpec, views, gt_volumes, n_steps: int = 100,
                  learning_rate: float = 1e-4, loss_kind: str = "L2",
                  seed: int = 0, batch_size: int = 1, model=None,
                  device="cuda"):
    """Minibatch training (``train_xlfmnet``, ``:87-119``): views (N, V, H,
    W) and gt_volumes (N, D, H, W) on the host, ``batch_size`` frames a step
    in the order of ``np.random.RandomState(seed)``'s permutations (the
    tail wraps around), the loss ``recon_loss(loss_kind)``, Lion.  ``model``
    starts from its weights where given (moved to ``device``), else from a
    seeded init.  The BatchNorm running statistics move at every step.
    Returns (model in eval mode, losses)."""
    if model is None:
        model = build_xlfmnet(spec, torch.Generator().manual_seed(seed))
    model = model.to(device)
    lion = Lion(model, learning_rate, weight_decay=LION_WEIGHT_DECAY)
    model.train()
    losses = []
    n = views.shape[0]
    bs = max(1, min(int(batch_size), n))
    rng = np.random.RandomState(seed)
    order: list = []
    for _ in range(n_steps):
        while len(order) < bs:
            order.extend(rng.permutation(n).tolist())
        ixs = np.asarray(order[:bs])
        del order[:bs]
        v = torch.as_tensor(views[ixs]).to(device)
        g = torch.as_tensor(gt_volumes[ixs]).to(device)
        lion.zero_grad()
        loss = L.recon_loss(loss_kind, g, model(v, train=True))
        loss.backward()
        lion.step()
        losses.append(float(loss.detach()))
    return model.eval(), losses


def xlfmnet_trees(model: XLFMNet):
    """The model as the JAX package's (params, state) trees of numpy
    arrays, each activation site without a parameter an empty map."""
    params, state = export_jax_params(model)
    for name, m in model.named_modules():
        if isinstance(m, _PARAMLESS_ACTS):
            *parents, leaf = name.split(".")
            node = params
            for part in parents:
                node = node[int(part)] if isinstance(node, list) else node[part]
            node[leaf] = {}
    return params, state


def load_xlfmnet(path: str, device="cuda"):
    """The newest ``xlfmnet_step_*`` checkpoint of a run directory
    (``load_xlfmnet``, ``:146-168``; the highest step).  Returns (model in
    eval mode on ``device``, cfg, stats)."""
    found = checkpoints.discover_checkpoints(path,
                                             CHECKPOINT_PREFIX + "*__ep_*")
    if not found:
        raise FileNotFoundError(f"no xlfmnet_step_* checkpoint in {path!r}")
    _, fname = found[max(found)]
    payload, cfg, stats = checkpoints.load_step_checkpoint(fname)
    model = XLFMNet(build_xlfmnet_spec(cfg))
    state = payload.get("model_state_dict") or export_jax_params(model)[1]
    load_jax_params(model, payload["condition_state_dict"], state)
    return model.to(device).eval(), cfg, stats


def _stack_norm(ds, stats, view_indices, device, chunk: int = 8):
    """Host-resident normalized (views, volumes) of every frame of ``ds``;
    the camera frames go through the card ``chunk`` at a time."""
    views, vols = [], []
    for ix in range(len(ds)):
        di, li = ds.locate(ix)
        d = ds.datasets[di]
        views.append(np.asarray(d.stacked_views[li]))
        vols.append((np.asarray(d.vols[li], np.float32) - stats.mean_vols)
                    / stats.std_vols)
    out = []
    for i in range(0, len(views), chunk):
        raw = torch.as_tensor(np.stack(views[i:i + chunk])).to(device)
        v = (extract_views(raw, view_indices) - stats.mean_imgs) \
            / stats.std_imgs
        out.append(v.cpu().numpy())
    return np.concatenate(out), np.stack(vols)


@torch.inference_mode()
def _predict(model, views, bs: int, device):
    return np.concatenate([
        model(torch.as_tensor(views[i:i + bs]).to(device)).cpu().numpy()
        for i in range(0, len(views), bs)])


def run_xlfmnet(cfg, train_ds, test_ds, stats, view_indices,
                output_path: str | None = None, verbose: bool = True,
                device="cuda"):
    """The ``--INN_net_type 2`` run of the training CLI (``run_xlfmnet``,
    ``:171-267``): train on ``train_ds`` for ``epochs x len // batch_size``
    steps at ``learning_rate_first_step`` with ``loss_func_first_step``,
    then evaluate train and test with the CWFA evaluation's
    un-normalization (``compute_step_performance`` at level 0; one warm-up
    forward outside the clock, the seconds per frame on the host clock),
    and save the checkpoint to ``output_path`` when given.  Returns the
    ``{tag: results}`` shape of ``CWFATrainer.fit`` (psnr / MAPE / times;
    nll empty: no likelihood model)."""
    device = torch.device(device)
    spec = build_xlfmnet_spec(cfg)
    views_n, vols_n = _stack_norm(train_ds, stats, view_indices, device)
    bs = max(1, min(int(cfg.batch_size), len(train_ds)))
    n_steps = max(int(cfg.epochs), 1) * max(len(train_ds) // bs, 1)
    model, losses = train_xlfmnet(
        spec, views_n, vols_n, n_steps=n_steps, batch_size=bs,
        learning_rate=cfg.learning_rate_first_step,
        loss_kind=cfg.loss_func_first_step, seed=cfg.seed, device=device)
    if verbose:
        print(f"XLFMNet: {n_steps} steps, loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}")
    warmed = False
    results = {}
    for tag, ds in (("train", train_ds), ("test", test_ds)):
        res = {"psnr": [], "MAPE": [], "times": [], "nll": [],
               "volumes_pred": [], "volumes_gt": [], "CC": None,
               "projections_gt": [], "projections_predicted": []}
        if ds is not None and len(ds):
            tv, tg = ((views_n, vols_n) if ds is train_ds
                      else _stack_norm(ds, stats, view_indices, device))
            bs = max(int(cfg.batch_size), 1)
            if not warmed:
                _predict(model, tv[:bs], bs, device)
                warmed = True
            t0 = time.perf_counter()
            pred = _predict(model, tv, bs, device)
            dt = (time.perf_counter() - t0) / len(ds)
            for j in range(len(ds)):
                p, m, _, _ = compute_step_performance(
                    tg[j:j + 1], pred[j:j + 1], 0, stats.mean_vols,
                    stats.std_vols)
                res["psnr"].append([p])
                res["MAPE"].append([m])
                res["times"].append(dt)
        results[tag] = res
    if output_path:
        params, state = xlfmnet_trees(model)
        checkpoints.save_step_checkpoint(
            output_path, step=0, epoch=max(int(cfg.epochs), 1) - 1, cfg=cfg,
            cond_params=params, model_state=state, prefix=CHECKPOINT_PREFIX)
    return results
