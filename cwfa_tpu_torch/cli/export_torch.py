"""A directory of step checkpoints written as the reference's PyTorch
checkpoints (counterpart of ``cwfa_tpu/cli/export_torch.py``).

    python -m cwfa_tpu_torch.cli.export_torch \\
        --pretrain_models_path <msgpack checkpoint dir> --output_path <dir>

Reads the ``model_step_<s>__ep_<e>.msgpack`` files that the port's trainer
or the JAX package's writes (only those: a reference torch file beside them
is not picked), rebuilds the model from the checkpoints' own configuration,
and writes the reference's ``model_step_<s>__ep_<e>`` files
(``engine/torch_export``) with the statistics, the highest epoch found and
the Lion momenta each file carries, then prints each path.  Every pyramid
step must have a checkpoint: a step exported from a random init would load
into the reference without complaint and reconstruct garbage, so a missing
step exits.  A configuration whose ``INN_block_type`` is not CAT raises
ValueError before any weight is read or file written.

Loading a checkpoint needs no card, so this one entry point of the port
runs on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from cwfa_tpu_torch.engine import checkpoints
from cwfa_tpu_torch.engine.optim import make_optimizers
from cwfa_tpu_torch.engine.torch_convert import require_cat
from cwfa_tpu_torch.engine.torch_export import export_torch_checkpoints
from cwfa_tpu_torch.models.cwfa_model import CWFAModel


def _momenta(model, found: dict) -> dict:
    """{"flow": [mu or None per step], "lrnn": mu or None}: the Lion
    momenta of each step's file, where it has a state that fits the model's
    group (a state that does not is skipped, as in the JAX CLI)."""
    flow, _, lrnn = make_optimizers(model)
    nf = model.n_flow_steps
    out = {"flow": [None] * nf, "lrnn": None}
    for step, (_, fname) in found.items():
        payload, _, _ = checkpoints.load_step_checkpoint(fname)
        osd = payload.get("optimizer_state_dict")
        if not osd:
            continue
        ix = step - 1
        lion, tree = ((flow[ix], osd.get("flow")) if ix < nf
                      else (lrnn, osd))
        try:
            lion.load_state_tree(tree)
        except (KeyError, ValueError, TypeError):
            continue
        mu = lion.state_tree()["0"]["mu"]
        if ix < nf:
            out["flow"][ix] = mu
        else:
            out["lrnn"] = mu
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pretrain_models_path", required=True,
                   help="directory of .msgpack step checkpoints")
    p.add_argument("--output_path", required=True,
                   help="directory for the reference torch checkpoint set")
    p.add_argument("--max_test_load_epoch", type=int, default=25000,
                   help="epoch cap on checkpoint discovery")
    args = p.parse_args(argv)

    found = checkpoints.discover_checkpoints(
        args.pretrain_models_path, checkpoints.MSGPACK_GLOB,
        max_epoch=args.max_test_load_epoch)
    if not found:
        raise SystemExit(
            f"no .msgpack step checkpoints under {args.pretrain_models_path}")
    # the architecture from the first checkpoint's payload, as JAX picks it
    _, cfg, _ = checkpoints.load_step_checkpoint(sorted(found.values())[0][1])
    require_cat(cfg.INN_block_type, "export_torch")
    model = CWFAModel.build(cfg, torch.Generator().manual_seed(0))
    nf = model.n_flow_steps
    missing = [s for s in range(1, nf + 2) if s not in found]
    if missing:
        raise SystemExit(
            f"steps {missing} have no .msgpack checkpoint under "
            f"{args.pretrain_models_path} (found steps {sorted(found)}); "
            "exporting them would write random-init weights the reference "
            "strict-loads without complaint")
    stats, _ = checkpoints.load_model_checkpoints(
        model, args.pretrain_models_path, max_epoch=args.max_test_load_epoch)
    epoch = max(int(ep) for ep, _ in found.values())
    written = export_torch_checkpoints(args.output_path, model, stats=stats,
                                       epoch=epoch,
                                       opt_momenta=_momenta(model, found))
    for w in written:
        print(w)
    print(f"exported {len(written)} reference checkpoints (epoch {epoch}) "
          f"to {args.output_path}")
    return written


if __name__ == "__main__":
    main()
