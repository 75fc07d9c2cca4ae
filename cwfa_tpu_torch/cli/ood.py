"""OOD evaluation CLI, on one CUDA card (counterpart of
``cwfa_tpu/cli/ood.py``, the working equivalent of the reference's missing
``main_OOD.evaluate_OOD_prediction``, reference main.py:16,398-402).

    python -m cwfa_tpu_torch.cli.ood --main_data_path <dir> \
        --pretrain_models_path <ckpt_dir> [--finetune 1] [--report <json>]

Loads the test frames of the fold (``--max_samples`` frames a fish, 4 by
default), restores the checkpoints, scores every frame's forward NLL
(``detect_ood`` under the tag ``"train"``, which primes the GT pyramids the
finetune reads), writes the JSON report (threshold, step, scores, is_ood),
with ``--create_dist_plots`` a PNG of the score distribution beside it
(``<report>_dist.png``), and with ``--finetune`` adapts the steps of
``--fine_tune_optimize_steps`` to the flagged frames
(``finetune_on_novel``) and scores them again (``scores_after_finetune``,
``finetune_losses``).  Each volume is uploaded once across the three.

The flags are those of ``python -m cwfa_tpu.cli.ood``.  The run is on the
card and raises without one (``main``'s ``device`` keyword is for tests on
the CPU).  Under a process group (torchrun, or ``CWFA_DISTRIBUTED`` and the
``CWFA_*`` variables; ``parallel.distributed``) every rank scores all the
frames, as the JAX CLI builds no mesh, and rank 0 writes the report and the
PNG.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from cwfa_tpu_torch.cli.train import build_parser, cross_validation_groups
from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.dataset import (ConcatXLFMDataset, load_xlfm_data,
                                         read_lenslet_centers)
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.engine.ood import detect_ood, finetune_on_novel
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.parallel.distributed import cli_bootstrap, is_primary
from cwfa_tpu_torch.utils.plots import distributions_image
from cwfa_tpu_torch.utils.png import write_png


def main(argv=None, device="cuda"):
    """Score, report and optionally finetune as the flags say; prints the
    JAX CLI's lines and returns the report."""
    p = build_parser()
    p.add_argument("--finetune", type=int, default=0,
                   help="run the fast finetune loop on flagged frames")
    p.add_argument("--report", type=str, default="ood_report.json")
    args = p.parse_args(argv)
    cfg = CWFAConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(CWFAConfig)
                        if hasattr(args, f.name)}).decode_lrs()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the OOD screen runs on the card")
    device, _ = cli_bootstrap(device, "ood", replicated=True)
    primary = is_primary()

    groups, paths = cross_validation_groups(cfg.main_data_path,
                                            bool(cfg.use_sparse_for_all))
    # the fold index is a group key (see cli/train.py)
    cv = int(cfg.cross_validation_nFold)
    if cv not in groups and groups:
        raise SystemExit(
            f"--cross_validation_nFold {cv} is not a valid fold; "
            f"available folds: {sorted(groups)}")
    test_names = groups.get(cv, {"test": list(paths)})["test"]

    img_shape = (args.img_size, args.img_size)
    vol_shape = (cfg.volume_side_size, cfg.volume_side_size, cfg.n_depths)
    n_imgs = args.max_samples or 4
    ds = ConcatXLFMDataset(*[
        load_xlfm_data(paths[n], cfg.lenslet_file, vol_shape=vol_shape,
                       img_shape=img_shape,
                       images_to_use=list(range(int(n_imgs))),
                       n_depths_to_fill=cfg.n_depths, ds_id=n)
        for n in test_names])
    stats = ds.get_statistics()
    coords = read_lenslet_centers(cfg.lenslet_file) + 50
    cfg = dataclasses.replace(cfg, n_lenslets=len(coords))
    vidx = make_view_indices(coords, img_shape,
                             (cfg.volume_side_size, cfg.volume_side_size))

    model = CWFAModel.build(cfg, torch.Generator().manual_seed(cfg.seed))
    trainer = CWFATrainer(model, stats, vidx, device=device)
    if cfg.pretrain_models_path:
        trainer.load_checkpoints(cfg.pretrain_models_path)

    # tag "train": the detect pass primes the GT pyramids and NLLs under the
    # tag the finetune epochs read, so detect -> finetune -> re-score
    # uploads each volume once
    result = detect_ood(trainer, ds, tag="train")
    print(f"OOD: {int(result.is_ood.sum())}/{len(result.is_ood)} frames "
          f"flagged (NLL > {result.threshold} at step {result.step_used})")
    report = {
        "threshold": result.threshold,
        "step": result.step_used,
        "scores": result.scores.tolist(),
        "is_ood": result.is_ood.astype(int).tolist(),
    }

    if cfg.create_dist_plots and primary:
        in_dist = (result.scores[~result.is_ood]
                   if (~result.is_ood).any() else result.scores)
        out_png = os.path.splitext(args.report)[0] + "_dist.png"
        write_png(out_png, distributions_image(result.scores, in_dist))
        print(f"distribution plot: {out_png}")

    if args.finetune and result.is_ood.any():
        losses = finetune_on_novel(
            trainer, ds, optimize_steps=tuple(
                int(s) for s in cfg.fine_tune_optimize_steps),
            verbose=True, reuse_caches=True)
        report["finetune_losses"] = {str(k): v for k, v in losses.items()}
        post = detect_ood(trainer, ds, tag="train")
        report["scores_after_finetune"] = post.scores.tolist()
        print(f"after finetune: {int(post.is_ood.sum())} frames still OOD")

    if primary:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report: {args.report}")
    return report


if __name__ == "__main__":
    main()
