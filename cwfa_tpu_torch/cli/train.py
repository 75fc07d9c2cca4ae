"""Training CLI, on one CUDA card — the reference ``python main.py``
(counterpart of ``cwfa_tpu/cli/train.py``; reference main.py:21-403).

    python -m cwfa_tpu_torch.cli.train --main_data_path <dir> [flags...]

Builds the leave-one-fish-out cross-validation groups over the fish
directories under ``--main_data_path`` (main.py:135-163), resolves each
split's frame indices by the reference's rules (``data/splits``, or the
first ``--max_samples`` frames), loads train / finetune-val / test, trains
the CWFA coarse to fine (``CWFATrainer.fit``: evaluation every
``--eval_every`` epochs with per-level PSNR / MAPE, the neuron-trace
correlation from each fish's ``Neural_activity_coordinates.csv``, volume
TIFF dumps, TensorBoard, checkpoints), prints the results table
(``finalize_results``) and screens the test frames for out-of-distribution
ones by their exact NLL (``detect_ood``).  The run directory is
``<output_testing_path>/<date>_<epochs>E_<prefix>_``.

The flags are those of ``python -m cwfa_tpu.cli.train``: every
``CWFAConfig`` field (integer-encoded learning rates included),
``--img_size`` and ``--max_samples``.  ``--INN_net_type 2`` trains,
evaluates and saves the XLFMNet baseline instead
(``engine/xlfmnet_train.run_xlfmnet``).  The run is on the card and raises
without one (``main``'s ``device`` keyword is for tests on the CPU).

``--mesh_data_axis D --mesh_space_axis S`` trains on a ``(data, space)``
mesh of D x S processes, one per GPU: each mini-batch's frames over
``data``, each frame's image rows over ``space`` (``torchrun
--nproc_per_node D*S -m cwfa_tpu_torch.cli.train --mesh_data_axis D
--mesh_space_axis S ...``, or ``CWFA_COORDINATOR`` / ``CWFA_NUM_PROCESSES``
/ ``CWFA_PROCESS_ID`` in each process: ``parallel.distributed``; the
trainer's ``mesh=``).  Rank 0 writes the run directory; the others write
nothing.  XLFMNet builds no mesh (as JAX): under a process group every rank
trains it whole and rank 0 writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
from datetime import datetime

import numpy as np
import torch

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data import splits
from cwfa_tpu_torch.data.dataset import (ConcatXLFMDataset, load_xlfm_data,
                                         read_lenslet_centers)
from cwfa_tpu_torch.data.tiff import count_tiff_pages
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.engine.metrics import read_neural_coordinates
from cwfa_tpu_torch.engine.ood import detect_ood
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.engine.xlfmnet_train import run_xlfmnet
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.parallel.distributed import cli_bootstrap, is_primary
from cwfa_tpu_torch.utils.seeding import set_all_seeds


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    for f in dataclasses.fields(CWFAConfig):
        name = f"--{f.name}"
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.default_factory is not dataclasses.MISSING:  # type: ignore
            default = f.default_factory()                 # type: ignore
        if isinstance(default, bool):
            p.add_argument(name, type=int, default=int(default))
        elif isinstance(default, (int, float, str)) or default is None:
            p.add_argument(name, type=type(default) if default is not None
                           else str, default=default)
        else:
            p.add_argument(name, nargs="*", type=float, default=list(default)
                           if isinstance(default, (tuple, list)) else default)
    p.add_argument("--img_size", type=int, default=2160,
                   help="camera frame side (reference psf_size_real)")
    p.add_argument("--max_samples", type=int, default=None)
    return p


def _count_frames(path: str) -> int:
    """Pages in the dataset's image stack (0 if missing or unreadable)."""
    try:
        return count_tiff_pages(
            os.path.join(path, "XLFM_image", "XLFM_image_stack.tif"))
    except (OSError, ValueError):
        return 0


def _filter_by_volumes(path: str, use: list) -> list:
    """Drop frame indices whose volume TIFF is missing (checked per index:
    volumes may be numbered from a non-zero window)."""
    vol_dir = os.path.join(path, "XLFM_stack")
    if not os.path.isdir(vol_dir):
        return use
    have = [i for i in use
            if glob.glob(os.path.join(vol_dir, f"*{i:03d}.tif"))]
    if not have:
        raise SystemExit(
            f"none of the requested frames {use[:5]}... have volumes "
            f"under {vol_dir} — deconvolve them first "
            "(python -m cwfa_tpu.cli.deconvolve)")
    if len(have) != len(use):
        print(f"warning: {len(use) - len(have)} requested frames have no "
              f"volume under {vol_dir} — skipped")
    return have


def cross_validation_groups(main_data_path: str, use_sparse: bool):
    """Leave-one-fish-out CV sets (reference main.py:135-163): fold i
    trains and validates on every fish but the i-th and tests on it;
    folds 30 + i train and validate on fish i alone and test on the first
    of its fold's training fish.  Returns (groups, {fish: data dir})."""
    datasets = sorted(os.path.basename(d.rstrip("/"))
                      for d in glob.glob(os.path.join(main_data_path, "*"))
                      if os.path.isdir(d))
    sub = "SLNet_preprocessed" if use_sparse else "raw"
    paths = {d: os.path.join(main_data_path, d, sub) for d in datasets}
    groups = {}
    for nn in range(len(datasets)):
        train = [d for i, d in enumerate(datasets) if i != nn]
        groups[nn] = {"train": train, "val": train, "test": [datasets[nn]]}
    for fish_ix, fish in enumerate(datasets):
        if groups.get(fish_ix, {}).get("train"):
            other = groups[fish_ix]["train"][0]
            groups[30 + fish_ix] = {"train": [fish], "val": [fish],
                                    "test": [other]}
    return groups, paths


def resolve_frame_indices(cfg: CWFAConfig, max_samples, groups: dict,
                          group: dict, cv: int):
    """(train, finetune-val, test) frame indices per fish (main.py:195-233,
    ``cwfa_tpu/cli/train.py:156-186``): ``max_samples`` frames from 0 for
    train and test and half as many for val; else the interleaved-stride
    train sampling and the eval windows from where it ends."""
    if max_samples:
        train_idx = list(range(int(max_samples)))
        return (train_idx, list(range(max(int(max_samples) // 2, 1))),
                train_idx)
    # the group-size rescale pair of folds >= 5 (main.py:195-196)
    group0 = groups.get(0, group)
    ratio = (len(group0["train"]), len(group["train"]))
    train_idx, window_start = splits.resolve_train(
        cfg.images_to_use, cv=cv, n_datasets=len(group["train"]),
        group_ratio=ratio)
    eval_idx = splits.resolve_eval_indices(
        cfg.images_to_use_fine_tune_val, window_start=window_start)
    test_idx = splits.resolve_eval_indices(
        cfg.images_to_use_test, n_datasets_test=len(group["test"]),
        group0_train_len=len(group0["train"]), window_start=window_start,
        rescale=True)
    return train_idx, eval_idx, test_idx


def _pretrain_path(cfg: CWFAConfig, cv: int) -> str:
    """``--pretrain_models_path``, or under ``--load_pretrained_networks``
    the newest run directory under ``pretrained_networks/`` whose name
    holds CV{cv}, else the newest one (``cwfa_tpu/cli/train.py:246-264``)."""
    if cfg.pretrain_models_path or not cfg.load_pretrained_networks:
        return cfg.pretrain_models_path
    runs_dir = "pretrained_networks"
    cands = sorted(d for d in glob.glob(os.path.join(runs_dir, "*"))
                   if os.path.isdir(d))
    tagged = [d for d in cands if f"CV{cv}" in os.path.basename(d)]
    pick = (tagged or cands)[-1:]
    if pick:
        print(f"load_pretrained_networks: using {pick[0]}")
        return pick[0]
    print(f"load_pretrained_networks: no runs under {runs_dir}/")
    return ""


def main(argv=None, device="cuda"):
    """Train, evaluate and screen as the flags say; prints the JAX CLI's
    lines and returns {tag: the last evaluation's results}."""
    args = build_parser().parse_args(argv)
    cfg = CWFAConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(CWFAConfig)
                        if hasattr(args, f.name)}).decode_lrs()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card")
    device, mesh = cli_bootstrap(device, "train", int(cfg.mesh_data_axis),
                                 int(cfg.mesh_space_axis),
                                 replicated=cfg.INN_net_type == 2)
    if cfg.INN_net_type == 0:
        print("warning: INN_net_type=0 (plain INN) is vestigial — "
              "training the CWF (type 1) architecture", flush=True)
    set_all_seeds(cfg.seed)

    groups, paths = cross_validation_groups(cfg.main_data_path,
                                            bool(cfg.use_sparse_for_all))
    # the fold index is a group key (main.py:181-187): 0..n-1 leave one
    # fish out, 30..30+n-1 single fish
    cv = int(cfg.cross_validation_nFold)
    if cv not in groups and groups:
        raise SystemExit(
            f"--cross_validation_nFold {cv} is not a valid fold; available "
            f"folds: {sorted(groups)} (0..n-1 leave-one-fish-out, "
            f"30..30+n-1 single-fish)")
    group = groups.get(cv, {"train": list(paths), "val": list(paths),
                            "test": list(paths)})
    img_shape = (args.img_size, args.img_size)
    vol_shape = (cfg.volume_side_size, cfg.volume_side_size, cfg.n_depths)

    def load_group(names, images):
        dss = []
        for name in names:
            n_avail = _count_frames(paths[name])
            use = splits.clamp_indices(images, n_avail) if n_avail else images
            use = _filter_by_volumes(paths[name], use)
            dss.append(load_xlfm_data(
                paths[name], cfg.lenslet_file, vol_shape=vol_shape,
                img_shape=img_shape, images_to_use=use,
                n_depths_to_fill=cfg.n_depths, ds_id=name,
                volume_ths=tuple(cfg.volume_ths),
                volume_quantiles=tuple(cfg.quantile_ths),
                img_ths=tuple(cfg.images_ths),
                norm=cfg.volume_norm_func))
        return ConcatXLFMDataset(*dss)

    train_idx, eval_idx, test_idx = resolve_frame_indices(
        cfg, args.max_samples, groups, group, cv)
    train_ds = load_group(group["train"], train_idx)
    # finetune-val frames come from the train fish unless
    # --evaluation_dataset test (main.py:293-294)
    val_src = group["train"] if cfg.evaluation_dataset == "train" \
        else group["test"]
    val_ds = load_group(val_src, eval_idx)
    test_ds = load_group(group["test"], test_idx)

    stats = train_ds.get_statistics()
    coords = read_lenslet_centers(cfg.lenslet_file) + 50
    vidx = make_view_indices(coords, img_shape,
                             (cfg.volume_side_size, cfg.volume_side_size))
    cfg = dataclasses.replace(cfg, n_lenslets=len(coords))
    # the run directory (main.py:165-168,356)
    prefix = cfg.evaluation_prefix or f"CV{cv}_{cfg.INN_z_temperature}T"
    cfg = dataclasses.replace(cfg, evaluation_prefix=prefix)
    marker = "test_set__" if cfg.evaluation_dataset == "test" else ""
    out = os.path.join(
        cfg.output_testing_path,
        f"{datetime.now().strftime('%Y_%m_%d__%H_%M_%S')}_{marker}"
        f"{cfg.epochs}E_{prefix}_")
    if not is_primary():
        # host-side artifacts (checkpoints, TensorBoard, TIFF dumps) are
        # rank 0's (cwfa_tpu/cli/train.py:213-216)
        out = None

    if cfg.INN_net_type == 2:
        # the XLFMNet baseline (main.py:99; the reference's switch never
        # constructs it, cwfa_tpu/cli/train.py:218-230)
        results = run_xlfmnet(cfg, train_ds, test_ds, stats, vidx,
                              output_path=out, device=device)
        for tag, res in results.items():
            if res["psnr"]:
                print(f"[{tag}] XLFMNet level-0 PSNR "
                      f"{np.mean([r[0] for r in res['psnr']]):.3f}")
        print(f"Saving directory: {out}")
        return results

    model = CWFAModel.build(cfg, torch.Generator().manual_seed(cfg.seed))
    trainer = CWFATrainer(model, stats, vidx, output_path=out, device=device,
                          mesh=mesh)
    counts = model.param_counts()
    print(f"nParameters: WF: {counts['WF']}\tOmega: {counts['Omega']}\t"
          f"LRNN: {counts['LRNN']}\t\ttotal: {sum(counts.values())}")
    pretrain_path = _pretrain_path(cfg, cv)
    if pretrain_path:
        loaded = trainer.load_checkpoints(
            pretrain_path, steps=list(cfg.fine_tune_load_checkpoints) or None)
        print(f"Loaded checkpoint steps: {loaded}")

    # per-fish neuron coordinates for the CC metric (main.py:343-347)
    neural_coords = {}
    for tag, names in (("train", group["train"]), ("val", group["val"]),
                       ("test", group["test"])):
        neural_coords[tag] = [
            read_neural_coordinates(csv_path) if os.path.exists(csv_path)
            else [] for csv_path in (
                os.path.join(paths[name], "Neural_activity_coordinates.csv")
                for name in names)]

    results = trainer.fit(train_ds, val_ds, test_ds, verbose=True,
                          neural_coords=neural_coords)
    trainer.finalize_results(results, output_posfix=prefix)
    for tag, res in results.items():
        if not res["times"]:
            print(f"[{tag}] no frames evaluated")
            continue
        psnr = np.mean([r[0] for r in res["psnr"]]) if res["psnr"] else 0
        print(f"[{tag}] level-0 PSNR {psnr:.3f}  mean time "
              f"{np.mean(res['times']):.4f}s  min {np.min(res['times']):.4f}s")

    ood = detect_ood(trainer, test_ds)
    print(f"OOD frames: {int(ood.is_ood.sum())}/{len(ood.is_ood)} "
          f"(threshold {ood.threshold} at step {ood.step_used})")
    print(f"Saving directory: {out}")
    return results


if __name__ == "__main__":
    main()
