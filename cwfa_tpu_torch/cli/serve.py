"""Streaming reconstruction service CLI, on one CUDA card.

Reconstructs every XLFM camera frame in a directory (optionally watching it
for new files) into volume TIFFs, from a checkpoint directory of the JAX
package's format (``model_step_<s>__ep_<e>.msgpack`` and
``mean_vols_cache_ds_<i>.msgpack``, written by ``cwfa_tpu``'s trainer or by
``cwfa_tpu_torch.engine.checkpoints``):

  python -m cwfa_tpu_torch.cli.serve --pretrain_models_path runs/xyz \\
      --lenslet_file lenslets.txt --in_dir frames/ --out_dir volumes/ \\
      [--batch 8] [--watch 2.0] [--no_int8]

The flags are those of ``python -m cwfa_tpu.cli.serve`` (every
``CWFAConfig`` field, ``--img_size``, ``--in_dir``, ``--out_dir``,
``--batch``, ``--watch``, ``--limit``, ``--no_int8``), and so are the steps
(``cwfa_tpu/cli/serve.py:45-119``): statistics and mean-volume caches come
from the checkpoint directory, lenslet centers from ``--lenslet_file``
(+50, as the dataset applies), and unless ``--no_int8`` the UNet runs int8,
calibrated on the first two frames of ``--in_dir``.  Volumes are written as
``XLFM_stack_<frame id>.tif``; a JSON summary is printed at the end.

The service runs on the card and raises without one; there is no device
flag (``main``'s ``device`` keyword is for tests on the CPU).
``--mesh_data_axis N`` serves with N processes, one per GPU (``torchrun
--nproc_per_node N -m cwfa_tpu_torch.cli.serve --mesh_data_axis N ...``, or
the ``CWFA_*`` variables; ``parallel.distributed``): rank 0 lists the
directory and broadcasts the names, and each rank reads, reconstructs
(``--batch`` / N frames a call) and writes its own share of each batch
(``engine.serving.serve_directory(group=)``).  The int8 UNet is calibrated
on every rank on the two frames rank 0 read, and checked equal.  Each rank
prints its own summary.  ``--mesh_space_axis S`` splits each frame's image rows
over S ranks (``torchrun --nproc_per_node D*S -m cwfa_tpu_torch.cli.serve
--mesh_data_axis D --mesh_space_axis S ...``): the S ranks of a space group
reconstruct the same frames together (``XLFMReconstructor(mesh=,
split_batch=False)``, halo exchanges between them); the first of them reads
each file, hands its pages to the others and writes the volumes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from cwfa_tpu_torch.cli.train import build_parser as _train_parser
from cwfa_tpu_torch.config import CWFAConfig


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__, parents=[_train_parser()], add_help=False,
        conflict_handler="resolve",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-h", "--help", action="help")
    p.add_argument("--in_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--watch", type=float, default=0.0,
                   help="poll the input dir every N seconds (0 = one pass)")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--no_int8", action="store_true",
                   help="run the UNet in the compute dtype, not int8")
    return p


def build_reconstructor(args, device="cuda"):
    """The reconstructor of the CLI's flags ``args`` (parsed by
    ``build_parser``) on ``device``: the model from the checkpoint
    directory, its statistics and first mean-cache set, int8 UNet
    calibration unless ``--no_int8``.  Returns (reconstructor, frame
    shape).  With a mesh the reconstructor serves this rank's data index's
    own frames (``split_batch=False``), its image rows split over the space
    group, and its int8 packs are checked equal on every rank.  Exits with
    a message when the directory
    lacks statistics or mean caches, or when the mesh does not fit the
    processes (``parallel.distributed.cli_bootstrap``)."""
    from cwfa_tpu_torch.data.dataset import read_lenslet_centers
    from cwfa_tpu_torch.data.tiff import read_tiff_stack
    from cwfa_tpu_torch.data.views import make_view_indices
    from cwfa_tpu_torch.engine.checkpoints import (load_mean_caches,
                                                   load_model_checkpoints)
    from cwfa_tpu_torch.engine.inference import XLFMReconstructor
    from cwfa_tpu_torch.models.cwfa_model import CWFAModel
    from cwfa_tpu_torch.parallel.distributed import cli_bootstrap

    cfg = CWFAConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(CWFAConfig)
                        if hasattr(args, f.name)}).decode_lrs()
    if not cfg.pretrain_models_path:
        sys.exit("--pretrain_models_path (checkpoint dir) is required")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the service runs on the card")
    device, mesh = cli_bootstrap(device, "serve", int(cfg.mesh_data_axis),
                                 int(cfg.mesh_space_axis))

    coords = read_lenslet_centers(cfg.lenslet_file) + 50
    cfg = dataclasses.replace(cfg, n_lenslets=len(coords))
    img_shape = (args.img_size, args.img_size)
    side = cfg.volume_side_size
    vidx = make_view_indices(coords, img_shape, (side, side))

    model = CWFAModel.build(cfg, torch.Generator().manual_seed(cfg.seed))
    stats, _ = load_model_checkpoints(
        model, cfg.pretrain_models_path,
        max_epoch=int(cfg.max_test_load_epoch))
    if stats is None:
        sys.exit("checkpoint has no dataset statistics")
    caches = load_mean_caches(cfg.pretrain_models_path)
    if not caches:
        sys.exit("checkpoint has no mean-volume caches "
                 "(retrain or pass a dir saved with them)")
    mean_caches = next(iter(caches.values()))

    calib = None
    if not args.no_int8:
        if mesh is None or torch.distributed.get_rank() == 0:
            names = sorted(f for f in os.listdir(args.in_dir)
                           if f.endswith(".tif"))[:2]
            frames = [read_tiff_stack(os.path.join(args.in_dir, n))
                      for n in names]
            calib = np.stack([f[0] if f.ndim == 3 else f for f in frames]
                             ).astype(np.float32) if frames else None
        if mesh is not None:
            # every rank calibrates on the two frames rank 0 read
            box = [calib]
            torch.distributed.broadcast_object_list(box, src=0)
            calib = box[0]
        if calib is None:
            print("warning: no frames in --in_dir to calibrate int8 on; "
                  "serving with the UNet in the compute dtype. Pre-place a "
                  "couple of frames or pass --no_int8 to silence this.",
                  flush=True)
    recon = XLFMReconstructor(
        model, stats, vidx, mean_caches, device=device, deterministic=True,
        compute_dtype=(torch.bfloat16 if cfg.use_half_precision
                       else torch.float32),
        use_int8=calib is not None, calib_frames=calib, mesh=mesh,
        split_batch=False)
    return recon, img_shape


def main(argv=None, device="cuda"):
    """Serve ``--in_dir`` into ``--out_dir``; prints and returns the
    service's summary dict."""
    from cwfa_tpu_torch.engine.serving import serve_directory
    from cwfa_tpu_torch.parallel.mesh import space_group

    args = build_parser().parse_args(argv)
    recon, img_shape = build_reconstructor(args, device)
    # the mesh (which build_reconstructor checked) spans every process
    n, space = int(args.mesh_data_axis), int(args.mesh_space_axis)
    group = torch.distributed.group.WORLD if n * space > 1 else None
    recon.warmup(-(-args.batch // n), img_shape)   # serve_directory's calls
    out = serve_directory(recon, args.batch, img_shape, args.in_dir,
                          args.out_dir, poll_seconds=args.watch,
                          limit=args.limit or None, group=group,
                          space_group=(space_group(recon.mesh) if space > 1
                                       else None))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
