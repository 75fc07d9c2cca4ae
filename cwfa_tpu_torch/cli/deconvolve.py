"""Dataset deconvolution CLI, on one CUDA card — the reference
``main_deconvolve_dataset.py`` (counterpart of
``cwfa_tpu/cli/deconvolve.py``; reference main_deconvolve_dataset.py:21-109).

Richardson–Lucy-deconvolves a dataset's XLFM camera frames into per-frame
volume TIFFs, the GT volumes of training:

    python -m cwfa_tpu_torch.cli.deconvolve --data_folder <fish_dir> \
        --psf_file <psf.tif> [--n_it 50 --n_depths 120 --vol_xy_size 600]

writes ``<data_folder>/XLFM_stack_<date><posfix>/XLFM_stack_NNN.tif`` (one
(n_depths, vol, vol) float32 volume per frame), ``arguments.txt`` and
``preview_MIP.tif`` (the last volume's projections).  Frames stream from
``XLFM_image/XLFM_image_stack.tif`` through a background decode thread;
where that stream cannot start, the frames are read through
``XLFMDataset`` instead (a decode error mid-stream propagates).

The flags are those of ``python -m cwfa_tpu.cli.deconvolve``.  The run is on
the card and raises without one (``main``'s ``device`` keyword is for tests
on the CPU).  ``--mesh_depth_axis N`` splits the depths over N processes,
one per GPU (``torchrun --nproc_per_node N -m cwfa_tpu_torch.cli.deconvolve
--mesh_depth_axis N ...``, or the ``CWFA_*`` variables;
``parallel.distributed``): each builds the OTF of its n_depths / N depths,
each iteration all-reduces the projection's spectrum
(``ops.deconv.xlfm_deconvolve_sharded``), and rank 0 gathers each volume
and writes the files.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np
import torch

from cwfa_tpu_torch.data.dataset import (XLFMDataset, _center_crop_img,
                                         _pad_to_square_img)
from cwfa_tpu_torch.data.psf import load_psf_otf
from cwfa_tpu_torch.data.tiff import read_tiff_stack, write_tiff_stack
from cwfa_tpu_torch.ops.deconv import (gather_depths, xlfm_deconvolve,
                                       xlfm_deconvolve_sharded)
from cwfa_tpu_torch.parallel.distributed import cli_bootstrap, is_primary
from cwfa_tpu_torch.utils.projections import volume_2_projections


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_folder", required=True)
    p.add_argument("--psf_file", required=True)
    p.add_argument("--bkg_file", default="")
    p.add_argument("--lenslet_file", default="")
    p.add_argument("--images_to_use", nargs="+", type=int, default=[0, 1])
    p.add_argument("--n_it", type=int, default=50)
    p.add_argument("--posfix", type=str, default="")
    p.add_argument("--n_depths", type=int, default=241 // 2)
    p.add_argument("--vol_xy_size", type=int, default=600)
    p.add_argument("--n_split_fourier", type=int, default=1,
                   help="depth chunking for the FFTs (1 = all at once)")
    p.add_argument("--dark_current", type=int, default=0,
                   help="constant camera offset subtracted with the "
                        "background (the reference accepts this flag but "
                        "never consumes it — main_deconvolve_dataset.py:35; "
                        "honored here as the evident intent)")
    p.add_argument("--main_gpu", nargs="+", type=int, default=[0],
                   help="accepted for reference CLI compatibility; the run "
                        "is on the current CUDA device")
    p.add_argument("--img_size", type=int, default=2160)
    p.add_argument("--mesh_depth_axis", type=int, default=1,
                   help="split the RL depths over N processes, one per GPU "
                        "(the depth sum is one all-reduce an iteration); "
                        "N must divide --n_depths; 1 = one device")
    return p


def _frames(args, lenslet: str):
    """(page index, preprocessed (img, img) float32 frame) of each requested
    page: the native prefetcher decodes frame n + 1 while the card
    deconvolves frame n.  The dataset path serves only when the stream
    cannot start; a failure mid-stream propagates."""
    try:
        from cwfa_tpu_torch.data.native_tiff import PrefetchingTiffReader
        path = os.path.join(args.data_folder, "XLFM_image",
                            "XLFM_image_stack.tif")
        it = PrefetchingTiffReader(path, pages=list(args.images_to_use))
    except (OSError, RuntimeError, ValueError):
        # the library does not build, or the file does not open as a TIFF
        it = None
    if it is not None:
        with it:
            for page_ix, frame in it:
                # XLFMDataset's hygiene (reference XLFMDataset.py:101-104):
                # a NaN / Inf would NaN the first RL ratio and freeze the
                # volume at the ones init
                im = np.clip(np.nan_to_num(frame.astype(np.float32)), 0,
                             50000)
                yield page_ix, _center_crop_img(
                    _pad_to_square_img(im), (args.img_size, args.img_size))
        return
    ds = XLFMDataset(args.data_folder, lenslet,
                     img_shape=(args.img_size, args.img_size),
                     images_to_use=args.images_to_use, load_vols=False)
    # the dataset keeps the requested pages that exist, in order
    for pos, img_ix in enumerate(ds.images_to_use):
        yield img_ix, ds.stacked_views[pos]


def main(argv=None, device="cuda"):
    """Deconvolve the requested frames; returns the output directory."""
    args = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: deconvolution runs on the card")
    n_shards = int(args.mesh_depth_axis)
    if args.n_depths % n_shards:
        raise SystemExit(f"--mesh_depth_axis {n_shards} must divide "
                         f"--n_depths {args.n_depths}")
    device, mesh = cli_bootstrap(device, "deconvolve", n_data=n_shards,
                                 flag="--mesh_depth_axis")
    primary = is_primary()

    stack_path = os.path.join(
        args.data_folder,
        "XLFM_stack_" + datetime.now().strftime("%Y_%m_%d__%H_%M_%S")
        + args.posfix)
    if mesh is not None:
        # rank 0's clock names the directory
        box = [stack_path]
        torch.distributed.broadcast_object_list(box, src=0)
        stack_path = box[0]
    if primary:
        os.makedirs(stack_path, exist_ok=True)

    lenslet = args.lenslet_file or os.path.join(
        os.path.dirname(args.data_folder.rstrip("/")),
        "lenslet_centers_python.txt")
    vol_shape = (args.vol_xy_size, args.vol_xy_size, args.n_depths)
    depths = None
    if mesh is not None:
        d_local = args.n_depths // n_shards
        r = torch.distributed.get_rank()
        depths = slice(r * d_local, (r + 1) * d_local)
        print(f"deconvolving depth-sharded over {n_shards} processes",
              flush=True)
        if args.n_split_fourier != 1:
            print("warning: --n_split_fourier is ignored on the sharded "
                  "path (each shard FFTs its n_depths/N slice at once; "
                  "the mesh factor itself divides the working set)",
                  flush=True)
    otf, _, full_hw = load_psf_otf(args.psf_file, vol_shape, device=device,
                                   depths=depths)

    background = float(args.dark_current)
    if args.bkg_file:
        bkg = read_tiff_stack(args.bkg_file).mean(axis=0).astype(np.float32)
        background = _center_crop_img(
            bkg, (args.img_size, args.img_size)) + args.dark_current

    if primary:
        with open(os.path.join(stack_path, "arguments.txt"), "w") as f:
            f.write(str(vars(args)))

    depth_chunk = (None if args.n_split_fourier == 1
                   else max(args.n_depths // args.n_split_fourier, 1))
    last_vol = None
    for img_ix, frame in _frames(args, lenslet):
        views = torch.from_numpy(
            np.asarray(frame[None, None] - background, np.float32)).to(device)
        obj_hw = (args.vol_xy_size, args.vol_xy_size)
        roi = min(90, args.n_depths)
        if mesh is not None:
            vol, _ = xlfm_deconvolve_sharded(otf, views, n_iter=args.n_it,
                                             obj_hw=obj_hw, roi_depths=roi,
                                             full_hw=full_hw)
            vol = gather_depths(vol)
        else:
            vol, _ = xlfm_deconvolve(
                otf, views, n_iter=args.n_it, obj_hw=obj_hw, roi_depths=roi,
                depth_chunk=depth_chunk, full_hw=full_hw)
        last_vol = vol[0].cpu().numpy()
        if not primary:
            continue
        write_tiff_stack(
            os.path.join(stack_path, f"XLFM_stack_{img_ix:03d}.tif"), last_vol)
        print(f"deconvolved frame {img_ix} -> "
              f"{stack_path}/XLFM_stack_{img_ix:03d}.tif")

    if last_vol is not None and primary:
        mip = volume_2_projections(last_vol[None])[0]
        write_tiff_stack(os.path.join(stack_path, "preview_MIP.tif"), mip)
    print(f"Output path: {stack_path}")
    return stack_path


if __name__ == "__main__":
    main()
