"""Smoke test of the PyTorch/CUDA port (``cwfa_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                      # the whole check
    python3 chip_smoke.py tower cond_pair      # phases alone (kernels,
                                               # tower, cond_pair, float_tower,
                                               # probes, serving, train,
                                               # train_cli, ood_cli, deconv,
                                               # torch_ckpt, xlfmnet, blocks,
                                               # parallel, int8_cond)
                                               # while working on one: no
                                               # verdict

Builds the CUDA kernels from ``cwfa_tpu_torch/csrc/``, then, failing (exit
code != 0) on the first phase that does not hold:

1. prints the card's name and power limit and the kernel build time;
2. holds each flow kernel against its plain PyTorch version on the card, at
   the main path's shapes, in f32 and bf16, for every clamp activation, and
   times both (CUDA events);
3. holds the int8 tower kernel (``fused_tower``) to its plain version,
   equal to the bit, at each flagship step's shape (B 1, 512^2, Cin
   48/24/12/6, 64 wide, Nout 2*Cin), at step 0's shape at batch 8, at two
   odd shapes and at three more tower widths (20, 72, 128), in f32 and bf16
   output, a 64-wide tower through both instances (s8 wgmma; __dp4a when
   asked for), logging the instance of every launch (each must have run);
   times the wgmma instance at every batch-1 step shape and the __dp4a
   instance and the plain version beside it at step 0;
4. holds the cond nets' 3-D pair kernel (``cond_pair``) against its plain
   version at each flagship step's depth (1, D, 512, 512), D = 48/24/12/6,
   at step 0's shape at batch 8 and at two odd shapes, in f32 (CUDA cores)
   and bf16 (both instances: tensor cores; CUDA cores when asked for), and
   times both at step 0 beside the plain version and the two cuDNN
   ``Conv3d`` modules the kernel replaces;
5. holds the float tower kernel (``fused_float_tower``) against its plain
   version at every flagship tower shape (coupling Cin -> 2*Cin and input
   Cin -> Cin, Cin 48/24/12/6, 64 wide), at step 0 at batch 8, at two odd
   shapes (64 and 8 wide), at tower widths 20, 72 and 128 and at Cin 65,
   72 and 128 (64 wide; 512^2 and odd sizes), in f32 and bf16, logging the
   instance that ran (wgmma bf16, wgmma 3xTF32 for f32, CUDA cores for
   every other width; each must have run), and times both wgmma instances
   at every batch-1 shape, with the plain versions, the cuDNN module chain
   the bf16 one replaces and the f32 instance's two bounds (f32 FMAs, 3 x
   TF32) at step 0, and at Cin above 64 in turns with the CUDA-core
   instance;
6. runs the small rig through ``XLFMReconstructor`` on the card (kernels)
   and on the CPU (plain versions), in f32, deterministic and in the
   default mode (``deterministic=False``; drop rates 0, so that nothing is
   drawn), and compares; then the same in int8 (``use_int8`` +
   ``use_int8_towers``);
7. runs the flagship configuration (2160^2 frames, 29 views of 512^2,
   512x512x96 volumes, 4 CAT steps x 4 blocks, 64-wide towers, random
   weights from a seed) in bf16, deterministic, at batch 1 and 8: shape,
   finiteness, the kernels' launch counts and instances, ms per frame and
   peak device memory;
8. compares the flagship bf16 output with the f32 output at batch 1; then
   runs the flagship in the reconstructor's default mode (bf16, batch 1):
   shape, finiteness, launch counts, ms per frame, two reconstructors from
   one seed agree, two calls differ; and once with z sampled at temperature
   0.7 and two samples per frame;
9. runs the flagship in int8 (bf16, ``use_int8`` + ``use_int8_towers``,
   calibrated on the batch) at batch 1 and 8: calibration time, shape,
   finiteness, launch counts (16 ``fused_tower`` per call, all the wgmma
   instance), ms per frame,
   peak memory, and the int8 UNet and the 16 int8 towers timed against
   their bf16 counterparts;
10. compares the flagship int8 output with the f32 output at batch 1; then
    ``use_int8_cond`` (the cond nets' 3-D pairs with an int8 intermediate on
    cuBLAS): the small rig card vs CPU in f32 (the CPU's packs carried
    across: 1e-3 of max|ref|; the card's own: 5e-3), the flagship in bf16 at
    batch 1 (launches with no ``cond_pair``, ms/frame, norm ratio to f32 <
    0.05) and the int8 pair timed against ``cond_pair`` at step 0;
11. holds the four ceiling probes (``ops/probes``: ``tiled_gemm``, its
    ``out8`` epilogue, ``chained_gemm``, ``fma_probe``) against their plain
    versions on the card at every size the probe scripts run (the GEMM at M
    2^20 for each of the scripts' (K, N) in int8 and bf16, the chain at M
    2^20 and the scripts' depth, the FMA probe at both of its row counts in
    every mode and accumulator count) and at small and odd ones: the int8
    kernels equal to the bit (the out8 GEMM and the int8 chain through both
    instances: s8 ``wgmma`` fed by TMA and ``mma.sync``), bf16 and FMA
    within their stated bounds; then drives the probe scripts' own entry points
    (``scripts/torch_bench_int8_micro.py``, ``torch_probe_cuda_core_rate.py``)
    for their times, with the library call beside each GEMM, holds the
    launch counts to what those entry points must make and the int8 chain
    and the out8 GEMM to the s8 ``wgmma`` instance, then times each of these
    two against its older instance on the same inputs, in turns (their
    ``ms`` is the median of the new instance's readings);
12. the exact-likelihood path: the small rig's per-frame NLLs of every step,
    card (kernels) vs CPU (plain), f32; forward then ``reverse`` on the card
    returns the volume and the log-dets cancel; ``reverse_fast`` agrees with
    ``reverse``; then the flagship at full width (96 x 512 x 512 volumes
    from a seed) through ``PyramidScorer`` at batch 1 and 4: shape,
    finiteness, launch counts (16 ``cat_affine``, 20 ``fused_float_tower``
    per call, no other kernel), ms per frame and peak memory;
13. the serving entry point, ``python -m cwfa_tpu_torch.cli.serve``, at the
    flagship width: the flagship model written as a checkpoint directory of
    the JAX package's format through the port's writer (5 step files, the
    mean caches of a seeded mean volume, the rig's statistics) and read back
    equal to the bit, a lenslet file of the rig's centers, 19 uint16
    camera frames of 2160^2 as TIFFs; then ``cli.serve.main`` at batch 8
    twice, with the int8 UNet (the default) and with ``--no_int8``: 19
    volume TIFFs of (96, 512, 512) f32, finite, 3 batches with 5 padded
    frames, every volume equal to the bit to a reconstructor built by the
    same steps and called on the same groups of 8 frames, the launch counts
    of the bf16 path per call (warm-up and three batches), and the served
    frames/s, batch latency p50 / p95, the service's segment seconds, peak
    memory, ``throughput()`` at batch 8, ``latency_ms()`` at batch 1, and
    the device-to-host copy and the TIFF writer timed alone;
14. training: the three backward kernels (``cat_affine_backward``,
    ``float_tower_backward``, ``cond_pair_backward``) against autograd
    through their plain versions at every flagship step shape and at odd
    ones, in f32 and bf16 (the pair with and without its Dropout3d scale;
    K2 and K3 through their tensor-core instances in bf16 at the flagship
    shapes, their CUDA-core ones in f32, and both at the odd shapes; K2 also
    at Cin 65, 72 and 128 at odd sizes and, bf16, at 512^2, Cin 65 and 128
    at 512^2 timed in turns with the CUDA-core instance), each
    timed at step 0 beside its plain backward, its bound and the cuDNN
    autograd chain for the same gradient (K2 and K3 in turns with their
    CUDA-core instances, K2 also at every step's shape); the small rig's
    LRNN step and every flow step, card vs CPU in f32 with nothing drawn (losses within
    1e-4, every gradient within 1e-3 of max|ref|); then the flagship trained
    in bf16 at batch 1 through every stage (``CWFATrainer.train_epoch``,
    epochs = INN_max_down_steps, on 3 random uint16 2160^2 frames and
    96 x 512^2 volumes written in the dataset's layout): finite losses, each
    stage's parameters changed and no other's, the launches per optimizer
    step (FLOW_PER_STEP, LRNN_PER_STEP; every K2 and K3 launch the
    tensor-core instance), ms per optimizer step and peak memory per stage,
    and the checkpoints read back equal to the bit;
15. the non-fast reconstruction (``reconstruct(fast=False)``, what
    evaluation runs): the small rig card vs CPU in f32; the flagship in
    bf16 at batch 1 against the fast path and against its own f32 run, its
    launches per call (EVAL_PER_CALL, the bf16 instances) and ms per frame;
    then the training entry point, ``python -m cwfa_tpu_torch.cli.train``
    (``cli.train.main``) at the flagship width and the configuration's
    defaults, on two fish of 3 random uint16 2160^2 frames and 96 x 512^2
    volumes in the CLI's layout with a neuron-coordinates file each: fold
    0, ``--max_samples 3 --epochs 5 --eval_every 5`` (one epoch a stage,
    then evaluation of train / val / test, 3 / 1 / 3 frames, the
    checkpoints and the OOD screen); the launches of every flow epoch
    (FLOW_PER_STEP a frame, every tower, pair, K2 and K3 launch on its
    tensor-core instance), of every evaluation reconstruction
    (EVAL_PER_CALL) and NLL refresh (NLL_PER_CALL a frame) and of the OOD
    screen; finite losses, PSNRs and NLLs, the frames per tag, the 15 TB
    PSNR scalars read back, 14 finite volume TIFFs of (96, 512, 512), no
    BatchNorm buffer moved by ``evaluate``, the 5 step checkpoints read
    back equal to the bit; and the CLI's seconds by segment (data load,
    statistics, ms per optimizer step and peak memory per stage, the
    reconstruction ms and host seconds per evaluated frame, peak memory
    of ``evaluate``, the OOD screen);
16. the OOD entry point, ``python -m cwfa_tpu_torch.cli.ood``
    (``cli.ood.main``), at the flagship width on a checkpoint directory of
    the flagship written by the port and one fish of 3 random uint16 2160^2
    frames and 96 x 512^2 volumes: ``--finetune 1 --create_dist_plots 1
    --epochs 5`` with a threshold that flags every frame; the report (finite
    scores, all flagged, steps 1-5 with 2 finite losses each, the scores
    after finetune finite and moved), the PNG, one volume upload a frame
    across detect -> finetune -> re-score, the launches of detect and
    re-score (NLL_PER_CALL a frame) and of every finetune epoch
    (FLOW_PER_STEP a frame in a flow epoch, on the tensor-core instances;
    none in the LRNN's), the three segments' seconds and peak memory;
17. Richardson–Lucy deconvolution: ``xlfm_deconvolve`` at a small size card
    vs CPU in f32 (fourier_sum on and off, a ragged depth chunk, batch 2
    with one NaN frame, init_obj chaining; bound 1e-4 of max|ref|) and the
    nonzero median card == CPU; then the deconvolution entry point,
    ``python -m cwfa_tpu_torch.cli.deconvolve`` (``cli.deconvolve.main``),
    at the JAX CLI's defaults (120 depths, 600^2 volumes, 2160^2 frames,
    50 iterations, canvas 2880^2) on a seeded PSF computed on the card with
    the synthetic PSF's formula and two frames projected from blob volumes,
    the RL loop under ``torch.cuda.set_sync_debug_mode("error")``: two
    volume TIFFs finite, >= 0 and zero outside the ROI depths, the first
    equal to the bit to a direct call (else within 1e-6 of max), the
    re-projection residual after 50 iterations below that after 1,
    ``--mesh_depth_axis 2`` in one process exits; ms per RL iteration at
    ``--n_split_fourier`` 1 and 4, seconds per frame, peak memory and the
    OTF's build time;
18. the reference's PyTorch checkpoints at the flagship width: the
    flagship (its LRNN's BatchNorm statistics moved off their init, random
    Lion momenta) saved as the port's msgpack set, written as the
    reference's torch files by ``python -m cwfa_tpu_torch.cli.export_torch``
    in a process of its own, two entries of one permutation of step 1
    swapped in the files, the set loaded into a fresh trainer on the card by
    ``CWFATrainer.load_torch_checkpoints`` and reconstructed at batch 1,
    bf16, deterministic: the volume equal to the bit to the source model's
    under the same permutation and unequal to its own, the launches per
    call the flagship's, the export and load seconds and the files' bytes;
19. XLFMNet (``--INN_net_type 2``): a small rig card vs CPU in f32 (the
    forward within 1e-4 of max|ref|, three Lion steps: losses within 1e-4,
    parameters within 1e-3); at the flagship width (29 views of 512^2 -> 96
    depths, UNet depth 5, wf 6, f32) the forward's ms/frame at batch 1 and
    8 and a training step at ``cfg.batch_size``, by segment, with peak
    memory; then ``cli.train.main`` with ``--INN_net_type 2`` on two fish of
    3 random 2160^2 frames: finite losses and PSNRs, the checkpoint
    written, ``load_xlfmnet``'s forward equal to the bit to the trained
    model's;
20. every other coupling type (``INN_block_type`` RNVP, GLOW, GIN, NICE,
    AI1): the float tower and K2 at the coupling-tower shapes they add (Cin
    72 -> 24 / 48 at step 0 and 36 / 18 / 9, all on ``wgmma``), f32 and
    bf16, each launch against its plain version with its instance, timed in
    bf16, at Cin 72 in turns with the CUDA-core instances beside the bound
    and the cuDNN chain; the small rig of each type card vs CPU in
    f32 (``reconstruct`` fast and not, the NLLs; bound 1e-4) and every
    step's forward then reverse; the flagship of each type (its blocks
    replaced, random weights from seed 0): bf16 deterministic
    reconstruction at batch 1 (ms/frame, peak memory, launches by kernel
    and by tower instance, bf16 vs f32 within 5e-2), ``PyramidScorer`` at
    batch 1, one flow optimizer step at step 0 in bf16 (finite loss, every
    parameter tensor of the step moved, AI1's ``w_perm`` not, launches by
    kernel and K2 by instance, ms and peak), no tower or K2 launch of the
    bf16 and f32 calls, the scorer or the step on the CUDA cores; then
    ``cli.train.main
    --INN_block_type AI1`` at the flagship width on two fish of 2 random
    frames, 2 epochs, and its msgpack checkpoint reloaded into a fresh
    trainer, whose reconstruction equals the run's own to the bit;
21. more than one device (``cwfa_tpu_torch/parallel``), on the one card:
    two ranks of this script (``--parallel-rank``) share cuda:0 over gloo
    against one process: (a) depth-sharded RL at the deconvolution CLI's
    defaults on one frame (60 depths a rank, one spectrum all-reduce an
    iteration) within 1e-4 of max of ``xlfm_deconvolve``, ms an iteration
    and peak memory a rank, and ``cli.deconvolve --mesh_depth_axis 2``'s
    volume equal to the bit to the direct sharded call's; (b) the flagship
    bf16 deterministic at batch 8 on a 2-rank data mesh: each rank's 4
    volumes equal to the bit to a one-process call at batch 4, the gathered
    batch within 5e-2 of max of one at batch 8, rows 1, 2, 3, 5 launched
    BF16_PER_CALL times a rank, and ``cli.serve --mesh_data_axis 2
    --no_int8`` writing each rank's 4 volumes equal to the bit to direct
    calls at batch 4; (c) an LRNN step and a step-0 flow step of the
    flagship trainer in bf16, 2 ranks x 1 frame against 1 process x 2,
    every draw on: losses within 1e-3 relative, each optimizer's
    all-reduced gradient within 5e-2 of max of one process's, parameters
    within 6 lr, the two ranks equal to the bit, K1 / K2 / K3 launches a
    step, step ms (cold and warm) and peaks; (d) NCCL at world size 1 through
    ``initialize_from_env`` (``--nccl-rank``); (e) ``utils.profiling``:
    ``trace`` around one flagship call names the four hand-written
    kernels, ``FrameTimer`` within 5% of ``device_timer``, ``debug_nans``
    raises on a NaN fed to ``cat_affine`` on the card; (f) the ``space``
    axis: the flagship deterministic at batch 1 on a (1, 2) mesh, 256 image
    rows a rank (halo exchanges in the UNet, the axis-2 permutations of
    steps 0 and 2 across the ranks, windows for the cond nets and towers),
    in bf16 and f32 against one process (2e-2 / 1e-4 of max), rows 1, 2, 3,
    5 launched BF16_PER_CALL times a call on each rank, the ms of a call and
    of its halo, permutation and gather traffic, and ``cli.serve
    --mesh_space_axis 2`` with the int8 UNet on 2 frames against direct
    one-process calls (2e-2 of max); (g) training on the ``space`` axis:
    an LRNN step and a step-0 flow step of the flagship trainer on a
    (1, 2) mesh in bf16, 1 frame, every draw on, against one process
    (losses 1e-3 relative, each optimizer's all-reduced gradient 5e-2 of
    max, parameters 6 lr, the ranks equal to the bit), rows 1 / 3 / 5 /
    10 / 11 / 12 launched 8 / 5 / 1 / 8 / 5 / 1 times a flow step on each
    rank, step ms cold and warm, the ms of the exchanges, row-global sums
    and gradient all-reduce, peaks; ``cli.train --mesh_space_axis 2`` at
    the flagship width (2 epochs, evaluation, OOD screen), rank 0 writing
    and its checkpoint reloaded equal on both ranks; and, in the main
    process, K2 and K3 at the window shapes (256 + 4 and 256 + 8 rows)
    against their plain versions (2^-5).

Each path is driven with every launch count set to 0 just before it and
read just after.  Prints a ``{"kernels": [...]}`` JSON line (twelve kernels,
each with its launches, error, time, plain version's time, bound and, where
one PyTorch call computes the same function, that call's time; the float
tower also with the ``f32_*`` numbers of its f32 instance, which the
likelihood path runs; the serving path's kernels with ``serve_launches``,
their launches in its two runs; the three backward kernels with the
training run's launches, the forward kernels of training with
``train_launches``; every kernel's launches in the training CLI's
evaluation as ``eval_launches``, in the OOD CLI's run as
``ood_launches``, in the reconstruction from the reference's checkpoints
as ``ckpt_launches``, per reconstruction of each non-CAT type as
``blocks_launches``, the tower's and K2's bf16 times at its shapes as
``blocks_step0_ms``, each rank's launches in the parallel phase's mesh
calls (data and space) and flow steps (data and space: ``train``,
``space_train``) as ``parallel_launches``), then, as
its
last line, ``{"ok": true, "device": {...}}``.  Exits non-zero without that
line when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cwfa_tpu_torch.cli import deconvolve
from cwfa_tpu_torch.cli import ood as ood_cli
from cwfa_tpu_torch.cli import serve
from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.psf import load_psf_otf
from cwfa_tpu_torch.data.tiff import read_tiff_stack, write_tiff_stack
from cwfa_tpu_torch.data.dataset import (ConcatXLFMDataset, _center_crop_img,
                                         _pad_to_square_img, load_xlfm_data)
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.engine import checkpoints
from cwfa_tpu_torch.engine.inference import XLFMReconstructor
from cwfa_tpu_torch.engine.losses import recon_loss
from cwfa_tpu_torch.engine.optim import make_optimizers
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.engine.ood import PyramidScorer
from cwfa_tpu_torch.flow.coupling import CLAMP_ACTIVATIONS
from cwfa_tpu_torch.flow.subnets import WaveletFlowSubnet2d
from cwfa_tpu_torch.models.cond_net import cond_networks_batched
from cwfa_tpu_torch.models.unet import unet_quantized
from cwfa_tpu_torch.nn import reset_parameters_
from cwfa_tpu_torch.ops import btower
from cwfa_tpu_torch.ops import cond_pair as cpair
from cwfa_tpu_torch.ops import cuda_build
from cwfa_tpu_torch.ops import flow_affine as fa
from cwfa_tpu_torch.ops.deconv import _median_nonzero_batch, xlfm_deconvolve
from cwfa_tpu_torch.ops.fft_conv import (_pad_center, fftshift2d_real,
                                         precompute_otf, rfft2_padded,
                                         shifted_crop, xlfm_forward_project)
from cwfa_tpu_torch.ops import probes
from cwfa_tpu_torch.ops import qtower
from cwfa_tpu_torch.models.cwfa_model import CWFAModel
from cwfa_tpu_torch.rig import flagship, lenslet_coords
from cwfa_tpu_torch.roofline import WARMUP, bound_ms, card_line, time_ms

SLICE_C, SLICE_HW = 48, 512        # step 0 of the flagship: (1, 48, 512, 512)
TOWER_CIN = (48, 24, 12, 6)        # the flagship steps' condition widths
INT8 = {"use_int8": True, "use_int8_towers": True}
FLOW_SRC = "cwfa_tpu_torch/csrc/flow_affine.cu"
PROBE_SRC = "cwfa_tpu_torch/csrc/probes.cu"
KERNELS = {
    "cat_affine": {"replaces": "cwfa_tpu/ops/pallas_flow.py:138",
                   "source": FLOW_SRC, "wrapper": fa.cat_affine},
    "haar_merge_affine": {"replaces": "cwfa_tpu/ops/pallas_flow.py:118",
                          "source": FLOW_SRC, "wrapper": fa.haar_merge_affine},
    # the 64-wide instance (s8 wgmma) of the int8 path; the other widths'
    # __dp4a instance is csrc/qtower.cu
    "fused_tower": {"replaces": "cwfa_tpu/ops/qtower.py:454",
                    "source": "cwfa_tpu_torch/csrc/qtower_wg.cu",
                    "wrapper": qtower.fused_tower},
    "cond_pair": {"replaces": "cwfa_tpu/ops/cond_pair.py:276",
                  "source": "cwfa_tpu_torch/csrc/cond_pair.cu",
                  "wrapper": cpair.cond_pair},
    # the 64-wide instances (wgmma) of the paths here; the other widths'
    # CUDA-core instance is csrc/btower.cu
    "fused_float_tower": {"replaces": "cwfa_tpu/ops/btower.py:235",
                          "source": "cwfa_tpu_torch/csrc/btower_wg.cu",
                          "wrapper": btower.fused_float_tower},
    "tiled_gemm": {"replaces": "scripts/bench_int8_micro.py:182",
                   "source": PROBE_SRC, "wrapper": probes.tiled_gemm},
    "chained_gemm": {"replaces": "scripts/bench_int8_micro.py:255",
                     "source": PROBE_SRC, "wrapper": probes.chained_gemm},
    # the int8 requant epilogue of tiled_gemm, counted on its own
    "tiled_gemm_out8": {"replaces": "scripts/bench_int8_micro.py:305",
                        "source": PROBE_SRC, "wrapper": probes.tiled_gemm,
                        "counter": "out8_launches"},
    "fma_probe": {"replaces": "scripts/probe_vpu_rate.py:24",
                  "source": PROBE_SRC, "wrapper": probes.fma_probe},
    # the backward kernels of training (the TPU kernels have none: JAX
    # differentiates its XLA forms); "replaces" names the TPU kernel whose
    # function each differentiates
    "cat_affine_bwd": {"replaces": "cwfa_tpu/ops/pallas_flow.py:146",
                       "source": FLOW_SRC, "wrapper": fa.cat_affine_backward},
    # the 64-wide bf16 instance (wgmma) of training; f32 and the other
    # widths' CUDA-core instance is csrc/btower_bwd.cu
    "float_tower_bwd": {"replaces": "cwfa_tpu/ops/btower.py:258",
                        "source": "cwfa_tpu_torch/csrc/btower_bwd_wg.cu",
                        "wrapper": btower.float_tower_backward},
    "cond_pair_bwd": {"replaces": "cwfa_tpu/ops/cond_pair.py:249",
                      "source": "cwfa_tpu_torch/csrc/cond_pair_bwd.cu",
                      "wrapper": cpair.cond_pair_backward},
}
# launches per call of each path (a kernel not named: none)
BF16_PER_CALL = {"cat_affine": 16, "haar_merge_affine": 4, "cond_pair": 4,
                 "fused_float_tower": 20}
INT8_PER_CALL = {"cat_affine": 16, "haar_merge_affine": 4, "fused_tower": 16,
                 "cond_pair": 4, "fused_float_tower": 4}
NLL_PER_CALL = {"cat_affine": 16, "fused_float_tower": 20}
# use_int8_cond: the 3-D pairs run on cuBLAS int8, not cond_pair
INT8_COND_PER_CALL = {"cat_affine": 16, "haar_merge_affine": 4,
                      "fused_float_tower": 20}
# the serving CLI: the int8 UNet (no custom kernel) or bf16, bf16 towers
SERVE_PER_CALL = BF16_PER_CALL
# launches per optimizer step of training: a flow step runs its five towers
# (input block + 4 coupling blocks) once, on the views condition that both
# directions read (CWFStep.towers), each with one backward that takes the
# two directions' gradients summed; its 4 CAT affines in both directions
# (the reverse for the reconstruction loss, the forward for step_nll), and
# its cond net's 3-D pair once, each with its backward; the LRNN step runs
# no kernel of the port (cuDNN)
FLOW_PER_STEP = {"fused_float_tower": 5, "float_tower_bwd": 5,
                 "cat_affine": 8, "cat_affine_bwd": 8, "cond_pair": 1,
                 "cond_pair_bwd": 1}
LRNN_PER_STEP = {}
TRAIN_FRAMES = 3
# launches per evaluation reconstruction (the non-fast chain, batch 1):
# every step reverses its 4 coupling blocks (tower + cat_affine each) and
# its input block (tower; the affine is plain torch), then merges with the
# plain inverse Haar, so haar_merge_affine does not run; the 4 cond nets
# run their 3-D pair once each
EVAL_PER_CALL = {"fused_float_tower": 20, "cat_affine": 16, "cond_pair": 4}
# the training CLI's frames per tag: --max_samples 3, fold 0 of two fish
CLI_FRAMES = {"train": 3, "val": 1, "test": 3}
SERVE_FRAMES, SERVE_BATCH = 19, 8
PROBE_US = (1, 4, 8, 16)           # the FMA probe's accumulator counts here
# bounds of the two fused-conv kernels, as a share of max|ref|:
# f32 1e-5 (the sums run in another order than cuDNN's); bf16 2^-6 for the
# tower (a canvas between convs can round one bf16 ulp the other way, and
# that propagates through the later convs) and 2^-7 for the 3-D pair (its
# one intermediate y feeds z through a single conv, so a y that rounds the
# other way moves z by far less than z's own rounding step)
REL_BOUND = {("cond_pair", torch.float32): 1e-5,
             ("cond_pair", torch.bfloat16): 2.0 ** -7,
             ("fused_float_tower", torch.float32): 1e-5,
             ("fused_float_tower", torch.bfloat16): 2.0 ** -6}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str):
    print(msg, flush=True)


def load_script(name: str):
    """A script of ``scripts/`` as a module (its entry points are what a
    user runs)."""
    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_bound(k: dict, nbytes: float, ops: float, kind: str, what: str):
    """Record the kernel's bound for this run's inputs and log its
    arithmetic."""
    k["bound_ms"], k["bound_by"] = bound_ms(nbytes, ops, kind)
    log(f"bound {what}: {nbytes / 1e6:.1f} MB -> "
        f"{bound_ms(nbytes, 0, kind)[0]:.4f} ms at 3.35 TB/s; "
        f"{ops / 1e9:.2f} G {kind} operations -> "
        f"{bound_ms(0, ops, kind)[0]:.4f} ms at the data-sheet peak; bound "
        f"{k['bound_ms']:.4f} ms by {k['bound_by']}")


def max_err(got, ref, dtype, what: str) -> float:
    """max |got - ref|, failing unless every element is within the bound:
    f32 |d| <= 1e-5 * max(1, |ref|) (atanf/expf differ from torch's by a few
    ulp); bf16 |d| <= 2^-7 * |ref| (one bf16 ulp of the output)."""
    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    if dtype == torch.float32:
        bound = 1e-5 * r.abs().clamp_min(1.0)
    else:
        bound = 2.0 ** -7 * r.abs() + torch.finfo(torch.bfloat16).tiny
    if not bool(torch.isfinite(g).all()) or bool((d > bound).any()):
        fail(f"{what}: max |d| {d.max().item():.3e} over the bound")
    return d.max().item()


def share_err(got, ref, share: float, what: str) -> float:
    """max|got - ref|, failing unless it is <= share * max|ref| and every
    value is finite."""
    torch.cuda.synchronize()
    d = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not bool(torch.isfinite(got.float()).all()) or not d <= share * scale:
        fail(f"{what}: max|d| {d:.3e} over {share:.3e} x max|ref| {scale:.3e}")
    return d


def rel_err(got, ref, name, dtype, what: str):
    """(max|got - ref|, the share of elements that differ), failing unless
    max|d| <= REL_BOUND[name, dtype] * max|ref| and every value is
    finite."""
    dmax = share_err(got, ref, REL_BOUND[name, dtype], what)
    return dmax, (got.float() != ref.float()).float().mean().item()


def rel_norm(got, ref) -> float:
    """tests/test_inference.py's norm ratio ||got - ref|| / ||ref - mean||."""
    g, r = got.double(), ref.double()
    return (torch.linalg.norm(g - r) / torch.linalg.norm(r - r.mean())).item()


def to_device(tree, dev):
    """A pack (nested dicts / lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree if tree is None else tree.to(dev)


def phase_kernels(dev, kernels):
    gen = torch.Generator(device=dev).manual_seed(0)

    def mk(c, dtype):
        return torch.randn((1, c, SLICE_HW, SLICE_HW), generator=gen,
                           device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        x, st = mk(SLICE_C, dtype), mk(2 * SLICE_C, dtype)
        z, s_raw, t, avg = (mk(SLICE_C, dtype) for _ in range(4))
        for act in CLAMP_ACTIVATIONS:
            kw = {"clamp": 2.0, "activation": act}
            for rev in (True, False):
                e = max_err(fa.cat_affine(x, st, rev=rev, **kw),
                            fa.cat_affine_reference(x, st, rev=rev, **kw),
                            dtype, f"cat_affine {dtype} {act} rev={rev}")
                kernels["cat_affine"]["max_abs_err"] = max(
                    kernels["cat_affine"].get("max_abs_err", 0.0), e)
                log(f"cat_affine {str(dtype):14s} {act:7s} rev={rev!s:5s} "
                    f"max|d| {e:.3e}")
            e = max_err(fa.haar_merge_affine(z, s_raw, t, avg, **kw),
                        fa.haar_merge_affine_reference(z, s_raw, t, avg, **kw),
                        dtype, f"haar_merge_affine {dtype} {act}")
            kernels["haar_merge_affine"]["max_abs_err"] = max(
                kernels["haar_merge_affine"].get("max_abs_err", 0.0), e)
            log(f"haar_merge_affine {str(dtype):14s} {act:7s} max|d| {e:.3e}")
        # times at the slice's shapes, ATAN (the configured clamp), rev
        kw = {"clamp": 2.0, "activation": "ATAN"}
        n = x.numel()
        times = {
            "cat_affine": (
                lambda: fa.cat_affine(x, st, rev=True, **kw),
                lambda: fa.cat_affine_reference(x, st, rev=True, **kw),
                4 * n * x.element_size()),
            "haar_merge_affine": (
                lambda: fa.haar_merge_affine(z, s_raw, t, avg, **kw),
                lambda: fa.haar_merge_affine_reference(z, s_raw, t, avg, **kw),
                6 * n * x.element_size()),
        }
        for name, (kern, plain, nbytes) in times.items():
            ms, plain_ms = time_ms(kern), time_ms(plain)
            log(f"time {name} {str(dtype):14s} kernel {ms:.4f} ms "
                f"({nbytes / ms / 1e6:.1f} GB/s)  plain {plain_ms:.4f} ms")
            if dtype == torch.bfloat16:
                kernels[name]["ms"], kernels[name]["plain_ms"] = ms, plain_ms
                # per element: the clamp (atan, two multiplies), exp, and
                # the affine (two) or the affine and the butterfly (six)
                set_bound(kernels[name], nbytes,
                          (6 if name == "cat_affine" else 10) * n, "f32",
                          f"{name} bf16 (1, {SLICE_C}, {SLICE_HW}, {SLICE_HW})")


def phase_tower(dev, kernels):
    """fused_tower vs quantized_tower_reference on the card, equal to the
    bit: every flagship step shape (64 wide), step 0 at batch 8 (the int8
    main path's batch), two odd shapes (H, W not multiples of the 16x16
    tile, batch 2; 64 wide and the small rig's 8 wide) and three more tower
    widths (20: not a multiple of 8; 72 and 128: smaller tiles, weights not
    staged), f32 and bf16 output.  A 64-wide tower is checked through both
    instances (s8 wgmma, and __dp4a when asked for); the instance of every
    launch is logged and each must have run.  Times the wgmma instance at
    every batch-1 step shape and, at step 0, the __dp4a instance and the
    plain version beside it (bf16 out)."""
    gen = torch.Generator().manual_seed(1)
    shapes = [(1, cin, SLICE_HW, SLICE_HW, 64) for cin in TOWER_CIN]
    shapes += [(8, SLICE_C, SLICE_HW, SLICE_HW, 64),
               (2, 12, 37, 53, 64), (2, 4, 19, 35, 8), (2, 5, 19, 35, 20),
               (1, 12, 37, 53, 72), (1, 12, 37, 53, 128)]
    k = kernels["fused_tower"]
    k["max_abs_err"] = 0.0
    by_instance = qtower.fused_tower.by_instance
    ran = dict.fromkeys(by_instance, 0)
    for b, cin, h, w, width in shapes:
        tower = WaveletFlowSubnet2d(cin, 2 * cin, width)
        reset_parameters_(tower, gen)
        tower = tower.to(dev).eval()
        x = torch.randn((b, cin, h, w), generator=gen).to(dev)
        scales = qtower.tower_calibrate(tower, x)
        qw = qtower.quantize_tower(tower, scales)
        xq = qtower.quantize_input(x, scales[0])
        ref = qtower.quantized_tower_reference(qw, scales, xq)
        own = qtower.kernel_instance(width, cin, 2 * cin)
        for instance in dict.fromkeys((own, qtower.DP4A)):
            asked = None if instance == own else instance
            for dtype in (torch.float32, torch.bfloat16):
                before = by_instance[instance]
                got = qtower.fused_tower(xq, qw, scales, out_dtype=dtype,
                                         instance=asked)
                if by_instance[instance] != before + 1:
                    fail(f"fused_tower {(b, cin, h, w)} C {width} did not "
                         f"run the {instance} instance")
                ran[instance] += 1
                exact_equal(got, ref.to(dtype), f"fused_tower {(b, cin, h, w)} "
                            f"C {width} {dtype} ({instance})")
                del got
            log(f"fused_tower B{b} Cin {cin:2d} {h}x{w} C {width} ({instance}): "
                f"f32 and bf16 out equal the plain version to the bit")
        if b != 1 or h != SLICE_HW:
            continue
        ms = time_ms(lambda: qtower.fused_tower(xq, qw, scales), 20)
        ops = 2 * b * h * w * (cin * 64 + 3 * (9 * 64 * 64 + 64 * 64)
                               + 9 * 64 * 2 * cin)
        line = (f"time fused_tower (1, {cin}, {h}, {w}) bf16 out ({own}): "
                f"kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} int8 TOP/s)")
        if cin == SLICE_C:                  # step 0: the other two as well
            dp4a_ms = time_ms(lambda: qtower.fused_tower(
                xq, qw, scales, instance=qtower.DP4A), 10)
            plain_ms = time_ms(
                lambda: qtower.quantized_tower_reference(qw, scales, xq), 5)
            line += (f"  {qtower.DP4A} instance {dp4a_ms:.4f} ms "
                     f"({ops / dp4a_ms / 1e9:.1f} TOP/s)  plain "
                     f"{plain_ms:.4f} ms ({ops / plain_ms / 1e9:.1f} TOP/s)")
            k["ms"], k["plain_ms"], k["dp4a_ms"] = ms, plain_ms, dp4a_ms
            wbytes = sum(t.numel() * t.element_size()
                         for name, t in qw.items() if name not in qtower.WEIGHTS)
            set_bound(k, b * h * w * (cin + 2 * 2 * cin) + wbytes, ops, "int8",
                      f"fused_tower (1, {cin}, {h}, {w}) -> {2 * cin} bf16 out")
        log(line)
    log(f"fused_tower instances checked: {ran}")
    if not all(ran.values()):
        fail(f"an instance of fused_tower was not checked: {ran}")


def cudnn_pair(net, x):
    """The two cuDNN ``Conv3d`` modules and the PReLU that ``cond_pair``
    replaced on the path, on the (B, 1, H, W, D) view."""
    v = net["c3b"](net["prelu"](net["c3a"](x.permute(0, 2, 3, 1).unsqueeze(1))))
    return v[:, 0].permute(0, 3, 1, 2).contiguous()


def cudnn_tower(t, x):
    """The module chain (separate cuDNN convs, ELU and adds, every tensor in
    the compute dtype) that ``fused_float_tower`` replaced on the path."""
    b1 = t.b1(x)
    b2 = t.b2b(F.elu(t.b2a(b1))) + b1
    b3 = F.elu(b2)
    b4 = t.b4b(F.elu(t.b4a(b3))) + b3
    b5 = F.elu(b4)
    b6 = t.b6b(F.elu(t.b6a(b5))) + b5
    return t.b7(F.elu(b6))


def phase_cond_pair(dev, kernels):
    """cond_pair vs cond_pair_reference on the card: every flagship step's
    depth at batch 1, step 0 at batch 8 and two odd shapes (D 5 and 8, a
    part of a depth chunk and a whole one; H, W not multiples of the 8x32
    tile), f32 and bf16.  bf16 is checked through both instances (tensor
    cores, and the CUDA cores when asked for); the instance of every launch
    is logged and each must have run.  Times both at step 0 (bf16)."""
    gen = torch.Generator().manual_seed(2)
    shapes = [(1, d, SLICE_HW, SLICE_HW) for d in (48, 24, 12, 6)]
    shapes += [(8, 48, SLICE_HW, SLICE_HW), (2, 5, 37, 53), (2, 8, 19, 35)]
    k = kernels["cond_pair"]
    by_instance = cpair.cond_pair.by_instance
    ran = dict.fromkeys(by_instance, 0)
    for shape in shapes:
        net = torch.nn.ModuleDict({"c3a": torch.nn.Conv3d(1, 32, 3, padding=1),
                                   "c3b": torch.nn.Conv3d(32, 1, 3, padding=1),
                                   "prelu": torch.nn.PReLU(1)})
        reset_parameters_(net, gen)
        with torch.no_grad():
            net["prelu"].weight.uniform_(0.05, 0.5, generator=gen)
        x0 = torch.randn(shape, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            net = net.to(dev, dtype)
            mods = (net["c3a"], net["c3b"], net["prelu"])
            x = x0.to(dev, dtype)
            own = cpair.kernel_instance(dtype, 32)
            with torch.inference_mode():
                want = cpair.cond_pair_reference(x, *mods)
                for instance in dict.fromkeys((own, cpair.CUDA_CORES)):
                    before = by_instance[instance]
                    got = cpair.cond_pair(
                        x, *mods, instance=None if instance == own else instance)
                    if by_instance[instance] != before + 1:
                        fail(f"cond_pair {shape} {dtype} did not run the "
                             f"{instance} instance")
                    ran[instance] += 1
                    e, share = rel_err(got, want, "cond_pair", dtype,
                                       f"cond_pair {shape} {dtype} ({instance})")
                    k["max_abs_err"] = max(k.get("max_abs_err", 0.0), e)
                    log(f"cond_pair {shape} {str(dtype):14s} ({instance}) "
                        f"max|d| {e:.3e}, {share:.2e} of the elements differ")
                del got, want
                if shape[0] != 1 or shape[1] != 48 or dtype != torch.bfloat16:
                    continue
                ms = time_ms(lambda: cpair.cond_pair(x, *mods), 20)
                cores_ms = time_ms(lambda: cpair.cond_pair(
                    x, *mods, instance=cpair.CUDA_CORES), 10)
                plain_ms = time_ms(lambda: cpair.cond_pair_reference(x, *mods), 5)
                cudnn_ms = time_ms(lambda: cudnn_pair(net, x), 5)
            flop = 2 * 2 * 27 * 32 * x.numel()
            log(f"time cond_pair {shape} bf16 ({own}): kernel {ms:.4f} ms "
                f"({flop / ms / 1e6:.0f} GFLOP/s)  {cpair.CUDA_CORES} instance "
                f"{cores_ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"cuDNN Conv3d modules (bf16) {cudnn_ms:.4f} ms")
            k["ms"], k["plain_ms"], k["cuda_cores_ms"] = ms, plain_ms, cores_ms
            # bf16 in, bf16 y between the two convs: both products could
            # run on the tensor cores, so that is the rate of the bound
            # (on f32 FMAs the same work takes bound_ms(0, flop, "f32"))
            set_bound(k, 2 * x.numel() * x.element_size(), flop, "bf16",
                      f"cond_pair {shape} bf16")
            log(f"bound cond_pair on f32 FMAs, as the {cpair.CUDA_CORES} "
                f"instance runs it: {bound_ms(0, flop, 'f32')[0]:.4f} ms")
    log(f"cond_pair instances checked: {ran}")
    if not all(ran.values()):
        fail(f"an instance of cond_pair was not checked: {ran}")


def phase_float_tower(dev, kernels):
    """fused_float_tower vs float_tower_reference on the card: every flagship
    tower shape (coupling Cin -> 2*Cin and input Cin -> Cin, 64 wide), step 0
    at batch 8, the two odd shapes of phase_tower and its three other tower
    widths (20, 72, 128: the CUDA cores, padded channels and smaller tiles),
    and 64-wide towers of Cin 65, 72 and 128 (wgmma, b1's K in chunks of
    64) at 512^2 and at odd sizes, f32 and bf16, with the
    instance of the kernel that ran each; times both instances at every
    batch-1 shape, and their plain versions and the cuDNN module chain at
    step 0's coupling tower; at Cin above 64, each wgmma instance in turns
    with the CUDA-core one beside its bound."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(1, cin, SLICE_HW, SLICE_HW, 64, nout)
              for cin in TOWER_CIN for nout in (2 * cin, cin)]
    shapes += [(8, SLICE_C, SLICE_HW, SLICE_HW, 64, 2 * SLICE_C),
               (2, 12, 37, 53, 64, 24), (2, 4, 19, 35, 8, 8),
               (2, 5, 19, 35, 20, 10), (1, 12, 37, 53, 72, 24),
               (1, 12, 37, 53, 128, 24)]
    shapes += [(1, 65, SLICE_HW, SLICE_HW, 64, 48),
               (1, 128, SLICE_HW, SLICE_HW, 64, 24), (2, 65, 37, 53, 64, 24),
               (1, 72, 37, 53, 64, 48), (1, 128, 37, 53, 64, 96)]
    k = kernels["fused_float_tower"]
    ran = dict.fromkeys(btower.fused_float_tower.by_instance, 0)
    for b, cin, h, w, width, nout in shapes:
        tower = WaveletFlowSubnet2d(cin, nout, width)
        reset_parameters_(tower, gen)
        x0 = torch.randn((b, cin, h, w), generator=gen)
        flop = 2 * b * h * w * (cin * width + 3 * 10 * width * width
                                + 9 * width * nout)
        for dtype in (torch.float32, torch.bfloat16):
            tower = tower.to(dev, dtype).eval()
            x = x0.to(dev, dtype)
            name = "f32" if dtype == torch.float32 else "bf16"
            instance = btower.kernel_instance(dtype, width, cin, nout)
            with torch.inference_mode():
                before = btower.fused_float_tower.by_instance[instance]
                got = btower.fused_float_tower(x, tower)
                if btower.fused_float_tower.by_instance[instance] != before + 1:
                    fail(f"fused_float_tower {(b, cin, h, w)} {dtype} did not "
                         f"run the {instance} instance")
                ran[instance] += 1
                want = btower.float_tower_reference(tower, x).to(dtype)
                e, share = rel_err(got, want, "fused_float_tower", dtype,
                                   f"fused_float_tower {(b, cin, h, w)} C "
                                   f"{width} Nout {nout} {dtype}")
                del got, want
                k["max_abs_err"] = max(k.get("max_abs_err", 0.0), e)
                log(f"fused_float_tower B{b} Cin {cin:2d} {h}x{w} C {width} "
                    f"Nout {nout:2d} {name:4s} ({instance}) max|d| {e:.3e}, "
                    f"{share:.2e} of the elements differ")
                if b != 1 or h != SLICE_HW:
                    continue
                if cin > btower.WGMMA_WIDTH:
                    wide_tower_in_turns(tower, x, instance, flop,
                                        f"(1, {cin}, {h}, {w}) -> {nout}")
                    continue
                ms = time_ms(lambda: btower.fused_float_tower(x, tower), 20)
                line = (f"time fused_float_tower (1, {cin}, {h}, {w}) -> "
                        f"{nout} {name} ({instance}): kernel {ms:.4f} ms "
                        f"({flop / ms / 1e6:.0f} GFLOP/s)")
                if cin == SLICE_C and nout == 2 * cin:
                    plain_ms = time_ms(
                        lambda: btower.float_tower_reference(tower, x), 5)
                    line += f"  plain {plain_ms:.4f} ms"
                    nbytes = tower_bytes(tower, x)
                    if dtype == torch.bfloat16:
                        cudnn_ms = time_ms(lambda: cudnn_tower(tower, x), 5)
                        line += f"  cuDNN module chain (bf16) {cudnn_ms:.4f} ms"
                        k["ms"], k["plain_ms"] = ms, plain_ms
                        set_bound(k, nbytes, flop, "bf16", f"fused_float_tower "
                                  f"(1, {cin}, {h}, {w}) -> {nout} bf16")
                    else:
                        # the plain version is eight cuDNN f32 convs (TF32
                        # off); two bounds: the work as f32 FMAs, and as the
                        # kernel runs it, three TF32 products on the tensor
                        # cores for each f32 one
                        k["f32_ms"], k["f32_plain_ms"] = ms, plain_ms
                        k["f32_bound_ms"] = bound_ms(nbytes, flop, "f32")[0]
                        k["f32_3xtf32_bound_ms"] = bound_ms(
                            nbytes, 3 * flop, "tf32")[0]
                        log(f"bound fused_float_tower f32 instance: "
                            f"{k['f32_bound_ms']:.4f} ms on f32 FMAs; "
                            f"{k['f32_3xtf32_bound_ms']:.4f} ms as 3 x "
                            f"{flop / 1e9:.2f} G TF32 operations at the "
                            f"data-sheet peak")
                log(line)
    log(f"fused_float_tower instances checked: {ran}")
    if not all(ran.values()):
        fail(f"an instance of fused_float_tower was not checked: {ran}")


def tower_bytes(tower, x) -> int:
    """The bytes a tower launch must move: x read, the output written, the
    kernel's weight pack read."""
    b, cin, h, w = x.shape
    return (b * h * w * (cin + tower.b7.out_channels) * x.element_size()
            + sum(t.numel() * t.element_size()
                  for t in btower.pack_float_tower(tower, x.dtype)))


def wide_tower_in_turns(tower, x, instance: str, flop: float, what: str,
                        cudnn: bool = False) -> float:
    """A tower of Cin above 64: its wgmma instance and the CUDA-core one
    timed in turns (new/old/new/old/new) beside the bound (bf16 on the
    tensor cores; f32 as 3 x TF32) and, with ``cudnn``, the cuDNN module
    chain.  Returns the median of the wgmma readings."""
    side = instances_side_by_side(
        lambda inst: btower.fused_float_tower(
            x, tower, instance=None if inst == instance else inst),
        instance, btower.CUDA_CORES, 5)
    ms = statistics.median(side[instance])
    bf16 = x.dtype == torch.bfloat16
    bound = bound_ms(tower_bytes(tower, x), flop if bf16 else 3 * flop,
                     "bf16" if bf16 else "tf32")
    line = (f"time fused_float_tower {what} {str(x.dtype)[6:]} in turns "
            f"new/old/new/old/new: {instance} "
            f"{['%.4f' % t for t in side[instance]]}, CUDA cores "
            f"{['%.4f' % t for t in side[btower.CUDA_CORES]]} ms; median "
            f"{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s) against CUDA cores "
            f"{statistics.median(side[btower.CUDA_CORES]):.4f}; bound "
            f"{bound[0]:.4f} ms ({bound[1]}{'' if bf16 else ', 3 x TF32'})")
    if cudnn:
        line += (f"  [cuDNN module chain: "
                 f"{time_ms(lambda: cudnn_tower(tower, x), 5):.4f} ms]")
    log(line)
    return ms


# bounds of the backward kernels against their plain backward (autograd
# through the plain forward), as a share of max|ref| of each gradient: f32
# dx 1e-5 and dW 1e-4 (the kernel's sums run in another order, dW's over
# 2.6e5 positions); bf16 2^-5 (the plain backward rounds each canvas's
# gradient to bf16 where the kernels keep f32, and a recomputed canvas can
# round one ulp the other way)
BWD_BOUND = {(torch.float32, "dx"): 1e-5, (torch.float32, "dW"): 1e-4,
             (torch.bfloat16, "dx"): 2.0 ** -5, (torch.bfloat16, "dW"): 2.0 ** -5}


def k2_reference(tower, x, dy):
    """K2's reference: f32 the f64 gradient of the tower's exact function
    (the plain f32 backward's cuDNN wgrad is itself up to 8e-5 of max off
    it at 512^2), bf16 the plain backward (autograd through the plain
    forward)."""
    if x.dtype == torch.float32:
        return btower.float_tower_backward_f64(tower, x, dy)
    return btower.float_tower_backward_reference(tower, x, dy)


def k3_reference(x, dz, mods, scale):
    """K3's reference: f32 the f64 gradient of the pair's function (PReLU's
    branch where the f32 forward takes it), bf16 the plain backward."""
    if x.dtype == torch.float32:
        return cpair.cond_pair_backward_f64(x, dz, *mods, scale)
    return cpair.cond_pair_backward_reference(x, dz, *mods, scale)


def grads_err(got, ref, dtype, what: str) -> float:
    """The largest max|got - ref| / max|ref| over the gradients (dx first,
    then the parameters'), failing where one is over its BWD_BOUND."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if r is None:
            continue
        bound = BWD_BOUND[dtype, "dx" if i == 0 else "dW"]
        share_err(g, r, bound, f"{what} gradient {i}")
        scale = r.float().abs().max().item()
        worst = max(worst, (g.float() - r.float()).abs().max().item()
                    / max(scale, 1e-30))
    return worst


def cudnn_tower_grad(t, x, dy):
    """The cuDNN autograd chain that would compute the tower's gradient:
    forward through the module chain, then its backward."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        out = cudnn_tower(t, xr)
        return torch.autograd.grad(out, [xr] + list(t.parameters()), dy)


def cudnn_pair_grad(net, x, dz):
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        out = cudnn_pair(net, xr)
        return torch.autograd.grad(out, [xr] + list(net.parameters()), dz)


def phase_train_kernels(dev, kernels):
    """The three backward kernels of training against their plain backward
    (autograd through the plain forward) on the card, at every flagship
    step's shape and at odd ones, in f32 and bf16, with f32 master weights;
    times each at step 0 (bf16) beside its plain backward and the cuDNN
    autograd chain for the same gradient."""
    check_train_forwards(dev)
    check_cat_affine_backward(dev, kernels)
    check_float_tower_backward(dev, kernels)
    check_cond_pair_backward(dev, kernels)


def check_train_forwards(dev):
    """The forward kernels as training calls them, against their plain
    versions: f32 master weights under an x of the compute dtype (bf16 and
    f32), so each must cast the weights itself and still run the compute
    dtype's instance; the 3-D pair with the Dropout3d scale and without, at
    every flagship depth and two odd shapes, through both instances; the
    float tower at every flagship tower shape and an odd one.  Bounds as in
    REL_BOUND (the plain versions round the master weights to x's dtype
    too)."""
    gen = torch.Generator().manual_seed(8)
    shapes = [(1, d, SLICE_HW, SLICE_HW) for d in (48, 24, 12, 6)]
    shapes += [(2, 5, 37, 53), (2, 8, 19, 35)]
    by_instance = cpair.cond_pair.by_instance
    ran = dict.fromkeys(by_instance, 0)
    for shape in shapes:
        net = torch.nn.ModuleDict({"c3a": torch.nn.Conv3d(1, 32, 3, padding=1),
                                   "c3b": torch.nn.Conv3d(32, 1, 3, padding=1),
                                   "prelu": torch.nn.PReLU(1)})
        reset_parameters_(net, gen)
        with torch.no_grad():
            net["prelu"].weight.uniform_(0.05, 0.5, generator=gen)
        net = net.to(dev)                       # f32 master weights
        mods = (net["c3a"], net["c3b"], net["prelu"])
        x0 = torch.randn(shape, generator=gen)
        # a Dropout3d scale as the cond net draws it: 0 or 1/keep, keep 0.5
        keep = ((torch.rand((shape[0], 32), generator=gen) < 0.5).float()
                * 2.0).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x0.to(dev, dtype)
            own = cpair.kernel_instance(dtype, 32)
            for scale in (keep, None):
                with torch.inference_mode():
                    want = cpair.cond_pair_reference(x, *mods, scale)
                    for instance in dict.fromkeys((own, cpair.CUDA_CORES)):
                        before = by_instance[instance]
                        got = cpair.cond_pair(
                            x, *mods, scale=scale,
                            instance=None if instance == own else instance)
                        if by_instance[instance] != before + 1:
                            fail(f"cond_pair {shape} {dtype} f32 masters did "
                                 f"not run the {instance} instance")
                        ran[instance] += 1
                        e, share = rel_err(
                            got, want, "cond_pair", dtype,
                            f"cond_pair {shape} {dtype} f32 master weights "
                            f"scale={scale is not None} ({instance})")
                        log(f"cond_pair {shape} {str(dtype):14s} f32 master "
                            f"weights, Dropout3d scale {scale is not None!s:5s}"
                            f" ({instance}): max|d| {e:.3e}, {share:.2e} of "
                            f"the elements differ")
                    del got, want
    if not all(ran.values()):
        fail(f"an instance of cond_pair was not checked with f32 master "
             f"weights: {ran}")
    gen = torch.Generator().manual_seed(9)
    shapes = [(1, cin, SLICE_HW, SLICE_HW, nout)
              for cin in TOWER_CIN for nout in (2 * cin, cin)]
    shapes += [(2, 12, 37, 53, 24)]
    for b, cin, h, w, nout in shapes:
        tower = WaveletFlowSubnet2d(cin, nout, 64)
        reset_parameters_(tower, gen)
        tower = tower.to(dev)                   # f32 master weights
        x0 = torch.randn((b, cin, h, w), generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = x0.to(dev, dtype)
            instance = btower.kernel_instance(dtype, 64, cin, nout)
            with torch.inference_mode():
                before = btower.fused_float_tower.by_instance[instance]
                got = btower.fused_float_tower(x, tower)
                if btower.fused_float_tower.by_instance[instance] != before + 1:
                    fail(f"fused_float_tower {(b, cin, h, w)} {dtype} f32 "
                         f"masters did not run the {instance} instance")
                want = btower.float_tower_reference(tower, x).to(dtype)
                e, share = rel_err(got, want, "fused_float_tower", dtype,
                                   f"fused_float_tower {(b, cin, h, w)} Nout "
                                   f"{nout} {dtype} f32 master weights")
                del got, want
            log(f"fused_float_tower B{b} Cin {cin:2d} {h}x{w} Nout {nout:2d} "
                f"{str(dtype):14s} f32 master weights ({instance}): max|d| "
                f"{e:.3e}, {share:.2e} of the elements differ")


def check_cat_affine_backward(dev, kernels):
    """K1 at every flagship step's c_flow (48, 24, 12, 6) and an odd shape,
    every activation and direction."""
    gen = torch.Generator().manual_seed(5)
    k = kernels["cat_affine_bwd"]
    for dtype in (torch.float32, torch.bfloat16):
        for c, shape in ([(c, (1, c, SLICE_HW, SLICE_HW)) for c in TOWER_CIN]
                         + [(5, (2, 5, 37, 53))]):
            x, dy = (torch.randn(shape, generator=gen).to(dev, dtype)
                     for _ in range(2))
            st = torch.randn((shape[0], 2 * c) + shape[2:],
                             generator=gen).to(dev, dtype)
            for act in CLAMP_ACTIVATIONS:
                for rev in (True, False):
                    kw = {"clamp": 2.0, "activation": act, "rev": rev}
                    got = fa.cat_affine_backward(dy, x, st, **kw)
                    ref = fa.cat_affine_backward_reference(dy, x, st, **kw)
                    e = max(max_err(g, r, dtype, f"cat_affine_backward "
                                    f"{shape} {dtype} {act} rev={rev}")
                            for g, r in zip(got, ref))
                    k["max_abs_err"] = max(k.get("max_abs_err", 0.0), e)
            log(f"cat_affine_backward {shape} {str(dtype):14s} every "
                f"activation, both directions: max|d| within the flow "
                f"kernels' bound")
            if dtype == torch.bfloat16 and shape[1] == SLICE_C:
                kw = {"clamp": 2.0, "activation": "ATAN", "rev": True}
                ms = time_ms(lambda: fa.cat_affine_backward(dy, x, st, **kw))
                plain_ms = time_ms(lambda: fa.cat_affine_backward_reference(
                    dy, x, st, **kw), 10)
                n = x.numel()
                k["ms"], k["plain_ms"] = ms, plain_ms
                log(f"time cat_affine_backward {shape} bf16: kernel "
                    f"{ms:.4f} ms ({7 * n * 2 / ms / 1e6:.1f} GB/s)  plain "
                    f"{plain_ms:.4f} ms")
                set_bound(k, 7 * n * x.element_size(), 14 * n, "f32",
                          f"cat_affine_backward bf16 {shape}")


def check_float_tower_backward(dev, kernels):
    """K2 at every flagship tower shape (the wgmma instances: bf16, and f32
    as 3xTF32), at two odd shapes (64 wide through both instances, in both
    dtypes), at width 20 (CUDA cores) and at Cin 65, 72 and 128 (wgmma: b1
    with K up to 128, dx in launches of 64) at odd sizes and at 512^2, each
    launch repeated and held equal to the bit; f32 against the f64
    gradient, bf16 against the plain backward (``k2_reference``); then, at
    step 0, the two instances of each dtype timed in turns beside the plain
    backward (bf16: and the cuDNN autograd chain), and the bf16 wgmma
    instance at every step's shape; at Cin 65 and 128 the two in turns
    beside the bound."""
    gen = torch.Generator().manual_seed(6)
    k = kernels["float_tower_bwd"]
    by_instance = btower.float_tower_backward.by_instance
    ran = dict.fromkeys(by_instance, 0)
    shapes = [(1, cin, SLICE_HW, SLICE_HW, 64, nout)
              for cin in TOWER_CIN for nout in (2 * cin, cin)]
    shapes += [(2, 12, 37, 53, 64, 24), (1, 64, 40, 24, 64, 80),
               (2, 5, 19, 35, 20, 10)]
    shapes += [(1, 65, SLICE_HW, SLICE_HW, 64, 48),
               (1, 128, SLICE_HW, SLICE_HW, 64, 24), (2, 65, 37, 53, 64, 24),
               (1, 72, 37, 53, 64, 48), (1, 128, 37, 53, 64, 96)]
    flat = lambda g: [g[0]] + [t for pair in zip(g[1], g[2]) for t in pair]
    step_ms = {}
    for b, cin, h, w, width, nout in shapes:
        tower = WaveletFlowSubnet2d(cin, nout, width)
        reset_parameters_(tower, gen)
        tower = tower.to(dev)                   # f32 master weights
        x0 = torch.randn((b, cin, h, w), generator=gen)
        dy0 = torch.randn((b, nout, h, w), generator=gen)
        wide = b == 1 and h == SLICE_HW and cin not in TOWER_CIN
        flagship_shape = b == 1 and h == SLICE_HW and not wide
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x0.to(dev, dtype), dy0.to(dev, dtype)
            own = btower.bwd_instance(dtype, width, cin, nout)
            ref = k2_reference(tower, x, dy)
            # the older instance also where the new one is picked, at the odd
            # shapes
            also = [] if flagship_shape else [btower.CUDA_CORES]
            for instance in dict.fromkeys([own] + also):
                run = lambda: btower.float_tower_backward(
                    tower, x, dy, instance=None if instance == own else instance)
                got = one_launch_of(
                    btower.float_tower_backward, instance, run,
                    f"float_tower_backward {(b, cin, h, w)} {dtype}")
                ran[instance] += 1
                # no atomics: a second launch gives the same gradients
                for g, again in zip(flat(got), flat(run())):
                    if g is not None:
                        exact_equal(again, g, f"float_tower_backward "
                                    f"{(b, cin, h, w)} {dtype} ({instance}), "
                                    f"second launch")
                e = grads_err(flat(got), flat(ref), dtype,
                              f"float_tower_backward {(b, cin, h, w)} C "
                              f"{width} Nout {nout} {dtype} ({instance})")
                k["max_abs_err"] = max(k.get("max_abs_err", 0.0),
                                       max((g - r).abs().max().item() for g, r
                                           in zip(flat(got), flat(ref))
                                           if r is not None))
                log(f"float_tower_backward B{b} Cin {cin:2d} {h}x{w} C {width} "
                    f"Nout {nout:2d} {str(dtype):14s} ({instance}) "
                    f"max|d|/max|ref| {e:.3e}")
                del got
            del ref
            if wide and dtype == torch.bfloat16:
                wide_k2_in_turns(tower, x, dy, f"(1, {cin}, {h}, {w}) -> "
                                 f"{nout}")
            if not flagship_shape:
                continue
            if dtype == torch.bfloat16:
                step_ms[(cin, nout)] = time_ms(
                    lambda: btower.float_tower_backward(tower, x, dy), 10)
            if not (cin == SLICE_C and nout == 2 * cin):
                continue
            flop = 2 * b * h * w * (cin * width + 3 * 10 * width * width
                                    + 9 * width * nout)
            plain_ms = time_ms(lambda: btower.float_tower_backward_reference(
                tower, x, dy), 3)
            if dtype == torch.float32:
                side = instances_side_by_side(
                    lambda inst: btower.float_tower_backward(
                        tower, x, dy,
                        instance=None if inst == btower.WGMMA_3XTF32 else inst),
                    btower.WGMMA_3XTF32, btower.CUDA_CORES, 3)
                ms = statistics.median(side[btower.WGMMA_3XTF32])
                old = statistics.median(side[btower.CUDA_CORES])
                # x and dy read, dx and the weights' gradients written, f32
                nbytes = (b * h * w * (2 * cin + nout) * 4
                          + 4 * sum(p.numel() for p in tower.parameters()))
                tf32 = bound_ms(nbytes, 3 * 2 * flop, "tf32")
                fma = bound_ms(nbytes, 2 * flop, "f32")
                k.update(f32_ms=ms, f32_cuda_cores_ms=old,
                         f32_plain_ms=plain_ms, f32_bound_ms=tf32[0],
                         f32_bound_by=tf32[1], f32_fma_bound_ms=fma[0])
                log(f"time float_tower_backward (1, {cin}, {h}, {w}) -> {nout}"
                    f" f32, in turns new/old/new/old/new: wgmma 3xTF32 "
                    f"{['%.4f' % t for t in side[btower.WGMMA_3XTF32]]}, CUDA "
                    f"cores {['%.4f' % t for t in side[btower.CUDA_CORES]]} "
                    f"ms; median {ms:.4f} ms against {old:.4f}  plain (cuDNN "
                    f"f32, TF32 off) {plain_ms:.4f} ms; bound as 3xTF32 "
                    f"({3 * 2 * flop / 1e9:.2f} G TF32 operations / 495 T) "
                    f"{tf32[0]:.4f} ms ({tf32[1]}), on f32 FMAs "
                    f"{fma[0]:.4f} ms")
                continue
            side = instances_side_by_side(
                lambda inst: btower.float_tower_backward(
                    tower, x, dy,
                    instance=None if inst == btower.WGMMA_BF16 else inst),
                btower.WGMMA_BF16, btower.CUDA_CORES, 5)
            ms = statistics.median(side[btower.WGMMA_BF16])
            t16 = copy.deepcopy(tower).to(torch.bfloat16)
            lib_ms = time_ms(lambda: cudnn_tower_grad(t16, x, dy), 5)
            k["ms"], k["plain_ms"], k["library_ms"] = ms, plain_ms, lib_ms
            k["cuda_cores_ms"] = statistics.median(side[btower.CUDA_CORES])
            log(f"time float_tower_backward (1, {cin}, {h}, {w}) -> {nout} "
                f"bf16, in turns new/old/new/old/new: wgmma bf16 "
                f"{['%.4f' % t for t in side[btower.WGMMA_BF16]]}, CUDA cores "
                f"{['%.4f' % t for t in side[btower.CUDA_CORES]]} ms; median "
                f"{ms:.4f} ms ({2 * flop / ms / 1e9:.1f} TFLOP/s of the "
                f"backward)  plain {plain_ms:.4f} ms  [cuDNN autograd chain, "
                f"bf16: {lib_ms:.4f} ms]")
            # x and dy read, dx written (bf16), the weights' f32 gradients
            # written
            wbytes = 4 * sum(p.numel() for p in tower.parameters())
            set_bound(k, b * h * w * (2 * cin + nout) * 2 + wbytes,
                      2 * flop, "bf16",
                      f"float_tower_backward (1, {cin}, {h}, {w}) bf16")
            log(f"bound float_tower_backward on f32 FMAs: "
                f"{bound_ms(0, 2 * flop, 'f32')[0]:.4f} ms")
    k["step_ms"] = {f"{cin}->{nout}": round(t, 4)
                    for (cin, nout), t in step_ms.items()}
    log(f"time float_tower_backward bf16 (wgmma) at every step's shape, "
        f"(1, Cin, 512, 512) -> Nout: "
        f"{ {key: '%.4f ms' % t for key, t in k['step_ms'].items()} }")
    log(f"float_tower_backward instances checked: {ran}")
    if not all(ran.values()):
        fail(f"an instance of float_tower_backward was not checked: {ran}")


def wide_k2_in_turns(tower, x, dy, what: str, cudnn: bool = False) -> float:
    """K2 in bf16 at Cin above 64: the wgmma instance and the CUDA-core one
    timed in turns (new/old/new/old/new) beside the bound (the dgrads and
    wgrads on the bf16 tensor cores) and, with ``cudnn``, the cuDNN autograd
    chain.  Returns the median of the wgmma readings."""
    b, cin, h, w = x.shape
    nout = dy.shape[1]
    flop = 2 * b * h * w * (cin * 64 + 3 * 10 * 64 * 64 + 9 * 64 * nout)
    side = instances_side_by_side(
        lambda inst: btower.float_tower_backward(
            tower, x, dy, instance=None if inst == btower.WGMMA_BF16 else inst),
        btower.WGMMA_BF16, btower.CUDA_CORES, 2)
    ms = statistics.median(side[btower.WGMMA_BF16])
    wbytes = 4 * sum(p.numel() for p in tower.parameters())
    bound = bound_ms(b * h * w * (2 * cin + nout) * 2 + wbytes, 2 * flop,
                     "bf16")
    line = (f"time float_tower_backward {what} bf16 in turns "
            f"new/old/new/old/new: wgmma bf16 "
            f"{['%.4f' % t for t in side[btower.WGMMA_BF16]]}, CUDA cores "
            f"{['%.4f' % t for t in side[btower.CUDA_CORES]]} ms; median "
            f"{ms:.4f} ms ({2 * flop / ms / 1e9:.1f} TFLOP/s) against CUDA "
            f"cores {statistics.median(side[btower.CUDA_CORES]):.4f}; bound "
            f"{bound[0]:.4f} ms ({bound[1]})")
    if cudnn:
        t16 = copy.deepcopy(tower).to(torch.bfloat16)
        line += (f"  [cuDNN autograd chain, bf16: "
                 f"{time_ms(lambda: cudnn_tower_grad(t16, x, dy), 3):.4f} ms]")
    log(line)
    return ms


def check_cond_pair_backward(dev, kernels):
    """K3 at every flagship step's depth (the tensor-core instances: bf16,
    and f32 as 3xTF32) and two odd shapes (through both instances, in both
    dtypes), with and without the Dropout3d scale, each launch repeated and
    held equal to the bit; f32 against the f64 gradient, bf16 against the
    plain backward (``k3_reference``); then a case built so that many a pre
    lands within 2^-16 of 0; at step 0 the two instances of each dtype
    timed in turns beside the plain backward (bf16: and the cuDNN autograd
    chain)."""
    gen = torch.Generator().manual_seed(7)
    k = kernels["cond_pair_bwd"]
    by_instance = cpair.cond_pair_backward.by_instance
    ran = dict.fromkeys(by_instance, 0)
    shapes = [(1, d, SLICE_HW, SLICE_HW) for d in (48, 24, 12, 6)]
    shapes += [(2, 5, 37, 53), (2, 8, 19, 35)]
    for shape in shapes:
        net = torch.nn.ModuleDict({"c3a": torch.nn.Conv3d(1, 32, 3, padding=1),
                                   "c3b": torch.nn.Conv3d(32, 1, 3, padding=1),
                                   "prelu": torch.nn.PReLU(1)})
        reset_parameters_(net, gen)
        with torch.no_grad():
            net["prelu"].weight.uniform_(0.05, 0.5, generator=gen)
        net = net.to(dev)                       # f32 master weights
        mods = (net["c3a"], net["c3b"], net["prelu"])
        x0, dz0 = (torch.randn(shape, generator=gen) for _ in range(2))
        keep = (torch.rand((shape[0], 32), generator=gen) < 0.5).float() * 2.0
        flagship_shape = shape[2] == SLICE_HW
        for dtype in (torch.float32, torch.bfloat16):
            x, dz = x0.to(dev, dtype), dz0.to(dev, dtype)
            own = cpair.bwd_instance(dtype, 32)
            also = [] if flagship_shape else [cpair.CUDA_CORES]
            for scale in (None, keep.to(dev)):
                ref = k3_reference(x, dz, mods, scale)
                for instance in dict.fromkeys([own] + also):
                    run = lambda: cpair.cond_pair_backward(
                        x, dz, *mods, scale,
                        instance=None if instance == own else instance)
                    got = one_launch_of(
                        cpair.cond_pair_backward, instance, run,
                        f"cond_pair_backward {shape} {dtype}")
                    ran[instance] += 1
                    # no atomics: a second launch gives the same gradients
                    for g, again in zip(got, run()):
                        exact_equal(again, g, f"cond_pair_backward {shape} "
                                    f"{dtype} ({instance}), second launch")
                    e = grads_err(got, ref, dtype, f"cond_pair_backward "
                                  f"{shape} {dtype} scale={scale is not None}"
                                  f" ({instance})")
                    k["max_abs_err"] = max(k.get("max_abs_err", 0.0),
                                           max((g - r).abs().max().item()
                                               for g, r in zip(got, ref)))
                    log(f"cond_pair_backward {shape} {str(dtype):14s} "
                        f"Dropout3d scale {scale is not None!s:5s} "
                        f"({instance}) max|d|/max|ref| {e:.3e}")
            if shape[1] != 48 or not flagship_shape:
                continue
            sc = keep.to(dev)
            if dtype == torch.float32:
                time_k3_f32(k, x, dz, mods, sc)
                continue
            side = instances_side_by_side(
                lambda inst: cpair.cond_pair_backward(
                    x, dz, *mods, sc,
                    instance=None if inst == cpair.TENSOR_CORES else inst),
                cpair.TENSOR_CORES, cpair.CUDA_CORES, 5)
            ms = statistics.median(side[cpair.TENSOR_CORES])
            plain_ms = time_ms(lambda: cpair.cond_pair_backward_reference(
                x, dz, *mods, sc), 3)
            net16 = copy.deepcopy(net).to(torch.bfloat16)
            lib_ms = time_ms(lambda: cudnn_pair_grad(net16, x, dz), 3)
            flop = 2 * 2 * 27 * 32 * x.numel()
            k["ms"], k["plain_ms"], k["library_ms"] = ms, plain_ms, lib_ms
            k["cuda_cores_ms"] = statistics.median(side[cpair.CUDA_CORES])
            log(f"time cond_pair_backward {shape} bf16, in turns "
                f"new/old/new/old/new: tensor cores "
                f"{['%.4f' % t for t in side[cpair.TENSOR_CORES]]}, CUDA "
                f"cores {['%.4f' % t for t in side[cpair.CUDA_CORES]]} ms; "
                f"median {ms:.4f} ms ({2 * flop / ms / 1e9:.1f} TFLOP/s)  "
                f"plain {plain_ms:.4f} ms  [cuDNN autograd chain of the two "
                f"Conv3d, bf16: {lib_ms:.4f} ms]")
            set_bound(k, 3 * x.numel() * x.element_size(), 2 * flop, "bf16",
                      f"cond_pair_backward {shape} bf16")
            log(f"bound cond_pair_backward on f32 FMAs: "
                f"{bound_ms(0, 2 * flop, 'f32')[0]:.4f} ms")
    check_k3_kink(dev, kernels, gen)
    log(f"cond_pair_backward instances checked: {ran}")
    if not all(ran.values()):
        fail(f"an instance of cond_pair_backward was not checked: {ran}")


def time_k3_f32(k, x, dz, mods, sc):
    """K3 in f32 at step 0: the 3xTF32 instance and the CUDA-core one in
    turns beside the plain backward and both bounds."""
    side = instances_side_by_side(
        lambda inst: cpair.cond_pair_backward(
            x, dz, *mods, sc,
            instance=None if inst == cpair.TENSOR_CORES_TF32 else inst),
        cpair.TENSOR_CORES_TF32, cpair.CUDA_CORES, 3)
    ms = statistics.median(side[cpair.TENSOR_CORES_TF32])
    old = statistics.median(side[cpair.CUDA_CORES])
    plain_ms = time_ms(lambda: cpair.cond_pair_backward_reference(
        x, dz, *mods, sc), 3)
    flop = 2 * 2 * 27 * 32 * x.numel()
    tf32 = bound_ms(3 * x.numel() * 4, 3 * 2 * flop, "tf32")
    fma = bound_ms(3 * x.numel() * 4, 2 * flop, "f32")
    k.update(f32_ms=ms, f32_cuda_cores_ms=old, f32_plain_ms=plain_ms,
             f32_bound_ms=tf32[0], f32_bound_by=tf32[1],
             f32_fma_bound_ms=fma[0])
    log(f"time cond_pair_backward {tuple(x.shape)} f32, in turns "
        f"new/old/new/old/new: tensor cores 3xTF32 "
        f"{['%.4f' % t for t in side[cpair.TENSOR_CORES_TF32]]}, CUDA cores "
        f"{['%.4f' % t for t in side[cpair.CUDA_CORES]]} ms; median "
        f"{ms:.4f} ms against {old:.4f}  plain (cuDNN f32, TF32 off) "
        f"{plain_ms:.4f} ms; bound as 3xTF32 ({3 * 2 * flop / 1e9:.2f} G "
        f"TF32 operations / 495 T) {tf32[0]:.4f} ms ({tf32[1]}), on f32 FMAs "
        f"{fma[0]:.4f} ms")


def check_k3_kink(dev, kernels, gen):
    """K3 in f32 where many a pre lands within 2^-16 of 0 (``cpair.KINK``):
    x zero on a block of voxels, where pre is then b_a exactly, and four
    channels' b_a set to +-2^-18 and +-2^-20; through the 3xTF32 instance,
    with and without the scale, against the f64 gradient (whose PReLU
    branch is the f32 forward's), each launch repeated equal to the bit."""
    k = kernels["cond_pair_bwd"]
    shape = (1, 24, 96, 80)
    net = torch.nn.ModuleDict({"c3a": torch.nn.Conv3d(1, 32, 3, padding=1),
                               "c3b": torch.nn.Conv3d(32, 1, 3, padding=1),
                               "prelu": torch.nn.PReLU(1)})
    reset_parameters_(net, gen)
    with torch.no_grad():
        net["prelu"].weight.uniform_(0.05, 0.5, generator=gen)
        for ch, b in ((3, 2.0 ** -18), (7, -2.0 ** -18), (11, 2.0 ** -20),
                      (19, -2.0 ** -20)):
            net["c3a"].bias[ch] = b
    net = net.to(dev)
    mods = (net["c3a"], net["c3b"], net["prelu"])
    x = torch.randn(shape, generator=gen)
    x[:, 4:20, 20:70, 10:60] = 0.0
    x, dz = x.to(dev), torch.randn(shape, generator=gen).to(dev)
    near = int((cpair.pre_f32_taps(x, mods[0].weight, mods[0].bias).abs()
                < cpair.KINK).sum())
    if near == 0:
        fail("cond_pair_backward kink case: no pre within 2^-16 of 0")
    keep = ((torch.rand((1, 32), generator=gen) < 0.5).float() * 2.0).to(dev)
    for scale in (None, keep):
        run = lambda: cpair.cond_pair_backward(x, dz, *mods, scale)
        got = one_launch_of(cpair.cond_pair_backward, cpair.TENSOR_CORES_TF32,
                            run, f"cond_pair_backward kink {shape}")
        for g, again in zip(got, run()):
            exact_equal(again, g, f"cond_pair_backward kink {shape}, second "
                        f"launch")
        ref = k3_reference(x, dz, mods, scale)
        e = grads_err(got, ref, torch.float32, f"cond_pair_backward kink "
                      f"{shape} scale={scale is not None}")
        k["max_abs_err"] = max(k.get("max_abs_err", 0.0),
                               max((g - r).abs().max().item()
                                   for g, r in zip(got, ref)))
        log(f"cond_pair_backward kink case {shape} f32 (x zero on 16 x 50 x "
            f"50 voxels; {near} pre within 2^-16 of 0) Dropout3d scale "
            f"{scale is not None!s:5s} ({cpair.TENSOR_CORES_TF32}) "
            f"max|d|/max|f64| {e:.3e}")


def phase_small_rig(dev):
    cfg, model, stats, vidx, img = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), cfg.volume_side_size,
                        cfg.volume_side_size).astype(np.float32)
              for k in range(model.n_flow_steps + 1)]
    frames = rng.rand(2, img, img).astype(np.float32) * 1000
    # the reconstructor's default (stochastic) mode draws from a generator
    # on its own device: with both drop rates 0 (and the configuration's
    # temperature 0) nothing is drawn, and what is left of the mode, the
    # LRNN's BatchNorm on batch statistics and its mean branch per call, can
    # be compared between the card and the CPU
    plain = copy.deepcopy(model)
    lrnn_spec = dataclasses.replace(
        plain.lrnn.spec, convnext_drop=0.0, unet_drop=0.0,
        unet=dataclasses.replace(plain.lrnn.spec.unet, drop_out=0.0))
    plain.lrnn.spec, plain.lrnn.unet.spec = lrnn_spec, lrnn_spec.unet
    for what, m, kw in (("deterministic", model, {"deterministic": True}),
                        ("default mode, drop rates 0", plain, {})):
        ref = XLFMReconstructor(m, stats, vidx, caches, device="cpu",
                                **kw)(frames)
        got = XLFMReconstructor(m, stats, vidx, caches, device=dev,
                                **kw)(frames)
        rel = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
        log(f"small rig f32, {what}, card vs CPU: max|d|/max|ref| {rel:.3e} "
            f"(bound 1e-4)")
        if not rel <= 1e-4:
            fail(f"small rig ({what}) card vs CPU {rel:.3e} > 1e-4")


def small_rig_int8(dev):
    """The small rig in int8 (f32), card vs CPU.  The CPU's packs are carried
    to the card for the bound (<= 1e-3 of max|ref|); the card's own
    calibration is compared as well, with the int8 weights that differ
    between the two calibrations named."""
    cfg, model, stats, vidx, img = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), cfg.volume_side_size,
                        cfg.volume_side_size).astype(np.float32)
              for k in range(model.n_flow_steps + 1)]
    frames = rng.rand(2, img, img).astype(np.float32) * 1000
    cpu = XLFMReconstructor(model, stats, vidx, caches, device="cpu",
                            deterministic=True, calib_frames=frames, **INT8)
    ref = cpu(frames)
    card = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                             deterministic=True, calib_frames=frames, **INT8)
    flips = []
    for k, (a, b) in enumerate(zip(cpu.qpacks, card.qpacks)):
        for i, (pa, pb) in enumerate(zip(a, b)):
            for name, t in pa["qw"].items():
                if t.dtype != torch.int8:
                    continue
                n = int((t != pb["qw"][name].cpu()).sum())
                if n:
                    flips.append(f"step {k} block {i} {name}: {n}")
    for site, pk in cpu.unet_q["qpack"].items():
        n = int((pk["wq"] != card.unet_q["qpack"][site]["wq"].cpu()).sum())
        if n:
            flips.append(f"unet {site}: {n}")
    own = card(frames).cpu()
    card.qpacks = to_device(cpu.qpacks, dev)
    card.unet_q = to_device(cpu.unet_q, dev)
    got = card(frames).cpu()
    scale = ref.abs().max()
    rel = ((got - ref).abs().max() / scale).item()
    rel_own = ((own - ref).abs().max() / scale).item()
    log(f"small rig int8 f32, card vs CPU, CPU packs: max|d|/max|ref| "
        f"{rel:.3e} (bound 1e-3); card's own calibration: {rel_own:.3e} "
        f"(bound 5e-3); int8 weights that differ between the card's and the "
        f"CPU's calibration: {'; '.join(flips) or 'none'}")
    if not rel <= 1e-3:
        fail(f"small rig int8 card vs CPU {rel:.3e} > 1e-3")
    if not rel_own <= 5e-3:
        fail(f"small rig int8, card's own calibration, {rel_own:.3e} > 5e-3")


def launch_counts():
    return {name: getattr(k["wrapper"], k.get("counter", "launches"))
            for name, k in KERNELS.items()}


def reset_counts():
    for k in KERNELS.values():
        setattr(k["wrapper"], k.get("counter", "launches"), 0)
    for wrapper in (btower.fused_float_tower, qtower.fused_tower,
                    cpair.cond_pair, probes.tiled_gemm, probes.chained_gemm,
                    btower.float_tower_backward, cpair.cond_pair_backward):
        for name in wrapper.by_instance:
            wrapper.by_instance[name] = 0


def check_instance(name: str, instance: str, what: str):
    """Fails unless every launch of kernel ``name`` since reset_counts() ran
    ``instance``."""
    by_instance = KERNELS[name]["wrapper"].by_instance
    n = launch_counts()[name]
    log(f"{what}: {name} launches by instance {by_instance}")
    if by_instance[instance] != n:
        fail(f"{what}: {by_instance[instance]} of its {n} {name} launches ran "
             f"the {instance} instance")


def check_counts(per_call: dict, calls: int, what: str, before: dict) -> dict:
    """The launches since ``before``, failing unless every kernel was
    launched ``per_call`` (0 where not named) times ``calls``."""
    after = launch_counts()
    delta = {name: after[name] - before[name] for name in after}
    for name, n in delta.items():
        if n != per_call.get(name, 0) * calls:
            fail(f"{what}: {name} launched {n} times in {calls} calls, "
                 f"expected {per_call.get(name, 0) * calls}")
    return delta


def phase_flagship(dev, card, kernels):
    t0 = time.perf_counter()
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    log(f"flagship model built on the CPU in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters())} parameters)")
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                              deterministic=True,
                              compute_dtype=torch.bfloat16)
    out_shape = (cfg.n_depths, side, side)
    frames1 = None
    reset_counts()
    for batch in (1, 8):
        frames = torch.as_tensor(
            rng.rand(batch, img, img).astype(np.float32) * 1000).to(dev)
        if batch == 1:
            frames1 = frames
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = recon(frames)                                   # warm-up
        torch.cuda.synchronize()
        if tuple(out.shape) != (batch,) + out_shape:
            fail(f"flagship output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail("flagship output has non-finite values")
        ms = event_ms(lambda: recon(frames))
        peak = torch.cuda.max_memory_allocated()
        delta = check_counts(BF16_PER_CALL, 4, "flagship bf16", before)
        log(f"flagship bf16 batch {batch}: out {tuple(out.shape)} finite; "
            f"{np.median(ms) / batch:.2f} ms/frame (median of {ms} ms per "
            f"call); peak memory {peak / 2**30:.2f} GiB; launches "
            f"{delta} in 4 calls; on {card}")
        del out
    check_instance("fused_float_tower", btower.WGMMA_BF16, "flagship bf16")
    check_instance("cond_pair", cpair.TENSOR_CORES, "flagship bf16")
    for name, n in launch_counts().items():
        if name in BF16_PER_CALL:
            kernels[name]["launches"] = n
    return model, stats, vidx, caches, frames1, recon


def phase_flagship_stochastic(dev, card, model, stats, vidx, caches, frames1):
    """The reconstructor's default mode at the flagship width, bf16, batch 1:
    the LRNN in train mode (BatchNorm on batch statistics, Dropout2d,
    drop_path, the mean branch per call), every draw from the generator
    seeded with the configuration's seed.  Two reconstructors agree on
    their first call and a second call differs from the first (the dropout
    masks); then one call with z sampled at temperature 0.7 and two samples
    per frame.  The launch counts per call are the deterministic path's."""
    side = model.cfg.volume_side_size
    out_shape = (1, model.cfg.n_depths, side, side)
    kw = {"device": dev, "compute_dtype": torch.bfloat16}
    recon = XLFMReconstructor(model, stats, vidx, caches, **kw)
    twin = XLFMReconstructor(model, stats, vidx, caches, **kw)
    if recon.deterministic or recon.mean_branch is not None:
        fail("the reconstructor's default is not the stochastic mode")
    reset_counts()
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    first, second, other = recon(frames1), recon(frames1), twin(frames1)
    torch.cuda.synchronize()
    for out in (first, second, other):
        if tuple(out.shape) != out_shape or not bool(torch.isfinite(out).all()):
            fail(f"flagship default mode: output {tuple(out.shape)} or "
                 f"non-finite values")
    if not torch.equal(first, other):
        fail("two reconstructors from the same seed disagree on their first "
             f"call: max|d| {(first - other).abs().max().item():.3e}")
    if torch.equal(first, second):
        fail("two calls of the default mode gave the same volume")
    ms = event_ms(lambda: recon(frames1))
    peak = torch.cuda.max_memory_allocated()
    delta = check_counts(BF16_PER_CALL, 6, "flagship default mode", before)
    check_instance("fused_float_tower", btower.WGMMA_BF16, "flagship default mode")
    check_instance("cond_pair", cpair.TENSOR_CORES, "flagship default mode")
    d12 = ((first - second).abs().max() / first.abs().max()).item()
    log(f"flagship bf16 default mode (deterministic=False) batch 1: out "
        f"{tuple(first.shape)} finite; two reconstructors from one seed agree "
        f"to the bit; a second call differs by {d12:.3e} of max|out|; "
        f"{np.median(ms):.2f} ms/frame (median of {ms} ms per call); peak "
        f"memory {peak / 2**30:.2f} GiB; launches {delta} in 6 calls; on "
        f"{card}")
    del first, second, other, recon, twin
    sampled = copy.deepcopy(model)
    sampled.cfg = dataclasses.replace(model.cfg, INN_z_temperature=0.7,
                                      INN_n_samples=2)
    recon = XLFMReconstructor(sampled, stats, vidx, caches, **kw)
    before = launch_counts()
    out = recon(frames1)
    torch.cuda.synchronize()
    if tuple(out.shape) != out_shape or not bool(torch.isfinite(out).all()):
        fail(f"flagship sampled: output {tuple(out.shape)} or non-finite")
    delta = check_counts(BF16_PER_CALL, 1, "flagship sampled", before)
    log(f"flagship bf16, temperature 0.7, 2 samples per frame, batch 1: out "
        f"{tuple(out.shape)} finite; launches {delta} in 1 call")


def phase_bf16_vs_f32(dev, model, stats, vidx, caches, frames1, recon16):
    out16 = recon16(frames1)
    recon32 = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                                deterministic=True,
                                compute_dtype=torch.float32)
    out32 = recon32(frames1)
    rel = ((out16 - out32).abs().max() / out32.abs().max()).item()
    log(f"flagship batch 1, bf16 vs f32: max|d|/max|f32| {rel:.3e} "
        f"(bound 5e-2)")
    if not rel <= 5e-2:
        fail(f"flagship bf16 vs f32 {rel:.3e} > 5e-2")
    return out32


def event_ms(fn, n: int = 3) -> list:
    """CUDA-event times in ms of ``n`` single calls of fn()."""
    ms = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def cuda_ms(fn, iters: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of fn() after one warm-up."""
    fn()
    return float(np.median(event_ms(fn, iters)))


def int8_layer_times(recon, frames):
    """(int8 UNet, bf16 UNet, 16 int8 towers, 16 bf16 towers) ms on the
    batch's own inputs; the bf16 towers run ``fused_float_tower``."""
    m = recon.model
    with torch.inference_mode():
        views = recon._normalized_views(frames)
        y = m.lrnn.proj(views)
        c_views = cond_networks_batched(m.cond, views)
        uq = recon.unet_q

        def towers_int8():
            for k, packs in enumerate(recon.qpacks):
                xq = qtower.quantize_input(c_views[k], packs[0]["scales"][0])
                for pk in packs:
                    qtower.fused_tower(xq, pk["qw"], pk["scales"],
                                       out_dtype=c_views[k].dtype)

        def towers_bf16():
            for k, step in enumerate(m.flow):
                for block in step.blocks:
                    block["subnet"](c_views[k])

        return (cuda_ms(lambda: unet_quantized(m.lrnn.unet, y, uq["qpack"],
                                               uq["scales"])),
                cuda_ms(lambda: m.lrnn.unet(y)),
                cuda_ms(towers_int8), cuda_ms(towers_bf16))


def phase_flagship_int8(dev, card, kernels, model, stats, vidx, caches,
                        frames1):
    """The int8 slice at the flagship width, bf16, batch 1 (the bf16 path's
    batch-1 frames) and 8, each calibrated on its own batch
    (bench.py:99-102).  Returns the batch-1 output."""
    rng = np.random.RandomState(1)
    img = frames1.shape[-1]
    side = model.cfg.volume_side_size
    out_shape = (model.cfg.n_depths, side, side)
    out1, runs = None, []
    reset_counts()
    for batch in (1, 8):
        frames = frames1 if batch == 1 else torch.as_tensor(
            rng.rand(batch, img, img).astype(np.float32) * 1000).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                                  deterministic=True,
                                  compute_dtype=torch.bfloat16,
                                  calib_frames=frames, **INT8)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        if (sum(pk is not None for step in recon.qpacks for pk in step)
                != INT8_PER_CALL["fused_tower"]):
            fail("flagship int8: not every coupling tower was quantized")
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = recon(frames)                                   # warm-up
        torch.cuda.synchronize()
        if tuple(out.shape) != (batch,) + out_shape:
            fail(f"flagship int8 output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            fail("flagship int8 output has non-finite values")
        ms = event_ms(lambda: recon(frames))
        peak = torch.cuda.max_memory_allocated()
        delta = check_counts(INT8_PER_CALL, 4, "flagship int8", before)
        log(f"flagship int8 bf16 batch {batch}: calibration + build "
            f"{calib_s:.2f} s; out {tuple(out.shape)} finite; "
            f"{np.median(ms) / batch:.2f} ms/frame (median of {ms} ms per "
            f"call); peak memory {peak / 2**30:.2f} GiB; launches "
            f"{delta} in 4 calls; on {card}")
        if batch == 1:
            out1 = out
        runs.append((batch, recon, frames))
    check_instance("fused_tower", qtower.WGMMA_S8, "flagship int8")
    check_instance("cond_pair", cpair.TENSOR_CORES, "flagship int8")
    check_instance("fused_float_tower", btower.WGMMA_BF16, "flagship int8")
    kernels["fused_tower"]["launches"] = launch_counts()["fused_tower"]
    for batch, recon, frames in runs:
        uq, ub, tq, tb = int8_layer_times(recon, frames)
        log(f"flagship batch {batch} layers: UNet int8 {uq:.3f} ms vs bf16 "
            f"{ub:.3f} ms; 16 coupling towers int8 (fused_tower) {tq:.3f} ms "
            f"vs bf16 (fused_float_tower) {tb:.3f} ms; on {card}")
    return out1

def phase_int8_cond(dev, card, model, stats, vidx, caches, frames1, out32):
    """``use_int8_cond`` (the cond nets' 3-D pairs with an int8 y, on
    cuBLAS): the small rig card vs CPU in f32 (the CPU's packs carried to
    the card: 1e-3 of max|ref|; the card's own: 5e-3); the flagship in bf16
    at batch 1: launches (no ``cond_pair``), ms/frame, the norm ratio to the
    f32 output; and at step 0 the int8 pair against ``cond_pair`` on the
    same (1, 48, 512, 512) bf16 input."""
    cfg_s, model_s, stats_s, vidx_s, img_s = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    caches_s = [rng.randn(1, cfg_s.n_depths // 2 ** (k + 1),
                          cfg_s.volume_side_size, cfg_s.volume_side_size)
                .astype(np.float32) for k in range(model_s.n_flow_steps + 1)]
    frames_s = rng.rand(2, img_s, img_s).astype(np.float32) * 1000
    kw = dict(deterministic=True, use_int8_cond=True, calib_frames=frames_s)
    cpu = XLFMReconstructor(model_s, stats_s, vidx_s, caches_s, device="cpu",
                            **kw)
    ref = cpu(frames_s)
    card_r = XLFMReconstructor(model_s, stats_s, vidx_s, caches_s,
                               device=dev, **kw)
    own = card_r(frames_s).cpu()
    card_r.cond_q = to_device(cpu.cond_q, dev)
    got = card_r(frames_s).cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    rel_own = ((own - ref).abs().max() / ref.abs().max()).item()
    if not (rel <= 1e-3 and rel_own <= 5e-3):
        fail(f"small rig use_int8_cond card vs CPU {rel:.3e} (bound 1e-3), "
             f"own calibration {rel_own:.3e} (bound 5e-3)")

    t0 = time.perf_counter()
    recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                              deterministic=True, compute_dtype=torch.bfloat16,
                              use_int8_cond=True, calib_frames=frames1)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    out = recon(frames1)
    before = launch_counts()
    ms = event_ms(lambda: recon(frames1))
    delta = check_counts(INT8_COND_PER_CALL, 3, "flagship use_int8_cond",
                         before)
    ratio = rel_norm(out, out32)
    if not (bool(torch.isfinite(out).all()) and ratio < 5e-2):
        fail(f"flagship use_int8_cond vs f32: norm ratio {ratio:.3e} "
             f"(bound 5e-2), finite {bool(torch.isfinite(out).all())}")
    from cwfa_tpu_torch.models import cond_net
    from cwfa_tpu_torch.ops.int8_conv import conv2d_int8, quantize_mul
    with torch.inference_mode():
        net = recon.model.cond[0]
        x = net.stack2d(recon._normalized_views(frames1)).contiguous()
        q = recon.cond_q[0]
        ms_q = cuda_ms(lambda: cond_net.conv3d_pair_int8(net, x, q))
        ms_k = cuda_ms(lambda: cpair.cond_pair(x, net.c3a, net.c3b,
                                               net.prelu))
        # the int8 pair's parts, each alone on its own inputs
        y = cond_net.conv_a_depthbatch(net, x)
        yq = quantize_mul(y, q["inv_s"])
        acc = conv2d_int8(yq, q["wbq"], 1)
        parts = {
            "conv_a": cuda_ms(lambda: cond_net.conv_a_depthbatch(net, x)),
            "quantize": cuda_ms(lambda: quantize_mul(y, q["inv_s"])),
            "conv_b int8": cuda_ms(lambda: conv2d_int8(yq, q["wbq"], 1)),
            "dequantize + band-add": cuda_ms(lambda: cond_net.band_add(
                (acc.float() * q["sb"][None, :, None, None]).to(x.dtype)
                .reshape(x.shape[:2] + (3,) + x.shape[2:]), net.c3b.bias))}
        del y, yq, acc
    log(f"use_int8_cond: small rig f32 card vs CPU, CPU packs max|d|/max|ref| "
        f"{rel:.3e} (bound 1e-3), card's own calibration {rel_own:.3e} "
        f"(bound 5e-3); flagship bf16 batch 1: calibration + build "
        f"{calib_s:.2f} s, {np.median(ms):.2f} ms/frame (median of {ms}), "
        f"launches {delta} in 3 calls, norm ratio to f32 {ratio:.3e} (bound "
        f"5e-2); step 0 {tuple(x.shape)} bf16: the int8 pair (conv_a, "
        f"quantize, int8 conv_b on cuBLAS, band-add) {ms_q:.3f} ms (parts "
        f"alone: { {k: round(v, 3) for k, v in parts.items()} }) vs "
        f"cond_pair {ms_k:.3f} ms; on {card}")
    return {"ms_frame": float(np.median(ms)), "pair_ms": ms_q,
            "cond_pair_ms": ms_k}


def int8_cond_alone(dev, card):
    """``phase_int8_cond`` on the flagship's batch-1 frame of
    ``phase_flagship``, with its f32 output."""
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    frames1 = torch.as_tensor(rng.rand(1, img, img).astype(np.float32)
                              * 1000).to(dev)
    out32 = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                              deterministic=True)(frames1)
    phase_int8_cond(dev, card, model, stats, vidx, caches, frames1, out32)


def one_launch_of(wrapper, instance: str, fn, what: str):
    """fn()'s result, failing unless fn() made exactly one launch of
    ``wrapper`` and that launch ran ``instance``."""
    before = dict(wrapper.by_instance)
    out = fn()
    ran = {k: n - before[k] for k, n in wrapper.by_instance.items()
           if n != before[k]}
    if ran != {instance: 1}:
        fail(f"{what}: launches by instance {ran}, expected one {instance}")
    return out


def exact_equal(got, ref, what: str):
    torch.cuda.synchronize()
    if got.dtype != ref.dtype or got.shape != ref.shape:
        fail(f"{what}: {got.dtype} {tuple(got.shape)} against "
             f"{ref.dtype} {tuple(ref.shape)}")
    ndiff = int((got != ref).sum())
    if ndiff:
        fail(f"{what}: {ndiff} of {got.numel()} elements differ")


def two_rounding_fma(x, y, t: int, u: int):
    """The FMA probe's function with a * x + y rounded twice per step (the
    form of the JAX kernel's source), for the stated distance to the fused
    form."""
    accs = [y * (0.5 + 0.01 * k) for k in range(u)]
    for _ in range(t):
        accs = [a * x + y for a in accs]
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc


def instances_side_by_side(call, new: str, old: str, iters: int) -> dict:
    """{instance: [ms, ...]}: call(instance) timed for the new instance,
    the old one, the new, the old and the new, in that order."""
    side = {}
    for inst in (new, old, new, old, new):
        side.setdefault(inst, []).append(time_ms(lambda: call(inst), iters))
    return side


def phase_probes(dev, card, kernels):
    """The four probe kernels against their plain versions on the card at
    every shape the probe scripts' entry points give them and at small and
    odd ones, then those entry points for the times, their launches held to
    the expected counts.  int8 (GEMM, out8, chain):
    equal to the bit.  bf16 GEMM: <= 2^-7 max|ref| (exact products, f32 sums
    in another order, one rounding to bf16).  bf16 chain: <= 2^-6 max|ref|
    (a value that rounds the other way is carried through the later
    stages).  FMA probe: mul and roll equal to the bit; fma <= one f32 ulp
    of the plain version's fused form, and within t ulps of the two-rounding
    form a * x + y at the probe's own inputs."""
    gen = torch.Generator(device=dev).manual_seed(4)
    micro = load_script("torch_bench_int8_micro")
    rate = load_script("torch_probe_cuda_core_rate")
    big, iters = 1 << 20, 10
    kg, kc, k8, kf = (kernels[n] for n in ("tiled_gemm", "chained_gemm",
                                           "tiled_gemm_out8", "fma_probe"))

    # ---- tiled_gemm and its out8 epilogue
    shapes = [(big, k, n) for k, n in micro.GEMM_SHAPES]     # probe_pallas's
    shapes += [(37, 20, 5), (129, 100, 130), (300, 1153, 136)]
    main_gemm = {}
    for m, k, n in shapes:
        a = micro.make((m, k), torch.int8, dev, gen)
        b = micro.make((k, n), torch.int8, dev, gen)
        a[0], b[:, 0] = -127, 127           # a corner of large negative sums
        ref = probes.tiled_gemm_reference(a, b)
        exact_equal(probes.tiled_gemm(a, b), ref, f"tiled_gemm int8 {(m, k, n)}")
        ref8 = probes.requant(ref)
        for inst in (probes.WGMMA_S8, probes.MMA_SYNC):
            what = f"tiled_gemm out8 {(m, k, n)} ({inst})"
            exact_equal(one_launch_of(probes.tiled_gemm, inst, lambda: (
                probes.tiled_gemm(a, b, out8=True, instance=inst)), what),
                ref8, what)
        log(f"tiled_gemm int8 {(m, k, n)}: int32 out and out8 (both "
            f"instances) equal the plain version to the bit (sums "
            f"{int(ref.min())}..{int(ref.max())}; "
            f"{float((ref8 < 0).float().mean()):.2f} of out8 negative)")
        if (m, k, n) == (big, 1152, 128):
            main_gemm = {"a": a, "b": b}
        del ref, ref8
        a, b = (micro.make(sh, torch.bfloat16, dev, gen)
                for sh in ((m, k), (k, n)))
        e = share_err(probes.tiled_gemm(a, b), probes.tiled_gemm_reference(a, b),
                      2.0 ** -7, f"tiled_gemm bf16 {(m, k, n)}")
        log(f"tiled_gemm bf16 {(m, k, n)}: max|d| {e:.3e} (bound 2^-7 max|ref|)")
        del a, b
    kg["max_abs_err"] = k8["max_abs_err"] = 0.0      # the int8 instances

    # ---- chained_gemm
    main_chain = {}
    for m, depth, full in [(big, micro.CHAIN_DEPTH, True), (1000, 8, False),
                           (37, 3, False), (256, 1, False)]:
        x = micro.make((m, 128), torch.int8, dev, gen)
        ws = micro.make((depth, 128, 128), torch.int8, dev, gen)
        if not full:                # smaller weights: fewer sums saturate
            ws = ws // 8
        ref = probes.chained_gemm_reference(x, ws)
        for inst in (probes.WGMMA_S8, probes.MMA_SYNC):
            what = f"chained_gemm int8 M {m} depth {depth} ({inst})"
            exact_equal(one_launch_of(probes.chained_gemm, inst, lambda: (
                probes.chained_gemm(x, ws, instance=inst)), what), ref, what)
        log(f"chained_gemm int8 M {m} depth {depth}: both instances equal "
            f"to the bit ({float((ref.abs() == 127).float().mean()):.2f} of the "
            f"outputs at the clip)")
        if full:
            main_chain = {"x": x, "ws": ws}
        x = micro.make((m, 128), torch.bfloat16, dev, gen)
        ws = micro.make((depth, 128, 128), torch.bfloat16, dev, gen)
        e = share_err(probes.chained_gemm(x, ws),
                      probes.chained_gemm_reference(x, ws), 2.0 ** -6,
                      f"chained_gemm bf16 M {m} depth {depth}")
        log(f"chained_gemm bf16 M {m} depth {depth}: max|d| {e:.3e} "
            f"(bound 2^-6 max|ref|)")
        del x, ws, ref
    kc["max_abs_err"] = 0.0

    # ---- fma_probe
    kf["max_abs_err"] = 0.0
    for rows, t, own in [(rate.ROWS_PROBE, 512, True),
                         (rate.ROWS_FULL, 512, True), (37, 8, False)]:
        if own:
            x = torch.full((rows, 128), 1.0000001, device=dev)
            y = torch.full((rows, 128), 1e-9, device=dev)
        else:
            x = torch.rand((rows, 128), device=dev, generator=gen) * 2 - 1
            y = torch.randn((rows, 128), device=dev, generator=gen)
        for mode in probes.FMA_MODES:
            for u in sorted({*PROBE_US, 3}):
                got = probes.fma_probe(x, y, t=t, u=u, mode=mode)
                ref = probes.fma_probe_reference(x, y, t=t, u=u, mode=mode)
                what = f"fma_probe {mode} rows {rows} t {t} u {u}"
                if mode != "fma":
                    exact_equal(got, ref, what)
                    continue
                torch.cuda.synchronize()
                d = (got - ref).abs()
                if bool((d > 2.0 ** -23 * ref.abs()).any()):
                    fail(f"{what}: more than one ulp from the fused plain "
                         f"version (max|d| {d.max().item():.3e})")
                kf["max_abs_err"] = max(kf["max_abs_err"], d.max().item())
                if own:
                    two = two_rounding_fma(x, y, t, u)
                    d2 = ((got - two).abs() / two.abs()).max().item()
                    log(f"{what}: against the two-rounding a * x + y "
                        f"max|d|/|ref| {d2:.3e} (bound t 2^-23 = "
                        f"{t * 2.0 ** -23:.3e})")
                    if not d2 <= t * 2.0 ** -23:
                        fail(f"{what}: {d2:.3e} from a * x + y")
        log(f"fma_probe rows {rows} t {t}: mul and roll equal the plain "
            f"version to the bit, fma within one ulp (max|d| "
            f"{kf['max_abs_err']:.3e}), u {sorted({*PROBE_US, 3})}")

    # ---- the probes' own entry points, counted
    reset_counts()
    before = launch_counts()
    recs = micro.probe_pallas(iters=iters, log=log)
    recs += micro.probe_chain(iters=iters, log=log)
    frecs = rate.probe_fma(n=iters, us=PROBE_US, log=log)
    # every configuration is launched WARMUP + iters times: each GEMM shape
    # and each chain in int8 and bf16, the out8 GEMM once (it also counts as
    # a tiled_gemm), the FMA probe at two row counts in every mode and u
    per = WARMUP + iters
    delta = check_counts(
        {"tiled_gemm": 2 * len(micro.GEMM_SHAPES) + 1, "chained_gemm": 2,
         "tiled_gemm_out8": 1,
         "fma_probe": 2 * len(probes.FMA_MODES) * len(PROBE_US)},
        per, "probe scripts", before)
    for name in ("tiled_gemm", "chained_gemm", "tiled_gemm_out8", "fma_probe"):
        kernels[name]["launches"] = delta[name]
    log(f"probe scripts: launches {delta}, {per} of each configuration")
    # the int8 chain (M 2^20) and the out8 GEMM (N 128) ran the s8 wgmma
    # instances, every other launch its older one
    gi, ci = probes.tiled_gemm.by_instance, probes.chained_gemm.by_instance
    log(f"probe scripts: tiled_gemm launches by instance {gi}, chained_gemm "
        f"{ci}")
    if gi[probes.WGMMA_S8] != per or ci[probes.WGMMA_S8] != per \
            or ci[probes.MMA_SYNC] != per:
        fail(f"probe scripts: {gi[probes.WGMMA_S8]} of the {per} out8 and "
             f"{ci[probes.WGMMA_S8]} of the {per} int8 chain launches ran "
             f"{probes.WGMMA_S8}")
    by_key = {r["key"]: r for r in recs}
    m, kk, n = big, 1152, 128
    r = by_key["gemm", "i8", kk, n]
    kg["ms"], kg["library_ms"] = r["ms"], r["library_ms"]
    a, b = main_gemm["a"], main_gemm["b"]
    kg["plain_ms"] = time_ms(lambda: probes.tiled_gemm_reference(a, b), 2, 1)
    set_bound(kg, m * kk + kk * n + 4 * m * n, 2 * m * kk * n, "int8",
              f"tiled_gemm int8 -> int32 {(m, kk, n)}")
    r = by_key["gemm_out8", "i8", kk, n]
    k8["script_ms"], k8["library_ms"] = r["ms"], None   # no one call does both
    k8["plain_ms"] = time_ms(
        lambda: probes.tiled_gemm_reference(a, b, out8=True), 2, 1)
    set_bound(k8, m * kk + kk * n + m * n, 2 * m * kk * n, "int8",
              f"tiled_gemm int8 -> int8 {(m, kk, n)}")
    lib8 = time_ms(lambda: probes.requant(torch._int_mm(a, b)), 10)
    log(f"out8 as library calls (torch._int_mm, then the epilogue in "
        f"torch): {lib8:.4f} ms; on {card}")
    # the older instance beside the new one, in turns, after the counted
    # launches; ms is the new one's median there (the script's single
    # reading, taken right after the GEMM probes, is kept as script_ms)
    side = instances_side_by_side(
        lambda inst: probes.tiled_gemm(a, b, out8=True, instance=inst),
        probes.WGMMA_S8, probes.MMA_SYNC, iters)
    k8["ms"] = statistics.median(side[probes.WGMMA_S8])
    k8["mma_sync_ms"] = statistics.median(side[probes.MMA_SYNC])
    log(f"tiled_gemm out8 {(m, kk, n)} side by side: {side}; script "
        f"{k8['script_ms']:.4f} ms; on {card}")
    r = by_key["chain", "int8"]
    kc["script_ms"], kc["library_ms"] = r["ms"], None   # eight calls, not one
    x, ws = main_chain["x"], main_chain["ws"]
    kc["plain_ms"] = time_ms(lambda: probes.chained_gemm_reference(x, ws), 2, 1)
    side = instances_side_by_side(
        lambda inst: probes.chained_gemm(x, ws, instance=inst),
        probes.WGMMA_S8, probes.MMA_SYNC, iters)
    kc["ms"] = statistics.median(side[probes.WGMMA_S8])
    kc["mma_sync_ms"] = statistics.median(side[probes.MMA_SYNC])
    log(f"chained_gemm int8 M {m} depth 8 side by side: {side}; script "
        f"{kc['script_ms']:.4f} ms; on {card}")
    set_bound(kc, 2 * m * 128 + 8 * 128 * 128, 2 * m * 128 * 128 * 8, "int8",
              f"chained_gemm int8 M {m} depth 8")
    rb = by_key["chain", "bfloat16"]
    log(f"chained_gemm bf16 M {m} depth 8: {rb['ms']:.4f} ms, bound "
        f"{bound_ms(4 * m * 128, rb['ops'], 'bf16')[0]:.4f} ms by operations")
    fr = next(r for r in frecs if r["mode"] == "fma" and r["u"] == 8
              and r["rows"] == rate.ROWS_FULL)
    kf["ms"], kf["library_ms"] = fr["ms"], None
    rows = fr["rows"]
    x = torch.full((rows, 128), 1.0000001, device=dev)
    y = torch.full((rows, 128), 1e-9, device=dev)
    kf["plain_ms"] = time_ms(lambda: probes.fma_probe_reference(
        x, y, t=fr["t"], u=8, mode="fma"), 1, 1)
    set_bound(kf, 3 * rows * 128 * 4, fr["ops"], "f32",
              f"fma_probe fma rows {rows} t {fr['t']} u 8")


def nll_bound(got, ref, what: str):
    """|d| <= 1e-4 * max(1, |ref|): the towers' and the reductions' f32 sums
    run in another order on the card."""
    g, r = got.double().cpu(), ref.double().cpu()
    d = (g - r).abs()
    if not bool(torch.isfinite(g).all()) or bool(
            (d > 1e-4 * r.abs().clamp_min(1.0)).any()):
        fail(f"{what}: max|d| {d.max().item():.3e} over the bound")
    return d.max().item()


def logdet_bound(ld, ld_rev, what: str) -> float:
    """max|ld + ld_rev| of forward-then-reverse log-dets, failing unless
    every |ld + ld_rev| <= max(1e-4, 2^-20 |ld|): the absolute 1e-4 up to
    |ld| ~ 105, eight f32 ulps of |ld| above it (one ulp of a log-det of
    1024 or more is 2^-13, over 1e-4, so a sum that cancels to rounding can
    exceed an absolute 1e-4)."""
    torch.cuda.synchronize()
    d = (ld.float() + ld_rev.float()).abs()
    bound = (2.0 ** -20 * ld.float().abs()).clamp_min(1e-4)
    if not bool(torch.isfinite(d).all()) or bool((d > bound).any()):
        fail(f"{what}: |ld + ld_rev| {d.tolist()} over max(1e-4, 2^-20 |ld|) "
             f"for ld {ld.tolist()}")
    return d.max().item()


def phase_likelihood_small(dev):
    """Small rig, f32: per-frame NLLs card (kernels) vs CPU (plain) from the
    same volumes and the same noise; one step forward then back."""
    cfg, model, stats, _, _ = flagship(
        True, "cpu", torch.Generator().manual_seed(0))
    model.eval()
    card_model = copy.deepcopy(model).to(dev)
    rng = np.random.RandomState(3)
    side = cfg.volume_side_size
    vols = (rng.randn(3, cfg.n_depths, side, side) * 5 + 10).astype(np.float32)
    vols[1, 4] = 0.0                          # an empty depth slice
    outs = []
    for m_, d_ in ((model, "cpu"), (card_model, dev)):
        scorer = PyramidScorer(m_, stats, device=d_, batch_size=3,
                               generator=torch.Generator().manual_seed(1))
        outs.append(scorer(vols))
    (nll_c, cache_c, pri_c, lj_c), (nll_g, cache_g, pri_g, lj_g) = outs
    e = max(nll_bound(nll_g, nll_c, "small rig NLLs"),
            nll_bound(pri_g, pri_c, "small rig priors"),
            nll_bound(lj_g, lj_c, "small rig log-jacobians"))
    for k, (g, c) in enumerate(zip(cache_g, cache_c)):
        nll_bound(g, c, f"small rig pyramid level {k}")
    log(f"small rig NLL f32, card vs CPU: nlls {nll_g.T.tolist()} max|d| "
        f"{e:.3e} (bound 1e-4 max(1, |ref|)), pyramid levels within the "
        f"same bound")
    again = torch.stack(card_model.nll_from_pyramid(cache_g))
    nll_bound(again, nll_g, "nll_from_pyramid vs forward_pyramid")

    gen = torch.Generator(device=dev).manual_seed(2)
    for k, step in enumerate(card_model.flow):
        d = cfg.n_depths // 2 ** k
        v = torch.randn((2, d, side, side), device=dev, generator=gen)
        cv, cm = (torch.randn((b, d // 2, side, side), device=dev,
                              generator=gen) for b in (2, 1))
        z, avg, ld = step(v, cv, cm)
        back, ld_rev = step.reverse(z, avg, cv, cm)
        fast = step.reverse_fast(z, avg, cv, cm)
        e_rt = share_err(back, v, 1e-5, f"step {k} forward then reverse")
        e_fast = share_err(fast, back, 1e-5, f"step {k} reverse_fast vs reverse")
        logdet_bound(ld, ld_rev, f"step {k} log-dets")
        log(f"small rig step {k} on the card: forward then reverse max|d| "
            f"{e_rt:.3e}, reverse_fast vs reverse {e_fast:.3e} (bounds 1e-5 "
            f"max|ref|); log-dets {ld.tolist()} cancel to "
            f"{(ld + ld_rev).abs().max().item():.3e}")


def phase_likelihood_flagship(dev, card, kernels, model, stats):
    """The forward pyramid at the flagship width, f32, through
    ``PyramidScorer`` at batch 1 and 4."""
    cfg = model.cfg
    card_model = copy.deepcopy(model).to(dev).eval()
    scorer = PyramidScorer(card_model, stats, device=dev, batch_size=4,
                           generator=torch.Generator(device=dev).manual_seed(5))
    rng = np.random.RandomState(5)
    side = cfg.volume_side_size
    nf = card_model.n_flow_steps
    reset_counts()
    for batch in (1, 4):
        vols = torch.as_tensor(
            (rng.rand(batch, cfg.n_depths, side, side) * 20)
            .astype(np.float16)).to(dev)
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        nlls, cache, priors, ljs = scorer(vols)               # warm-up
        torch.cuda.synchronize()
        if tuple(nlls.shape) != (nf, batch) or len(cache) != nf + 1:
            fail(f"flagship NLL shape {tuple(nlls.shape)}")
        if not bool(torch.isfinite(nlls).all()) or bool(
                (nlls == 1e15).any()):
            fail(f"flagship NLLs not finite: {nlls.tolist()}")
        ms = event_ms(lambda: scorer(vols))
        peak = torch.cuda.max_memory_allocated()
        delta = check_counts(NLL_PER_CALL, 4, "flagship NLL", before)
        log(f"flagship NLL f32 batch {batch}: nlls {tuple(nlls.shape)} "
            f"finite, frame 0 {[round(v, 4) for v in nlls[:, 0].tolist()]}; "
            f"{np.median(ms) / batch:.2f} ms/frame (median of {ms} ms per "
            f"call); peak memory {peak / 2**30:.2f} GiB; launches {delta} "
            f"in 4 calls; on {card}")
        del nlls, cache, priors, ljs, vols
    check_instance("fused_float_tower", btower.WGMMA_3XTF32, "likelihood path")
    n32 = launch_counts()["fused_float_tower"]
    kernels["fused_float_tower"]["f32_launches"] = n32
    log(f"likelihood path launches in 8 calls: cat_affine "
        f"{launch_counts()['cat_affine']} (forward mode), fused_float_tower "
        f"{n32} (all the f32 instance, {btower.WGMMA_3XTF32})")


def write_checkpoint_dir(root: Path, dev, model, stats):
    """``model`` as a checkpoint directory ``root/ckpt`` through the port's
    writer, with the mean caches of a seeded mean volume (computed on the
    card) as dataset 0's.  Fails unless it reads back equal to the bit.
    Returns (directory, files)."""
    cfg = model.cfg
    side = cfg.volume_side_size
    ckpt = root / "ckpt"
    files = checkpoints.save_model_checkpoints(model, str(ckpt), epoch=0,
                                               stats=stats)
    card_model = copy.deepcopy(model).to(dev).eval()
    mean = torch.as_tensor(np.random.RandomState(7).randn(
        1, cfg.n_depths, side, side).astype(np.float32)).to(dev)
    caches = [c.cpu().numpy() for c in card_model.make_mean_caches(mean)]
    del card_model, mean
    files += checkpoints.save_mean_caches(str(ckpt), {0: caches})
    reloaded = CWFAModel.build(cfg, torch.Generator().manual_seed(1))
    got_stats, steps = checkpoints.load_model_checkpoints(reloaded, str(ckpt))
    want, got = model.state_dict(), reloaded.state_dict()
    if steps != list(range(1, cfg.INN_max_down_steps + 1)) \
            or got_stats.astuple() != stats.astuple() \
            or set(want) != set(got) \
            or not all(torch.equal(want[k], got[k]) for k in want):
        fail(f"checkpoint reload: steps {steps}, or a parameter or buffer "
             "differs from the written model")
    back = checkpoints.load_mean_caches(str(ckpt))[0]
    if len(back) != len(caches) or not all(
            np.array_equal(a, b) for a, b in zip(back, caches)):
        fail("mean caches read back differ from the written ones")
    return ckpt, files


def write_serving_inputs(root: Path, dev, model, stats, img: int):
    """The serving phase's inputs under ``root``: the flagship model as a
    checkpoint directory (``write_checkpoint_dir``), the rig's lenslet
    centers - 50, and SERVE_FRAMES uint16 camera frames."""
    cfg = model.cfg
    side = cfg.volume_side_size
    t0 = time.perf_counter()
    ckpt, files = write_checkpoint_dir(root, dev, model, stats)
    coords = lenslet_coords(cfg.n_lenslets, side, img)
    lenslets = root / "lenslets.txt"
    lenslets.write_text("".join(f"{x - 50}\t{y - 50}\n" for x, y in coords))
    frames_dir = root / "frames"
    frames_dir.mkdir()
    rng = np.random.RandomState(11)
    for i in range(SERVE_FRAMES):
        write_tiff_stack(str(frames_dir / f"cam_{i:02d}.tif"),
                         rng.randint(0, 400, (img, img)).astype(np.uint16))
    mb = sum(os.path.getsize(f) for f in files) / 1e6
    log(f"serving inputs: checkpoint directory of {len(files)} files "
        f"({mb:.1f} MB: {', '.join(os.path.basename(f) for f in files)}) "
        f"read back equal to the bit, parameter for parameter and BatchNorm "
        f"buffer for buffer; {SERVE_FRAMES} uint16 frames of {img}^2; "
        f"{time.perf_counter() - t0:.1f} s")
    return ckpt, lenslets, frames_dir


def check_served_volumes(args, out_dir: Path, frames_dir: Path, what: str):
    """Every served volume equal to the bit to a reconstructor built by the
    CLI's own steps and called on the same groups of SERVE_BATCH frames in
    the same order, the last group zero-padded.  Returns the reconstructor
    and one batch of frames on the card."""
    recon, img_shape = serve.build_reconstructor(args, "cuda")
    names = sorted(os.listdir(frames_dir))
    served = sorted(os.listdir(out_dir))
    want_names = [f"XLFM_stack_{os.path.splitext(n)[0]}.tif" for n in names]
    if served != sorted(want_names):
        fail(f"{what}: served files {served[:3]}... != {want_names[:3]}...")
    side, nd = recon.model.cfg.volume_side_size, recon.model.cfg.n_depths
    batch = None
    for g in range(0, len(names), SERVE_BATCH):
        group = names[g:g + SERVE_BATCH]
        frames = torch.zeros((SERVE_BATCH,) + img_shape, dtype=torch.float32)
        for i, n in enumerate(group):
            frames[i] = torch.from_numpy(
                read_tiff_stack(str(frames_dir / n))[0])
        frames = frames.to("cuda")
        batch = frames if batch is None else batch
        out = recon(frames).cpu()
        for i, n in enumerate(group):
            name = want_names[g + i]
            vol = read_tiff_stack(str(out_dir / name), dtype=None)
            if vol.shape != (nd, side, side) or vol.dtype != np.float32 \
                    or not np.isfinite(vol).all():
                fail(f"{what}: {name} is {vol.dtype} {vol.shape} or not "
                     "finite")
            if not torch.equal(torch.from_numpy(vol), out[i]):
                d = (torch.from_numpy(vol) - out[i]).abs().max().item()
                fail(f"{what}: {name} differs from the direct call by "
                     f"max|d| {d:.3e}")
    return recon, batch


def phase_serving(dev, card, kernels, model, stats, img: int):
    """The serving entry point, ``python -m cwfa_tpu_torch.cli.serve``, at
    the flagship width, in its default configuration (int8 UNet) and with
    ``--no_int8``, at batch 8 on 19 frames."""
    root = Path(tempfile.mkdtemp(prefix="cwfa_serve_"))
    try:
        ckpt, lenslets, frames_dir = write_serving_inputs(root, dev, model,
                                                          stats, img)
        base = ["--pretrain_models_path", str(ckpt),
                "--lenslet_file", str(lenslets), "--img_size", str(img),
                "--in_dir", str(frames_dir), "--batch", str(SERVE_BATCH)]
        for name in SERVE_PER_CALL:
            kernels[name]["serve_launches"] = 0
        for mode, extra in (("int8 UNet (default)", []),
                            ("bf16 (--no_int8)", ["--no_int8"])):
            out_dir = root / "volumes"
            argv = base + extra + ["--out_dir", str(out_dir)]
            reset_counts()
            before = launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = serve.main(argv)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            calls = 1 + out["batches"]                # warm-up + batches
            delta = check_counts(SERVE_PER_CALL, calls, f"serve {mode}",
                                 before)
            check_instance("fused_float_tower", btower.WGMMA_BF16,
                           f"serve {mode}")
            check_instance("cond_pair", cpair.TENSOR_CORES, f"serve {mode}")
            for name, n in delta.items():
                if name in SERVE_PER_CALL:
                    kernels[name]["serve_launches"] += n
            if (out["frames"], out["batches"], out["padded_frames"]) != (
                    SERVE_FRAMES, 3, 5):
                fail(f"serve {mode}: {out['frames']} frames, "
                     f"{out['batches']} batches, {out['padded_frames']} "
                     "padded; expected 19, 3, 5")
            args = serve.build_parser().parse_args(argv)
            recon, batch = check_served_volumes(args, out_dir, frames_dir,
                                                f"serve {mode}")
            fps = recon.throughput(batch, n_repeats=5)
            p50, best = recon.latency_ms(batch[:1], n=10)
            log(f"serve {mode}: {out['frames']} frames in {out['batches']} "
                f"batches ({out['padded_frames']} padded), every volume "
                f"(96, 512, 512) f32, finite and equal to the bit to the "
                f"direct call; launches {delta} in {calls} calls; on {card}")
            e2e = out["frames"] / (out["frames"] / out["throughput_fps"]
                                   + out["writer_tail_seconds"])
            log(f"serve {mode}: served {out['throughput_fps']} frames/s "
                f"({e2e:.2f} frames/s until the last volume is written: "
                f"the writer's tail {out['writer_tail_seconds']} s after the "
                f"drain; {wall:.2f} s for main() with the model build, "
                f"calibration and warm-up); batch latency p50 "
                f"{out['batch_latency_p50_s']} s, p95 "
                f"{out['batch_latency_p95_s']} s; fetch "
                f"{out['fetch_seconds']} s, parse {out['parse_seconds']} s, "
                f"submit {out['submit_seconds']} s, dispatch "
                f"{out['dispatch_seconds']} s ({out['fetch_bytes'] / 1e9:.2f}"
                f" GB fetched, {out['feed_bytes'] / 1e6:.1f} MB fed); peak "
                f"memory {peak / 2**30:.2f} GiB; the same reconstructor: "
                f"throughput() {fps:.2f} frames/s at batch {SERVE_BATCH} "
                f"({1e3 / fps:.2f} ms/frame), latency_ms() at batch 1 p50 "
                f"{p50:.2f} ms, min {best:.2f} ms; on {card}")
            shutil.rmtree(out_dir)
            del recon, batch
            torch.cuda.empty_cache()
        # the pace-setters alone: the batch's device-to-host copy into
        # pinned memory, and one volume through the TIFF writer
        vols = torch.randn((SERVE_BATCH, model.cfg.n_depths, 512, 512),
                           device=dev)
        host = torch.empty(vols.shape, pin_memory=True)
        d2h = cuda_ms(lambda: host.copy_(vols, non_blocking=True))
        vol = host[0].numpy()
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            write_tiff_stack(str(root / f"w{i}.tif"), vol)
            times.append(time.perf_counter() - t0)
        wms = float(np.median(times)) * 1e3
        log(f"serving pace: device-to-host copy of a batch of "
            f"{SERVE_BATCH} volumes ({vols.numel() * 4 / 1e9:.2f} GB, pinned)"
            f" {d2h:.2f} ms ({vols.numel() * 4 / d2h / 1e6:.1f} GB/s); "
            f"TIFF write of one volume ({vol.nbytes / 1e6:.0f} MB) "
            f"{wms:.1f} ms ({vol.nbytes / wms / 1e6:.2f} GB/s) on one "
            f"thread, {wms * SERVE_BATCH:.0f} ms a batch; on {card}")
        del vols, host
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_grads(trainer, k, inputs):
    """(loss terms, {group: [gradients]}) of the LRNN step (k None) or of
    flow step k, nothing drawn."""
    m = trainer.model
    for p in m.parameters():
        p.grad = None
    if k is None:
        m.lrnn.train()
        loss, _ = trainer.lrnn_loss(*inputs, generator=None)
        losses, groups = [loss], {"lrnn": m.lrnn}
    else:
        m.cond[k].train()
        losses = trainer.flow_loss(k, *inputs, generator=None)[:3]
        groups = {f"flow.{k}": m.flow[k], f"cond.{k}": m.cond[k]}
    losses[0].backward()
    m.eval()
    return ([float(v.detach()) for v in losses],
            {g: {n: p.grad.detach().cpu() for n, p in mod.named_parameters()}
             for g, mod in groups.items()})


def phase_train_small(dev):
    """The small rig's LRNN step and every flow step's loss and gradients,
    f32, nothing drawn: the card (kernels) against the CPU (plain)."""
    _, model, stats, _, _ = flagship(True, "cpu",
                                     torch.Generator().manual_seed(0))
    cfg = model.cfg = dataclasses.replace(model.cfg, use_half_precision=0)
    cpu = CWFATrainer(copy.deepcopy(model), stats, None, device="cpu")
    card = CWFATrainer(model, stats, None, device=dev)
    rng = np.random.RandomState(4)
    s, b = cfg.volume_side_size, 2

    def rand(c, scale=1.0):
        return torch.as_tensor((rng.randn(b, c, s, s) * scale)
                               .astype(np.float32))

    d_lrnn = cfg.n_depths // 2 ** model.n_flow_steps
    cases = [(None, [rand(cfg.n_lenslets), rand(d_lrnn, 0.3), rand(d_lrnn)])]
    for k, spec in enumerate(model.step_specs):
        cases.append((k, [rand(cfg.n_lenslets), rand(spec.c_flow, 0.3),
                          rand(spec.d_in), rand(spec.c_flow)]))
    for k, inputs in cases:
        ref_l, ref_g = train_grads(cpu, k, inputs)
        got_l, got_g = train_grads(card, k, [t.to(dev) for t in inputs])
        loss_rel = max(abs(g - r) / max(abs(r), 1e-30)
                       for g, r in zip(got_l, ref_l))
        if not loss_rel <= 1e-4:
            fail(f"small rig train step {k}: losses {got_l} vs {ref_l}")
        worst, where = 0.0, ""
        for group, refs in ref_g.items():
            scale = max(r.abs().max().item() for r in refs.values())
            d, leaf = max(((got_g[group][n] - r).abs().max().item(), n)
                          for n, r in refs.items())
            if d / scale >= worst:
                worst, where = d / scale, f"{group}: {leaf}"
            if not d <= 1e-3 * scale:
                fail(f"small rig train step {k}, {group}: max|d| {d:.3e} "
                     f"(at {leaf}) over 1e-3 x max|ref| {scale:.3e}")
        # the bound is 1e-3, not f32's 1e-5: a PReLU input within rounding
        # of zero takes the slope 1 on one side and alpha on the other, and
        # every gradient upstream inherits the difference (scripts/
        # torch_lrnn_grad_conditioning.py: f32 against f64)
        log(f"small rig f32 {'LRNN step' if k is None else f'flow step {k}'}"
            f", card vs CPU: losses {['%.6g' % v for v in got_l]} within "
            f"{loss_rel:.2e} (bound 1e-4), gradients within {worst:.2e} of "
            f"max|ref| (bound 1e-3), the worst at {where}")


def write_train_dataset(root: Path, cfg, img: int, seed: int = 12,
                        frames: int = TRAIN_FRAMES):
    """``frames`` random uint16 camera frames of img^2 in XLFMDataset's
    layout (XLFM_image/XLFM_image_stack.tif, XLFM_stack/XLFM_stack_NNN.tif
    volumes of the configuration's depth and side) and the rig's lenslet
    file.  Returns (dataset dir, lenslet file)."""
    side = cfg.volume_side_size
    rng = np.random.RandomState(seed)
    (root / "XLFM_image").mkdir(parents=True)
    (root / "XLFM_stack").mkdir()
    write_tiff_stack(str(root / "XLFM_image" / "XLFM_image_stack.tif"),
                     rng.randint(0, 4000, (frames, img, img))
                     .astype(np.uint16))
    for i in range(frames):
        write_tiff_stack(str(root / "XLFM_stack" / f"XLFM_stack_{i:03d}.tif"),
                         rng.randint(0, 1000, (cfg.n_depths, side, side))
                         .astype(np.uint16))
    lenslets = root / "lenslets.txt"
    lenslets.write_text("".join(
        f"{x - 50}\t{y - 50}\n"
        for x, y in lenslet_coords(cfg.n_lenslets, side, img)))
    return root, lenslets


def phase_train_flagship(dev, card, kernels, img: int):
    """The flagship trained on the card through every stage, bf16 (the JAX
    default), batch 1: ``CWFATrainer.train_epoch`` for epochs =
    INN_max_down_steps, one stage each, LRNN first, on TRAIN_FRAMES random
    frames; losses finite, each stage's parameters changed and no other's,
    launches per optimizer step held to FLOW_PER_STEP / LRNN_PER_STEP, ms
    per optimizer step (CUDA events, the median after the first) and peak
    memory per stage; then ``save_checkpoints`` read back equal to the
    bit."""
    root = Path(tempfile.mkdtemp(prefix="cwfa_train_"))
    try:
        t0 = time.perf_counter()
        _, model, _, _, _ = flagship(False, "cpu",
                                     torch.Generator().manual_seed(0))
        # one epoch per stage
        cfg = model.cfg = dataclasses.replace(
            model.cfg, epochs=model.cfg.INN_max_down_steps)
        data_dir, lenslets = write_train_dataset(root / "fish", cfg, img)
        side = cfg.volume_side_size
        ds = load_xlfm_data(str(data_dir), str(lenslets),
                            vol_shape=(side, side, cfg.n_depths),
                            img_shape=(img, img),
                            images_to_use=list(range(TRAIN_FRAMES)),
                            n_depths_to_fill=cfg.n_depths, ds_id="fish_0")
        cat = ConcatXLFMDataset(ds)
        stats = cat.get_statistics()
        vidx = make_view_indices(ds.lenslet_coords, (img, img), (side, side))
        tr = CWFATrainer(model, stats, vidx, device=dev)
        log(f"train dataset: {TRAIN_FRAMES} uint16 frames of {img}^2 and "
            f"volumes of {cfg.n_depths} x {side}^2 written and read in "
            f"{time.perf_counter() - t0:.1f} s; use_half_precision "
            f"{cfg.use_half_precision}, batch {cfg.batch_size}, epochs "
            f"{cfg.epochs}")
        # the caches the epochs read (views, GT pyramids, mean caches),
        # built before the counted epochs: 4 f32 forward pyramids
        reset_counts()
        before = launch_counts()
        tr.ensure_mean_caches(cat)
        for ix in range(TRAIN_FRAMES):
            tr._views_for(cat, "train", ix)
            tr._gt_pyramids(cat, "train", [ix])
        check_counts(NLL_PER_CALL, TRAIN_FRAMES + 1, "train caches", before)
        times = []

        def timed(fn):
            def run(*args):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                out = fn(*args)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                return out
            return run

        tr._lrnn_step = timed(tr._lrnn_step)
        tr._flow_step = timed(tr._flow_step)
        groups = ["lrnn"] + [f"{g}.{k}" for k in range(model.n_flow_steps)
                             for g in ("flow", "cond")]

        def snapshot():
            return {g: [p.detach().clone() for p in
                        (model.lrnn if g == "lrnn" else
                         getattr(model, g.split(".")[0])[int(g[-1])])
                        .parameters()] for g in groups}

        reset_counts()
        totals = dict.fromkeys(KERNELS, 0)
        for epoch in range(cfg.epochs):
            stage = tr.stage_for_epoch(epoch)
            before, params = launch_counts(), snapshot()
            times.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss = tr.train_epoch(cat, epoch)
            peak = torch.cuda.max_memory_allocated()
            per = LRNN_PER_STEP if stage == model.n_flow_steps \
                else FLOW_PER_STEP
            delta = check_counts(per, TRAIN_FRAMES, f"train epoch {epoch}",
                                 before)
            for name, n in delta.items():
                totals[name] += n
            after = snapshot()
            changed = sorted(g for g in groups if any(
                not torch.equal(a, b) for a, b in zip(params[g], after[g])))
            want = (["lrnn"] if stage == model.n_flow_steps
                    else sorted([f"cond.{stage}", f"flow.{stage}"]))
            if changed != want:
                fail(f"train epoch {epoch} (stage {stage}) changed {changed}, "
                     f"expected {want}")
            if not np.isfinite(loss):
                fail(f"train epoch {epoch}: loss {loss}")
            if stage != model.n_flow_steps:
                # bf16 activations under f32 master weights: the bf16
                # instances, every launch since the counts were reset
                check_instance("fused_float_tower", btower.WGMMA_BF16,
                               f"train epoch {epoch}")
                check_instance("cond_pair", cpair.TENSOR_CORES,
                               f"train epoch {epoch}")
                check_instance("float_tower_bwd", btower.WGMMA_BF16,
                               f"train epoch {epoch}")
                check_instance("cond_pair_bwd", cpair.TENSOR_CORES,
                               f"train epoch {epoch}")
            what = "LRNN" if stage == model.n_flow_steps else f"flow step {stage}"
            log(f"flagship train bf16 batch 1, epoch {epoch} ({what}): mean "
                f"loss {loss:.6g}; ms per optimizer step "
                f"{float(np.median(times[1:])):.2f} (median after the first; "
                f"all {['%.2f' % t for t in times]}); peak memory "
                f"{peak / 2**30:.2f} GiB; changed {changed}; launches "
                f"{ {n: c for n, c in delta.items() if c} }; on {card}")
        for name in KERNELS:
            if name in FLOW_PER_STEP:
                key = "launches" if name.endswith("_bwd") else "train_launches"
                kernels[name][key] = totals[name]
        for name in ("float_tower_bwd", "cond_pair_bwd"):
            kernels[name]["launches_by_instance"] = dict(
                KERNELS[name]["wrapper"].by_instance)
        ckpt = root / "ckpt"
        files = tr.save_checkpoints(cfg.epochs - 1, str(ckpt))
        check_checkpoints(tr, ckpt, files, "train")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_checkpoints(tr, ckpt: Path, files: list, what: str):
    """The step files in ``ckpt`` read back through engine/checkpoints into
    a zeroed copy of the trainer's model equal to the bit: parameters,
    BatchNorm statistics, Lion momenta and counts."""
    model, cfg = tr.model, tr.cfg
    back = copy.deepcopy(model).cpu()
    back.load_state_dict({k: torch.zeros_like(v)
                          for k, v in back.state_dict().items()})
    opts = make_optimizers(back)
    _, steps = checkpoints.load_model_checkpoints(back, str(ckpt),
                                                  optimizers=opts)
    want, got = model.state_dict(), back.state_dict()
    lions = [*tr.opt_flow, *tr.opt_cond, tr.opt_lrnn]
    lions_back = [*opts[0], *opts[1], opts[2]]
    same = steps == list(range(1, cfg.INN_max_down_steps + 1)) and all(
        torch.equal(want[k].cpu(), got[k]) for k in want) and all(
        a.count == b.count and all(torch.equal(x.cpu(), y)
                                   for x, y in zip(a.mu, b.mu))
        for a, b in zip(lions, lions_back))
    if not same:
        fail(f"{what} checkpoints: a parameter, BatchNorm buffer or Lion "
             "momentum read back differs from the trainer's")
    mb = sum(os.path.getsize(f) for f in files) / 1e6
    log(f"{what} checkpoints: {len(files)} files ({mb:.1f} MB), steps "
        f"{steps}, read back through engine/checkpoints equal to the bit "
        f"(parameters, BatchNorm statistics, Lion momenta and counts)")


def phase_train(dev, card, kernels, img: int):
    """Training: the backward kernels against their plain backward, the
    small rig's optimizer steps card vs CPU, the flagship through every
    stage."""
    phase_train_kernels(dev, kernels)
    phase_train_small(dev)
    torch.cuda.empty_cache()
    phase_train_flagship(dev, card, kernels, img)
    torch.cuda.empty_cache()
    phase_f32_step(dev, card, kernels)


def phase_f32_step(dev, card, kernels):
    """A step-0 flow optimizer step of the CAT flagship in f32
    (``use_half_precision=0``, batch 1) through ``scripts/torch_f32_step.py``:
    its ms (CUDA events, median after the first) and its launches by
    instance, failing unless K2 ran 5 times and K3 once, all on their
    tensor-core instances (none on the CUDA cores)."""
    reset_counts()
    out = load_script("torch_f32_step").run(dev)
    want = {"k2": {btower.WGMMA_3XTF32: FLOW_PER_STEP["float_tower_bwd"]},
            "k3": {cpair.TENSOR_CORES_TF32: FLOW_PER_STEP["cond_pair_bwd"]}}
    for key, name in (("k2", "float_tower_bwd"), ("k3", "cond_pair_bwd")):
        if out[key] != want[key]:
            fail(f"f32 flow step 0: {name} launches by instance {out[key]}, "
                 f"expected {want[key]}")
        kernels[name]["f32_step_launches"] = out[key]
    kernels["float_tower_bwd"]["f32_step_ms"] = out["ms"]
    log(f"f32 flow optimizer step 0 of the flagship (CAT, batch 1): "
        f"{out['ms']:.2f} ms (median after the first of "
        f"{[round(t, 2) for t in out['readings']]}); loss {out['loss']:.4f}; "
        f"K2 {out['k2']}, K3 {out['k3']}, none on the CUDA cores; on {card}")


def phase_nonfast(dev, card, kernels):
    """The non-fast reconstruction (``reconstruct(fast=False)``, what
    evaluation runs): the small rig card vs CPU in f32, deterministic; the
    flagship at batch 1, deterministic, in bf16 against the fast path and
    against its own f32 run, its launches per call (EVAL_PER_CALL, the
    bf16 instances) and ms per frame beside the fast path's."""
    def chain(recon, frames, fast):
        with torch.inference_mode():
            return recon.model.reconstruct(
                recon._normalized_views(frames), recon.mean_caches, fast=fast,
                lrnn_mean_branch=recon.mean_branch).float()

    _, small, stats, vidx, img = flagship(True, "cpu",
                                          torch.Generator().manual_seed(0))
    rng = np.random.RandomState(5)
    side = small.cfg.volume_side_size
    caches = [rng.randn(1, small.cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(small.n_flow_steps + 1)]
    frames = (rng.rand(2, img, img) * 1000).astype(np.float32)
    ref = chain(XLFMReconstructor(small, stats, vidx, caches, device="cpu",
                                  deterministic=True), frames, False)
    got = chain(XLFMReconstructor(small, stats, vidx, caches, device=dev,
                                  deterministic=True), frames, False).cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"small rig f32 reconstruct(fast=False), card vs CPU: max|d|/max|ref| "
        f"{rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        fail(f"small rig non-fast card vs CPU {rel:.3e} > 1e-4")

    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    frames = torch.as_tensor(
        rng.rand(1, img, img).astype(np.float32) * 1000).to(dev)
    recon16 = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                                deterministic=True,
                                compute_dtype=torch.bfloat16)
    reset_counts()
    before = launch_counts()
    slow16 = chain(recon16, frames, False)
    check_counts(EVAL_PER_CALL, 1, "flagship bf16 reconstruct(fast=False)",
                 before)
    check_instance("fused_float_tower", btower.WGMMA_BF16,
                   "flagship bf16 reconstruct(fast=False)")
    check_instance("cond_pair", cpair.TENSOR_CORES,
                   "flagship bf16 reconstruct(fast=False)")
    fast16 = chain(recon16, frames, True)
    if not (bool(torch.isfinite(slow16).all())
            and slow16.shape == (1, cfg.n_depths, side, side)):
        fail(f"flagship non-fast: shape {tuple(slow16.shape)} or non-finite")
    rel_fast = ((slow16 - fast16).abs().max() / fast16.abs().max()).item()
    ms_slow = event_ms(lambda: chain(recon16, frames, False))
    ms_fast = event_ms(lambda: chain(recon16, frames, True))
    del recon16
    recon32 = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                                deterministic=True)
    slow32 = chain(recon32, frames, False)
    del recon32
    rel32 = ((slow16 - slow32).abs().max() / slow32.abs().max()).item()
    log(f"flagship reconstruct(fast=False), batch 1: bf16 vs the fast path "
        f"max|d|/max|fast| {rel_fast:.3e} (bound 5e-2), bf16 vs its f32 run "
        f"{rel32:.3e} (bound 5e-2); launches per call {EVAL_PER_CALL}, the "
        f"bf16 instances; bf16 ms per frame {np.median(ms_slow):.2f} "
        f"(fast path {np.median(ms_fast):.2f}; {ms_slow} / {ms_fast}); on "
        f"{card}")
    if not rel_fast <= 5e-2:
        fail(f"flagship non-fast vs fast {rel_fast:.3e} > 5e-2")
    if not rel32 <= 5e-2:
        fail(f"flagship non-fast bf16 vs f32 {rel32:.3e} > 5e-2")
    torch.cuda.empty_cache()


def write_cli_tree(root: Path, cfg, img: int,
                   frames: int = TRAIN_FRAMES) -> Path:
    """Two fish in the training CLI's layout (``<root>/<fish>/
    SLNet_preprocessed``, as ``use_sparse_for_all`` = 1 reads), each with
    ``frames`` frames and volumes (``write_train_dataset``) and a
    ``Neural_activity_coordinates.csv`` of four neurons inside the volume,
    one at its edge.  Returns the first fish's lenslet file."""
    lenslets = None
    for fi in range(2):
        data, lens = write_train_dataset(
            root / f"fish_{fi}" / "SLNet_preprocessed", cfg, img,
            seed=12 + fi, frames=frames)
        lenslets = lenslets or lens
        (data / "Neural_activity_coordinates.csv").write_text(
            "patch_n,coord_x,coord_y,coord_z,corr_coeff,is_gt\n"
            "0,100,200,0,1,1\n1,256,256,10,1,1\n2,2,509,-30,1,1\n"
            "3,400,50,40,1,1\n")
    return lenslets


def phase_train_cli(dev, card, kernels, img: int):
    """The training entry point, ``cli.train.main``, at the flagship width
    and the configuration's defaults (bf16, batch 1, 4 CAT steps x 4
    blocks, 64-wide towers) on two fish of TRAIN_FRAMES random frames:
    fold 0, ``--max_samples 3 --epochs 5 --eval_every 5`` — one epoch a
    stage, then ``evaluate`` of train / val / test (3 / 1 / 3 frames), the
    checkpoints and the OOD screen of the test frames.  The trainer's
    methods are wrapped to hold the launches of every flow epoch
    (FLOW_PER_STEP a frame), evaluation reconstruction (EVAL_PER_CALL) and
    NLL refresh (NLL_PER_CALL a frame), each on its tensor-core instance,
    and to time the CLI's segments."""
    from cwfa_tpu_torch.cli import train as train_cli
    from cwfa_tpu_torch.utils.tb_writer import read_event_file

    root = Path(tempfile.mkdtemp(prefix="cwfa_cli_"))
    seg: dict = {}
    state = {"eval": None, "trainer": None, "ood": None, "files": None}
    patches = []

    def add(name, v):
        seg.setdefault(name, []).append(v)

    def patch(obj, name, make):
        orig = getattr(obj, name)
        patches.append((obj, name, orig))
        setattr(obj, name, make(orig))

    def host_timed(name):
        def make(fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                add(name if state["eval"] is None
                    else f"{name}/{state['eval']}", time.perf_counter() - t0)
                return out
            return run
        return make

    def instances():
        return {n: dict(KERNELS[n]["wrapper"].by_instance)
                for n in ("fused_float_tower", "cond_pair", "float_tower_bwd",
                          "cond_pair_bwd")}

    def on_instance(before, counts, name, instance, what):
        got = KERNELS[name]["wrapper"].by_instance[instance] \
            - before[name][instance]
        n = launch_counts()[name] - counts[name]
        if got != n:
            fail(f"{what}: {got} of its {n} {name} launches ran the "
                 f"{instance} instance")

    def step_timed(fn):
        def run(self, *args):
            stage = args[0] if fn.__name__ == "_flow_step" \
                else self.model.n_flow_steps
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(self, *args)
            end.record()
            torch.cuda.synchronize()
            add(f"step_ms/{stage}", start.elapsed_time(end))
            return out
        return run

    def epoch_checked(fn):
        def run(self, dataset, epoch, *args, **kw):
            stage = self.stage_for_epoch(epoch)
            nf = self.model.n_flow_steps
            counts, inst = launch_counts(), instances()
            torch.cuda.reset_peak_memory_stats()
            loss = fn(self, dataset, epoch, *args, **kw)
            what = f"train_cli epoch {epoch} (stage {stage})"
            if stage == nf:
                # the first epoch: the 3 GT pyramids and the mean caches
                check_counts(NLL_PER_CALL, TRAIN_FRAMES + 1, what, counts)
            else:
                check_counts(FLOW_PER_STEP, TRAIN_FRAMES, what, counts)
                for name, instance in (
                        ("fused_float_tower", btower.WGMMA_BF16),
                        ("cond_pair", cpair.TENSOR_CORES),
                        ("float_tower_bwd", btower.WGMMA_BF16),
                        ("cond_pair_bwd", cpair.TENSOR_CORES)):
                    on_instance(inst, counts, name, instance, what)
            add("loss", loss)
            add(f"train_peak/{stage}", torch.cuda.max_memory_allocated())
            return loss
        return run

    def recon_checked(fn):
        def run(self, *args):
            counts, inst = launch_counts(), instances()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(self, *args)
            end.record()
            torch.cuda.synchronize()
            add(f"recon_ms/{state['eval']}", start.elapsed_time(end))
            what = f"train_cli evaluate {state['eval']} reconstruction"
            check_counts(EVAL_PER_CALL, 1, what, counts)
            on_instance(inst, counts, "fused_float_tower", btower.WGMMA_BF16,
                        what)
            on_instance(inst, counts, "cond_pair", cpair.TENSOR_CORES, what)
            return out
        return run

    def eval_checked(fn):
        def run(self, dataset, tag="val", *args, **kw):
            state["trainer"] = self
            buffers = {k: v.clone() for k, v in self.model.named_buffers()}
            counts = launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state["eval"] = tag
            t0 = time.perf_counter()
            try:
                res = fn(self, dataset, tag, *args, **kw)
            finally:
                state["eval"] = None
            torch.cuda.synchronize()
            add(f"eval_s/{tag}", time.perf_counter() - t0)
            add(f"eval_peak/{tag}", torch.cuda.max_memory_allocated())
            n = len(dataset)
            delta = check_counts({k: EVAL_PER_CALL.get(k, 0)
                                  + NLL_PER_CALL.get(k, 0)
                                  for k in KERNELS}, n,
                                 f"train_cli evaluate {tag}", counts)
            for name, d in delta.items():
                kernels[name]["eval_launches"] = \
                    kernels[name].get("eval_launches", 0) + d
            moved = [k for k, v in self.model.named_buffers()
                     if not torch.equal(v, buffers[k])]
            if moved:
                fail(f"train_cli evaluate {tag} moved the buffers {moved}")
            return res
        return run

    def ood_checked(fn):
        def run(trainer, dataset, *args, **kw):
            counts = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(trainer, dataset, *args, **kw)
            add("ood_s", time.perf_counter() - t0)
            check_counts(NLL_PER_CALL, len(dataset), "train_cli OOD screen",
                         counts)
            state["ood"] = out
            return out
        return run

    def files_kept(fn):
        def run(self, *args, **kw):
            state["files"] = fn(self, *args, **kw)
            return state["files"]
        return run

    try:
        t0 = time.perf_counter()
        cfg = CWFAConfig()                          # the defaults
        lenslets = write_cli_tree(root / "data", cfg, img)
        log(f"train_cli tree: 2 fish x {TRAIN_FRAMES} uint16 frames of "
            f"{img}^2 and volumes of {cfg.n_depths} x "
            f"{cfg.volume_side_size}^2 written in "
            f"{time.perf_counter() - t0:.1f} s")
        T = CWFATrainer
        patch(train_cli, "load_xlfm_data", host_timed("load"))
        patch(ConcatXLFMDataset, "get_statistics", host_timed("statistics"))
        patch(T, "_lrnn_step", step_timed)
        patch(T, "_flow_step", step_timed)
        patch(T, "train_epoch", epoch_checked)
        patch(T, "_recon_eval", recon_checked)
        patch(T, "_batch_inputs", host_timed("inputs_s"))
        patch(T, "_refresh_nlls", host_timed("refresh_s"))
        patch(T, "evaluate", eval_checked)
        patch(T, "save_checkpoints", files_kept)
        patch(train_cli, "detect_ood", ood_checked)
        argv = ["--main_data_path", str(root / "data"), "--lenslet_file",
                str(lenslets), "--output_testing_path", str(root / "runs") + "/",
                "--cross_validation_nFold", "0", "--max_samples", "3",
                "--epochs", "5", "--eval_every", "5", "--img_size", str(img)]
        reset_counts()
        t0 = time.perf_counter()
        try:
            results = train_cli.main(argv)
        finally:
            for obj, name, orig in reversed(patches):
                setattr(obj, name, orig)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        _check_train_cli(root, results, seg, state, total, card, kernels,
                         read_event_file)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _check_train_cli(root, results, seg, state, total, card, kernels,
                     read_event_file):
    tr = state["trainer"]
    nf = tr.model.n_flow_steps
    (run_dir,) = list((root / "runs").iterdir())
    if not all(np.isfinite(seg["loss"])):
        fail(f"train_cli losses {seg['loss']}")
    for tag, n in CLI_FRAMES.items():
        res = results[tag]
        if not (len(res["psnr"]) == len(res["nll"]) == len(res["times"]) == n):
            fail(f"train_cli {tag}: {len(res['psnr'])} frames evaluated, "
                 f"expected {n}")
        if not (np.isfinite(np.asarray(res["psnr"])).all()
                and np.isfinite(np.asarray(res["nll"])).all()):
            fail(f"train_cli {tag}: non-finite PSNR or NLL")
    (events,) = run_dir.glob("events.out.tfevents.*")
    scalars = {e["tag"]: e["value"] for e in read_event_file(str(events))
               if e["kind"] == "scalar"}
    want = [f"fine_tune/psnr/{tag}/step_{k}" for tag in CLI_FRAMES
            for k in range(nf + 1)]
    missing = [t for t in want if not np.isfinite(scalars.get(t, np.nan))]
    if missing:
        fail(f"train_cli event file: no finite {missing}")
    vols = sorted(run_dir.glob("stacks/*/*/*.tif"))
    cfg = tr.cfg
    shape = (cfg.n_depths, cfg.volume_side_size, cfg.volume_side_size)
    bad = [str(p.relative_to(run_dir)) for p in vols
           if (lambda v: v.shape != shape or not np.isfinite(v).all())(
               read_tiff_stack(str(p)))]
    if len(vols) != 2 * sum(CLI_FRAMES.values()) or bad:
        fail(f"train_cli volume TIFFs: {len(vols)} found, bad {bad}")
    check_checkpoints(tr, run_dir, state["files"], "train_cli")
    ood = state["ood"]
    if ood.nll_per_frame.shape != (CLI_FRAMES["test"], nf) or not \
            np.isfinite(ood.nll_per_frame).all():
        fail(f"train_cli OOD NLLs {ood.nll_per_frame}")

    def med(key):
        return float(np.median(seg[key]))
    steps = "; ".join(
        f"{'LRNN' if k == nf else f'flow step {k}'} "
        f"{med(f'step_ms/{k}'):.2f} ms ({['%.2f' % t for t in seg[f'step_ms/{k}']]})"
        f", peak {max(seg[f'train_peak/{k}']) / 2**30:.2f} GiB"
        for k in range(nf, -1, -1))
    log(f"train_cli: finite losses {['%.5g' % v for v in seg['loss']]}; "
        f"frames per tag {CLI_FRAMES}; {len(want)} TB PSNR scalars; "
        f"{len(vols)} volume TIFFs of {shape}, finite; OOD NLLs "
        f"{np.round(ood.nll_per_frame, 4).tolist()}; on {card}")
    log(f"train_cli segments: main {total:.1f} s; data load "
        f"{sum(seg['load']):.1f} s ({len(seg['load'])} fish datasets), "
        f"statistics {sum(seg['statistics']):.2f} s; ms per optimizer step "
        f"(CUDA events): {steps}; OOD screen of {CLI_FRAMES['test']} frames "
        f"{sum(seg['ood_s']):.2f} s")
    for tag, n in CLI_FRAMES.items():
        recon = seg[f"recon_ms/{tag}"]
        inputs = sum(seg.get(f"inputs_s/{tag}", []))
        refresh = sum(seg.get(f"refresh_s/{tag}", []))
        wall = sum(seg[f"eval_s/{tag}"])
        host = (wall - inputs - refresh - sum(recon) / 1e3) / n
        log(f"train_cli evaluate {tag} ({n} frames): reconstruction "
            f"{np.median(recon):.2f} ms/frame (CUDA events; "
            f"{['%.2f' % t for t in recon]}; res['times'] "
            f"{['%.2f' % (t * 1e3) for t in results[tag]['times']]}); "
            f"GT pyramids + views {inputs:.2f} s, NLL refresh {refresh:.2f} s; "
            f"host {host:.2f} s/frame (metrics, projections, TIFF puts, "
            f"copies); wall {wall:.2f} s; peak "
            f"{max(seg[f'eval_peak/{tag}']) / 2**30:.2f} GiB")
    log(f"train_cli launches in evaluate (reconstruction + NLL refresh): "
        f"{ {k: v['eval_launches'] for k, v in kernels.items() if v.get('eval_launches')} }")


# --------------------------------------------------------------- deconv
# the JAX deconvolution CLI's defaults: 120 depths, 600^2 volumes from
# 2160^2 frames, 50 RL iterations; the canvas 600 + 2160 = 2760 rounds to
# the 5-smooth 2880
RL_DEPTHS, RL_VOL, RL_ITERS, RL_FRAMES = 120, 600, 50, 2
RL_ROI = 90                         # roi_depths = min(90, n_depths)


def phase_deconv_small(dev):
    """``xlfm_deconvolve`` at a small size, card vs CPU in f32: fourier_sum
    on and off, unchunked and a ragged depth chunk, batch 2 with one NaN
    frame (frozen at the ones init, the other updated), init_obj chaining;
    and the nonzero median card vs CPU equal, at small sizes and at the
    ratio's full canvas."""
    rng = np.random.RandomState(31)
    d, s, p = 6, 24, 40
    psf = np.abs(rng.rand(1, d, p, p)).astype(np.float32)
    psf /= psf.sum(axis=(-2, -1), keepdims=True)
    vol = np.abs(rng.rand(2, d, s, s)).astype(np.float32)
    otf_c, hw = precompute_otf(torch.from_numpy(psf), (s, s))
    otf_g, _ = precompute_otf(torch.from_numpy(psf).to(dev), (s, s))
    img = xlfm_forward_project(torch.from_numpy(vol), otf_c, hw,
                               psf_hw=(p, p))
    img[0, 0, 5, 7] = float("nan")
    worst = 0.0
    for fourier_sum in (True, False):
        for chunk in (None, 4):
            kw = dict(n_iter=8, obj_hw=(s, s), roi_depths=d, full_hw=hw,
                      depth_chunk=chunk, fourier_sum=fourier_sum)
            ref, ref_est = xlfm_deconvolve(otf_c, img, **kw)
            got, got_est = xlfm_deconvolve(otf_g, img.to(dev), **kw)
            what = f"deconv small fourier_sum={fourier_sum} chunk={chunk}"
            for g, r in ((got, ref), (got_est, ref_est)):
                err = (g.cpu() - r).abs().max().item()
                scale = r.abs().max().item()
                worst = max(worst, err / scale)
                if not err <= 1e-4 * scale:
                    fail(f"{what}: card vs CPU {err:.3e} > 1e-4 * {scale:.3e}")
            if not (torch.equal(got[0].cpu(), torch.ones(d, s, s))
                    and not torch.equal(got[1].cpu(), torch.ones(d, s, s))):
                fail(f"{what}: the NaN frame was not frozen, or the other "
                     "not updated")
    kw = dict(obj_hw=(s, s), roi_depths=d, full_hw=hw)
    one, _ = xlfm_deconvolve(otf_g, img.to(dev), n_iter=8, **kw)
    mid, _ = xlfm_deconvolve(otf_g, img.to(dev), n_iter=5, **kw)
    two, _ = xlfm_deconvolve(otf_g, img.to(dev), n_iter=3, init_obj=mid,
                             **kw)
    chain = ((two - one).abs().max() / one.abs().max()).item()
    if not chain <= 1e-6:
        fail(f"deconv init_obj chaining 5 + 3 vs 8 iterations: {chain:.3e}")
    x = rng.randn(3, 4099).astype(np.float32)
    x[:, ::3] = 0
    x[1, :2000] = np.round(x[1, :2000])      # duplicates
    x[2] = 0
    full = rng.rand(1, 2880 * 2880).astype(np.float32)
    full[:, rng.rand(2880 * 2880) < 0.4] = 0
    for m in (x, full):
        got = _median_nonzero_batch(torch.from_numpy(m).to(dev)).cpu()
        if not torch.equal(got, _median_nonzero_batch(torch.from_numpy(m))):
            fail(f"nonzero median of {m.shape} card != CPU")
    log(f"deconv small (6 depths, 24^2 from 40^2, batch 2 with a NaN frame, "
        f"8 iterations): card vs CPU within {worst:.2e} of max|ref| (bound "
        f"1e-4) for fourier_sum on/off and depth chunk none/4 (ragged), the "
        f"NaN frame frozen and the other updated; init_obj 5 + 3 vs 8 "
        f"{chain:.1e}; nonzero median card == CPU at (3, 4099) and "
        f"(1, 2880^2)")


def card_psf(dev, n_depths: int, size: int, coords, seed: int):
    """``data/synthetic.synthetic_psf``'s formula on the card, (1, D, P, P)
    f32, each plane normalized to unit sum: per lenslet (dataset-frame
    centers) a gaussian of sigma 1.2 + 0.12|dz| shifted by the depth's
    parallax and a seeded tilt.  Each gaussian is the outer product of its
    two 1-D factors, so a plane is one product of (P, L) and (L, P)."""
    rng = np.random.RandomState(seed)
    tilt = torch.as_tensor(rng.uniform(-0.25, 0.25, (len(coords), 2)),
                           dtype=torch.float64, device=dev)
    c = torch.as_tensor(np.asarray(coords), dtype=torch.float64, device=dev)
    grid = torch.arange(size, dtype=torch.float64, device=dev)
    center = size / 2.0
    psf = torch.empty((1, n_depths, size, size), device=dev)
    for d in range(n_depths):
        dz = d - n_depths / 2.0
        sigma = 1.2 + 0.12 * abs(dz)
        mu = c + (c - center) / center * dz * 0.8 + tilt * dz     # (L, 2)
        gy = torch.exp(-(grid[None] - mu[:, :1]) ** 2 / (2 * sigma ** 2))
        gx = torch.exp(-(grid[None] - mu[:, 1:]) ** 2 / (2 * sigma ** 2))
        plane = (gy.T @ gx).float()
        psf[0, d] = plane / plane.sum().clamp(min=1e-30)
    return psf


def blob_volumes(dev, n: int, depths: int, side: int, seed: int):
    """(n, D, S, S) f32 volumes of 12 gaussian blobs (centers in the middle
    60% of each axis) whose amplitudes differ per volume, on the card."""
    rng = np.random.RandomState(seed)
    k = 12
    centre = rng.uniform(0.2, 0.8, (k, 3)) * [depths, side, side]
    sig = np.stack([rng.uniform(1.0, depths / 12, k),
                    rng.uniform(side / 40 + 1, side / 16 + 2, k),
                    rng.uniform(side / 40 + 1, side / 16 + 2, k)], 1)
    amp = torch.as_tensor(rng.uniform(0.3, 1.0, (n, k)), dtype=torch.float32,
                          device=dev)

    def g(axis, size):
        t = torch.arange(size, dtype=torch.float32, device=dev)[None]
        mu = torch.as_tensor(centre[:, axis:axis + 1], dtype=torch.float32,
                             device=dev)
        sd = torch.as_tensor(sig[:, axis:axis + 1], dtype=torch.float32,
                             device=dev)
        return torch.exp(-((t - mu) / sd) ** 2 / 2)
    return torch.einsum("nk,kd,kh,kw->ndhw", amp, g(0, depths), g(1, side),
                        g(2, side))


def write_deconv_inputs(root: Path, dev, img: int):
    """A seeded RL_DEPTHS x img^2 PSF (``card_psf`` at the rig's 29 lenslet
    centers) written as a TIFF, and RL_FRAMES frames formed from seeded blob
    volumes by ``xlfm_forward_project`` through its OTF, scaled to a peak of
    5000, as a fish's ``XLFM_image/XLFM_image_stack.tif``.  Returns (PSF
    file, fish directory, seconds)."""
    t0 = time.perf_counter()
    coords = lenslet_coords(29, 512, img)
    psf = card_psf(dev, RL_DEPTHS, img, coords, seed=5)
    otf, hw = precompute_otf(psf, (RL_VOL, RL_VOL))
    psf_file = root / "psf.tif"
    write_tiff_stack(str(psf_file), psf[0].cpu().numpy())
    del psf
    vols = blob_volumes(dev, RL_FRAMES, RL_DEPTHS, RL_VOL, seed=6)
    frames = torch.cat([xlfm_forward_project(vols[i:i + 1], otf, hw,
                                             psf_hw=(img, img),
                                             depth_chunk=24)
                        for i in range(RL_FRAMES)])[:, 0]
    frames *= 5000.0 / frames.max()
    fish = root / "fish"
    (fish / "XLFM_image").mkdir(parents=True)
    write_tiff_stack(str(fish / "XLFM_image" / "XLFM_image_stack.tif"),
                     frames.cpu().numpy())
    del otf, vols, frames
    torch.cuda.synchronize()
    return psf_file, fish, time.perf_counter() - t0


def phase_deconv(dev, card):
    """Richardson–Lucy deconvolution: ``phase_deconv_small``, then the
    deconvolution CLI (``cli.deconvolve.main``) at the JAX CLI's defaults on
    the full-width inputs of ``write_deconv_inputs``, the RL loop run under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync fails it):
    the volume TIFFs' shape, finiteness, sign and ROI zeros, the first
    volume against a direct ``xlfm_deconvolve`` call on the same frame,
    the re-projection residual after 50 iterations below that after 1,
    ``--mesh_depth_axis 2`` in one process exits; then ms per RL iteration
    (CUDA events, median of 7) at ``--n_split_fourier`` 1 and 4, peak device
    memory, the OTF build, seconds per frame."""
    phase_deconv_small(dev)
    torch.cuda.empty_cache()
    img = 2160
    root = Path(tempfile.mkdtemp(prefix="cwfa_deconv_"))
    seg: dict = {}
    try:
        psf_file, fish, t_in = write_deconv_inputs(root, dev, img)
        log(f"deconv inputs: PSF {RL_DEPTHS} x {img}^2 f32 on the card "
            f"({os.path.getsize(psf_file) / 1e9:.2f} GB TIFF), {RL_FRAMES} "
            f"frames projected from blob volumes of {RL_DEPTHS} x "
            f"{RL_VOL}^2; {t_in:.1f} s")
        argv = ["--data_folder", str(fish), "--psf_file", str(psf_file),
                "--images_to_use", *map(str, range(RL_FRAMES)),
                "--n_it", str(RL_ITERS), "--posfix", "_smoke"]
        try:
            deconvolve.main(argv + ["--mesh_depth_axis", "2"])
            fail("deconv CLI --mesh_depth_axis 2 did not exit")
        except SystemExit as e:
            # one process: the mesh of 2 has no processes to run on
            if "world size of 1" not in str(e):
                fail(f"deconv CLI --mesh_depth_axis 2: {e}")
        real = {n: getattr(deconvolve, n) for n in
                ("xlfm_deconvolve", "load_psf_otf", "write_tiff_stack")}

        def timed_otf(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real["load_psf_otf"](*a, **k)
            torch.cuda.synchronize()
            seg["otf_s"] = time.perf_counter() - t0
            return out

        def checked_rl(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real["xlfm_deconvolve"](*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            end.record()
            seg.setdefault("enqueue_s", []).append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            seg.setdefault("rl_ms", []).append(start.elapsed_time(end))
            return out

        def timed_write(*a, **k):
            t0 = time.perf_counter()
            real["write_tiff_stack"](*a, **k)
            seg.setdefault("write_s", []).append(time.perf_counter() - t0)

        deconvolve.load_psf_otf = timed_otf
        deconvolve.xlfm_deconvolve = checked_rl
        deconvolve.write_tiff_stack = timed_write
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        try:
            out_dir = Path(deconvolve.main(argv))
        finally:
            for n, fn in real.items():
                setattr(deconvolve, n, fn)
        total = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        mem1 = torch.cuda.memory_stats()
        seg["allocator"] = {k: mem1.get(k, 0) - mem0.get(k, 0) for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries")}
        _check_deconv(dev, card, out_dir, psf_file, fish, img, seg, total,
                      peak)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _check_deconv(dev, card, out_dir, psf_file, fish, img, seg, total, peak):
    names = sorted(os.listdir(out_dir))
    want = [f"XLFM_stack_{i:03d}.tif" for i in range(RL_FRAMES)] + [
        "arguments.txt", "preview_MIP.tif"]
    if names != sorted(want):
        fail(f"deconv CLI wrote {names}, expected {want}")
    lo, hi = RL_DEPTHS // 2 - RL_ROI // 2, RL_DEPTHS // 2 + RL_ROI // 2
    vols = []
    for i in range(RL_FRAMES):
        v = read_tiff_stack(str(out_dir / f"XLFM_stack_{i:03d}.tif"))
        # >= 0 up to the FFT's roundoff: the update multiplies by a
        # correlation whose exact value is >= 0 and whose computed value
        # can dip below 0 by roundoff where the ratio is ~0
        if v.shape != (RL_DEPTHS, RL_VOL, RL_VOL) or not np.isfinite(v).all() \
                or v.min() < -1e-6 * v.max():
            fail(f"deconv volume {i}: shape {v.shape}, not finite, or min "
                 f"{v.min():.3e} below -1e-6 * max {v.max():.3e}")
        seg.setdefault("min_rel", []).append(float(v.min() / v.max()))
        if v[:lo].any() or v[hi:].any() or not v[lo:hi].any():
            fail(f"deconv volume {i}: depths outside [{lo}, {hi}) not zero, "
                 "or none inside nonzero")
        vols.append(v)
    # the first frame again, directly, as the CLI prepared it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    otf, _, hw = load_psf_otf(str(psf_file), (RL_VOL, RL_VOL, RL_DEPTHS),
                              device=dev)
    torch.cuda.synchronize()
    otf_again = time.perf_counter() - t0
    frame = read_tiff_stack(str(fish / "XLFM_image" / "XLFM_image_stack.tif"),
                            pages=[0])[0]
    frame = _center_crop_img(_pad_to_square_img(
        np.clip(np.nan_to_num(frame), 0, 50000)), (img, img))
    f = torch.from_numpy(np.asarray(frame[None, None] - 0.0,
                                    np.float32)).to(dev)
    kw = dict(obj_hw=(RL_VOL, RL_VOL), roi_depths=RL_ROI, full_hw=hw)
    direct, _ = xlfm_deconvolve(otf, f, n_iter=RL_ITERS, **kw)
    got = torch.from_numpy(vols[0]).to(dev)[None]
    if torch.equal(direct, got):
        same = "equal to the bit"
    else:
        err = ((direct - got).abs().max() / direct.abs().max()).item()
        if not err <= 1e-6:
            fail(f"deconv CLI volume 0 vs a direct call: {err:.3e} of max "
                 "> 1e-6")
        same = f"within {err:.2e} of max (not equal to the bit)"
    one, _ = xlfm_deconvolve(otf, f, n_iter=1, **kw)

    def residual(v):
        p = xlfm_forward_project(v, otf, hw, psf_hw=(img, img),
                                 depth_chunk=24)
        return ((p - f).norm() / f.norm()).item()
    r1, r50 = residual(one), residual(direct)
    if not r50 < r1:
        fail(f"deconv: re-projection residual {r50:.4f} after {RL_ITERS} "
             f"iterations not below {r1:.4f} after 1")
    del one, direct, got
    # ms per RL iteration: chained one-iteration calls, in turns
    times, peaks = {1: [], 4: []}, {}
    obj = {n: None for n in times}
    for rep in range(8):
        for n_split in (1, 4):
            chunk = None if n_split == 1 else RL_DEPTHS // n_split
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            obj[n_split], _ = xlfm_deconvolve(
                otf, f, n_iter=1, init_obj=obj[n_split], depth_chunk=chunk,
                obj_hw=(RL_VOL, RL_VOL), roi_depths=RL_DEPTHS, full_hw=hw)
            end.record()
            torch.cuda.synchronize()
            if rep:                      # the first is the warm-up
                times[n_split].append(start.elapsed_time(end))
            peaks[n_split] = torch.cuda.max_memory_allocated()
    parts = rl_segments(otf, f, hw)
    otf_gb = otf.numel() * otf.element_size() / 2**30
    del otf, obj
    per_frame = [ms / 1e3 + w for ms, w in zip(seg["rl_ms"], seg["write_s"])]
    log(f"deconv CLI (cli.deconvolve.main, {RL_FRAMES} frames of {img}^2 -> "
        f"{RL_DEPTHS} x {RL_VOL}^2, canvas {hw[0]}^2, {RL_ITERS} iterations, "
        f"n_split_fourier 1): {RL_FRAMES} volumes finite, >= 0 to roundoff "
        f"(min / max {['%.1e' % m for m in seg['min_rel']]}), zero outside "
        f"depths [{lo}, {hi}); volume 0 {same} to a direct call; residual "
        f"||P(v) - frame|| / ||frame|| {r1:.4f} after 1 iteration, {r50:.4f} "
        f"after {RL_ITERS}; the RL loop under set_sync_debug_mode('error') "
        f"(enqueue {['%.3f' % t for t in seg['enqueue_s']]} s; allocator "
        f"in the CLI {seg['allocator']}); "
        f"--mesh_depth_axis 2 in one process exits; on {card}")
    log(f"deconv times: RL per frame {['%.1f' % t for t in seg['rl_ms']]} ms "
        f"(CUDA events), TIFF write {['%.2f' % t for t in seg['write_s']]} s, "
        f"{['%.2f' % t for t in per_frame]} s a frame; OTF build (PSF TIFF "
        f"read, normalize, rfft2 of {RL_DEPTHS} planes, {otf_gb:.2f} GiB) "
        f"{seg['otf_s']:.2f} s in the CLI, {otf_again:.2f} s again; main "
        f"{total:.1f} s; peak {peak / 2**30:.2f} GiB in the CLI")
    log(f"deconv ms per RL iteration (CUDA events, median of 7 chained "
        f"one-iteration calls, in turns): n_split_fourier 1 "
        f"{statistics.median(times[1]):.2f} ms "
        f"({['%.2f' % t for t in times[1]]}), peak "
        f"{peaks[1] / 2**30:.2f} GiB; n_split_fourier 4 "
        f"{statistics.median(times[4]):.2f} ms "
        f"({['%.2f' % t for t in times[4]]}), peak {peaks[4] / 2**30:.2f} GiB")
    log(f"deconv RL iteration by segment (each alone, CUDA events, median of "
        f"5 after a warm-up): {parts['segments']}; host enqueue of 10 iterations "
        f"{parts['enqueue_ms']:.1f} ms against {parts['device_ms']:.1f} ms "
        f"of device time; allocator {parts['allocator']}")
    log(f"deconv one iteration under torch.profiler: device idle "
        f"{parts['idle']:.3f}, {parts['events']} device events; by kernel "
        f"(ms, count): {parts['kernels']}")


def rl_segments(otf, f, hw) -> dict:
    """One unchunked RL iteration at the CLI's shapes cut into its three
    segments, each run alone (as ``xlfm_deconvolve``'s loop runs them):
    the forward projection, the ratio with its median clamp, the back
    projection (and within it the 120-plane irfft2); the host's enqueue
    time of 10 iterations against their device time, with the caching
    allocator's device calls; one iteration under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    obj = torch.ones((1, RL_DEPTHS, RL_VOL, RL_VOL), device=otf.device)
    img_exp = _pad_center(f, hw)
    pad = ((hw[0] - RL_VOL) // 2, (hw[1] - RL_VOL) // 2)
    est = torch.relu(fftshift2d_real(torch.fft.irfft2(
        (rfft2_padded(obj, hw) * otf).sum(1, keepdim=True), s=hw)))
    ratio = img_exp / (est + 1e-8)
    ratio_fft = torch.fft.rfft2(ratio)

    def forward():
        spec = rfft2_padded(obj, hw).mul_(otf).sum(1, keepdim=True)
        torch.relu(fftshift2d_real(torch.fft.irfft2(spec, s=hw)))

    def clamp():
        r = img_exp / (est + 1e-8)
        lim = _median_nonzero_batch(r).reshape(-1, 1, 1, 1) * 10.0
        torch.minimum(torch.clamp(r, min=0.0), lim)

    def backward():
        corr = torch.fft.irfft2(torch.fft.rfft2(ratio) * otf.conj(), s=hw)
        obj * shifted_crop(corr, pad, (RL_VOL, RL_VOL))

    def iteration():
        xlfm_deconvolve(otf, f, n_iter=1, obj_hw=(RL_VOL, RL_VOL),
                        roi_depths=RL_DEPTHS, full_hw=hw)

    segments = {name: round(cuda_ms(fn, 5), 3)
                for name, fn in (
                    ("iteration", iteration), ("forward projection", forward),
                    ("ratio + median clamp", clamp),
                    ("median", lambda: _median_nonzero_batch(ratio)),
                    ("back projection", backward),
                    ("back projection's irfft2", lambda: torch.fft.irfft2(
                        ratio_fft * otf.conj(), s=hw)))}
    mem0 = torch.cuda.memory_stats()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    xlfm_deconvolve(otf, f, n_iter=10, obj_hw=(RL_VOL, RL_VOL),
                    roi_depths=RL_DEPTHS, full_hw=hw)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iteration()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    rows = sorted(((getattr(a, "self_device_time_total", 0) / 1e3, a.count,
                    a.key[:40]) for a in prof.key_averages()
                   if getattr(a, "self_device_time_total", 0) > 0),
                  reverse=True)[:10]
    return {"segments": segments, "enqueue_ms": enqueue_ms,
            "device_ms": start.elapsed_time(end),
            "allocator": {k: mem1.get(k, 0) - mem0.get(k, 0) for k in (
                "num_device_alloc", "num_device_free", "num_alloc_retries")},
            "idle": 1 - busy / max(wall_us, 1e-9), "events": len(spans),
            "kernels": [(round(t, 3), n, k) for t, n, k in rows]}


# ------------------------------------------------------------- ood_cli
OOD_FRAMES, OOD_EPOCHS_PER_STEP = 3, 2
# a flow epoch's stage input reconstructed for a frame whose handed-off
# input is of another level (the finetune's second epoch of a stage, after
# its first captured its own outputs; JAX's trainer does the same): the
# fast chain in f32, the trainer's master weights, so its towers run the
# 3xTF32 instance and its pairs the CUDA cores
STAGE_INPUT_PER_CALL = BF16_PER_CALL


def phase_ood_cli(dev, card, kernels, img: int):
    """The OOD entry point, ``cli.ood.main``, at the flagship width: the
    flagship (random weights from a seed) as a checkpoint directory
    (``write_checkpoint_dir``), one fish of OOD_FRAMES random uint16 frames
    and 96 x 512^2 volumes, ``--max_samples 3 --finetune 1
    --create_dist_plots 1 --epochs 5 --step_LL_ths_to_use=-1e30`` (every
    frame flagged, so the finetune runs every step).  Holds the report
    (finite scores, all flagged, steps 1-5 with 2 finite losses each, the
    scores after finetune finite and moved), the PNG's signature, one
    volume upload a frame across detect -> finetune -> re-score, and the
    launches: NLL_PER_CALL a frame in detect and in the re-score,
    FLOW_PER_STEP a frame in each flow epoch (every tower, pair, K2 and K3
    launch of the steps on its tensor-core instance) and
    STAGE_INPUT_PER_CALL a reconstructed stage input (the second epoch of
    each flow stage but the finest, one a frame), none in the LRNN's; times the three
    segments and peak memory."""
    root = Path(tempfile.mkdtemp(prefix="cwfa_ood_"))
    seg: dict = {}
    state: dict = {"trainer": None}
    real = {n: getattr(ood_cli, n) for n in ("detect_ood",
                                              "finetune_on_novel")}
    real_epoch = CWFATrainer.train_epoch
    real_recon = CWFAModel.reconstruct
    try:
        t0 = time.perf_counter()
        cfg, model, stats, _, _ = flagship(False, "cpu",
                                           torch.Generator().manual_seed(3))
        ckpt, files = write_checkpoint_dir(root, dev, model, stats)
        del model
        data, lenslets = write_train_dataset(
            root / "data" / "fish_0" / "SLNet_preprocessed", cfg, img,
            seed=21)
        log(f"ood_cli inputs: flagship checkpoint directory of {len(files)} "
            f"files read back equal to the bit; 1 fish of {TRAIN_FRAMES} "
            f"uint16 frames of {img}^2 and volumes of {cfg.n_depths} x "
            f"{cfg.volume_side_size}^2; {time.perf_counter() - t0:.1f} s")

        def segment(name, per_frame):
            def run(fn):
                def wrapped(trainer, dataset, *a, **k):
                    state["trainer"] = trainer
                    counts = launch_counts()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t = time.perf_counter()
                    out = fn(trainer, dataset, *a, **k)
                    torch.cuda.synchronize()
                    seg.setdefault(name, []).append(time.perf_counter() - t)
                    seg.setdefault(f"{name}_peak", []).append(
                        torch.cuda.max_memory_allocated())
                    seg.setdefault(f"{name}_uploads", []).append(
                        trainer.transfer_log["volume_uploads"])
                    if per_frame is not None:
                        check_counts(per_frame, len(dataset),
                                     f"ood_cli {name}", counts)
                    return out
                return wrapped
            return run

        def recon_counted(self, *a, **k):
            state["recons"] = state.get("recons", 0) + 1
            return real_recon(self, *a, **k)

        def epoch_checked(self, dataset, epoch, *a, **k):
            stage = self.stage_for_epoch(epoch)
            counts, recons = launch_counts(), state.get("recons", 0)
            inst = {n: dict(KERNELS[n]["wrapper"].by_instance)
                    for n in ("fused_float_tower", "cond_pair",
                              "float_tower_bwd", "cond_pair_bwd")}
            loss = real_epoch(self, dataset, epoch, *a, **k)
            what = f"ood_cli finetune epoch {epoch} (stage {stage})"
            n, rec = len(dataset), state.get("recons", 0) - recons
            if stage == self.model.n_flow_steps:
                check_counts(LRNN_PER_STEP, n, what, counts)
            else:
                check_counts({k: FLOW_PER_STEP.get(k, 0) * n
                              + STAGE_INPUT_PER_CALL.get(k, 0) * rec
                              for k in KERNELS}, 1, what, counts)
                for name, instance, want in (
                        ("fused_float_tower", btower.WGMMA_BF16, 5 * n),
                        ("fused_float_tower", btower.WGMMA_3XTF32, 20 * rec),
                        ("cond_pair", cpair.TENSOR_CORES, n),
                        ("cond_pair", cpair.CUDA_CORES, 4 * rec),
                        ("float_tower_bwd", btower.WGMMA_BF16, 5 * n),
                        ("cond_pair_bwd", cpair.TENSOR_CORES, n)):
                    got = KERNELS[name]["wrapper"].by_instance[instance] \
                        - inst[name][instance]
                    if got != want:
                        fail(f"{what}: {got} {name} launches ran the "
                             f"{instance} instance, expected {want}")
            seg.setdefault("epochs", []).append(stage)
            seg.setdefault("recons", []).append(rec)
            return loss

        def detect_checked(trainer, dataset, **k):
            name = "rescore" if "finetune" in seg else "detect"
            return segment(name, NLL_PER_CALL)(real["detect_ood"])(
                trainer, dataset, **k)

        ood_cli.detect_ood = detect_checked
        ood_cli.finetune_on_novel = segment("finetune", None)(
            real["finetune_on_novel"])
        CWFATrainer.train_epoch = epoch_checked
        CWFAModel.reconstruct = recon_counted
        report_path = root / "ood_report.json"
        argv = ["--main_data_path", str(root / "data"), "--lenslet_file",
                str(lenslets), "--pretrain_models_path", str(ckpt),
                "--cross_validation_nFold", "0", "--max_samples",
                str(OOD_FRAMES), "--finetune", "1", "--create_dist_plots",
                "1", "--epochs", "5", "--step_LL_ths_to_use=-1e30",
                "--img_size", str(img), "--report", str(report_path)]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            report = ood_cli.main(argv)
        finally:
            for n, fn in real.items():
                setattr(ood_cli, n, fn)
            CWFATrainer.train_epoch = real_epoch
            CWFAModel.reconstruct = real_recon
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        for name, n in launch_counts().items():
            kernels[name]["ood_launches"] = n
        _check_ood_cli(report, report_path, seg, state["trainer"], total,
                       card, kernels)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def _check_ood_cli(report, report_path, seg, trainer, total, card, kernels):
    n_steps = trainer.cfg.INN_max_down_steps
    with open(report_path) as f:
        if json.load(f) != report:
            fail("ood_cli: the report file differs from main's return")
    scores, after = (np.asarray(report[k]) for k in
                     ("scores", "scores_after_finetune"))
    if scores.shape != (OOD_FRAMES,) or not np.isfinite(scores).all() \
            or report["is_ood"] != [1] * OOD_FRAMES:
        fail(f"ood_cli scores {report['scores']}, is_ood {report['is_ood']}")
    losses = report["finetune_losses"]
    if sorted(losses) != [str(s) for s in range(1, n_steps + 1)] or not all(
            len(v) == OOD_EPOCHS_PER_STEP and np.isfinite(v).all()
            for v in losses.values()):
        fail(f"ood_cli finetune_losses {losses}")
    if after.shape != scores.shape or not np.isfinite(after).all() \
            or np.array_equal(after, scores):
        fail(f"ood_cli scores after finetune {after} (before {scores})")
    png = report_path.with_name(report_path.stem + "_dist.png")
    with open(png, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            fail(f"ood_cli {png.name} is not a PNG")
    if seg["detect_uploads"] != [OOD_FRAMES] or seg["finetune_uploads"] != \
            [OOD_FRAMES] or seg["rescore_uploads"] != [OOD_FRAMES]:
        fail(f"ood_cli volume uploads after detect / finetune / re-score: "
             f"{seg['detect_uploads']} / {seg['finetune_uploads']} / "
             f"{seg['rescore_uploads']}, expected {OOD_FRAMES} each")
    want = [s for s in range(n_steps - 1, -1, -1)
            for _ in range(OOD_EPOCHS_PER_STEP)]
    if seg["epochs"] != want:
        fail(f"ood_cli finetune ran stages {seg['epochs']}, expected {want}")
    # a stage's second epoch reconstructs every frame's input: its first
    # captured outputs of its own level (all but the finest stage capture)
    want_recons = ([0] * OOD_EPOCHS_PER_STEP + [0, OOD_FRAMES] * (n_steps - 2)
                   + [0, 0])
    if seg["recons"] != want_recons:
        fail(f"ood_cli stage inputs reconstructed per epoch {seg['recons']}, "
             f"expected {want_recons}")
    log(f"ood_cli (cli.ood.main at the flagship, {OOD_FRAMES} frames): "
        f"scores {np.round(scores, 4).tolist()}, all flagged; finetune "
        f"losses by step { {k: ['%.5g' % x for x in v] for k, v in losses.items()} }; "
        f"scores after {np.round(after, 4).tolist()}; {png.name} written "
        f"(the numpy drawing); "
        f"{OOD_FRAMES} volume uploads across detect -> finetune -> "
        f"re-score; stages {seg['epochs']}, stage inputs reconstructed "
        f"{seg['recons']}; on {card}")
    log(f"ood_cli segments: main {total:.1f} s; detect {seg['detect'][0]:.2f}"
        f" s (peak {seg['detect_peak'][0] / 2**30:.2f} GiB), finetune "
        f"{seg['finetune'][0]:.2f} s for {len(seg['epochs'])} epochs of "
        f"{OOD_FRAMES} frames (peak {seg['finetune_peak'][0] / 2**30:.2f} "
        f"GiB), re-score {seg['rescore'][0]:.2f} s (peak "
        f"{seg['rescore_peak'][0] / 2**30:.2f} GiB)")
    log(f"ood_cli launches: "
        f"{ {k: v['ood_launches'] for k, v in kernels.items() if v.get('ood_launches')} }")


# ---------------------------------------------------------------------------
# the reference's PyTorch checkpoints, and the XLFMNet baseline
# ---------------------------------------------------------------------------


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir() if f.is_file())


def _swap_perm(path: Path, step: int, module: int):
    """Swap entries 0 and 1 of ``module_list.<module>.perm`` in the torch
    file of ``step``, with perm_inv fixed to match.  Returns the step's
    (perm, inv) pairs as the file now holds them."""
    (fname,) = path.glob(f"model_step_{step}__ep_*")
    payload = torch.load(fname, weights_only=False)
    sd = payload["INN_state_dict"]
    perm = sd[f"module_list.{module}.perm"].clone()
    perm[[0, 1]] = perm[[1, 0]]
    sd[f"module_list.{module}.perm"] = perm
    sd[f"module_list.{module}.perm_inv"] = torch.argsort(perm)
    torch.save(payload, fname)
    return [(sd[f"module_list.{m}.perm"].numpy().astype(np.int32),
             sd[f"module_list.{m}.perm_inv"].numpy().astype(np.int32))
            for m in sorted(int(k.split(".")[1]) for k in sd
                            if k.endswith(".perm"))]


def phase_torch_ckpt(dev, card, kernels):
    """The reference's checkpoint format at the flagship width: the
    flagship (random weights from a seed, the LRNN's BatchNorm statistics
    moved off their init, random Lion momenta) saved as the port's msgpack
    set, written as the reference's torch files by ``python -m
    cwfa_tpu_torch.cli.export_torch``, one permutation of step 1 altered in
    the files, then loaded into a fresh trainer on the card with
    ``CWFATrainer.load_torch_checkpoints`` and reconstructed at batch 1,
    bf16, deterministic: the volume equal to the bit to the source model's
    under the same altered permutation and unequal to the source model's
    own, the launches per call the flagship's (BF16_PER_CALL)."""
    from cwfa_tpu_torch.engine import torch_convert as tc

    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in model.lrnn.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.num_batches_tracked.fill_(7)
    opts = make_optimizers(model)
    for lion in opts[0] + opts[1] + [opts[2]]:
        for mu in lion.mu:
            mu.normal_(0.0, 1e-3, generator=g)
    root = Path(tempfile.mkdtemp(prefix="cwfa_tckpt_"))
    try:
        src, out = root / "msgpack", root / "torch"
        checkpoints.save_model_checkpoints(model, str(src), epoch=7,
                                           stats=stats, optimizers=opts)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cwfa_tpu_torch.cli.export_torch",
             "--pretrain_models_path", str(src), "--output_path", str(out)],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600)
        export_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"cli.export_torch exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        names = sorted(p.name for p in out.iterdir())
        nf = model.n_flow_steps
        if names != [f"model_step_{s}__ep_7" for s in range(1, nf + 2)] \
                or len(proc.stdout.splitlines()) != nf + 2:
            fail(f"cli.export_torch wrote {names}: {proc.stdout}")
        perms = _swap_perm(out, step=1, module=3)

        fresh = flagship(False, "cpu", torch.Generator().manual_seed(5))[1]
        tr = CWFATrainer(fresh, None, vidx, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = tr.load_torch_checkpoints(str(out))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if loaded != list(range(1, nf + 2)) \
                or tr.stats.astuple() != stats.astuple():
            fail(f"load_torch_checkpoints: steps {loaded}, stats {tr.stats}")
        for k in range(nf):
            want = tr.model.flow[k].spec.perms
            if not all(np.array_equal(a[-2], b[-2]) for a, b in zip(
                    want, (perms if k == 0 else model.step_specs[k].perms))):
                fail(f"step {k}: the loaded permutations are not the file's")
        got_bn = [m.running_mean.cpu() for m in tr.model.lrnn.modules()
                  if isinstance(m, torch.nn.BatchNorm2d)]
        want_bn = [m.running_mean for m in model.lrnn.modules()
                   if isinstance(m, torch.nn.BatchNorm2d)]
        if not all(torch.equal(a, b) for a, b in zip(got_bn, want_bn)):
            fail("the LRNN's BatchNorm statistics did not come across")

        rng = np.random.RandomState(9)
        side = cfg.volume_side_size
        caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
                  .astype(np.float32) for k in range(nf + 1)]
        frames = torch.as_tensor(
            rng.rand(1, img, img).astype(np.float32) * 1000).to(dev)

        def volume(m, s):
            recon = XLFMReconstructor(m, s, vidx, caches, device=dev,
                                      deterministic=True,
                                      compute_dtype=torch.bfloat16)
            out_ = recon(frames)
            torch.cuda.synchronize()
            return out_

        reset_counts()
        before = launch_counts()
        got = volume(tr.model, tr.stats)
        delta = check_counts(BF16_PER_CALL, 1, "torch_ckpt reload", before)
        for name, n in delta.items():
            if name in BF16_PER_CALL:
                kernels[name]["ckpt_launches"] = n
        ref = copy.deepcopy(model)
        ref.set_step_spec(0, tc.apply_perm_overrides(ref.step_specs[0],
                                                     perms))
        want = volume(ref, stats)
        plain = volume(model, stats)
        if tuple(got.shape) != (1, cfg.n_depths, side, side) \
                or not bool(torch.isfinite(got).all()):
            fail(f"torch_ckpt volume {tuple(got.shape)} not finite")
        if not torch.equal(got, want):
            fail(f"torch_ckpt: the reloaded volume differs from the source "
                 f"model's under the altered permutation by "
                 f"{float((got.float() - want.float()).abs().max()):.3e}")
        if torch.equal(got, plain):
            fail("torch_ckpt: the altered permutation did not change the "
                 "volume")
        log(f"torch_ckpt: msgpack set {_dir_bytes(src)} B -> "
            f"cli.export_torch {export_s:.2f} s (a process of its own) -> "
            f"{len(names)} reference files {_dir_bytes(out)} B; "
            f"load_torch_checkpoints {load_s:.2f} s on the card; the "
            f"reloaded batch-1 bf16 volume equal to the bit to the source "
            f"model's under the altered perm (step 1, module 3), unequal "
            f"without it (max |d| "
            f"{float((plain.float() - got.float()).abs().max()):.3e}); "
            f"launches {delta} in 1 call; on {card}")
        del tr, fresh, ref
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_xlfmnet_small(dev):
    """XLFMNet on a small rig, card vs CPU in f32 (TF32 off): the eval
    forward within 1e-4 of max|ref|; three ``train_xlfmnet`` steps from one
    init on the same batches, losses within 1e-4 relative, parameters and
    BatchNorm statistics within 1e-3 of each tree's max|ref|."""
    from cwfa_tpu_torch.engine import xlfmnet_train as xt
    from cwfa_tpu_torch.models.unet import UNetSpec
    from cwfa_tpu_torch.models.xlfmnet import XLFMNetSpec

    spec = XLFMNetSpec(in_views=4, out_depths=16, unet=UNetSpec(
        in_channels=16, n_classes=16, depth=3, wf=6, batch_norm=True,
        skip_conn=False, drop_out=0.0, activation="elu"))
    cpu = xt.build_xlfmnet(spec, torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu).to(dev)
    rng = np.random.RandomState(0)
    views = rng.randn(4, 4, 32, 32).astype(np.float32)
    vols = rng.randn(4, 16, 32, 32).astype(np.float32)
    with torch.inference_mode():
        want = cpu(torch.as_tensor(views))
        got = card_model(torch.as_tensor(views).to(dev)).cpu()
    err = share_err(got, want, 1e-4, "xlfmnet small forward card vs CPU")
    lr = CWFAConfig().decode_lrs().learning_rate_first_step
    res = [xt.train_xlfmnet(spec, views, vols, n_steps=3, learning_rate=lr,
                            batch_size=2, model=m, device=d)
           for m, d in ((cpu, "cpu"), (card_model, dev))]
    (m_cpu, l_cpu), (m_dev, l_dev) = res
    lerr = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
    if not lerr <= 1e-4:
        fail(f"xlfmnet small Lion steps: losses {l_dev} vs {l_cpu}")
    m_dev = m_dev.cpu()
    for what, tensors in (
            ("parameters", lambda m: [p.detach() for p in m.parameters()]),
            ("BatchNorm statistics", lambda m: [
                b for n, b in m.named_buffers()
                if not n.endswith("num_batches_tracked")])):
        want_t, got_t = tensors(m_cpu), tensors(m_dev)
        scale = max(float(t.abs().max()) for t in want_t)
        e = max(float((a - b).abs().max()) for a, b in zip(got_t, want_t))
        if not e <= 1e-3 * scale:
            fail(f"xlfmnet small Lion steps: {what} differ by {e:.3e} "
                 f"(bound {1e-3 * scale:.3e})")
    log(f"xlfmnet small rig (4 views -> 16 depths at 32^2, UNet depth 3), "
        f"card vs CPU f32: forward max|d| {err:.3e} (bound 1e-4 x "
        f"max|ref|); 3 Lion steps: losses within {lerr:.3e} relative "
        f"(bound 1e-4), parameters and BatchNorm statistics within 1e-3 of "
        f"max|ref|")


def xlfmnet_flop(spec, side: int) -> float:
    """Multiply-adds x 2 of one XLFMNet forward at ``side``^2 (convs and
    transposed convs; BatchNorm and activations not counted)."""
    u = spec.unet
    flop = 2 * 9 * spec.in_views * spec.out_depths * side * side
    prev, s = u.in_channels, side
    for i in range(u.depth):
        c = 2 ** (u.wf + i)
        flop += 2 * 9 * (prev * c + c * c) * s * s
        prev = c
        if i != u.depth - 1:
            s //= 2
    for i in reversed(range(u.depth - 1)):
        c = 2 ** (u.wf + i)
        s *= 2
        flop += 2 * prev * c * s * s + 2 * 9 * 2 * c * c * s * s
        prev = c
    return flop + 2 * prev * u.n_classes * s * s


def phase_xlfmnet(dev, card, img: int):
    """XLFMNet (``--INN_net_type 2``): the small rig card vs CPU; the
    flagship width (29 views of 512^2 -> 96 depths, UNet depth 5, wf 6),
    f32, forward ms/frame at batch 1 and 8 and a training step at
    ``cfg.batch_size``, CUDA events, the median of 3 after a warm-up, with
    peak memory; then ``cli.train.main`` with ``--INN_net_type 2`` on two
    fish of TRAIN_FRAMES random frames (fold 0, ``--max_samples 3 --epochs
    2``): finite losses and PSNRs, the checkpoint written, and
    ``load_xlfmnet`` giving back the trained model's forward to the bit."""
    from cwfa_tpu_torch.cli import train as train_cli
    from cwfa_tpu_torch.engine import xlfmnet_train as xt
    from cwfa_tpu_torch.engine.optim import Lion

    phase_xlfmnet_small(dev)
    cfg = CWFAConfig().decode_lrs()
    side = cfg.volume_side_size
    spec = xt.build_xlfmnet_spec(cfg)
    model = xt.build_xlfmnet(spec, torch.Generator().manual_seed(0)).to(dev)
    flop = xlfmnet_flop(spec, side)
    rng = np.random.RandomState(1)
    x8 = torch.as_tensor(rng.randn(8, spec.in_views, side, side)
                         .astype(np.float32)).to(dev)
    fwd = {}
    for batch in (1, 8):
        x = x8[:batch]
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = model(x)
            torch.cuda.synchronize()
            if tuple(out.shape) != (batch, cfg.n_depths, side, side) \
                    or not bool(torch.isfinite(out).all()):
                fail(f"xlfmnet flagship forward {tuple(out.shape)}")
            ms = event_ms(lambda: model(x))
        fwd[batch] = (float(np.median(ms)) / batch,
                      torch.cuda.max_memory_allocated())
        log(f"xlfmnet flagship forward batch {batch}: "
            f"{fwd[batch][0]:.3f} ms/frame (median of {ms} ms per call), "
            f"{flop / 1e12:.4f} TFLOP a frame, "
            f"{flop / (fwd[batch][0] * 1e-3) / 1e12:.1f} TFLOP/s f32, "
            f"peak memory {fwd[batch][1] / 2**30:.2f} GiB; on {card}")
    del out, x8
    bs = max(int(cfg.batch_size), 1)
    v = torch.as_tensor(rng.randn(bs, spec.in_views, side, side)
                        .astype(np.float32)).to(dev)
    gt = torch.as_tensor(rng.randn(bs, cfg.n_depths, side, side)
                         .astype(np.float32)).to(dev)
    lion = Lion(model, cfg.learning_rate_first_step,
                weight_decay=xt.LION_WEIGHT_DECAY)
    model.train()
    losses, marks = [], []

    def step():
        """One optimizer step, with events between its three segments."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        lion.zero_grad()
        loss = recon_loss(cfg.loss_func_first_step, gt, model(v, train=True))
        ev[1].record()
        loss.backward()
        ev[2].record()
        lion.step()
        ev[3].record()
        losses.append(loss.detach())
        marks.append(ev)

    torch.cuda.reset_peak_memory_stats()
    step()
    ms = event_ms(step)
    peak = torch.cuda.max_memory_allocated()
    model.eval()
    if not all(bool(torch.isfinite(l_)) for l_ in losses):
        fail(f"xlfmnet flagship training losses {losses}")
    step_ms = float(np.median(ms))
    segs = {name: float(np.median([ev[i].elapsed_time(ev[i + 1])
                                   for ev in marks[1:]]))
            for i, name in enumerate(("forward + loss", "backward",
                                      "Lion"))}
    log(f"xlfmnet flagship training step at batch {bs}: {step_ms:.3f} ms "
        f"(median of {ms}), {3 * flop * bs / 1e12:.4f} TFLOP (3x the "
        f"forward), peak memory {peak / 2**30:.2f} GiB; by segment "
        f"(medians, ms) {segs}; on {card}")
    del model, lion, v, gt
    torch.cuda.empty_cache()

    root = Path(tempfile.mkdtemp(prefix="cwfa_xlfmnet_"))
    trained = {}
    orig = xt.train_xlfmnet

    def keep(*args, **kw):
        out_ = orig(*args, **kw)
        trained["model"], trained["losses"] = out_
        return out_

    try:
        lenslets = write_cli_tree(root / "data", cfg, img)
        argv = ["--main_data_path", str(root / "data"), "--lenslet_file",
                str(lenslets), "--output_testing_path",
                str(root / "runs") + "/", "--cross_validation_nFold", "0",
                "--max_samples", "3", "--epochs", "2", "--img_size",
                str(img), "--n_depths", str(cfg.n_depths),
                "--volume_side_size", str(side), "--INN_net_type", "2"]
        xt.train_xlfmnet = keep
        t0 = time.perf_counter()
        try:
            results = train_cli.main(argv)
        finally:
            xt.train_xlfmnet = orig
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        (run_dir,) = list((root / "runs").iterdir())
        losses = trained["losses"]
        if len(losses) != 2 * TRAIN_FRAMES or not np.isfinite(losses).all():
            fail(f"xlfmnet CLI losses {losses}")
        for tag in ("train", "test"):
            psnr = [r[0] for r in results[tag]["psnr"]]
            if len(psnr) != TRAIN_FRAMES or not np.isfinite(psnr).all():
                fail(f"xlfmnet CLI {tag} PSNRs {psnr}")
        ckpt = run_dir / "xlfmnet_step_0__ep_1.msgpack"
        if not ckpt.is_file():
            fail(f"xlfmnet CLI: no {ckpt.name} in {sorted(os.listdir(run_dir))}")
        back, _, _ = xt.load_xlfmnet(str(run_dir), device=dev)
        x = torch.as_tensor(np.random.RandomState(2).randn(
            1, spec.in_views, side, side).astype(np.float32)).to(dev)
        with torch.inference_mode():
            same = torch.equal(back(x), trained["model"](x))
        if not same:
            fail("xlfmnet: load_xlfmnet's forward differs from the trained "
                 "model's")
        log(f"xlfmnet CLI (--INN_net_type 2, fold 0, {TRAIN_FRAMES} train / "
            f"{TRAIN_FRAMES} test frames of {img}^2, 2 epochs, batch "
            f"{bs}): {total:.1f} s; losses {np.round(losses, 5).tolist()}; "
            f"level-0 PSNR train "
            f"{np.mean([r[0] for r in results['train']['psnr']]):.3f} test "
            f"{np.mean([r[0] for r in results['test']['psnr']]):.3f}; "
            f"{ckpt.name} {ckpt.stat().st_size} B, load_xlfmnet's forward "
            f"equal to the bit; eval s/frame "
            f"{np.mean(results['test']['times']):.4f}; on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ blocks

NON_CAT = ("RNVP", "GLOW", "GIN", "NICE", "AI1")
BLOCK_FRAMES = 2                   # a fish's frames in the AI1 CLI run


def model_towers(model, steps=None):
    """Every float tower of the model's flow steps (all, or those in
    ``steps``): each step's input block's and its coupling blocks'."""
    return [m for k, step in enumerate(model.flow)
            if steps is None or k in steps
            for m in step.modules() if isinstance(m, WaveletFlowSubnet2d)]


def tower_instances(towers, dtype, backward: bool = False) -> dict:
    """{instance: count} of the towers' launches in ``dtype``, by the
    kernel's own choice (``btower.kernel_instance`` / ``bwd_instance``)."""
    pick = btower.bwd_instance if backward else btower.kernel_instance
    out = {}
    for t in towers:
        inst = pick(dtype, t.b2a.in_channels, t.b1.in_channels,
                    t.b7.out_channels)
        out[inst] = out.get(inst, 0) + 1
    return out


def no_cuda_cores(wrapper, what: str):
    """Fails if ``wrapper`` ran its CUDA-core instance since
    reset_counts()."""
    n = wrapper.by_instance[btower.CUDA_CORES]
    if n:
        fail(f"{what}: {n} launches on the CUDA cores, expected none")


def check_by_instance(wrapper, want: dict, calls: int, what: str):
    """Fails unless ``wrapper``'s launches by instance since reset_counts()
    are ``want`` times ``calls``."""
    got = {k: n for k, n in wrapper.by_instance.items() if n}
    want = {k: n * calls for k, n in want.items()}
    log(f"{what}: launches by instance {got}")
    if got != want:
        fail(f"{what}: launches by instance {got}, expected {want}")


def non_cat_tower_shapes(cin_list=TOWER_CIN):
    """(Cin, Nout) of every coupling tower of the non-CAT types at the
    flagship's steps: the two-sided halves [x half | c_views] -> the other
    half (RNVP, NICE) or its (s | t) (GLOW, GIN, AI1)."""
    shapes = []
    for c in cin_list:
        l1, l2 = c // 2, c - c // 2
        for shape in ((l1 + c, l2), (l2 + c, l1), (l1 + c, 2 * l2),
                      (l2 + c, 2 * l1)):
            if shape not in shapes:
                shapes.append(shape)
    return shapes


def check_block_towers(dev, kernels) -> dict:
    """The float tower (forward) and K2 (backward) at every coupling-tower
    shape of the non-CAT types (Cin 72 / 36 / 18 / 9 at 512^2, 64 wide),
    each launch against its plain version, f32 and bf16, logging the
    instance that ran (wgmma at every shape, Cin 72 too); times the bf16
    forward and K2 at each shape; at Cin 72 each wgmma instance in turns
    with the CUDA-core one (the f32 forward too), beside the bound and the
    cuDNN chain.  Returns {(cin, nout): (forward ms, K2 ms)} in bf16."""
    gen = torch.Generator().manual_seed(14)
    flat = lambda g: [g[0]] + [t for pair in zip(g[1], g[2]) for t in pair]
    fwd, bwd = kernels["fused_float_tower"], kernels["float_tower_bwd"]
    times = {}
    for cin, nout in non_cat_tower_shapes():
        tower = WaveletFlowSubnet2d(cin, nout, 64)
        reset_parameters_(tower, gen)
        tower = tower.to(dev)                   # f32 master weights
        x0 = torch.randn((1, cin, SLICE_HW, SLICE_HW), generator=gen)
        dy0 = torch.randn((1, nout, SLICE_HW, SLICE_HW), generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x0.to(dev, dtype), dy0.to(dev, dtype)
            t = copy.deepcopy(tower).to(dtype).eval()
            inst = btower.kernel_instance(dtype, 64, cin, nout)
            if inst == btower.CUDA_CORES:
                fail(f"blocks tower {cin}->{nout} {dtype}: not on wgmma")
            with torch.inference_mode():
                got = one_launch_of(
                    btower.fused_float_tower, inst,
                    lambda: btower.fused_float_tower(x, t),
                    f"blocks tower {cin}->{nout} {dtype}")
                want = btower.float_tower_reference(t, x).to(dtype)
                e, share = rel_err(got, want, "fused_float_tower", dtype,
                                   f"blocks tower {cin}->{nout} {dtype}")
            fwd["max_abs_err"] = max(fwd.get("max_abs_err", 0.0), e)
            del got, want
            binst = btower.bwd_instance(dtype, 64, cin, nout)
            got = one_launch_of(
                btower.float_tower_backward, binst,
                lambda: btower.float_tower_backward(tower, x, dy),
                f"blocks K2 {cin}->{nout} {dtype}")
            ref = k2_reference(tower, x, dy)
            eb = grads_err(flat(got), flat(ref), dtype,
                           f"blocks K2 {cin}->{nout} {dtype} ({binst})")
            bwd["max_abs_err"] = max(bwd.get("max_abs_err", 0.0), max(
                (g - r).abs().max().item()
                for g, r in zip(flat(got), flat(ref)) if r is not None))
            del got, ref
            line = (f"blocks tower (1, {cin}, 512, 512) -> {nout} "
                    f"{str(dtype)[6:]}: forward ({inst}) max|d| {e:.3e}, "
                    f"{share:.2e} of the elements differ; K2 ({binst}) "
                    f"max|d|/max|ref| {eb:.3e}")
            log(line)
            flop = 2 * SLICE_HW * SLICE_HW * (cin * 64 + 3 * 10 * 64 * 64
                                              + 9 * 64 * nout)
            if cin > btower.WGMMA_WIDTH:
                with torch.inference_mode():
                    f_ms = wide_tower_in_turns(
                        t, x, inst, flop, f"(1, {cin}, 512, 512) -> {nout} "
                        f"(blocks)", cudnn=dtype == torch.bfloat16)
                if dtype == torch.bfloat16:
                    b_ms = wide_k2_in_turns(
                        tower, x, dy, f"(1, {cin}, 512, 512) -> {nout} "
                        f"(blocks)", cudnn=True)
                    times[(cin, nout)] = (f_ms, b_ms)
            elif dtype == torch.bfloat16:
                with torch.inference_mode():
                    f_ms = time_ms(lambda: btower.fused_float_tower(x, t), 5)
                b_ms = time_ms(lambda: btower.float_tower_backward(
                    tower, x, dy), 3, warmup=1)
                times[(cin, nout)] = (f_ms, b_ms)
                log(f"time blocks tower (1, {cin}, 512, 512) -> {nout} bf16: "
                    f"forward {f_ms:.4f} ms, K2 {b_ms:.4f} ms")
    return times


def phase_blocks_small(dev):
    """Small rig, f32, each non-CAT type: reconstruct (fast and not) and
    the per-frame NLLs, card vs CPU within 1e-4; every step forward then
    reverse on the card."""
    rng = np.random.RandomState(15)
    for bt in NON_CAT:
        cfg, model, _, _, _ = flagship(
            True, "cpu", torch.Generator().manual_seed(0), bt)
        model.eval()
        card = copy.deepcopy(model).to(dev)
        side, nf = cfg.volume_side_size, model.n_flow_steps
        views = torch.as_tensor(rng.randn(2, cfg.n_lenslets, side, side)
                                .astype(np.float32))
        caches = [torch.as_tensor(rng.randn(1, cfg.n_depths // 2 ** (k + 1),
                                            side, side).astype(np.float32))
                  for k in range(nf + 1)]
        errs = []
        for fast in (True, False):
            ref = model.reconstruct(views, caches, fast=fast)
            got = card.reconstruct(views.to(dev), [c.to(dev) for c in caches],
                                   fast=fast)
            errs.append(share_err(got.cpu(), ref, 1e-4,
                                  f"blocks small rig {bt} fast={fast}"))
        gt = torch.as_tensor(rng.randn(2, cfg.n_depths, side, side)
                             .astype(np.float32) * 3)
        ref = torch.stack(model.forward_pyramid(gt, per_sample=True)[0])
        got = torch.stack(card.forward_pyramid(gt.to(dev),
                                               per_sample=True)[0])
        e_nll = nll_bound(got, ref, f"blocks small rig {bt} NLLs")
        rt = []
        gen = torch.Generator(device=dev).manual_seed(16)
        with torch.no_grad():
            for k, step in enumerate(card.flow):
                d = cfg.n_depths // 2 ** k
                v, cv, cm = (torch.randn((2, c, side, side), device=dev,
                                         generator=gen)
                             for c in (d, d // 2, d // 2))
                z, avg, ld = step(v, cv, cm)
                back, ld_rev = step.reverse(z, avg, cv, cm)
                rt.append(share_err(back, v, 1e-4,
                                    f"blocks {bt} step {k} round trip"))
                logdet_bound(ld, ld_rev, f"blocks {bt} step {k} log-dets")
        log(f"blocks small rig f32 {bt}, card vs CPU: reconstruct fast "
            f"{errs[0]:.3e}, non-fast {errs[1]:.3e} (bound 1e-4 max|ref|); "
            f"NLLs max|d| {e_nll:.3e} (bound 1e-4 max(1, |ref|)); forward "
            f"then reverse on the card max|d| {max(rt):.3e}; log-dets within "
            f"max(1e-4, 2^-20 |ld|)")


def phase_blocks_flagship(dev, card, kernels, bt: str) -> dict:
    """The flagship with ``INN_block_type`` = bt: bf16 deterministic
    reconstruction at batch 1 (ms/frame, peak, launches by kernel and
    instance), bf16 vs f32, ``PyramidScorer`` at batch 1, and one flow
    optimizer step at step 0 in bf16 (ms, peak, finite loss, parameters
    moved, AI1's w_perm unchanged).  Returns the figures."""
    t0 = time.perf_counter()
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0), bt)
    built = time.perf_counter() - t0
    nf, side = model.n_flow_steps, cfg.volume_side_size
    rng = np.random.RandomState(0)
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(nf + 1)]
    frames1 = torch.as_tensor(rng.rand(1, img, img).astype(np.float32)
                              * 1000).to(dev)
    towers = model_towers(model)
    out = {"towers_per_call": len(towers), "build_s": built}
    per_call = {"fused_float_tower": len(towers), "haar_merge_affine": nf,
                "cond_pair": nf}

    recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                              deterministic=True,
                              compute_dtype=torch.bfloat16)
    reset_counts()
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out16 = recon(frames1)
    torch.cuda.synchronize()
    if tuple(out16.shape) != (1, cfg.n_depths, side, side) or not bool(
            torch.isfinite(out16).all()):
        fail(f"blocks {bt} flagship bf16: {tuple(out16.shape)} or not finite")
    ms = event_ms(lambda: recon(frames1))
    peak = torch.cuda.max_memory_allocated()
    delta = check_counts(per_call, 4, f"blocks {bt} flagship bf16", before)
    check_by_instance(btower.fused_float_tower,
                      tower_instances(towers, torch.bfloat16), 4,
                      f"blocks {bt} flagship bf16 towers")
    no_cuda_cores(btower.fused_float_tower, f"blocks {bt} flagship bf16 towers")
    check_instance("cond_pair", cpair.TENSOR_CORES,
                   f"blocks {bt} flagship bf16")
    for name, n in delta.items():
        kernels[name].setdefault("blocks_launches", {})[bt] = n // 4
    out.update(ms=float(np.median(ms)), peak=peak / 2 ** 30,
               by_instance={k: n // 4 for k, n in
                            btower.fused_float_tower.by_instance.items() if n})
    del recon
    recon32 = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                                deterministic=True,
                                compute_dtype=torch.float32)
    reset_counts()
    out32 = recon32(frames1)
    check_by_instance(btower.fused_float_tower,
                      tower_instances(towers, torch.float32), 1,
                      f"blocks {bt} flagship f32 towers")
    no_cuda_cores(btower.fused_float_tower, f"blocks {bt} flagship f32 towers")
    rel = ((out16 - out32).abs().max() / out32.abs().max()).item()
    out["bf16_vs_f32"] = rel
    del recon32, out16, out32
    if not rel <= 5e-2:
        fail(f"blocks {bt} flagship bf16 vs f32 {rel:.3e} > 5e-2")
    log(f"blocks {bt} flagship bf16 batch 1: built on the CPU in "
        f"{built:.1f} s; {out['ms']:.2f} ms/frame (median of {ms} ms); "
        f"peak memory {out['peak']:.2f} GiB; launches {delta} in 4 calls; "
        f"towers by instance per call {out['by_instance']}; bf16 vs f32 "
        f"max|d|/max|f32| {rel:.3e} (bound 5e-2); on {card}")

    card_model = copy.deepcopy(model).to(dev).eval()
    scorer = PyramidScorer(card_model, stats, device=dev, batch_size=1,
                           generator=torch.Generator(device=dev).manual_seed(5))
    vols = torch.as_tensor((rng.rand(1, cfg.n_depths, side, side) * 20)
                           .astype(np.float16)).to(dev)
    reset_counts()
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    nlls = scorer(vols)[0]
    torch.cuda.synchronize()
    if tuple(nlls.shape) != (nf, 1) or not bool(torch.isfinite(nlls).all()) \
            or bool((nlls == 1e15).any()):
        fail(f"blocks {bt} flagship NLLs {nlls.tolist()}")
    nll_ms = event_ms(lambda: scorer(vols))
    nll_peak = torch.cuda.max_memory_allocated()
    check_counts({"fused_float_tower": len(towers)}, 4,
                 f"blocks {bt} flagship NLL", before)
    check_by_instance(btower.fused_float_tower,
                      tower_instances(towers, torch.float32), 4,
                      f"blocks {bt} flagship NLL towers")
    no_cuda_cores(btower.fused_float_tower, f"blocks {bt} flagship NLL towers")
    out.update(nll_ms=float(np.median(nll_ms)), nll_peak=nll_peak / 2 ** 30)
    log(f"blocks {bt} flagship NLL f32 batch 1: "
        f"{[round(v, 4) for v in nlls[:, 0].tolist()]}; {out['nll_ms']:.2f} "
        f"ms/frame (median of {nll_ms}); peak {out['nll_peak']:.2f} GiB; "
        f"on {card}")
    del scorer, card_model, vols

    tr = CWFATrainer(model, stats, vidx, device=dev)
    spec = model.step_specs[0]
    d = spec.d_in
    gen = torch.Generator(device=dev).manual_seed(6)
    inputs = (torch.randn((1, cfg.n_lenslets, side, side), device=dev,
                          generator=gen),
              torch.randn((1, d // 2, side, side), device=dev,
                          generator=gen) * 0.3,
              torch.randn((1, d, side, side), device=dev, generator=gen),
              torch.randn((1, d // 2, side, side), device=dev, generator=gen))
    step_towers = model_towers(model, steps={0})
    fixed = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith("w_perm")}
    if (bt == "AI1") != bool(fixed):
        fail(f"blocks {bt}: w_perm buffers {sorted(fixed)}")
    params0 = [p.detach().clone() for p in model.flow[0].parameters()]
    reset_counts()
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    loss = tr._flow_step(0, *inputs)[0]
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(float(loss)):
        fail(f"blocks {bt} flow step 0 loss {float(loss)}")
    n_t = 2 * len(step_towers)
    check_counts({"fused_float_tower": n_t, "float_tower_bwd": n_t,
                  "cond_pair": 1, "cond_pair_bwd": 1}, 1,
                 f"blocks {bt} flow step 0", before)
    check_by_instance(btower.float_tower_backward,
                      tower_instances(step_towers, torch.bfloat16,
                                      backward=True), 2,
                      f"blocks {bt} flow step 0 K2")
    no_cuda_cores(btower.float_tower_backward, f"blocks {bt} flow step 0 K2")
    no_cuda_cores(btower.fused_float_tower, f"blocks {bt} flow step 0 towers")
    moved = sum(not torch.equal(p0, p) for p0, p in
                zip(params0, model.flow[0].parameters()))
    if moved != len(params0):
        fail(f"blocks {bt} flow step 0: {moved} of {len(params0)} "
             "parameters moved")
    for n, b in model.named_buffers():
        if n in fixed and not torch.equal(b, fixed[n]):
            fail(f"blocks {bt}: the optimizer step moved {n}")
    step_ms = event_ms(lambda: tr._flow_step(0, *inputs), 2)
    out.update(step_ms=float(np.median(step_ms)), step_peak=step_peak / 2 ** 30,
               loss=float(loss),
               k2_by_instance={k: n for k, n in
                               btower.float_tower_backward.by_instance.items()
                               if n})
    log(f"blocks {bt} flow optimizer step 0 bf16 batch 1: loss "
        f"{float(loss):.4f}, all {moved} parameter tensors of step 0 moved"
        f"{', w_perm unchanged' if fixed else ''}; {out['step_ms']:.2f} ms "
        f"(events {step_ms}); peak {out['step_peak']:.2f} GiB; towers and K2 "
        f"{n_t} each, K2 by instance in the 3 steps {out['k2_by_instance']};"
        f" on {card}")
    del tr, model
    torch.cuda.empty_cache()
    return out


def phase_blocks_cli(dev, card, kernels, img: int):
    """``cli.train.main --INN_block_type AI1`` at the flagship width on two
    fish of BLOCK_FRAMES random frames, 2 epochs (the LRNN stage, then the
    coarsest flow step), evaluation and the checkpoints at the end; the
    checkpoint directory read into a fresh trainer, whose reconstruction of
    a frame equals the trained model's to the bit."""
    from cwfa_tpu_torch.cli import train as train_cli

    root = Path(tempfile.mkdtemp(prefix="cwfa_blocks_"))
    state = {}
    orig = CWFATrainer.save_checkpoints

    def save(self, *args, **kw):
        files = orig(self, *args, **kw)
        state.update(files=files, trainer=self, sd={
            k: v.detach().clone() for k, v in self.model.state_dict().items()})
        return files

    try:
        cfg = CWFAConfig(INN_block_type="AI1")
        lenslets = write_cli_tree(root / "data", cfg, img,
                                  frames=BLOCK_FRAMES)
        argv = ["--main_data_path", str(root / "data"), "--lenslet_file",
                str(lenslets), "--output_testing_path",
                str(root / "runs") + "/", "--INN_block_type", "AI1",
                "--cross_validation_nFold", "0", "--max_samples",
                str(BLOCK_FRAMES), "--epochs", "2", "--eval_every", "2",
                "--img_size", str(img), "--save_tiff_volumes", "0"]
        CWFATrainer.save_checkpoints = save
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                results = train_cli.main(argv)
        finally:
            CWFATrainer.save_checkpoints = orig
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        if "files" not in state:
            fail("blocks AI1 CLI: no checkpoint written")
        for tag, res in results.items():
            if not (np.isfinite(np.asarray(res["nll"])).all()
                    and np.isfinite(np.asarray(res["psnr"])).all()):
                fail(f"blocks AI1 CLI: {tag} NLLs / PSNRs not finite")
        run_dir = os.path.dirname(state["files"][0])
        trained = state["trainer"]
        mcfg = trained.model.cfg
        gen = torch.Generator().manual_seed(1)
        mine = CWFAModel.build(mcfg, gen)
        mine.load_state_dict(state["sd"])
        fresh = CWFATrainer(CWFAModel.build(mcfg, gen), None, None,
                            device=dev)
        loaded = fresh.load_checkpoints(run_dir)
        if loaded != list(range(1, mcfg.INN_max_down_steps + 1)):
            fail(f"blocks AI1 CLI: loaded steps {loaded}")
        side = mcfg.volume_side_size
        vidx = make_view_indices(lenslet_coords(mcfg.n_lenslets, side, img),
                                 (img, img), (side, side))
        caches = [c.cpu().numpy() for c in fresh.mean_caches[0]]
        frame = np.random.RandomState(16).rand(1, img, img).astype(
            np.float32) * 1000
        vols = [XLFMReconstructor(m, fresh.stats, vidx, caches, device=dev,
                                  deterministic=True,
                                  compute_dtype=torch.bfloat16)(frame)
                for m in (mine, fresh.model)]
        exact_equal(vols[1], vols[0], "blocks AI1 CLI checkpoint reloaded")
        if not bool(torch.isfinite(vols[0]).all()):
            fail("blocks AI1 CLI reconstruction not finite")
        log(f"blocks AI1 CLI: main {total:.1f} s (2 fish x {BLOCK_FRAMES} "
            f"frames, 2 epochs, evaluation {sorted(results)}), "
            f"{len(state['files'])} files; the msgpack checkpoint reloaded "
            f"into a fresh trainer reconstructs equal to the bit; on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_blocks(dev, card, kernels, img: int):
    """Every other coupling type on the card: the tower shapes they add,
    the small rig card vs CPU, the flagship of each type, the AI1 CLI."""
    times = check_block_towers(dev, kernels)
    kernels["float_tower_bwd"]["blocks_step0_ms"] = {
        f"{cin}->{nout}": round(t[1], 4) for (cin, nout), t in times.items()}
    kernels["fused_float_tower"]["blocks_step0_ms"] = {
        f"{cin}->{nout}": round(t[0], 4) for (cin, nout), t in times.items()}
    torch.cuda.empty_cache()
    phase_blocks_small(dev)
    figures = {bt: phase_blocks_flagship(dev, card, kernels, bt)
               for bt in NON_CAT}
    log("blocks flagship summary: " + json.dumps(
        {bt: {k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in f.items()} for bt, f in figures.items()}))
    phase_blocks_cli(dev, card, kernels, img)


# ---------------------------------------------------------------------------
# More than one device: two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

PAR_RANKS = 2                      # ranks of the parallel phase, on cuda:0
PAR_BATCH = 8                      # the flagship's batch across the ranks
PAR_TIMEOUT = 600                  # seconds the ranks may take together
PAR_TRAIN_BATCH = 2                # training: 2 ranks x 1 against 1 x 2
PAR_GRAD_BOUND = 5e-2              # all-reduced gradient vs one process's,
                                   # of its max: the bf16 limit of (b)
PAR_CLI_FRAMES = 2                 # (g): cli.train on 2 frames of one fish


def par_train_inputs(dev, cfg, b: int):
    """Normalized views, GT levels 0..nf and mean caches of every step, (b,
    ...) f32, drawn on the card from a seeded generator (every process
    draws the same)."""
    g = torch.Generator(device=dev).manual_seed(31)
    side, nd = cfg.volume_side_size, cfg.n_depths
    nf = cfg.INN_max_down_steps - 1

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)
    views = rand(b, cfg.n_lenslets, side, side)
    gt = [rand(b, nd // 2 ** k, side, side) for k in range(nf + 1)]
    mcs = [rand(b, nd // 2 ** (k + 1), side, side) for k in range(nf + 1)]
    return views, gt, mcs


def par_two_steps(tr, views, gt, mcs, grads=None):
    """One LRNN step and one step-0 flow step (its stage input the GT's level
    1) on this rank's rows of the batch and of the image (the trainer's
    ``step_shards``; all of them without a mesh): the losses, each step's
    ms (CUDA events) and the launches of each step.  With a ``grads`` dict,
    each optimizer's gradient as it steps (after the all-reduce on a mesh)
    goes into it, flat f32 on the host (a copy inside the step's ms)."""
    from cwfa_tpu_torch.parallel.mesh import data_shard, row_shard
    nf = tr.model.n_flow_steps
    shard, rows = tr.step_shards(views.shape[0])
    sl = slice(None) if shard is None else slice(shard.start, shard.stop)
    own = (lambda t: t[sl]) if rows is None else (lambda t: rows.own(t[sl]))
    out = {"ms": [], "launches": []}
    opts = (("lrnn", tr.opt_lrnn), ("flow", tr.opt_flow[0]),
            ("cond", tr.opt_cond[0])) if grads is not None else ()
    for tag, opt in opts:
        def recorded(tag=tag, opt=opt, step=opt.step):
            grads[tag] = torch.cat([
                (torch.zeros_like(p) if p.grad is None else p.grad)
                .float().reshape(-1) for p in opt.params]).cpu()
            step()
        opt.step = recorded
    try:
        with data_shard(shard), row_shard(rows):
            for step in (lambda: tr._lrnn_step(views[sl], mcs[nf - 1][sl],
                                               own(gt[nf]))[0],
                         lambda: tr._flow_step(0, views[sl], mcs[0][sl],
                                               own(gt[0]), own(gt[1]))[0]):
                reset_counts()
                ms = event_ms(lambda: out.setdefault("losses", []).append(
                    float(step())), n=1)
                out["ms"] += ms
                out["launches"].append(launch_counts())
    finally:
        for _, opt in opts:
            del opt.step
    return out


def par_state(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def par_rank_rl(dev, rank, work: Path, a) -> dict:
    """(a) on this rank: its depths' OTF, a warm call, the timed sharded RL
    on frame 0, the gathered volume; then the CLI with --mesh_depth_axis."""
    from cwfa_tpu_torch.ops.deconv import (gather_depths,
                                           xlfm_deconvolve_sharded)
    argv = a["rl_argv"]
    args = deconvolve.build_parser().parse_args(argv)
    d_local = RL_DEPTHS // PAR_RANKS
    torch.cuda.reset_peak_memory_stats()
    otf, _, hw = load_psf_otf(a["psf_file"], (RL_VOL, RL_VOL, RL_DEPTHS),
                              device=dev, depths=slice(rank * d_local,
                                                       (rank + 1) * d_local))
    _, frame = next(deconvolve._frames(args, ""))
    views = torch.from_numpy(np.asarray(frame[None, None], np.float32)).to(dev)
    kw = dict(obj_hw=(RL_VOL, RL_VOL), roi_depths=RL_ROI, full_hw=hw)
    xlfm_deconvolve_sharded(otf, views, n_iter=1, **kw)         # plans
    torch.distributed.barrier()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    vol, _ = xlfm_deconvolve_sharded(otf, views, n_iter=RL_ITERS, **kw)
    end.record()
    end.synchronize()
    out = {"ms_iter": start.elapsed_time(end) / RL_ITERS,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    full = gather_depths(vol).cpu()
    del otf, vol, views
    torch.cuda.empty_cache()
    out_dir = Path(deconvolve.main(argv + ["--mesh_depth_axis",
                                           str(PAR_RANKS)], device=dev))
    if rank == 0:
        np.save(work / "rl_sharded.npy", full[0].numpy())
        cli = torch.from_numpy(read_tiff_stack(
            str(out_dir / "XLFM_stack_000.tif"), dtype=None))
        out["cli_equal"] = bool(torch.equal(cli, full[0]))
        out["cli_rel"] = float((cli - full[0]).abs().max()
                               / full[0].abs().max())
    return out


def par_rank_recon(dev, rank, work: Path, a) -> dict:
    """(b) on this rank: the flagship, bf16, deterministic, batch 8 on the
    mesh (this rank's 4 frames, gathered); one-rank calls at batch 4 on the
    same frames and (rank 0) at batch 8; then the serve CLI."""
    from cwfa_tpu_torch.parallel import make_mesh
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    caches = a["caches"]
    frames = torch.as_tensor(np.random.RandomState(21).rand(
        PAR_BATCH, img, img).astype(np.float32) * 1000).to(dev)
    kw = dict(device=dev, deterministic=True, compute_dtype=torch.bfloat16)
    mesh = make_mesh(PAR_RANKS, 1)
    recon = XLFMReconstructor(model, stats, vidx, caches, mesh=mesh, **kw)
    recon(frames)                                               # warm-up
    torch.distributed.barrier()
    reset_counts()
    ms = event_ms(lambda: recon(frames), n=1)
    launches = launch_counts()
    got = recon(frames)
    one = XLFMReconstructor(model, stats, vidx, caches, **kw)
    b = PAR_BATCH // PAR_RANKS
    mine = one(frames[rank * b:(rank + 1) * b])
    torch.distributed.barrier()
    local_ms = event_ms(lambda: recon.reconstruct_local(
        frames[rank * b:(rank + 1) * b]), n=1)
    out = {"ms": ms[0], "local_ms": local_ms[0], "launches": launches,
           "finite": bool(torch.isfinite(got).all()),
           "shape": tuple(got.shape),
           "equal_local": bool(torch.equal(got[rank * b:(rank + 1) * b],
                                           mine))}
    if rank == 0:
        whole = one(frames)
        out["rel8"] = float((got - whole).abs().max() / whole.abs().max())
    del recon, one, got, mine, frames
    torch.cuda.empty_cache()
    serve.main(a["serve_argv"] + ["--mesh_data_axis", str(PAR_RANKS)],
               device=dev)
    return out


def par_timed_exchanges():
    """Wrap the space axis's exchanges where the model calls them (the
    UNet's halos, the flow steps' row permutations, the reconstructor's
    gather of rows) to time each on the host, the card synchronized on
    both sides.  Returns (times {name: [ms]}, undo)."""
    from cwfa_tpu_torch.engine import inference
    from cwfa_tpu_torch.models import cwf, unet
    times = {"halo": [], "permute": [], "gather": []}
    saved = [(unet, "halo_rows"), (cwf, "permute_rows"),
             (inference, "gather_image_rows")]
    originals = [getattr(m, n) for m, n in saved]

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for (m, n), fn, name in zip(saved, originals, times):
        setattr(m, n, timed(name, fn))

    def undo():
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)
    return times, undo


def par_rank_space(dev, rank, work: Path, a) -> dict:
    """(f) on this rank: the flagship at batch 1 on a (1, 2) mesh, image
    rows over ``space`` (256 a rank), deterministic, in bf16 and f32: the
    gathered volume against one process's, the launches and ms of a call
    (CUDA events), then one call with its exchanges timed; then ``cli.serve
    --mesh_space_axis 2`` with the int8 UNet on 2 frames."""
    from cwfa_tpu_torch.parallel import make_mesh
    _, model, stats, vidx, _ = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    frame = torch.as_tensor(a["space_frame"]).to(dev)
    mesh = make_mesh(1, PAR_RANKS)
    out = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        recon = XLFMReconstructor(model, stats, vidx, a["caches"], device=dev,
                                  deterministic=True, compute_dtype=dtype,
                                  mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        recon(frame)                                            # warm-up
        torch.distributed.barrier()
        ms = event_ms(lambda: recon(frame), n=3)
        reset_counts()
        got = recon(frame)[0].cpu()
        launches = launch_counts()
        ref = torch.from_numpy(np.load(work / f"space_ref_{tag}.npy"))
        res = {"ms": ms, "launches": launches,
               "rows": recon.shards(1)[1].bounds(rank),
               "finite": bool(torch.isfinite(got).all()),
               "shape": tuple(got.shape),
               "rel": float((got - ref).abs().max() / ref.abs().max()),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if tag == "bf16":
            torch.distributed.barrier()
            times, undo = par_timed_exchanges()
            try:
                res["timed_ms"] = event_ms(lambda: recon(frame), n=1)[0]
            finally:
                undo()
            res["exchanges"] = {k: (len(v), sum(v)) for k, v in times.items()}
        out[tag] = res
        del recon, got
        torch.cuda.empty_cache()
    del model
    reset_counts()
    served = serve.main(a["space_serve_argv"] + ["--mesh_space_axis",
                                                 str(PAR_RANKS)], device=dev)
    out["serve"] = {"frames": served["frames"], "batches": served["batches"],
                    "launches": launch_counts()}
    return out


def par_rank_train(dev, rank, work: Path, a) -> dict:
    """(c) on this rank: the flagship trainer on the mesh, bf16, one LRNN
    step and one step-0 flow step on its frame; rank 1's state to disk,
    rank 0 holds both ranks and the one-rank run against each other."""
    from cwfa_tpu_torch.parallel import make_mesh
    cfg, model, stats, vidx, _ = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    tr = CWFATrainer(model, stats, vidx, device=dev,
                     mesh=make_mesh(PAR_RANKS, 1))
    views, gt, mcs = par_train_inputs(dev, cfg, PAR_TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    grads = {}
    out = par_two_steps(tr, views, gt, mcs, grads)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    state = par_state(tr.model)
    out["warm_ms"] = par_two_steps(tr, views, gt, mcs)["ms"]
    if rank == 1:
        torch.save(state, work / "train_rank1.pt")
    torch.distributed.barrier()
    if rank == 0:
        other = torch.load(work / "train_rank1.pt")
        ref = torch.load(work / "train_ref.pt")
        ref_grads = torch.load(work / "train_ref_grads.pt")
        out["ranks_equal"] = all(torch.equal(state[k], other[k])
                                 for k in state)
        params = dict(tr.model.named_parameters())
        out["max_param_d"] = max(
            float((state[k] - ref[k]).abs().max()) for k in params)
        out["grad_rel"] = {
            tag: float((grads[tag] - g).abs().max() / g.abs().max())
            for tag, g in ref_grads.items()}
    return out


def par_timed_train_traffic():
    """Time (host clock, the card synchronized on both sides) every
    point-to-point exchange of the space axis (``halo._p2p``: the UNet's
    halos, the flow's row permutations and the non-CAT towers' halos, in
    the forward and, sending each row's gradient back, in the backward),
    the forward calls of ``halo_rows`` and ``permute_rows`` among them, the
    model's row-global sums (``mesh._all_reduce``: BatchNorm statistics,
    the losses' extremes) and the trainer's one gradient all-reduce a step
    (``_sum_over_ranks``).  Returns (times {name: [ms]}, undo)."""
    from cwfa_tpu_torch.models import cwf, unet
    from cwfa_tpu_torch.parallel import halo, mesh
    times = {"p2p": [], "halo_fwd": [], "permute_fwd": [], "sums": [],
             "grad_all_reduce": []}
    saved = [(halo, "_p2p", "p2p"), (unet, "halo_rows", "halo_fwd"),
             (cwf, "permute_rows", "permute_fwd"),
             (mesh, "_all_reduce", "sums"),
             (CWFATrainer, "_sum_over_ranks", "grad_all_reduce")]
    originals = [getattr(m, n) for m, n, _ in saved]

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for (m, n, name), fn in zip(saved, originals):
        setattr(m, n, timed(name, fn))

    def undo():
        for (m, n, _), fn in zip(saved, originals):
            setattr(m, n, fn)
    return times, undo


def par_rank_space_train(dev, rank, work: Path, a) -> dict:
    """(g) on this rank: the flagship trainer on a (1, 2) space mesh, bf16,
    one LRNN step and one step-0 flow step on 1 frame, this rank's 256
    image rows (cold, warm, then once with its traffic timed); rank 1's
    state to disk, rank 0 holds both ranks and the one-process run against
    each other; then ``cli.train --mesh_space_axis 2`` at the flagship
    width and its checkpoint reloaded on both ranks."""
    from cwfa_tpu_torch.cli import train as train_cli
    from cwfa_tpu_torch.parallel import make_mesh
    cfg, model, stats, vidx, _ = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    mesh = make_mesh(1, PAR_RANKS)
    tr = CWFATrainer(model, stats, vidx, device=dev, mesh=mesh)
    views, gt, mcs = par_train_inputs(dev, cfg, 1)
    torch.cuda.reset_peak_memory_stats()
    grads = {}
    out = par_two_steps(tr, views, gt, mcs, grads)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["rows"] = tr.step_shards(1)[1].bounds(rank)
    state = par_state(tr.model)
    out["warm_ms"] = par_two_steps(tr, views, gt, mcs)["ms"]
    torch.distributed.barrier()
    times, undo = par_timed_train_traffic()
    try:
        out["timed_ms"] = par_two_steps(tr, views, gt, mcs)["ms"]
    finally:
        undo()
    out["traffic"] = {k: (len(v), sum(v)) for k, v in times.items()}
    if rank == 1:
        torch.save(state, work / "space_train_rank1.pt")
    torch.distributed.barrier()
    if rank == 0:
        other = torch.load(work / "space_train_rank1.pt")
        ref = torch.load(work / "space_train_ref.pt")
        ref_grads = torch.load(work / "space_train_ref_grads.pt")
        out["ranks_equal"] = all(torch.equal(state[k], other[k])
                                 for k in state)
        params = dict(tr.model.named_parameters())
        out["max_param_d"] = max(
            float((state[k] - ref[k]).abs().max()) for k in params)
        out["grad_rel"] = {
            tag: float((grads[tag] - g).abs().max() / g.abs().max())
            for tag, g in ref_grads.items()}
    del tr, model, views, gt, mcs, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = train_cli.main(a["space_cli_argv"] + ["--mesh_space_axis",
                                                    str(PAR_RANKS)],
                             device=dev)
    out["cli_s"] = time.perf_counter() - t0
    out["cli_eval"] = {tag: (len(r["psnr"]), bool(np.isfinite(
        np.asarray(r["psnr"])).all()), bool(np.isfinite(
            np.asarray(r["nll"])).all())) for tag, r in results.items()}
    torch.distributed.barrier()
    runs = Path(a["space_cli_out"])
    out["cli_dirs"] = sorted(p.name for p in runs.iterdir())
    (run_dir,) = [p for p in runs.iterdir() if p.is_dir()]
    _, model, stats, vidx, _ = flagship(
        False, "cpu", torch.Generator().manual_seed(1))
    tr = CWFATrainer(model, stats, vidx, device=dev, mesh=mesh)
    out["cli_loaded"] = tr.load_checkpoints(str(run_dir))
    out["cli_reload_digest"] = {
        k: float(v.double().sum()) for k, v in tr.model.state_dict().items()}
    del tr, model
    return out


def parallel_rank(work: Path) -> int:
    """A rank of the parallel phase (``chip_smoke.py --parallel-rank``):
    joins the gloo group, runs (a)-(c) on cuda:0, pickles its results."""
    import pickle
    rank = int(os.environ["CWFA_PROCESS_ID"])
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['CWFA_COORDINATOR']}",
        world_size=PAR_RANKS, rank=rank)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with open(work / "args.pkl", "rb") as f:
        a = pickle.load(f)
    res = {}
    for name, fn in (("rl", par_rank_rl), ("recon", par_rank_recon),
                     ("space", par_rank_space), ("train", par_rank_train),
                     ("space_train", par_rank_space_train)):
        t0 = time.perf_counter()
        res[name] = fn(dev, rank, work, a)
        res[name]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    with open(work / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def nccl_rank(work: Path) -> int:
    """(d): ``initialize_from_env`` on NCCL at world size 1 (``chip_smoke.py
    --nccl-rank``, CWFA_COORDINATOR / CWFA_NUM_PROCESSES=1 /
    CWFA_PROCESS_ID=0): an all_reduce and a gather on the card."""
    from cwfa_tpu_torch.parallel import (gather_rows, initialize_from_env,
                                         is_primary, make_mesh)
    out = {"init": initialize_from_env("cuda"),
           "backend": torch.distributed.get_backend()}
    t = torch.full((4,), 3.0, device="cuda")
    torch.distributed.all_reduce(t)
    mesh = make_mesh(1, 1)
    out.update(all_reduce=t.tolist(), primary=is_primary(),
               mesh=str(mesh.device_type),
               gather=gather_rows(torch.arange(3.0, device="cuda")).tolist())
    torch.distributed.destroy_process_group()
    (work / "nccl.json").write_text(json.dumps(out))
    return 0


def start_ranks(flag: str, work: Path, n: int) -> list:
    """n processes of this script with ``flag``, joined through
    CWFA_COORDINATOR on a free local port; their output into work/."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = {**os.environ, "CWFA_COORDINATOR": f"localhost:{port}",
               "CWFA_NUM_PROCESSES": str(n), "CWFA_PROCESS_ID": str(r)}
        log_f = open(work / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(work)],
            env=env, stdout=log_f, stderr=subprocess.STDOUT), log_f))
    return procs


def wait_ranks(procs, work: Path, timeout: float, what: str):
    """Wait for every rank; kill them all and fail on a timeout or a rank
    that exits non-zero, with the ranks' output."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    for r, (p, _) in enumerate(procs):
        tail = (work / f"rank{r}.log").read_text()[-6000:]
        if p.returncode != 0:
            fail(f"{what}: rank {r} exited {p.returncode}:\n{tail}")


def phase_parallel(dev, card, kernels):
    """More than one device, on the one card: (a) depth-sharded RL and the
    deconvolution CLI with --mesh_depth_axis 2, (b) the flagship bf16 on a
    2-rank data mesh and the serve CLI with --mesh_data_axis 2, (c) a
    data-parallel LRNN and step-0 flow step, each on two ranks sharing
    cuda:0 over gloo against one process; (d) NCCL at world size 1; (e)
    utils/profiling."""
    import pickle
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="cwfa_parallel_"))
    try:
        a = par_inputs(dev, root)
        with open(root / "args.pkl", "wb") as f:
            pickle.dump(a, f)
        t0 = time.perf_counter()
        procs = start_ranks("--parallel-rank", root, PAR_RANKS)
        wait_ranks(procs, root, PAR_TIMEOUT, "parallel ranks")
        t_ranks = time.perf_counter() - t0
        ranks = []
        for r in range(PAR_RANKS):
            with open(root / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        par_check_rl(root, a, ranks, card)
        par_check_recon(dev, a, ranks, kernels, card)
        par_check_space(dev, a, ranks, kernels, card)
        par_check_train(a, ranks, kernels, card)
        par_check_space_train(a, ranks, kernels, card)
        log(f"parallel: the two ranks took {t_ranks:.1f} s (start-up, "
            f"model builds and (a)-(c), (f), (g) at "
            f"{[round(r[k]['s'], 1) for r in ranks for k in ('rl', 'recon', 'train', 'space', 'space_train')]}"
            f" s); on {card}")
        check_window_backward(dev, kernels, card)
        procs = start_ranks("--nccl-rank", root, 1)
        wait_ranks(procs, root, 120, "NCCL rank")
        nccl = json.loads((root / "nccl.json").read_text())
        if not (nccl["init"] and nccl["backend"] == "nccl"
                and nccl["all_reduce"] == [3.0] * 4 and nccl["primary"]
                and nccl["gather"] == [0.0, 1.0, 2.0]
                and nccl["mesh"] == "cuda"):
            fail(f"parallel (d) NCCL at world size 1: {nccl}")
        log(f"parallel (d): initialize_from_env('cuda') through "
            f"CWFA_COORDINATOR / CWFA_NUM_PROCESSES=1 made an NCCL group; "
            f"all_reduce on the card, gather_rows, is_primary and a (1, 1) "
            f"cuda mesh held: {nccl}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    par_profiling(dev, card)
    log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s")


def par_inputs(dev, root: Path) -> dict:
    """The phase's inputs and the one-process references: the deconvolution
    inputs and a direct one-process RL on frame 0; a checkpoint directory of
    the flagship, a lenslet file and PAR_BATCH frames for the serve CLI;
    the one-process training run's losses and state."""
    t0 = time.perf_counter()
    psf_file, fish, _ = write_deconv_inputs(root, dev, 2160)
    rl_argv = ["--data_folder", str(fish), "--psf_file", str(psf_file),
               "--images_to_use", "0", "--n_it", str(RL_ITERS),
               "--posfix", "_parallel"]
    args = deconvolve.build_parser().parse_args(rl_argv)
    otf, _, hw = load_psf_otf(str(psf_file), (RL_VOL, RL_VOL, RL_DEPTHS),
                              device=dev)
    _, frame = next(deconvolve._frames(args, ""))
    views = torch.from_numpy(np.asarray(frame[None, None], np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ref, _ = xlfm_deconvolve(otf, views, n_iter=RL_ITERS,
                             obj_hw=(RL_VOL, RL_VOL), roi_depths=RL_ROI,
                             full_hw=hw)
    rl_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    np.save(root / "rl_ref.npy", ref[0].cpu().numpy())
    del otf, views, ref
    torch.cuda.empty_cache()

    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    ckpt, _ = write_checkpoint_dir(root, dev, model, stats)
    coords = lenslet_coords(cfg.n_lenslets, side, img)
    lenslets = root / "lenslets.txt"
    lenslets.write_text("".join(f"{x - 50}\t{y - 50}\n" for x, y in coords))
    frames_dir = root / "frames"
    frames_dir.mkdir()
    frng = np.random.RandomState(13)
    for i in range(PAR_BATCH):
        write_tiff_stack(str(frames_dir / f"cam_{i:02d}.tif"),
                         frng.randint(0, 400, (img, img)).astype(np.uint16))
    serve_argv = ["--pretrain_models_path", str(ckpt), "--lenslet_file",
                  str(lenslets), "--in_dir", str(frames_dir), "--out_dir",
                  str(root / "served"), "--batch", str(PAR_BATCH),
                  "--no_int8"]
    # (f): the int8 UNet (the CLI's default) on the first 2 frames
    space_serve_argv = ["--pretrain_models_path", str(ckpt),
                        "--lenslet_file", str(lenslets), "--in_dir",
                        str(frames_dir), "--out_dir",
                        str(root / "served_space"), "--batch", "2",
                        "--limit", "2"]
    space_frame = (np.random.RandomState(22).rand(1, img, img)
                   .astype(np.float32) * 1000)
    space_one_ms = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        one = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                                deterministic=True, compute_dtype=dtype)
        frame = torch.as_tensor(space_frame).to(dev)
        one(frame)
        space_one_ms[tag] = event_ms(lambda: one(frame), n=3)
        np.save(root / f"space_ref_{tag}.npy", one(frame)[0].cpu().numpy())
        del one, frame
        torch.cuda.empty_cache()

    tr = CWFATrainer(model, stats, vidx, device=dev)
    views, gt, mcs = par_train_inputs(dev, cfg, PAR_TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    ref_grads = {}
    one = par_two_steps(tr, views, gt, mcs, ref_grads)
    one["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(par_state(tr.model), root / "train_ref.pt")
    torch.save(ref_grads, root / "train_ref_grads.pt")
    one["warm_ms"] = par_two_steps(tr, views, gt, mcs)["ms"]
    lr = max(cfg.learning_rate, cfg.learning_rate_cond,
             cfg.learning_rate_first_step)
    del tr, model, views, gt, mcs
    torch.cuda.empty_cache()

    # (g): one process on the frame the space ranks split by rows, a fresh
    # flagship from the same seed
    _, model, stats, vidx, _ = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    tr = CWFATrainer(model, stats, vidx, device=dev)
    views, gt, mcs = par_train_inputs(dev, cfg, 1)
    torch.cuda.reset_peak_memory_stats()
    space_ref_grads = {}
    space_one = par_two_steps(tr, views, gt, mcs, space_ref_grads)
    space_one["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(par_state(tr.model), root / "space_train_ref.pt")
    torch.save(space_ref_grads, root / "space_train_ref_grads.pt")
    space_one["warm_ms"] = par_two_steps(tr, views, gt, mcs)["ms"]
    del tr, model, views, gt, mcs
    torch.cuda.empty_cache()
    lenslets_cli = write_cli_tree(root / "space_cli_data", cfg, img,
                                  frames=PAR_CLI_FRAMES)
    space_cli_out = root / "space_cli_runs"
    space_cli_argv = [
        "--main_data_path", str(root / "space_cli_data"), "--lenslet_file",
        str(lenslets_cli), "--output_testing_path", str(space_cli_out) + "/",
        "--cross_validation_nFold", "0", "--max_samples",
        str(PAR_CLI_FRAMES), "--epochs", "2", "--eval_every", "2",
        "--save_tiff_volumes", "0", "--img_size", str(img)]
    log(f"parallel inputs and one-process references in "
        f"{time.perf_counter() - t0:.1f} s (RL peak {rl_peak:.2f} GiB)")
    return {"psf_file": str(psf_file), "rl_argv": rl_argv, "caches": caches,
            "serve_argv": serve_argv, "frames_dir": str(frames_dir),
            "served": str(root / "served"), "train_one": one, "lr": lr,
            "rl_peak": rl_peak, "space_serve_argv": space_serve_argv,
            "space_frame": space_frame, "space_one_ms": space_one_ms,
            "space_train_one": space_one, "space_cli_argv": space_cli_argv,
            "space_cli_out": str(space_cli_out)}


def par_check_rl(root: Path, a, ranks, card):
    ref = np.load(root / "rl_ref.npy")
    got = np.load(root / "rl_sharded.npy")
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    rl = [r["rl"] for r in ranks]
    if not (np.isfinite(got).all() and rel <= 1e-4):
        fail(f"parallel (a): sharded RL vs one process {rel:.3e} > 1e-4")
    if not (rl[0]["cli_equal"] or rl[0]["cli_rel"] <= 1e-6):
        fail(f"parallel (a): the CLI's volume differs from the direct "
             f"sharded call by {rl[0]['cli_rel']:.3e} of max")
    log(f"parallel (a) depth-sharded RL ({RL_DEPTHS} depths x {RL_VOL}^2, "
        f"{RL_ITERS} iterations, one frame of 2160^2; {RL_DEPTHS // 2} "
        f"depths a rank, one all-reduce of the (1, 1, F0, F1r) spectrum an "
        f"iteration over gloo, both ranks on cuda:0): vs one process "
        f"max|d|/max|ref| {rel:.3e} (bound 1e-4); ms an iteration by rank "
        f"{[round(r['ms_iter'], 2) for r in rl]} (the ranks share one card "
        f"and gloo stages the sum through the host: not a speed figure); "
        f"peak by rank {[round(r['peak_gib'], 2) for r in rl]} GiB (one "
        f"process {a['rl_peak']:.2f}); cli.deconvolve --mesh_depth_axis 2 "
        f"wrote a volume {'equal to the bit' if rl[0]['cli_equal'] else 'within %.1e of max' % rl[0]['cli_rel']}"
        f" to the direct sharded call's; on {card}")


def par_check_recon(dev, a, ranks, kernels, card):
    rc = [r["recon"] for r in ranks]
    for r, x in enumerate(rc):
        if x["shape"] != (PAR_BATCH, 96, 512, 512) or not x["finite"]:
            fail(f"parallel (b) rank {r}: {x['shape']} finite {x['finite']}")
        if not x["equal_local"]:
            fail(f"parallel (b) rank {r}: its 4 volumes differ from a "
                 "one-process call at batch 4")
        for name in KERNELS:
            if x["launches"][name] != BF16_PER_CALL.get(name, 0):
                fail(f"parallel (b) rank {r}: {name} launched "
                     f"{x['launches'][name]} times in the mesh call, "
                     f"expected {BF16_PER_CALL.get(name, 0)}")
    if not rc[0]["rel8"] <= 5e-2:
        fail(f"parallel (b): gathered batch vs one process at batch 8 "
             f"{rc[0]['rel8']:.3e} > 5e-2")
    for name in BF16_PER_CALL:
        kernels[name].setdefault("parallel_launches", {})["recon"] = [
            x["launches"][name] for x in rc]
    # the served volumes: each rank's 4 frames against a direct one-process
    # call on them, built by the CLI's own steps
    args = serve.build_parser().parse_args(a["serve_argv"])
    recon, img_shape = serve.build_reconstructor(args, "cuda")
    names = sorted(os.listdir(a["frames_dir"]))
    served = sorted(os.listdir(a["served"]))
    want = [f"XLFM_stack_{os.path.splitext(n)[0]}.tif" for n in names]
    if served != sorted(want):
        fail(f"parallel (b) serve: files {served} != {want}")
    b = PAR_BATCH // PAR_RANKS
    for r in range(PAR_RANKS):
        group = names[r * b:(r + 1) * b]
        frames = torch.stack([torch.from_numpy(read_tiff_stack(
            os.path.join(a["frames_dir"], n))[0]) for n in group]).to(dev)
        out = recon(frames).cpu()
        for i, n in enumerate(group):
            vol = torch.from_numpy(read_tiff_stack(
                os.path.join(a["served"], want[r * b + i]), dtype=None))
            if not torch.equal(vol, out[i]):
                fail(f"parallel (b) serve: {n} differs from the direct "
                     f"call by {(vol - out[i]).abs().max().item():.3e}")
    del recon
    log(f"parallel (b) flagship bf16 deterministic, batch {PAR_BATCH} on a "
        f"2-rank data mesh: gathered {rc[0]['shape']} finite on both ranks; "
        f"each rank's {b} volumes equal to the bit to a one-process call at "
        f"batch {b}; the gathered batch vs one process at batch {PAR_BATCH} "
        f"max|d|/max {rc[0]['rel8']:.3e} (bound 5e-2); launches a rank "
        f"{[{k: x['launches'][k] for k in BF16_PER_CALL} for x in rc]}; ms of "
        f"the mesh call by rank {[round(x['ms'], 1) for x in rc]}, of its "
        f"local reconstruction alone {[round(x['local_ms'], 1) for x in rc]}"
        f" (sharing one card; the rest is the gather through the host); "
        f"cli.serve "
        f"--mesh_data_axis 2 --no_int8 --batch {PAR_BATCH}: {len(served)} "
        f"volumes, each rank its {b}, equal to the bit to direct calls at "
        f"batch {b}; on {card}")


PAR_SPACE_BOUND = {"f32": 1e-4, "bf16": 2e-2}   # of max|one process|
# the space serve runs the same int8 code on the same packs as one process
PAR_SERVE_BOUND = 1e-5
SPACE_ROWS = ("cat_affine", "haar_merge_affine", "fused_float_tower",
              "fused_tower", "cond_pair")        # PERF.md rows 1-5


def par_check_space(dev, a, ranks, kernels, card):
    """(f): each rank's gathered volume against one process's, its launches
    (every rank runs every kernel on its rows: BF16_PER_CALL a call, the
    f32 call too), and the served int8 volumes against direct one-process
    calls built by the CLI's own steps, each rank's serve launches
    SERVE_PER_CALL a call (the warm-up and each batch)."""
    sp = [r["space"] for r in ranks]
    for r, x in enumerate(sp):
        if x["bf16"]["rows"] != (256 * r, 256 * (r + 1)):
            fail(f"parallel (f) rank {r}: rows {x['bf16']['rows']}, not a "
                 f"split of 512")
        for tag, bound in PAR_SPACE_BOUND.items():
            y = x[tag]
            if y["shape"] != (96, 512, 512) or not y["finite"] \
                    or not y["rel"] <= bound:
                fail(f"parallel (f) rank {r} {tag}: {y['shape']} finite "
                     f"{y['finite']}, vs one process {y['rel']:.3e} (bound "
                     f"{bound})")
            for name in KERNELS:
                if y["launches"][name] != BF16_PER_CALL.get(name, 0):
                    fail(f"parallel (f) rank {r} {tag}: {name} launched "
                         f"{y['launches'][name]} times a call, expected "
                         f"{BF16_PER_CALL.get(name, 0)}")
        if x["serve"]["frames"] != 2:
            fail(f"parallel (f) rank {r}: served {x['serve']['frames']} "
                 "frames, not 2")
        calls = 1 + x["serve"]["batches"]                # warm-up + batches
        for name in KERNELS:
            want = SERVE_PER_CALL.get(name, 0) * calls
            if x["serve"]["launches"][name] != want:
                fail(f"parallel (f) rank {r} serve: {name} launched "
                     f"{x['serve']['launches'][name]} times in {calls} "
                     f"calls, expected {want}")
    for name in SPACE_ROWS:
        kernels[name].setdefault("parallel_launches", {})["space"] = [
            x["bf16"]["launches"][name] for x in sp]
    args = serve.build_parser().parse_args(a["space_serve_argv"])
    recon, _ = serve.build_reconstructor(args, "cuda")
    names = sorted(os.listdir(a["frames_dir"]))[:2]
    out_dir = Path(a["space_serve_argv"][
        a["space_serve_argv"].index("--out_dir") + 1])
    served = sorted(os.listdir(out_dir))
    want = [f"XLFM_stack_{os.path.splitext(n)[0]}.tif" for n in names]
    if served != want:
        fail(f"parallel (f) serve: files {served} != {want}")
    frames = torch.stack([torch.from_numpy(read_tiff_stack(
        os.path.join(a["frames_dir"], n))[0]) for n in names]).to(dev)
    direct = recon(frames).cpu()
    serve_rel = max(float((torch.from_numpy(read_tiff_stack(
        str(out_dir / w), dtype=None)) - direct[i]).abs().max()
        / direct[i].abs().max()) for i, w in enumerate(want))
    if not serve_rel <= PAR_SERVE_BOUND:
        fail(f"parallel (f) serve int8: the served volumes vs direct "
             f"one-process calls {serve_rel:.3e} > {PAR_SERVE_BOUND}")
    del recon
    b16 = [x["bf16"] for x in sp]
    log(f"parallel (f) flagship deterministic, batch 1, on a (1, 2) mesh "
        f"(rows 0-255 / 256-511 a rank, both ranks on cuda:0 over gloo): the "
        f"gathered volume vs one process max|d|/max bf16 "
        f"{[round(x['bf16']['rel'], 6) for x in sp]} (bound 2e-2), f32 "
        f"{[x['f32']['rel'] for x in sp]} (bound 1e-4); launches a call a "
        f"rank (rows 1-5) {[{k: y['launches'][k] for k in SPACE_ROWS} for y in b16]};"
        f" ms a call by rank bf16 {[[round(m, 2) for m in y['ms']] for y in b16]}"
        f", f32 {[[round(m, 2) for m in x['f32']['ms']] for x in sp]} (one "
        f"process at batch 1: bf16 "
        f"{[round(m, 2) for m in a['space_one_ms']['bf16']]}, f32 "
        f"{[round(m, 2) for m in a['space_one_ms']['f32']]}); a bf16 call "
        f"with its exchanges timed (host clock, the card synchronized around "
        f"each): {[round(y['timed_ms'], 2) for y in b16]} ms, of it "
        f"(count, ms) {[y['exchanges'] for y in b16]}; peak "
        f"{[round(y['peak_gib'], 2) for y in b16]} GiB; cli.serve "
        f"--mesh_space_axis 2 (int8 UNet, 2 frames): each rank reconstructed "
        f"both in {[1 + x['serve']['batches'] for x in sp]} calls with the "
        f"warm-up (launches by rank: "
        f"{[{k: v for k, v in x['serve']['launches'].items() if v} for x in sp]}"
        f", SERVE_PER_CALL a call), rank 0 read and wrote them, within "
        f"{serve_rel:.3e} of max of direct one-process calls (bound "
        f"{PAR_SERVE_BOUND}); on {card}")


def par_check_train(a, ranks, kernels, card):
    tr = [r["train"] for r in ranks]
    one = a["train_one"]
    rel = [abs(x - y) / max(abs(y), 1e-12)
           for x, y in zip(tr[0]["losses"], one["losses"])]
    if not all(np.isfinite(tr[0]["losses"])) or max(rel) > 1e-3:
        fail(f"parallel (c): losses {tr[0]['losses']} vs one process "
             f"{one['losses']} (rel {rel})")
    if tr[0]["losses"] != tr[1]["losses"] or not tr[0]["ranks_equal"]:
        fail("parallel (c): the two ranks' losses or states differ")
    if tr[0]["max_param_d"] > 6 * a["lr"]:
        fail(f"parallel (c): a parameter moved {tr[0]['max_param_d']:.3e} "
             f"from the one-process run's (bound 6 lr = {6 * a['lr']:.1e})")
    grad_rel = tr[0]["grad_rel"]
    if sorted(grad_rel) != ["cond", "flow", "lrnn"] or not all(
            v <= PAR_GRAD_BOUND for v in grad_rel.values()):
        fail(f"parallel (c): the all-reduced gradients vs one process's, "
             f"max|d|/max {grad_rel} (bound {PAR_GRAD_BOUND})")
    for r, x in enumerate(tr):
        for per, got in zip((LRNN_PER_STEP, FLOW_PER_STEP), x["launches"]):
            for name in KERNELS:
                if got[name] != per.get(name, 0):
                    fail(f"parallel (c) rank {r}: {name} launched "
                         f"{got[name]} times in a step, expected "
                         f"{per.get(name, 0)}")
    for name in FLOW_PER_STEP:
        kernels[name].setdefault("parallel_launches", {})["train"] = [
            x["launches"][1][name] for x in tr]
    log(f"parallel (c) flagship training, bf16, an LRNN step and a step-0 "
        f"flow step, 2 ranks x 1 frame vs 1 process x 2 (every draw on): "
        f"losses {['%.6g' % v for v in tr[0]['losses']]} vs "
        f"{['%.6g' % v for v in one['losses']]} (rel {['%.1e' % v for v in rel]},"
        f" bound 1e-3); parameters within {tr[0]['max_param_d']:.2e} "
        f"(bound 6 lr {6 * a['lr']:.1e}); each optimizer's all-reduced "
        f"gradient vs one process's max|d|/max "
        f"{ {k: '%.2e' % v for k, v in grad_rel.items()} } (bound "
        f"{PAR_GRAD_BOUND}, bf16); the two ranks equal to the bit; "
        f"step ms by rank, the first (cold, with the gradients' copy to the "
        f"host) then a second (warm) "
        f"{[[round(m, 1) for m in x['ms'] + x['warm_ms']] for x in tr]} "
        f"(sharing one card: not a speed figure; one process at batch 2 "
        f"{[round(m, 1) for m in one['ms'] + one['warm_ms']]}); K1/K2/K3 a "
        f"flow step "
        f"{[{k: x['launches'][1][k] for k in ('cat_affine_bwd', 'float_tower_bwd', 'cond_pair_bwd')} for x in tr]};"
        f" peak by rank {[round(x['peak_gib'], 2) for x in tr]} GiB; on "
        f"{card}")


SPACE_TRAIN_ROWS = {"cat_affine": 1, "fused_float_tower": 3, "cond_pair": 5,
                    "cat_affine_bwd": 10, "float_tower_bwd": 11,
                    "cond_pair_bwd": 12}     # PERF.md rows of a flow step


def par_check_space_train(a, ranks, kernels, card):
    """(g): the (1, 2) space mesh's steps against one process (losses 1e-3
    relative, each optimizer's all-reduced gradient within 5e-2 of max,
    parameters within 6 lr, the ranks equal to the bit), each rank's
    launches a step (FLOW_PER_STEP in the flow step, none in the LRNN
    step), and the training CLI's run: both ranks evaluated every tag,
    rank 0 wrote one run directory, and its checkpoints reload the same on
    both ranks."""
    sp = [r["space_train"] for r in ranks]
    one = a["space_train_one"]
    for r, x in enumerate(sp):
        if x["rows"] != (256 * r, 256 * (r + 1)):
            fail(f"parallel (g) rank {r}: rows {x['rows']}, not a split of "
                 "512")
        for per, got in zip((LRNN_PER_STEP, FLOW_PER_STEP), x["launches"]):
            for name in KERNELS:
                if got[name] != per.get(name, 0):
                    fail(f"parallel (g) rank {r}: {name} launched "
                         f"{got[name]} times in a step, expected "
                         f"{per.get(name, 0)}")
    rel = [abs(x - y) / max(abs(y), 1e-12)
           for x, y in zip(sp[0]["losses"], one["losses"])]
    if not all(np.isfinite(sp[0]["losses"])) or max(rel) > 1e-3:
        fail(f"parallel (g): losses {sp[0]['losses']} vs one process "
             f"{one['losses']} (rel {rel})")
    if sp[0]["losses"] != sp[1]["losses"] or not sp[0]["ranks_equal"]:
        fail("parallel (g): the two ranks' losses or states differ")
    if sp[0]["max_param_d"] > 6 * a["lr"]:
        fail(f"parallel (g): a parameter moved {sp[0]['max_param_d']:.3e} "
             f"from the one-process run's (bound 6 lr = {6 * a['lr']:.1e})")
    grad_rel = sp[0]["grad_rel"]
    if sorted(grad_rel) != ["cond", "flow", "lrnn"] or not all(
            v <= PAR_GRAD_BOUND for v in grad_rel.values()):
        fail(f"parallel (g): the all-reduced gradients vs one process's, "
             f"max|d|/max {grad_rel} (bound {PAR_GRAD_BOUND})")
    for name in FLOW_PER_STEP:
        kernels[name].setdefault("parallel_launches", {})["space_train"] = [
            x["launches"][1][name] for x in sp]
    want_eval = {"train": PAR_CLI_FRAMES, "val": PAR_CLI_FRAMES // 2,
                 "test": PAR_CLI_FRAMES}
    for r, x in enumerate(sp):
        if {t: v[0] for t, v in x["cli_eval"].items()} != want_eval or not \
                all(v[1] and v[2] for v in x["cli_eval"].values()):
            fail(f"parallel (g) rank {r}: cli.train's evaluation "
                 f"{x['cli_eval']}, expected finite PSNRs and NLLs of "
                 f"{want_eval} frames")
        if len(x["cli_dirs"]) != 1:
            fail(f"parallel (g) rank {r}: cli.train wrote {x['cli_dirs']}, "
                 "not one run directory")
        if sorted(x["cli_loaded"]) != [1, 2, 3, 4, 5]:
            fail(f"parallel (g) rank {r}: the checkpoint reloaded steps "
                 f"{x['cli_loaded']}")
    if sp[0]["cli_reload_digest"] != sp[1]["cli_reload_digest"]:
        fail("parallel (g): the CLI's checkpoint reloads differently on the "
             "two ranks")
    tr = [x["traffic"] for x in sp]
    log(f"parallel (g) flagship training on a (1, 2) space mesh, bf16, an "
        f"LRNN step and a step-0 flow step on 1 frame, rows 0-255 / 256-511 "
        f"a rank, both ranks on cuda:0 over gloo, vs one process (every "
        f"draw on): losses {['%.6g' % v for v in sp[0]['losses']]} vs "
        f"{['%.6g' % v for v in one['losses']]} (rel "
        f"{['%.1e' % v for v in rel]}, bound 1e-3); parameters within "
        f"{sp[0]['max_param_d']:.2e} (bound 6 lr {6 * a['lr']:.1e}); each "
        f"optimizer's all-reduced gradient vs one process's max|d|/max "
        f"{ {k: '%.2e' % v for k, v in grad_rel.items()} } (bound "
        f"{PAR_GRAD_BOUND}); the two ranks equal to the bit; launches a "
        f"flow step by rank (rows 1/3/5/10/11/12) "
        f"{[{k: x['launches'][1][k] for k in SPACE_TRAIN_ROWS} for x in sp]};"
        f" step ms by rank, cold then warm "
        f"{[[round(m, 1) for m in x['ms'] + x['warm_ms']] for x in sp]} "
        f"(one process {[round(m, 1) for m in one['ms'] + one['warm_ms']]}); "
        f"a pair of steps with its traffic timed (host clock, the card "
        f"synchronized around each) {[[round(m, 1) for m in x['timed_ms']] for x in sp]}"
        f" ms, of it (count, ms): "
        f"{[{k: (n, round(t, 1)) for k, (n, t) in x.items()} for x in tr]} "
        f"(p2p: every halo / row-permutation exchange, forward and "
        f"backward; sums: BatchNorm statistics and loss extremes); peak by "
        f"rank {[round(x['peak_gib'], 2) for x in sp]} GiB (one process "
        f"{one['peak_gib']:.2f}); cli.train --mesh_space_axis 2 (1 fish x "
        f"{PAR_CLI_FRAMES} frames, 2 epochs: the LRNN stage and flow step "
        f"3, then evaluation {want_eval} and the OOD screen) "
        f"{[round(x['cli_s'], 1) for x in sp]} s by rank, rank 0 wrote "
        f"{sp[0]['cli_dirs']}, its checkpoint (steps "
        f"{sp[0]['cli_loaded']}) reloads equal on both ranks; on {card}")


def check_window_backward(dev, kernels, card):
    """K2 and K3 at the shapes (g) gives them on each rank of a (1, 2) mesh
    at flagship step 0 (256 rows a rank): the towers on the views
    condition's window of 256 + 4 rows (Cin 48 -> 96 and -> 48), their dy
    zero outside the rank's rows; the cond net's 3-D pair on the window of
    256 + 8, its dz zero outside the towers' window, with a Dropout3d scale;
    in bf16 against the plain backward, at its bound (2^-5)."""
    from cwfa_tpu_torch.parallel.mesh import RowShard
    gen = torch.Generator().manual_seed(23)
    out = []
    for index in range(PAR_RANKS):
        rs = RowShard(None, index, PAR_RANKS, SLICE_HW)
        lo, hi = rs.window(4)
        clo, chi = rs.window(8)
        for cin, nout in ((SLICE_C, 2 * SLICE_C), (SLICE_C, SLICE_C)):
            tower = WaveletFlowSubnet2d(cin, nout, 64)
            reset_parameters_(tower, gen)
            tower = tower.to(dev)
            x = torch.randn((1, cin, hi - lo, SLICE_HW), generator=gen).to(
                dev, torch.bfloat16)
            dy = torch.zeros((1, nout, hi - lo, SLICE_HW), device=dev,
                             dtype=torch.bfloat16)
            dy[:, :, rs.start - lo:rs.stop - lo] = torch.randn(
                (1, nout, rs.rows, SLICE_HW), generator=gen).to(
                    dev, torch.bfloat16)
            ref = btower.float_tower_backward_reference(tower, x, dy)
            got = one_launch_of(
                btower.float_tower_backward, btower.WGMMA_BF16,
                lambda: btower.float_tower_backward(tower, x, dy),
                f"float_tower_backward window {tuple(x.shape)}")
            flat = lambda g: [g[0]] + [t for pair in zip(g[1], g[2])
                                       for t in pair]
            e = grads_err(flat(got), flat(ref), torch.bfloat16,
                          f"float_tower_backward window {tuple(x.shape)} "
                          f"-> {nout} (rank {index})")
            out.append((f"K2 {tuple(x.shape)}->{nout}", e))
        net = torch.nn.ModuleDict({"c3a": torch.nn.Conv3d(1, 32, 3, padding=1),
                                   "c3b": torch.nn.Conv3d(32, 1, 3, padding=1),
                                   "prelu": torch.nn.PReLU(1)})
        reset_parameters_(net, gen)
        with torch.no_grad():
            net["prelu"].weight.uniform_(0.05, 0.5, generator=gen)
        net = net.to(dev)
        mods = (net["c3a"], net["c3b"], net["prelu"])
        x = torch.randn((1, SLICE_C, chi - clo, SLICE_HW), generator=gen).to(
            dev, torch.bfloat16)
        dz = torch.zeros_like(x)
        dz[:, :, lo - clo:hi - clo] = torch.randn(
            (1, SLICE_C, hi - lo, SLICE_HW), generator=gen).to(
                dev, torch.bfloat16)
        scale = ((torch.rand((1, 32), generator=gen) < 0.5).float()
                 * 2.0).to(dev)
        ref = cpair.cond_pair_backward_reference(x, dz, *mods, scale)
        got = one_launch_of(
            cpair.cond_pair_backward, cpair.TENSOR_CORES,
            lambda: cpair.cond_pair_backward(x, dz, *mods, scale),
            f"cond_pair_backward window {tuple(x.shape)}")
        e = grads_err(got, ref, torch.bfloat16,
                      f"cond_pair_backward window {tuple(x.shape)} (rank "
                      f"{index})")
        out.append((f"K3 {tuple(x.shape)}", e))
        del ref, got
    log(f"parallel (g) K2 and K3 at the space mesh's window shapes (flagship "
        f"step 0, 256 rows a rank; dy / dz zero outside the rows a rank's "
        f"loss reads), bf16, max|d|/max|ref| against the plain backward "
        f"(bound 2^-5): {[(w, '%.3e' % e) for w, e in out]}; on {card}")


def par_profiling(dev, card):
    """(e): ``utils.profiling`` on the card: ``trace`` around one flagship
    call names the hand-written kernels; ``FrameTimer`` against
    ``device_timer``; ``debug_nans`` on a NaN fed to ``cat_affine``."""
    from cwfa_tpu_torch.engine.inference import device_timer
    from cwfa_tpu_torch.utils.profiling import FrameTimer, debug_nans, trace
    cfg, model, stats, vidx, img = flagship(
        False, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    side = cfg.volume_side_size
    caches = [rng.randn(1, cfg.n_depths // 2 ** (k + 1), side, side)
              .astype(np.float32) for k in range(model.n_flow_steps + 1)]
    recon = XLFMReconstructor(model, stats, vidx, caches, device=dev,
                              deterministic=True,
                              compute_dtype=torch.bfloat16)
    frames = torch.as_tensor(rng.rand(1, img, img).astype(np.float32)
                             * 1000).to(dev)
    recon(frames)
    torch.cuda.synchronize()
    tdir = Path(tempfile.mkdtemp(prefix="cwfa_trace_"))
    try:
        with trace(str(tdir)):
            recon(frames)
            torch.cuda.synchronize()
        path = tdir / f"trace_{os.getpid()}.json"
        events = json.loads(path.read_text())["traceEvents"]
        size = path.stat().st_size
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    want = ("cat_affine_kernel", "haar_merge_affine_kernel",
            "tower_bf16_kernel", "cond_pair_tc_kernel")
    found = {w: sum(w in n for n in names) for w in want}
    if not all(found.values()):
        fail(f"parallel (e): the trace's {len(names)} kernel events lack "
             f"{[w for w, n in found.items() if not n]}")
    ft, dt = FrameTimer(dev), []
    for _ in range(5):
        ft.start()
        recon(frames)
        ft.stop()
        stop = device_timer(dev)
        recon(frames)
        dt.append(stop())
    a, b = float(np.median(ft.times)), float(np.median(dt))
    if abs(a - b) > 0.05 * b:
        fail(f"parallel (e): FrameTimer {a * 1e3:.3f} ms vs device_timer "
             f"{b * 1e3:.3f} ms, more than 5% apart")
    x = torch.full((1, 48, 64, 64), float("nan"), device=dev,
                   dtype=torch.bfloat16)
    st = torch.randn((1, 96, 64, 64), device=dev, dtype=torch.bfloat16)
    try:
        with debug_nans():
            fa.cat_affine(x, st, clamp=2.0, activation="ATAN", rev=True)
        fail("parallel (e): debug_nans let cat_affine's NaN pass")
    except FloatingPointError as e:
        if "cat_affine" not in str(e):
            fail(f"parallel (e): debug_nans raised for another op: {e}")
        msg = str(e)
    fa.cat_affine(x, st, clamp=2.0, activation="ATAN", rev=True)
    log(f"parallel (e) utils.profiling: trace() around one flagship call "
        f"wrote a Chrome trace of {size / 1e6:.1f} MB with {len(names)} "
        f"kernel events, the hand-written ones among them {found}; "
        f"FrameTimer {a * 1e3:.3f} ms vs device_timer {b * 1e3:.3f} ms "
        f"(median of 5, within 5%); debug_nans: '{msg}', and no raise "
        f"outside the scope; on {card}")


def main():
    if len(sys.argv) == 3 and sys.argv[1] in ("--parallel-rank",
                                               "--nccl-rank"):
        # a process that the parallel phase starts
        return (parallel_rank if sys.argv[1] == "--parallel-rank"
                else nccl_rank)(Path(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = cuda_build.build_kernels()
    for mod in (fa, qtower, cpair, btower, probes):
        mod._lib()
    btower._bwd_lib()
    cpair._bwd_lib()
    root = cuda_build.BUILD_DIR.parents[1]
    names = ", ".join(str(p.relative_to(root)) for p in libs.values())
    log(f"kernels built from cwfa_tpu_torch/csrc/*.cu with nvcc "
        f"{' '.join(cuda_build.NVCC_FLAGS)} (one nvcc per source, in "
        f"parallel) -> {names} in {time.perf_counter() - t0:.1f} s")

    kernels = {name: {} for name in KERNELS}
    kernel_phases = {"kernels": phase_kernels, "tower": phase_tower,
                     "cond_pair": phase_cond_pair,
                     "float_tower": phase_float_tower}
    if len(sys.argv) > 1:
        # python3 chip_smoke.py tower cond_pair: those kernel phases alone,
        # while a kernel is being worked on; not the check, and no "ok" line
        def serving(dev, kernels):
            _, model, stats, _, img = flagship(
                False, "cpu", torch.Generator().manual_seed(0))
            phase_serving(dev, card, kernels, model, stats, img)

        alone = {**kernel_phases, "serving": serving,
                 "train": lambda dev, kernels: phase_train(dev, card, kernels,
                                                           2160),
                 "train_kernels": phase_train_kernels,
                 "f32_step": lambda dev, kernels: phase_f32_step(dev, card,
                                                                 kernels),
                 "train_cli": lambda dev, kernels: (
                     phase_nonfast(dev, card, kernels),
                     phase_train_cli(dev, card, kernels, 2160)),
                 "ood_cli": lambda dev, kernels: phase_ood_cli(
                     dev, card, kernels, 2160),
                 "deconv": lambda dev, kernels: phase_deconv(dev, card),
                 "torch_ckpt": lambda dev, kernels: phase_torch_ckpt(
                     dev, card, kernels),
                 "xlfmnet": lambda dev, kernels: phase_xlfmnet(dev, card,
                                                               2160),
                 "blocks": lambda dev, kernels: phase_blocks(dev, card,
                                                             kernels, 2160),
                 "probes": lambda dev, kernels: phase_probes(dev, card, kernels),
                 "parallel": lambda dev, kernels: phase_parallel(dev, card,
                                                                 kernels),
                 "int8_cond": lambda dev, kernels: int8_cond_alone(dev, card)}
        for name in sys.argv[1:]:
            alone[name](dev, kernels)
        log(f"partial run ({', '.join(sys.argv[1:])}): no verdict")
        return 1
    for phase in kernel_phases.values():
        phase(dev, kernels)
    phase_small_rig(dev)
    small_rig_int8(dev)
    model, stats, vidx, caches, frames1, recon16 = phase_flagship(
        dev, card, kernels)
    out32 = phase_bf16_vs_f32(dev, model, stats, vidx, caches, frames1,
                              recon16)
    del recon16
    phase_flagship_stochastic(dev, card, model, stats, vidx, caches, frames1)
    out8 = phase_flagship_int8(dev, card, kernels, model, stats, vidx, caches,
                               frames1)
    rel = rel_norm(out8, out32)
    log(f"flagship batch 1, int8 (bf16) vs f32: ||d||/||f32 - mean|| "
        f"{rel:.3e} (bound 5e-2)")
    if not rel < 5e-2:
        fail(f"flagship int8 vs f32 {rel:.3e} >= 5e-2")
    del out8
    torch.cuda.empty_cache()
    phase_int8_cond(dev, card, model, stats, vidx, caches, frames1, out32)

    del out32
    torch.cuda.empty_cache()
    phase_probes(dev, card, kernels)
    torch.cuda.empty_cache()
    phase_likelihood_small(dev)
    phase_likelihood_flagship(dev, card, kernels, model, stats)
    torch.cuda.empty_cache()
    phase_serving(dev, card, kernels, model, stats, frames1.shape[-1])
    del model
    torch.cuda.empty_cache()
    phase_train(dev, card, kernels, frames1.shape[-1])
    torch.cuda.empty_cache()
    phase_nonfast(dev, card, kernels)
    phase_train_cli(dev, card, kernels, frames1.shape[-1])
    torch.cuda.empty_cache()
    phase_ood_cli(dev, card, kernels, frames1.shape[-1])
    phase_deconv(dev, card)
    torch.cuda.empty_cache()
    phase_torch_ckpt(dev, card, kernels)
    phase_xlfmnet(dev, card, frames1.shape[-1])
    torch.cuda.empty_cache()
    phase_blocks(dev, card, kernels, frames1.shape[-1])
    torch.cuda.empty_cache()
    phase_parallel(dev, card, kernels)

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name]["source"],
         "replaces": KERNELS[name]["replaces"],
         "launches": k["launches"], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k.get("library_ms"),
         # the float tower's f32 instance (3xTF32): the likelihood path's
         # (and the f32 backward's time, K2);
         # the instance that fused_tower (__dp4a), cond_pair and the two
         # backward kernels K2, K3 (CUDA cores), chained_gemm and the out8
         # GEMM (mma.sync) ran before their tensor-core ones, timed in this
         # run; the probe script's own reading of the two s8 instances; the
         # launches of the serving path's two runs and of the flagship's
         # training, K2's and K3's by instance; K2 at every step's shape;
         # the launches of the training CLI's evaluation, of the OOD CLI
         # and of the reconstruction from the reference's checkpoints
         **{key: v for key, v in k.items()
            if key.startswith("f32_") or key in (
                "dp4a_ms", "cuda_cores_ms", "mma_sync_ms", "script_ms",
                "serve_launches", "train_launches", "launches_by_instance",
                "step_ms", "eval_launches", "ood_launches",
                "ckpt_launches", "blocks_launches", "blocks_step0_ms",
                "parallel_launches")}}
        for name, k in kernels.items()]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
