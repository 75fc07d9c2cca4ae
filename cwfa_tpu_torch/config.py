"""Typed configuration mirroring the reference CLI flag surface.

A verbatim copy of ``cwfa_tpu/config.py`` (which imports no JAX), so that
``cwfa_tpu_torch`` runs where JAX is not installed.  Keep the two in step.

Reference: main.py:21-111 (training CLI, ~70 argparse flags) and
main_deconvolve_dataset.py:21-36 (deconvolution CLI).  Defaults reproduce the
reference defaults, including the integer-encoded learning rates used for
Slurm/Guild sweeps (main.py:236-243: values >= 1 are divided by 1e7).

Checkpoints persist the per-step config copies exactly like the reference
stores ``args`` inside every ``model_step_*`` file (networks.py:708-730).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


def _decode_lr(v: float) -> float:
    return v / 1e7 if v >= 1 else v


@dataclass
class CWFAConfig:
    # --- data (main.py:24-34) ---
    main_data_path: str = "XLFM_data/Datasets/"
    # data_folder*/dataset_ids*: dead as USER flags in the reference too —
    # main.py:162-163,171-172 unconditionally clobbers all four from the CV
    # group before any read, so only cross_validation_nFold selects data.
    # Accepted for config/checkpoint parity (they ride in saved configs).
    data_folder: list = field(default_factory=list)
    data_folder_test: list = field(default_factory=list)
    dataset_ids: list = field(default_factory=list)
    dataset_ids_test: list = field(default_factory=list)
    cross_validation_nFold: int = 1
    use_sparse_for_all: int = 1
    lenslet_file: str = "XLFM_data/lenslet_centers_python.txt"
    images_to_use: Any = 10
    images_to_use_test: Any = (0, 250)
    images_to_use_fine_tune_val: Any = 5

    # --- optimization (main.py:36-46) ---
    seed: int = 364898
    use_half_precision: int = 1        # -> bf16 compute on TPU (doc'd divergence)
    batch_size: int = 1
    epochs: int = 100
    learning_rate: float = 221         # integer-encoded; decoded via decode_lrs()
    learning_rate_first_step: float = 80
    loss_func_first_step: str = "L2"   # L1 | L2 | wL2 | LL
    loss_func_reg: str = "L2"
    learning_rate_cond: float = 845
    learning_weight_decay: float = 1e-2
    add_noise: int = 1

    # --- logging (main.py:48-57) ---
    eval_every: int = 25
    save_every: int = 25
    save_model: int = 1                # 0 = no checkpoint writes (declared
                                       # but never read by the reference;
                                       # honored as evident intent)
    save_tiff_volumes: int = 1
    save_images: int = 0
    files_to_store: str = "*.py"
    load_pretrained_networks: int = 0
    output_testing_path: str = "output/cwfa_tpu/"

    # --- volume loading (main.py:60-66) ---
    volume_norm_func: Any = None
    volume_ths: tuple = (0.0, 20000)
    images_ths: tuple = (0.01, 1)
    quantile_ths: tuple = (0, 0.99999)
    n_depths: int = 96
    volume_side_size: int = 512
    n_lenslets: int = 29               # fixed 29 in the reference (hard-coded
                                       # at CWFA.py:495,502); configurable here
                                       # so synthetic/test rigs can shrink it

    # --- evaluation (main.py:69-75) ---
    evaluation_dataset: str = "train"
    neural_activation_filter_width: float = 10
    evaluation_prefix: str = ""
    main_gpu: int = -2                 # kept for config parity; unused on TPU
    n_threads: int = 8                 # reference: torch.set_num_threads
                                       # (main.py:260); N/A here — host math
                                       # threads are XLA-managed, native IO
                                       # threads are per-stream

    # --- OOD (main.py:78-83) ---
    step_LL_to_use: int = 0
    step_LL_ths_to_use: float = -1.33
    create_dist_plots: int = 0

    # --- pretrained / finetune (main.py:86-96) ---
    pretrain_models_path: str = ""
    fine_tune_optimize_steps: tuple = (1, 2, 3, 4, 5)
    fine_tune_load_checkpoints: tuple = ()
    max_test_load_epoch: int = 25000
    fine_tune_use_model_args: int = 0
    force_all_steps_NF: int = 0
    force_last_step_NF: int = 0
    disable_low_res_input: int = 0
    train_with_gt_low_res: int = 0

    # --- INN architecture (main.py:98-110) ---
    INN_net_type: int = 1              # 0 plain INN / 1 CWF / 2 XLFMNet
    INN_down_steps: int = 5            # internal per-step bookkeeping: the
                                       # reference overwrites it per built
                                       # step (CWFA.py:486) before any read,
                                       # so the user value is dead there too;
                                       # INN_max_down_steps is the live knob
    INN_max_down_steps: int = 5
    INN_use_perm: int = 1
    INN_use_bias: int = 1
    INN_n_blocks: int = 4
    INN_internal_chans: int = 64
    INN_cond_chans: int = 32
    INN_cond_weight: float = 0.40984
    INN_block_type: str = "CAT"        # RNVP | GLOW | GIN | AI1 | CAT
    INN_z_temperature: float = 0.0
    INN_n_samples: int = 1

    # --- runtime extras (no reference counterpart; TPU-specific) ---
    fine_tune: int = 1                 # derived: len(fine_tune_optimize_steps)>0
    mesh_data_axis: int = 1            # data-parallel chips (serve + train CLI mesh)
    mesh_space_axis: int = 1           # spatial (H) sharding chips (ditto)

    def decode_lrs(self) -> "CWFAConfig":
        """Integer-flag learning-rate decoding (main.py:238-243)."""
        return dataclasses.replace(
            self,
            learning_rate=_decode_lr(self.learning_rate),
            learning_rate_first_step=_decode_lr(self.learning_rate_first_step),
            learning_rate_cond=_decode_lr(self.learning_rate_cond),
            fine_tune=int(len(self.fine_tune_optimize_steps) > 0),
        )

    def step_config(self, step_ix: int) -> "CWFAConfig":
        """Per-step copy with INN_down_steps = ix+1 (CWFA.py:485-486)."""
        return dataclasses.replace(self, INN_down_steps=step_ix + 1)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CWFAConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class DeconvConfig:
    """Deconvolution CLI flags (main_deconvolve_dataset.py:21-36)."""
    data_folder: str = ""
    psf_file: str = ""
    bkg_file: str = ""
    lenslet_file: str = ""
    images_to_use: tuple = (0, 1)
    n_it: int = 50
    posfix: str = ""
    n_depths: int = 120                # 241//2
    vol_xy_size: int = 600
    n_split_fourier: int = 1
    dark_current: int = 0
