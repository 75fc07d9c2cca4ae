"""Conditional Wavelet Flow steps, inverse direction, for inference
(counterpart of ``cwfa_tpu/models/cwf.py``).

Per-step graph (reference networks.py:305-366), for step k on a volume with
D = n_depths/2^k depth-channels:

  fwd:  v --Haar1D--> [avg | diff];  diff --CAT_first(c_mean, c_views)--> x0
        for nn = 1..n_blocks:  x --Permute(nn)--> --CAT(c_views)--> x
        [--PermuteRandom--]  (if INN_use_perm);  outputs (z, avg)

  rev   inverts the chain; ``avg`` is the upsampled volume from the coarser
        step, z is zeros at temperature 0 (CWFA.py:47-64).

Only the CAT block type and the inverse direction are ported; the coupling
towers run one by one (the TPU's 128-wide tower pairing is not carried over).
With a ``qpack`` (``quantize_cat_step``) the coupling towers run in int8
through the CUDA tower kernel (``ops/qtower.fused_tower``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from cwfa_tpu_torch.flow.permute import (
    ReferencePermReplayer, apply_channel_perm, apply_spatial_perm)
from cwfa_tpu_torch.flow.subnets import (
    SQRT2_INV, WaveletFlowSubnet2d, WaveletFlowSubnet2dFirst)
from cwfa_tpu_torch.ops import qtower
from cwfa_tpu_torch.ops.flow_affine import cat_affine, haar_merge_affine


@dataclass(frozen=True)
class CWFStepSpec:
    """Static description of one CWF pyramid step (flow on the differences)."""
    step: int                       # k = 0..n_steps-2
    d_in: int                       # depth-channels of the input volume
    spatial: int                    # H = W
    n_blocks: int = 4
    block_type: str = "CAT"
    internal_ch: int = 64
    use_bias: bool = True
    clamp: float = 2.0
    clamp_activation: str = "ATAN"
    use_final_perm: bool = True
    disable_low_res_input: bool = False
    # ('channel', perm, inv) / ('spatial', axis, perm, inv) numpy entries
    # from ReferencePermReplayer
    perms: tuple = field(default_factory=tuple, compare=False)

    @property
    def c_flow(self) -> int:        # differences channel count
        return self.d_in // 2


def build_step_specs(n_depths: int, spatial: int, n_flow_steps: int,
                     n_blocks: int, block_type: str, internal_ch: int,
                     use_bias: bool, use_final_perm: bool,
                     disable_low_res_input: bool, global_seed: int,
                     clamp: float = 2.0, clamp_activation: str = "ATAN"):
    """Build specs for flow steps k = 0..n_flow_steps-1 with reference-parity
    permutations (the replayer walks the numpy RNG exactly like run_CWFA's
    sequence of conditional_wavelet_flow calls, CWFA.py:478-510)."""
    replayer = ReferencePermReplayer(global_seed)
    specs = []
    for k in range(n_flow_steps):
        perms = replayer.build_factory_call(
            n_down_steps=k + 1, n_depths=n_depths, spatial_size=spatial,
            n_blocks=n_blocks, use_final_perm=use_final_perm)
        specs.append(CWFStepSpec(
            step=k, d_in=n_depths // (2 ** k), spatial=spatial,
            n_blocks=n_blocks, block_type=block_type, internal_ch=internal_ch,
            use_bias=use_bias, use_final_perm=use_final_perm,
            disable_low_res_input=disable_low_res_input,
            perms=tuple(perms), clamp=clamp, clamp_activation=clamp_activation))
    return specs


class CWFStep(nn.Module):
    """One CAT step: the input block (``_first`` subnet) and ``n_blocks``
    coupling blocks, each holding its tower as ``subnet`` (the parameter
    names of ``cwfa_tpu.models.cwf.init_cwf_step``)."""

    def __init__(self, spec: CWFStepSpec):
        super().__init__()
        if spec.block_type != "CAT":
            raise NotImplementedError(
                f"block type {spec.block_type!r}: only CAT is ported")
        if spec.disable_low_res_input:
            raise NotImplementedError("disable_low_res_input is not ported")
        self.spec = spec
        n = spec.c_flow
        self.input_block = nn.ModuleDict({"subnet": WaveletFlowSubnet2dFirst(
            2 * n, 2 * n, n_ch=spec.internal_ch, use_bias=spec.use_bias)})
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"subnet": WaveletFlowSubnet2d(
                n, 2 * n, n_ch=spec.internal_ch, use_bias=spec.use_bias)})
            for _ in range(spec.n_blocks))
        # inverse permutations as non-persistent buffers: they follow the
        # module's device and stay out of the state dict
        self._perm_axes = []
        for i, entry in enumerate(spec.perms):
            self._perm_axes.append(1 if entry[0] == "channel" else entry[1])
            self.register_buffer(f"perm_inv_{i}",
                                 torch.as_tensor(entry[-1], dtype=torch.long),
                                 persistent=False)

    def _inverse_perm(self, i: int, x):
        inv = getattr(self, f"perm_inv_{i}")
        axis = self._perm_axes[i]
        if axis == 1:
            return apply_channel_perm(x, inv)
        return apply_spatial_perm(x, axis, inv)

    @torch.inference_mode()
    def reverse_fast(self, z, avg, c_views, c_mean, qpack=None):
        """Generative direction through the CUDA flow-affine kernels
        (counterpart of ``_cat_reverse_fast``, ``cwf.py:346-383``): no logdet,
        no grads.

        z, avg, c_views: (B, C, H, W); c_mean: (1 or B, C, H, W).
        qpack: optional ``quantize_cat_step`` output; block i's tower runs in
        int8 where ``qpack[i]`` is not None.
        Returns the volume (B, 2C, H, W)."""
        spec = self.spec
        kw = {"clamp": spec.clamp, "activation": spec.clamp_activation}
        xq = None
        if qpack is not None and any(pk is not None for pk in qpack):
            # every tower's input scale row is the absmax of the same
            # c_views: one quantization serves the whole step (cwf.py:308-311)
            first = next(pk for pk in qpack if pk is not None)
            xq = qtower.quantize_input(c_views, first["scales"][0])
        x = z
        if spec.use_final_perm:
            x = self._inverse_perm(spec.n_blocks, x)
        for nn_ in range(spec.n_blocks, 0, -1):
            pk = None if xq is None else qpack[nn_ - 1]
            if pk is not None:
                st = qtower.fused_tower(xq, pk["qw"], pk["scales"],
                                        out_dtype=c_views.dtype)
            else:
                st = self.blocks[nn_ - 1]["subnet"](c_views)
            x = cat_affine(x, st, rev=True, **kw)
            x = self._inverse_perm(nn_ - 1, x)
        # input block: s_raw from the tower on the views condition; t is the
        # low-res prior -c_mean/sqrt(2) (flow/subnets.py), computed on the
        # batch-1 cache and broadcast with a stride-0 expand
        s_raw = self.input_block["subnet"].tower(c_views)
        t = (c_mean * -SQRT2_INV).expand(x.shape)
        return haar_merge_affine(x, s_raw, t, avg, **kw)


def quantize_cat_step(step: CWFStep, c_views_sample):
    """int8 packs of one CAT step's coupling towers (counterpart of
    ``quantize_cat_step``, ``cwf.py:273-290``): per-channel calibration of
    the step's towers, in f32, on sample conditions; scales folded into
    int8 weights quantized from the step's (f32 master) weights.  Towers are
    quantized in pairs of blocks, as JAX pairs them, so with an odd
    ``n_blocks`` the tail tower stays in the compute dtype; the input
    block's tower always does.

    Returns one entry per coupling block: {"qw", "scales"} or None."""
    n = step.spec.n_blocks
    packs = [None] * n
    x = c_views_sample.float()
    for i in range(n - n % 2):
        tower = step.blocks[i]["subnet"]
        scales = qtower.tower_calibrate(tower, x)
        packs[i] = {"qw": qtower.quantize_tower(tower, scales),
                    "scales": scales}
    return packs
