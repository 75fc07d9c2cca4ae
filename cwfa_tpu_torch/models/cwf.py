"""Conditional Wavelet Flow steps, both directions (counterpart of
``cwfa_tpu/models/cwf.py``).

Per-step graph (reference networks.py:305-366), for step k on a volume with
D = n_depths/2^k depth-channels:

  fwd:  v --Haar1D--> [avg | diff];  diff --CAT_first(c_mean, c_views)--> x0
        for nn = 1..n_blocks:  x --Permute(nn)--> --Coupling(c_views)--> x
        [--PermuteRandom--]  (if INN_use_perm);  outputs (z, avg)

  rev   inverts the chain; ``avg`` is the upsampled volume from the coarser
        step, z is zeros at temperature 0 (CWFA.py:47-64).

The coupling is the step's ``block_type``: CAT (the default), RNVP, GLOW,
GIN, NICE or AI1 (``flow/coupling.py``); the input block is a CAT for every
type.  ``forward`` (normalizing, with f32 log-dets: the exact-likelihood
path and training's NLL), ``reverse`` (its exact inverse, with log-dets:
training's reconstruction, JAX's ``fast=False``), both differentiable, and
``reverse_fast`` (reconstruction: no log-det, the input affine fused with
the inverse Haar, no gradients).  The inference callers run them under
``torch.inference_mode``.  Every tower runs through the float tower kernel
(``ops/btower.FloatTowerFn``, via ``WaveletFlowSubnet2d.tower``; the TPU's
128-wide tower pairing is not carried over), its backward a kernel too.

CAT's towers read only the views condition, so a CAT step can run them
before its chain (``towers``, which training hands to both directions) and
its block affines go through ``ops/flow_affine.CatAffineFn`` (a kernel and
its backward); with a ``qpack`` (``quantize_cat_step``) ``reverse_fast`` and
``towers`` run the coupling towers in int8 through the int8 tower kernel
(``ops/qtower.fused_tower``).  The other types' towers read x, so they run
inside the chain, in the float tower kernel, and their affines are plain
torch; they have no int8 path (JAX quantizes CAT steps only).

Under a row shard (``parallel.mesh.row_shard``, the ``space`` axis) every
direction takes x, z, v, avg and c_mean on this rank's rows and c_views on
a window of ``c_reach`` more rows on each side (at least ``tower_reach``):
the Haar split and merge are over depth channels and the affines
elementwise, so they stay local, as do channel and axis-3 permutations; an
axis-2 ``PermuteDim`` fetches rows from their owners
(``parallel.halo.permute_rows``, differentiable); each log-det is the
rank's part, a sum over its rows.  A CAT step's towers run on the c_views
window and are cropped to the rank's rows (``towers``).  A non-CAT step's
towers read [x half | c_views]: before each tower x's half gets
``tower_reach`` rows from each neighbour (``parallel.halo.halo_rows``,
differentiable), c_views is cut to the same window, and the tower's output
is cropped.  ``forward`` and ``reverse`` carry gradients through all of it
(training on ``space``); ``reverse_fast`` runs the same without them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from cwfa_tpu_torch.flow.coupling import (
    all_in_one_block, cat_apply, clamp_fn, init_all_in_one_block,
    two_sided_coupling)
from cwfa_tpu_torch.flow.haar import haar1d_merge, haar1d_split
from cwfa_tpu_torch.flow.permute import (
    ReferencePermReplayer, apply_channel_perm, apply_spatial_perm,
    make_spatial_perm)
from cwfa_tpu_torch.flow.subnets import (
    SQRT2_INV, WaveletFlowSubnet2d, WaveletFlowSubnet2dFirst)
from cwfa_tpu_torch.ops import qtower
from cwfa_tpu_torch.ops.flow_affine import (CatAffineFn, cat_affine,
                                            haar_merge_affine)
from cwfa_tpu_torch.parallel.halo import halo_rows, permute_rows
from cwfa_tpu_torch.parallel.mesh import current_rows


@dataclass(frozen=True)
class CWFStepSpec:
    """Static description of one CWF pyramid step (flow on the differences)."""
    step: int                       # k = 0..n_steps-2
    d_in: int                       # depth-channels of the input volume
    spatial: int                    # H = W
    n_blocks: int = 4
    block_type: str = "CAT"         # CAT | RNVP | GLOW | GIN | NICE | AI1
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


BLOCK_TYPES = ("CAT", "RNVP", "GLOW", "GIN", "NICE", "AI1")


def reset_permutations(spec: CWFStepSpec, seed: int = 1234) -> CWFStepSpec:
    """The spec with its spatial (PermuteDim) permutations drawn anew
    (``reset_permutations``, ``cwf.py:447-473``; reference reset_perm,
    networks.py:153-163, applied to finetuned steps at CWFA.py:538); a step
    takes it through ``CWFStep.set_spec``.  The axis choice comes from a
    local ``RandomState(seed)`` (the reference draws it from the global RNG
    at reset time).

    Two reference quirks kept as JAX keeps them: (a) every PermuteDim gets
    the SAME seed, so after a reset all spatial permutations are the same
    permutation (only the pre-seed axis draw differs); (b) the reference's
    loop only rebinds its loop variable (networks.py:160-162), so its reset
    is a no-op; this implements the intent, not the no-op."""
    rng = np.random.RandomState(seed)
    new_perms = []
    for entry in spec.perms:
        if entry[0] == "spatial":
            axis, perm, inv = make_spatial_perm(spec.spatial, seed=seed,
                                                rng=rng)
            new_perms.append(("spatial", axis, perm, inv))
        else:
            new_perms.append(entry)
    return dataclasses.replace(spec, perms=tuple(new_perms))


class AllInOneParams(nn.Module):
    """An AI1 block's own state (``init_all_in_one_block``): the global
    affine's ``global_scale`` and ``global_offset`` (1, C, 1, 1) as
    parameters, and the fixed permutation matrix ``w_perm`` (C, C) as a
    persistent buffer: checkpoints carry it and no optimizer moves it, as
    the reference registers it with ``requires_grad=False``.  (The JAX
    package keeps ``w_perm`` among its params, where its Lion moves it:
    ROADMAP C.)  The permutation is drawn from the generator of
    ``init_override_``, never from numpy's global RNG."""

    # buffers that the JAX package keeps among its params
    # (``engine/jax_params``)
    JAX_PARAM_BUFFERS = ("w_perm",)

    def __init__(self, channels: int):
        super().__init__()
        p = init_all_in_one_block(torch.Generator().manual_seed(0), channels)
        self.global_scale = nn.Parameter(p["global_scale"])
        self.global_offset = nn.Parameter(p["global_offset"])
        self.register_buffer("w_perm", p["w_perm"])

    @torch.no_grad()
    def init_override_(self, generator: torch.Generator):
        p = init_all_in_one_block(generator, self.w_perm.shape[0])
        for name, value in p.items():
            getattr(self, name).copy_(value)

    def __getitem__(self, name: str):
        return getattr(self, name)


def _coupling_block(spec: CWFStepSpec) -> nn.ModuleDict:
    """One coupling block of the spec's type, conditioned on c_views (n =
    c_flow channels), with the JAX package's keys and tower widths
    (``_init_coupling_block``, ``cwf.py:116-141``)."""
    n = spec.c_flow
    cond_len = n
    l1, l2 = n // 2, n - n // 2

    def mk(ci, co):
        return WaveletFlowSubnet2d(ci, co, n_ch=spec.internal_ch,
                                   use_bias=spec.use_bias)

    bt = spec.block_type
    if bt == "CAT":
        return nn.ModuleDict({"subnet": mk(cond_len, 2 * n)})
    if bt == "RNVP":
        return nn.ModuleDict({"s1": mk(l1 + cond_len, l2),
                              "t1": mk(l1 + cond_len, l2),
                              "s2": mk(l2 + cond_len, l1),
                              "t2": mk(l2 + cond_len, l1)})
    if bt in ("GLOW", "GIN"):
        return nn.ModuleDict({"subnet1": mk(l1 + cond_len, 2 * l2),
                              "subnet2": mk(l2 + cond_len, 2 * l1)})
    if bt == "NICE":
        return nn.ModuleDict({"F": mk(l2 + cond_len, l1),
                              "G": mk(l1 + cond_len, l2)})
    if bt == "AI1":
        # AI1 splits the other way: l1 = n - n//2 (coupling.py:214)
        return nn.ModuleDict({"aio": AllInOneParams(n),
                              "subnet": mk(l2 + cond_len, 2 * l1)})
    raise ValueError(f"unknown block type {bt!r}; one of {BLOCK_TYPES}")


def tower_reach(tower: WaveletFlowSubnet2d) -> int:
    """Rows of input beyond a row range that the tower's output on it needs:
    its convs lie on one path (the residuals add nothing wider), so the
    sum of their half-widths."""
    return sum(m.kernel_size[0] // 2 for m in tower.modules()
               if isinstance(m, nn.Conv2d))


def _quantized_condition(c_views, qpack):
    """``c_views`` quantized for the int8 towers of ``qpack``, or None when
    no tower of the step is int8.  Every tower's input scale row is the
    absmax of the same c_views: one quantization serves the whole step
    (``cwf.py:308-311``)."""
    if qpack is None or all(pk is None for pk in qpack):
        return None
    first = next(pk for pk in qpack if pk is not None)
    return qtower.quantize_input(c_views, first["scales"][0])


class CWFStep(nn.Module):
    """One step: the input block (a CAT with the ``_first`` subnet) and
    ``n_blocks`` coupling blocks of the spec's type, each an
    ``nn.ModuleDict`` of its towers (and AI1's ``aio``) under the parameter
    names of ``cwfa_tpu.models.cwf.init_cwf_step``."""

    def __init__(self, spec: CWFStepSpec):
        super().__init__()
        n = spec.c_flow
        # without the low-res input the input block is an ordinary CAT on
        # the views condition alone (cwf.py:148-150,417-419)
        first = (WaveletFlowSubnet2d(n, 2 * n, n_ch=spec.internal_ch,
                                     use_bias=spec.use_bias)
                 if spec.disable_low_res_input else
                 WaveletFlowSubnet2dFirst(2 * n, 2 * n, n_ch=spec.internal_ch,
                                          use_bias=spec.use_bias))
        self.input_block = nn.ModuleDict({"subnet": first})
        self.blocks = nn.ModuleList(_coupling_block(spec)
                                    for _ in range(spec.n_blocks))
        self.set_spec(spec)

    @property
    def is_cat(self) -> bool:
        return self.spec.block_type == "CAT"

    def set_spec(self, spec: CWFStepSpec):
        """Take ``spec``, which may differ from the step's only in its
        permutations (a checkpoint's, ``engine/torch_convert.
        apply_perm_overrides``): the permutations and their inverses become
        non-persistent buffers, on the device of the step's parameters, out
        of the state dict."""
        device = next(self.parameters()).device
        self.spec = spec
        self._perm_axes = []
        for i, entry in enumerate(spec.perms):
            self._perm_axes.append(1 if entry[0] == "channel" else entry[1])
            for name, idx in (("fwd", entry[-2]), ("inv", entry[-1])):
                self.register_buffer(
                    f"perm_{name}_{i}",
                    torch.as_tensor(idx, dtype=torch.long, device=device),
                    persistent=False)

    def _perm(self, i: int, x, inverse: bool):
        idx = getattr(self, f"perm_{'inv' if inverse else 'fwd'}_{i}")
        axis = self._perm_axes[i]
        if axis == 1:
            return apply_channel_perm(x, idx)
        rows = current_rows() if axis == 2 else None
        if rows is not None:
            return permute_rows(x, self.spec.perms[i][-1 if inverse else -2],
                                rows)
        return apply_spatial_perm(x, axis, idx)

    @property
    def tower_reach(self) -> int:
        """The widest reach of the step's towers (``tower_reach``)."""
        return max(tower_reach(m) for m in self.modules()
                   if isinstance(m, WaveletFlowSubnet2d))

    def _crop(self, c_reach: int):
        """What cuts a tower's output on the c_views window to this rank's
        rows, contiguous, under a row shard (raises where ``c_reach`` is
        short of the towers' reach); the identity outside one."""
        rows = current_rows()
        if rows is None:
            return lambda t: t
        if c_reach < self.tower_reach:
            raise ValueError(f"c_views with {c_reach} rows of reach; the "
                             f"towers need {self.tower_reach}")
        return lambda t: rows.crop(t, c_reach).contiguous()

    def towers(self, c_views, qpack=None, c_reach: int = 0):
        """Every tower's output on the views condition: the input block's
        (its s_raw, or its (s_raw | t) without the low-res input), then
        the coupling blocks' (s_raw | t) in order.  All five read only
        ``c_views``, so training computes them once per step and hands them
        to both directions (``towers=``); autograd then sums the two
        directions' gradients into one backward per tower.  qpack: as in
        ``reverse_fast``, coupling block i's tower in int8 where
        ``qpack[i]`` is not None (inference only).  c_reach: under a row
        shard, c_views' rows beyond this rank's on each side; the outputs
        are cropped to the rank's rows.  CAT steps only: the other types'
        towers read x.  Raises ValueError otherwise."""
        if not self.is_cat:
            raise ValueError(f"towers() of a {self.spec.block_type} step: "
                             "only CAT towers read the condition alone")
        crop = self._crop(c_reach)
        xq = _quantized_condition(c_views, qpack)
        return [crop(self.input_block["subnet"].tower(c_views))] + [
            crop(self._coupling_tower(i, c_views, xq, qpack))
            for i in range(self.spec.n_blocks)]

    def _coupling_tower(self, i: int, c_views, xq, qpack):
        """Coupling block i's (s_raw | t): the int8 tower kernel where
        ``qpack[i]`` is a pack (``xq`` the quantized condition), else the
        float tower."""
        pk = None if xq is None else qpack[i]
        if pk is not None:
            return qtower.fused_tower(xq, pk["qw"], pk["scales"],
                                      out_dtype=c_views.dtype)
        return self.blocks[i]["subnet"].tower(c_views)

    def _input_block(self, x, c_views, c_mean, rev: bool, st=None,
                     c_reach: int = 0):
        """The input ConditionalAffineTransform, conditions concatenated as
        [mean cache | views] (``_input_block``, ``cwf.py:414-425``): s_raw
        from the tower on the views (``st``, where given), t the low-res
        prior -c_mean/sqrt(2) (``WaveletFlowSubnet2dFirst``).  A batch-1
        ``c_mean`` is expanded over the batch."""
        spec = self.spec
        if st is None:
            st = self._crop(c_reach)(self.input_block["subnet"].tower(c_views))
        if not spec.disable_low_res_input:
            st = torch.cat([st, c_mean.expand(x.shape) * -SQRT2_INV], dim=1)
        return cat_apply(st, x, rev=rev, clamp=spec.clamp,
                         clamp_activation=spec.clamp_activation)

    def _cat_chain(self, x, c_views, rev: bool, towers=None,
                   c_reach: int = 0):
        """The permute / CAT block chain (``_cat_chain``, ``cwf.py:386-411``):
        each block's (s_raw | t) from its tower (``towers[nn]``, where
        given), the affine through ``CatAffineFn`` (which clamps s itself),
        the log-det as the f32 sum of the clamped s per sample."""
        spec = self.spec
        n = spec.c_flow
        fcl = clamp_fn(spec.clamp_activation)
        logdet = torch.zeros((x.shape[0],), dtype=torch.float32,
                             device=x.device)
        crop = self._crop(c_reach) if towers is None else None

        def block(nn_, x):
            st = (crop(self.blocks[nn_ - 1]["subnet"].tower(c_views))
                  if towers is None else towers[nn_])
            s = (spec.clamp * fcl(st[:, :n].float())).to(st.dtype)
            j = s.float().sum(dim=(1, 2, 3))
            return CatAffineFn.apply(x.contiguous(), st, spec.clamp,
                                     spec.clamp_activation, rev), j

        if not rev:
            for nn_ in range(1, spec.n_blocks + 1):
                x = self._perm(nn_ - 1, x, inverse=False)
                x, j = block(nn_, x)
                logdet = logdet + j
            if spec.use_final_perm:
                x = self._perm(spec.n_blocks, x, inverse=False)
        else:
            if spec.use_final_perm:
                x = self._perm(spec.n_blocks, x, inverse=True)
            for nn_ in range(spec.n_blocks, 0, -1):
                x, j = block(nn_, x)
                logdet = logdet - j
                x = self._perm(nn_ - 1, x, inverse=True)
        return x, logdet

    def _subnet(self, tower: WaveletFlowSubnet2d, c_views, c_reach: int):
        """A non-CAT tower as the couplings call it on u, the x half: on
        [u | c_views] outside a row shard; under one on u with
        ``tower_reach`` rows of each neighbour (a differentiable halo) next
        to c_views' window of the same reach, cropped to the rank's rows."""
        rows = current_rows()
        if rows is None:
            return lambda u: tower.tower(torch.cat([u, c_views], dim=1))
        self._crop(c_reach)             # raises where the reach is short
        r = tower_reach(tower)
        cw = rows.crop(c_views, c_reach, r)
        return lambda u: rows.crop(tower.tower(torch.cat(
            [halo_rows(u, r, rows), cw], dim=1)), r)

    def _coupling(self, i: int, x, c_views, rev: bool, c_reach: int = 0):
        """Coupling block i of a non-CAT step on x (``_coupling``,
        ``cwf.py:428-444``), its towers on [x half | c_views] through the
        float tower kernel (``_subnet``).  Returns (y, logdet (B,) f32)."""
        spec = self.spec
        bp = self.blocks[i]
        if spec.block_type == "AI1":
            return all_in_one_block(
                bp["aio"], self._subnet(bp["subnet"], c_views, c_reach), x,
                rev=rev, clamp=spec.clamp)
        return two_sided_coupling(
            spec.block_type, {k: self._subnet(v, c_views, c_reach)
                              for k, v in bp.items()}, x,
            rev=rev, clamp=spec.clamp, clamp_activation=spec.clamp_activation)

    def _block_chain(self, x, c_views, rev: bool, c_reach: int = 0):
        """The permute / coupling chain of a non-CAT step
        (``cwf.py:487-494,516-523``).  Returns (x, logdet (B,) f32)."""
        spec = self.spec
        logdet = torch.zeros((x.shape[0],), dtype=torch.float32,
                             device=x.device)
        if not rev:
            for nn_ in range(1, spec.n_blocks + 1):
                x = self._perm(nn_ - 1, x, inverse=False)
                x, j = self._coupling(nn_ - 1, x, c_views, False, c_reach)
                logdet = logdet + j
            if spec.use_final_perm:
                x = self._perm(spec.n_blocks, x, inverse=False)
        else:
            if spec.use_final_perm:
                x = self._perm(spec.n_blocks, x, inverse=True)
            for nn_ in range(spec.n_blocks, 0, -1):
                x, j = self._coupling(nn_ - 1, x, c_views, True, c_reach)
                logdet = logdet + j
                x = self._perm(nn_ - 1, x, inverse=True)
        return x, logdet

    def _chain(self, x, c_views, rev: bool, towers=None, c_reach: int = 0):
        if self.is_cat:
            return self._cat_chain(x, c_views, rev, towers, c_reach)
        if towers is not None:
            raise ValueError(f"towers= for a {self.spec.block_type} step")
        return self._block_chain(x, c_views, rev, c_reach)

    def forward(self, v, c_views, c_mean, towers=None, c_reach: int = 0):
        """Normalizing direction (``cwf_step_forward``, ``cwf.py:476-494``):
        volume -> (z, averages, logdet).

        v: (B, D, H, W); c_views: (B, D/2, H, W); c_mean: (1 or B, D/2, H, W);
        towers: None (each tower runs where its block needs it) or
        ``self.towers(c_views)`` (CAT steps).  c_reach: under a row shard,
        c_views' rows beyond this rank's on each side (module docstring).
        logdet: (B,) f32."""
        avg, diff, logdet = haar1d_split(v)
        x, j = self._input_block(diff, c_views, c_mean, rev=False,
                                 st=None if towers is None else towers[0],
                                 c_reach=c_reach)
        logdet = logdet + j
        x, j = self._chain(x, c_views, rev=False, towers=towers,
                           c_reach=c_reach)
        return x, avg, logdet + j

    def reverse(self, z, avg, c_views, c_mean, towers=None, c_reach: int = 0):
        """Generative direction, the exact inverse of ``forward`` with its
        log-det (the non-fast ``cwf_step_reverse``, ``cwf.py:510-538``):
        (z, averages) -> (volume (B, 2C, H, W), logdet (B,) f32).  towers,
        c_reach: as in ``forward``."""
        x, logdet = self._chain(z, c_views, rev=True, towers=towers,
                                c_reach=c_reach)
        x, j = self._input_block(x, c_views, c_mean, rev=True,
                                 st=None if towers is None else towers[0],
                                 c_reach=c_reach)
        v, ld = haar1d_merge(avg, x)
        return v, logdet + j + ld

    @torch.inference_mode()
    def reverse_fast(self, z, avg, c_views, c_mean, qpack=None,
                     c_reach: int = 0):
        """Generative direction through the CUDA flow-affine kernels
        (counterpart of ``_cat_reverse_fast``, ``cwf.py:346-383``): no logdet,
        no grads.

        A non-CAT step runs its block chain as ``reverse`` does, its
        log-det dropped, and ends as CAT does: the input affine fused with
        the inverse Haar (JAX: ``cat_transform`` + ``haar1d_merge``,
        ``cwf.py:520-538``).

        z, avg, c_views: (B, C, H, W); c_mean: (1 or B, C, H, W).
        qpack: optional ``quantize_cat_step`` output (CAT steps); block i's
        tower runs in int8 where ``qpack[i]`` is not None.
        c_reach: under a row shard, the rows of c_views beyond this rank's
        on each side (module docstring).
        Returns the volume (B, 2C, H, W)."""
        spec = self.spec
        kw = {"clamp": spec.clamp, "activation": spec.clamp_activation}
        crop = self._crop(c_reach)
        if current_rows() is not None:
            z, avg = z.contiguous(), avg.contiguous()
        if not self.is_cat:
            if qpack is not None:
                raise ValueError(f"an int8 pack for a {spec.block_type} "
                                 "step: only CAT towers are quantized")
            x, _ = self._block_chain(z, c_views, rev=True, c_reach=c_reach)
        else:
            xq = _quantized_condition(c_views, qpack)
            x = z
            if spec.use_final_perm:
                x = self._perm(spec.n_blocks, x, inverse=True)
            for nn_ in range(spec.n_blocks, 0, -1):
                st = crop(self._coupling_tower(nn_ - 1, c_views, xq, qpack))
                x = cat_affine(x, st.contiguous(), rev=True, **kw)
                x = self._perm(nn_ - 1, x, inverse=True)
        if spec.disable_low_res_input:
            # an ordinary CAT: (s_raw | t) both from the tower
            st = crop(self.input_block["subnet"](c_views))
            n = spec.c_flow
            s_raw, t = st[:, :n].contiguous(), st[:, n:].contiguous()
        else:
            # s_raw from the tower on the views condition; t is the low-res
            # prior -c_mean/sqrt(2) (flow/subnets.py), computed on the
            # batch-1 cache and broadcast with a stride-0 expand
            s_raw = crop(self.input_block["subnet"].tower(c_views))
            s_raw = s_raw.contiguous()
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
