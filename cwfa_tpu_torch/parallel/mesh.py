"""The device mesh, batch placement and the data-parallel batch shard
(counterpart of ``cwfa_tpu/parallel/mesh.py``).

The model is small beside a card's memory, so parameters are replicated on
every rank.  The ``data`` axis spreads the frames of a batch over the ranks:
each rank computes on its own contiguous rows, the gradients are summed by
one all-reduce a step (``engine/trainer``), and results come back through
an all-gather (``distributed.to_host``).  JAX gets every collective from
``jit`` and shardings; here each is written where it runs.

Inside ``data_shard(shard)`` the batch-global pieces of the model see the
global batch:

- ``draw_rows``: a random draw over the batch (dropout masks, ``drop_path``,
  z, input noise) is drawn for the global batch from the shared seeded
  generator, and the rank keeps its rows, so N ranks draw what one does;
- ``all_reduce_sum``: the train-mode BatchNorm statistics
  (``nn.batch_norm_batch_stats``) are summed over the ranks, differentiably
  (the backward sums its terms over the ranks too);
- ``global_min`` / ``global_max``: the min-shift and support masks of the
  ``LL`` and ``wL2`` losses (``engine/losses``).

The ``space`` axis (image rows over devices, with a halo exchange before
every spatially local module and row-global BatchNorm statistics and losses
in training) is not ported: ``make_mesh`` raises for ``n_space > 1``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

SPACE_AXIS_ITEM = ("the 'space' mesh axis (image rows sharded over devices, "
                   "with halo exchanges and row-global BatchNorm statistics "
                   "and losses) is not ported yet: ROADMAP A19")


def make_mesh(n_data: int | None = None, n_space: int = 1,
              device_type: str | None = None):
    """A ``(data, space)`` ``DeviceMesh`` over the process group, one rank a
    device (``init_device_mesh(..., mesh_dim_names=("data", "space"))``).
    ``n_data`` defaults to the world size; the mesh must cover the world.
    ``device_type`` defaults to ``cuda`` under NCCL; a gloo group's mesh is
    a ``cpu`` one whatever the caller's devices (ranks sharing a card, the
    tests): its ``all_reduce`` and ``broadcast`` take CUDA tensors, and
    ``distributed.gather_rows`` stages its gathers through the host.
    Raises ValueError for ``n_space > 1`` (ROADMAP A19) or a mesh that does
    not match the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_space > 1:
        raise ValueError(f"n_space={n_space}: " + SPACE_AXIS_ITEM)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_data = world // n_space if n_data is None else n_data
    if n_data * n_space != world:
        raise ValueError(f"a ({n_data}, {n_space}) (data, space) mesh needs "
                         f"{n_data * n_space} processes; the process group "
                         f"has {world}")
    gloo = not dist.is_initialized() or dist.get_backend() == "gloo"
    if device_type is None or gloo:
        device_type = "cpu" if gloo else "cuda"
    return init_device_mesh(device_type, (n_data, n_space),
                            mesh_dim_names=("data", "space"))


def data_group(mesh):
    """The process group of the mesh's ``data`` axis (None for no mesh)."""
    return None if mesh is None else mesh.get_group("data")


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index("data"))


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank("data")


# ---------------------------------------------------------------------------
# The batch shard of a data-parallel call, and placement on it
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchShard:
    """This rank's rows [start, stop) of a global batch of ``total`` rows,
    on the ranks of ``group``."""
    group: object
    start: int
    stop: int
    total: int

    @property
    def size(self) -> int:
        return self.stop - self.start


def batch_shard(mesh, n: int) -> BatchShard | None:
    """This rank's contiguous rows of an n-row batch on the mesh's ``data``
    axis, or None when the batch is replicated: no mesh, one rank, or n not
    a multiple of the axis (a ragged final batch: every rank computes all
    of it, JAX's replication fallback).  The one rule of where rows go:
    the trainer, the reconstructor and ``Placement`` all take it."""
    k = data_size(mesh)
    if k == 1 or n % k:
        return None
    r = data_rank(mesh)
    return BatchShard(data_group(mesh), r * (n // k), (r + 1) * (n // k), n)


_SHARDS: list = []


@contextlib.contextmanager
def data_shard(shard: BatchShard | None):
    """Run the enclosed model code on this rank's rows of a global batch
    (None: no shard, a no-op)."""
    if shard is None:
        yield
        return
    _SHARDS.append(shard)
    try:
        yield
    finally:
        _SHARDS.pop()


def current_shard() -> BatchShard | None:
    return _SHARDS[-1] if _SHARDS else None


@dataclass(frozen=True)
class Placement:
    """Where a leaf of a batch goes: ``shard`` keeps this rank's rows of the
    ``data`` axis (``batch_sharding``: the rows of ``batch_shard``), else
    every row (``replicate``), on ``device``.  Per leaf, as JAX's
    ``sharded_train_step`` places them: a non-array or 0-d leaf passes
    through untouched, and a batch whose size does not divide the axis is
    replicated."""
    mesh: object
    shard: bool
    device: torch.device

    def place(self, x):
        if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0:
            return x
        t = torch.as_tensor(x)
        sh = batch_shard(self.mesh, t.shape[0]) if self.shard else None
        if sh is not None:
            t = t[sh.start:sh.stop]
        return t.to(self.device)


def _mesh_device(mesh) -> torch.device:
    if mesh is not None and mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_sharding(mesh, with_space: bool = False) -> Placement:
    """(B, ...) arrays: batch over ``data``.  ``with_space`` (rows over
    ``space``) raises: ROADMAP A19."""
    if with_space:
        raise ValueError(SPACE_AXIS_ITEM)
    return Placement(mesh, True, _mesh_device(mesh))


def replicate(mesh) -> Placement:
    return Placement(mesh, False, _mesh_device(mesh))


def draw_rows(draw, shape, dim: int = 0):
    """``draw(shape)`` — a random draw whose ``dim`` runs over the batch.
    Under a shard the draw is made for the global batch and this rank keeps
    its rows, so the generator moves as on one device and every rank's
    generator stays in step."""
    sh = current_shard()
    shape = tuple(shape)
    if sh is None:
        return draw(shape)
    if shape[dim] != sh.size:
        raise ValueError(f"a draw of shape {shape} over a batch shard of "
                         f"{sh.size} rows (dim {dim})")
    full = shape[:dim] + (sh.total,) + shape[dim + 1:]
    return draw(full).narrow(dim, sh.start, sh.size)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the shard's group (or ``group``):
    differentiable under grad mode (its backward sums the gradient over the
    ranks), a plain in-place all-reduce on a copy otherwise."""
    if group is None:
        sh = current_shard()
        if sh is None:
            return t
        group = sh.group
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t, group)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; dx = sum over ranks of dy (every rank's
    loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        dx = dy.detach().clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def _global_extreme(t: torch.Tensor, local, op) -> torch.Tensor:
    """The extreme of ``t`` over the global batch, from this rank's
    ``local`` one: a ``MIN`` / ``MAX`` all-reduce of the value, then one
    differentiable all-reduce that hands the gradient to every element equal
    to it on every rank, in equal parts, as ``torch.min`` shares it among
    ties in one process."""
    sh = current_shard()
    if sh is None:
        return local
    m = local.detach().clone()
    dist.all_reduce(m, op=op, group=sh.group)
    if not (torch.is_grad_enabled() and t.requires_grad):
        return m
    hit = t.detach() == m
    # zero forward; its gradient is 1 at each hit
    tie = torch.where(hit, t - t.detach(), torch.zeros_like(t)).sum()
    acc = torch.promote_types(t.dtype, torch.float32)   # counts past 256
    parts = all_reduce_sum(torch.stack([tie.to(acc), hit.sum().to(acc)]))
    return m + (parts[0] / parts[1]).to(m.dtype)


def global_min(t: torch.Tensor) -> torch.Tensor:
    """``t.min()`` over the global batch under a shard (every rank of the
    shard's group must call it), ``t.min()`` outside one."""
    return _global_extreme(t, t.min(), dist.ReduceOp.MIN)


def global_max(t: torch.Tensor) -> torch.Tensor:
    return _global_extreme(t, t.max(), dist.ReduceOp.MAX)
