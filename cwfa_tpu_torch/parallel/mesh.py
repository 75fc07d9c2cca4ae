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

The ``space`` axis spreads the image rows of a call over the ranks of a
``space`` group (``RowShard``): each rank holds ``H / n_space`` contiguous
rows, and inside ``row_shard(rows)`` the model computes on them
(``parallel/halo.py`` exchanges the rows that a spatially local module needs
from the neighbours, differentiably).  Where ``H`` does not split into
``n_space`` equal shards whose rows divide by the UNet's 2^(depth - 1),
every rank of the space group computes all rows (JAX's fallback), and
``space_rows`` says so once.  Reconstruction, serving and training run on
it.

One rule decides where a batch-global or row-global sum goes: ``sum_group``,
the ranks that computed distinct parts of the call (the whole mesh when the
batch and the rows are both split, the ``space`` group for a batch that is
ragged on ``data``, the ``data`` group where the rows fall back).  The
BatchNorm statistics, the losses' extremes and a training step's gradient
all-reduce go there, and ``loss_share`` is this rank's part of a mean over
the call (its batch share times its row share), so that the ranks' parts
add up to the one-process value.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

def make_mesh(n_data: int | None = None, n_space: int = 1,
              device_type: str | None = None):
    """A ``(data, space)`` ``DeviceMesh`` over the process group, one rank a
    device (``init_device_mesh(..., mesh_dim_names=("data", "space"))``).
    ``n_data`` defaults to the world size; the mesh must cover the world.
    ``device_type`` defaults to ``cuda`` under NCCL; a gloo group's mesh is
    a ``cpu`` one whatever the caller's devices (ranks sharing a card, the
    tests): its ``all_reduce`` and ``broadcast`` take CUDA tensors, and
    ``distributed.gather_rows`` stages its gathers through the host.
    Ranks lie row-major: rank ``d * n_space + s`` is place ``s`` of data
    index ``d``, so a space group is ``n_space`` consecutive ranks.  Raises
    ValueError for a mesh that does not match the world size."""
    from torch.distributed.device_mesh import init_device_mesh

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


def space_group(mesh):
    """The process group of the mesh's ``space`` axis (None for no mesh)."""
    return None if mesh is None else mesh.get_group("space")


def space_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index("space"))


def space_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank("space")


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


# ---------------------------------------------------------------------------
# The row shard of a space-parallel call
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class RowShard:
    """This rank's image rows of a call: ``size`` ranks of ``group`` hold
    ``total`` rows in equal contiguous shards, this one place ``index``
    (rows [start, stop)).  ``stats_group``: where a row-global sum goes
    (``sum_group``: the train-mode BatchNorm statistics, the losses'
    extremes, a training step's gradients): the whole mesh when the batch
    is split over ``data`` too, else ``group`` (None: ``group``)."""
    group: object
    index: int
    size: int
    total: int
    stats_group: object = None

    @property
    def rows(self) -> int:
        return self.total // self.size

    @property
    def sum_group(self):
        return self.group if self.stats_group is None else self.stats_group

    @property
    def start(self) -> int:
        return self.index * self.rows

    @property
    def stop(self) -> int:
        return self.start + self.rows

    def bounds(self, i: int) -> tuple[int, int]:
        """Rows [start, stop) of place ``i``."""
        return i * self.rows, (i + 1) * self.rows

    def window(self, reach: int, i: int | None = None) -> tuple[int, int]:
        """Rows [lo, hi) of place ``i``'s (default this rank's) shard with
        ``reach`` rows on each side, clipped to the image: at its true top
        and bottom no row is added, so a layer's own SAME padding still
        zeroes outside the image."""
        lo, hi = self.bounds(self.index if i is None else i)
        return max(lo - reach, 0), min(hi + reach, self.total)

    def scaled(self, f: int) -> "RowShard":
        """The same shard at 1/f of the rows (a UNet level)."""
        if self.rows % f:
            raise ValueError(f"{self.rows} rows a rank do not divide by {f}")
        return RowShard(self.group, self.index, self.size, self.total // f,
                        self.stats_group)

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole (B, C, H, W) tensor (a batch-1 one
        too)."""
        return t.narrow(2, self.start, self.rows)

    def take_window(self, t: torch.Tensor, reach: int) -> torch.Tensor:
        """The rows of ``window(reach)`` of a whole tensor."""
        lo, hi = self.window(reach)
        return t.narrow(2, lo, hi - lo)

    def crop(self, t: torch.Tensor, reach: int, to: int = 0) -> torch.Tensor:
        """A tensor on ``window(reach)`` cut to ``window(to)``."""
        lo, _ = self.window(reach)
        a, b = self.window(to)
        return t.narrow(2, a - lo, b - a)


# per thread, so that the places of an in-process stand-in group can run
# side by side in threads
_ROWS = threading.local()
_FALLBACK_SAID: set = set()


@contextlib.contextmanager
def row_shard(rows: RowShard | None):
    """Run the enclosed model code (in this thread) on this rank's image
    rows (None: no shard, a no-op)."""
    if rows is None:
        yield
        return
    stack = _ROWS.__dict__.setdefault("stack", [])
    stack.append(rows)
    try:
        yield
    finally:
        stack.pop()


def current_rows() -> RowShard | None:
    stack = getattr(_ROWS, "stack", None)
    return stack[-1] if stack else None


def space_rows(mesh, total: int, multiple: int = 1,
               batch_split: bool = False) -> RowShard | None:
    """This rank's rows of a ``total``-row image on the mesh's ``space``
    axis, or None when every rank computes all rows: no mesh, one space
    rank, or ``total`` not splitting into ``n_space`` shards whose rows
    divide by ``multiple`` (JAX's fallback; said once per case, never
    silently).  ``batch_split``: the batch is split over ``data`` too, so
    row-global sums go over the whole mesh."""
    n = space_size(mesh)
    if n == 1:
        return None
    if total % n or (total // n) % multiple:
        key = (total, n, multiple)
        if key not in _FALLBACK_SAID:
            _FALLBACK_SAID.add(key)
            print(f"space axis: {total} rows do not split into {n} shards "
                  f"of a multiple of {multiple} rows; every rank of the "
                  f"space group computes all rows", flush=True)
        return None
    group = space_group(mesh)
    return RowShard(group, space_rank(mesh), n, total,
                    dist.group.WORLD if batch_split else group)


@dataclass(frozen=True)
class Placement:
    """Where a leaf of a batch goes: ``shard`` keeps this rank's rows of the
    ``data`` axis (``batch_sharding``: the rows of ``batch_shard``), else
    every row (``replicate``), on ``device``; ``rows`` also keeps this
    rank's image rows (dim 2) of a (B, C, H, W) leaf on the ``space`` axis
    (the rows of ``space_rows`` at ``row_multiple``).  Per leaf, as JAX's
    ``sharded_train_step`` places them: a non-array or 0-d leaf passes
    through untouched, a batch whose size does not divide the ``data`` axis
    is replicated, and a leaf whose H ``space_rows`` does not split keeps
    all its rows."""
    mesh: object
    shard: bool
    device: torch.device
    rows: bool = False
    row_multiple: int = 1

    def place(self, x):
        if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0:
            return x
        t = torch.as_tensor(x)
        sh = batch_shard(self.mesh, t.shape[0]) if self.shard else None
        if sh is not None:
            t = t[sh.start:sh.stop]
        rs = (space_rows(self.mesh, t.shape[2], self.row_multiple)
              if self.rows and t.ndim >= 4 else None)
        if rs is not None:
            t = rs.own(t)
        return t.to(self.device)


def _mesh_device(mesh) -> torch.device:
    if mesh is not None and mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_sharding(mesh, with_space: bool = False,
                   row_multiple: int = 1) -> Placement:
    """(B, C, H, W) arrays: batch over ``data``, and with ``with_space``
    rows over ``space`` (JAX's ``P("data", None, "space", None)``), each
    rank's rows a multiple of ``row_multiple`` (the UNet's 2^(depth - 1)
    for a model input) or all of them."""
    return Placement(mesh, True, _mesh_device(mesh), with_space,
                     row_multiple)


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


def sum_group():
    """The group over which this rank's part of a call-global sum adds up:
    the row shard's ``sum_group`` (the whole mesh when the batch is split
    too, else the space group), else the batch shard's group (the rows fell
    back to all of them on every rank, so only the ``data`` ranks computed
    distinct parts), else None (this rank computed all of it).  A shard
    whose group is None means the default group."""
    rows, sh = current_rows(), current_shard()
    group = (rows.sum_group if rows is not None
             else None if sh is None else sh.group)
    if group is None and (rows is not None or sh is not None):
        return dist.group.WORLD
    return group


def loss_share() -> float:
    """This rank's share of a mean over the call: its batch share times its
    row share (1 outside every shard).  A mean's part on this rank is its
    own mean times the share, and the parts add up over ``sum_group`` to
    the one-process mean."""
    share = 1.0
    sh, rows = current_shard(), current_rows()
    if sh is not None:
        share *= sh.size / sh.total
    if rows is not None:
        share *= rows.rows / rows.total
    return share


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """In place: ``t`` reduced by ``op`` over ``group``.  Every collective
    sum and extreme of the model goes through this one call."""
    dist.all_reduce(t, op=op, group=group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (default ``sum_group()``; the
    identity where that is None): differentiable under grad mode (its
    backward sums the gradient over the ranks), a plain all-reduce on a copy
    otherwise."""
    if group is None:
        group = sum_group()
        if group is None:
            return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t, group)
    out = t.detach().clone()
    _all_reduce(out, group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; dx = sum over ranks of dy (every rank's
    loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, dy):
        dx = dy.detach().clone()
        _all_reduce(dx, ctx.group)
        return dx, None


def _global_extreme(t: torch.Tensor, local, op) -> torch.Tensor:
    """The extreme of ``t`` over the call (the global batch and the whole
    image), from this rank's ``local`` one: a ``MIN`` / ``MAX`` all-reduce
    of the value over ``sum_group()``, then one differentiable all-reduce
    that hands the gradient to every element equal to it on every rank, in
    equal parts, as ``torch.min`` shares it among ties in one process."""
    group = sum_group()
    if group is None:
        return local
    m = local.detach().clone()
    _all_reduce(m, group, op)
    if not (torch.is_grad_enabled() and t.requires_grad):
        return m
    hit = t.detach() == m
    # zero forward; its gradient is 1 at each hit
    tie = torch.where(hit, t - t.detach(), torch.zeros_like(t)).sum()
    acc = torch.promote_types(t.dtype, torch.float32)   # counts past 256
    parts = all_reduce_sum(torch.stack([tie.to(acc), hit.sum().to(acc)]),
                           group)
    return m + (parts[0] / parts[1]).to(m.dtype)


def global_min(t: torch.Tensor) -> torch.Tensor:
    """``t.min()`` over the call under a shard (every rank of
    ``sum_group()`` must call it), ``t.min()`` outside one."""
    return _global_extreme(t, t.min(), dist.ReduceOp.MIN)


def global_max(t: torch.Tensor) -> torch.Tensor:
    return _global_extreme(t, t.max(), dist.ReduceOp.MAX)
