"""Row exchanges of the ``space`` mesh axis (the halo exchanges, row
permutations and gathers that XLA's SPMD partitioner inserts for JAX's
``P("data", None, "space", None)``; here each is written where it runs).

Design, for one call on a ``RowShard`` (``parallel/mesh.py``: ``size``
ranks, each with ``H / size`` contiguous rows):

- **Inputs cost nothing.**  Every rank reads the whole frame, so the views,
  their normalization, the mean caches and the un-normalize statistics are
  whole on every rank, and each rank cuts the rows it needs
  (``RowShard.own`` / ``take_window``).
- **Windows instead of exchanges where the input is whole.**  A chain of
  spatially local modules that reads only whole inputs (the cond nets, then
  each CAT step's towers, which read only the views condition) runs on the
  rank's rows plus ``reach`` rows on each side, clipped to the image, and is
  cropped after.  A 3x3 conv spoils one row at each cut edge of its input,
  so ``reach`` is the sum of the chain's kernel half-widths
  (``models/cond_net.cond_reach``, ``models/cwf.tower_reach``: 4 + 4 = 8).
  At the true top and bottom edge no row is added, so each layer's own SAME
  padding (the kernels zero every canvas outside the tensor they are given)
  is the image's.
- **Exchanges where the input is computed.**  The UNet's levels hold only
  the rank's rows: before each ``ConvBlock`` (two 3x3 convs) ``halo_rows``
  fetches 2 rows from each side, and the block's output is cropped; the
  max-pool and the 2x2 stride-2 transposed conv stay local while a rank's
  rows are even at every level (``space_rows``' multiple, 2^(depth - 1)).
- **Row permutations.**  An axis-2 ``PermuteDim`` of a flow step moves rows
  between ranks: ``permute_rows`` fetches each output row from its owner.
  Channel and axis-3 permutations stay local.
- **Row-global sums.**  The train-mode BatchNorm statistics, the losses'
  extremes and means, and the per-sample log-dets and priors of the NLL
  are each rank's part over its own rows, summed over the row shard's
  ``sum_group`` (``nn.batch_norm_batch_stats``, ``parallel.mesh.
  global_min`` / ``loss_share``).
- **Whole-image modules run whole.**  The LRNN's mean branch (a LayerNorm
  over (C, H, W) and a Conv1d over the flattened H*W) reads only the mean
  cache: every rank computes it whole and keeps its rows.

Gradients (training).  Each rank computes a loss ``L_r`` on its batch rows
and its image rows, and the sum of ``L_r`` over the whole mesh is the
one-process loss of the global batch and the whole image.  Each rank
backpropagates its own ``L_r``.  Every exchange's backward returns the
gradient to the rank that owns the row (``fetch_rows``, and through it
``halo_rows`` and ``permute_rows``, is a ``torch.autograd.Function``: a row
fetched by two peers gets both gradients), and every row-global sum's
backward sums over the same ranks as its forward.  A window computed from a
whole input (the cond nets, a CAT step's towers) exchanges nothing: the
rank's loss depends on its own rows, which depend on its own redundant
window computation, so the exact gradient of ``L_r`` flows into the rank's
own copy of the parameters.  One flat all-reduce over the mesh then sums
the stage's gradients and the losses (``engine/trainer``), and Lion moves
every rank alike, to the bit.  Under ``torch.no_grad`` / inference mode an
exchange is the same forward, with no graph.

Transport: point-to-point sends of exactly the rows a peer needs
(``dist.batch_isend_irecv`` on NCCL; gloo sends no CUDA tensor, so there the
rows cross through host memory, as ``distributed.gather_rows`` does).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cwfa_tpu_torch.parallel.distributed import gather_rows
from cwfa_tpu_torch.parallel.mesh import RowShard


def _is_run(idx: np.ndarray) -> bool:
    """Whether idx is a nonempty run of consecutive ascending numbers."""
    return len(idx) > 0 and bool((np.diff(idx) == 1).all())


def _take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """x[:, :, idx]: a view where idx is a run of consecutive rows."""
    if _is_run(idx):
        return x.narrow(2, int(idx[0]), len(idx))
    return x.index_select(2, torch.as_tensor(idx, dtype=torch.long,
                                             device=x.device))


def _p2p(group, sends: dict, recv_shapes: dict, like: torch.Tensor) -> dict:
    """Send ``sends[j]`` to place j of ``group`` and receive a tensor of
    ``recv_shapes[j]`` from each place j, all posted before any is waited
    for.  Returns {j: received tensor on ``like``'s device}."""
    host = dist.get_backend(group) == "gloo" and like.device.type != "cpu"
    dev = torch.device("cpu") if host else like.device
    bufs = {j: torch.empty(shape, dtype=like.dtype, device=dev)
            for j, shape in recv_shapes.items()}
    outs = {j: t.to(dev).contiguous() for j, t in sends.items()}
    peer = {j: dist.get_global_rank(group, j)
            for j in set(bufs) | set(outs)}
    if dist.get_backend(group) == "nccl":
        ops = ([dist.P2POp(dist.irecv, b, peer[j], group)
                for j, b in bufs.items()]
               + [dist.P2POp(dist.isend, t, peer[j], group)
                  for j, t in outs.items()])
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = ([dist.irecv(b, peer[j], group) for j, b in bufs.items()]
                 + [dist.isend(t, peer[j], group) for j, t in outs.items()])
    for w in works:
        w.wait()
    return {j: b.to(like.device) for j, b in bufs.items()}


def _plan(rs: RowShard, wanted):
    """Who sends whom which rows for ``fetch_rows``: (positions in this
    rank's result of each peer's rows {j: array}, this rank's rows that
    each peer wants {j: array, local row numbers}, (positions, local rows)
    of this rank's own wanted rows or None, the number of rows wanted)."""
    me = rs.index
    want = np.asarray(wanted(me), dtype=np.int64)
    recv, send, local = {}, {}, None
    for j in range(rs.size):
        lo, hi = rs.bounds(j)
        sel = np.nonzero((want >= lo) & (want < hi))[0]
        if j == me:
            if len(sel):
                local = (sel, want[sel] - lo)
            continue
        if len(sel):
            recv[j] = sel
        wj = np.asarray(wanted(j), dtype=np.int64)
        mine = wj[(wj >= rs.start) & (wj < rs.stop)] - rs.start
        if len(mine):
            send[j] = mine
    return recv, send, local, len(want)


def _rows_shape(x: torch.Tensor, n: int) -> tuple:
    return tuple(x.shape[:2]) + (n,) + tuple(x.shape[3:])


def _fetch(x: torch.Tensor, rs: RowShard, plan) -> torch.Tensor:
    recv, send, local, n = plan
    got = _p2p(rs.group, {j: _take(x, m) for j, m in send.items()},
               {j: _rows_shape(x, len(p)) for j, p in recv.items()}, x)
    parts = ([] if local is None else [(local[0], _take(x, local[1]))]) + [
        (recv[j], got[j]) for j in recv]
    if all(_is_run(pos) for pos, _ in parts):
        # the parts tile [0, n) in runs (a halo): concatenate them in
        # order of position
        parts.sort(key=lambda q: int(q[0][0]))
        return (parts[0][1] if len(parts) == 1
                else torch.cat([t for _, t in parts], dim=2))
    out = x.new_empty(_rows_shape(x, n))
    for pos, t in parts:
        out.index_copy_(2, torch.as_tensor(pos, device=x.device), t)
    return out


def _add_rows(dx: torch.Tensor, rows: np.ndarray, g: torch.Tensor):
    """dx[:, :, rows] += g (rows may repeat)."""
    if _is_run(rows):
        dx.narrow(2, int(rows[0]), len(rows)).add_(g)
    else:
        dx.index_add_(2, torch.as_tensor(rows, device=dx.device), g)


def _send_back(dy: torch.Tensor, rs: RowShard, plan,
               x_shape) -> torch.Tensor:
    """The backward of ``_fetch``: each received row's gradient goes back to
    its owner over the same transport, and each rank adds what comes back
    (and its own rows' part) to its rows, own part first, then the peers
    in place order."""
    recv, send, local, _ = plan
    got = _p2p(rs.group, {j: _take(dy, p) for j, p in recv.items()},
               {j: _rows_shape(dy, len(m)) for j, m in send.items()}, dy)
    dx = dy.new_zeros(tuple(x_shape))
    if local is not None:
        _add_rows(dx, local[1], _take(dy, local[0]))
    for j in sorted(got):
        _add_rows(dx, send[j], got[j])
    return dx


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rs, plan):
        ctx.rs, ctx.plan, ctx.x_shape = rs, plan, x.shape
        out = _fetch(x, rs, plan)
        return out.clone() if out._is_view() else out

    @staticmethod
    def backward(ctx, dy):
        return _send_back(dy.contiguous(), ctx.rs, ctx.plan,
                          ctx.x_shape), None, None


def fetch_rows(x: torch.Tensor, rs: RowShard, wanted) -> torch.Tensor:
    """The rows ``wanted(rs.index)`` (global row numbers, a 1-D int array)
    of the tensor whose rows [start, stop) this rank holds in ``x`` (rows on
    dim 2), in that order.  ``wanted(i)`` must give the rows every place i
    wants (each rank computes every peer's wants, so no request is sent):
    each rank sends each peer exactly the rows of its own that the peer
    wants.  Differentiable where ``x`` requires a gradient: the backward
    sends each row's gradient back to its owner (module docstring).  Every
    rank of ``rs.group`` must call it, and under grad mode every rank must
    backpropagate through it."""
    plan = _plan(rs, wanted)
    if torch.is_grad_enabled() and x.requires_grad:
        return _FetchRows.apply(x, rs, plan)
    return _fetch(x, rs, plan)


def halo_rows(x: torch.Tensor, reach: int, rs: RowShard) -> torch.Tensor:
    """This rank's rows with ``reach`` rows of its neighbours on each side,
    clipped to the image: rows ``rs.window(reach)`` (at the true top and
    bottom edge none are added, so the next layer's SAME padding is the
    image's).  ``rs.crop(y, reach)`` cuts a result back to the rank's
    rows."""
    return fetch_rows(x, rs, lambda i: np.arange(*rs.window(reach, i)))


def permute_rows(x: torch.Tensor, perm, rs: RowShard) -> torch.Tensor:
    """``x.index_select(2, perm)`` of the whole tensor, on this rank's rows:
    output row i (global) is input row ``perm[i]``, fetched from the rank
    that holds it.  perm: a numpy array of the ``rs.total`` rows."""
    perm = np.asarray(perm, dtype=np.int64)
    return fetch_rows(x, rs, lambda i: perm[slice(*rs.bounds(i))])


def gather_image_rows(t: torch.Tensor, rs: RowShard) -> torch.Tensor:
    """Every rank's rows of ``t`` (rows on dim 2) concatenated in place
    order, on every rank: the whole image."""
    whole = gather_rows(t.movedim(2, 0).contiguous(), rs.group)
    return whole.movedim(0, 2).contiguous()
