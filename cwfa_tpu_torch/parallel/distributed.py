"""Multi-process bootstrap on ``torch.distributed`` (counterpart of
``cwfa_tpu/parallel/distributed.py``).

One process per device, PyTorch's idiom (the JAX package runs one process
per host, which drives all of that host's chips).  A run on N devices is N
processes, each on ``cuda:LOCAL_RANK``, joined in one process group:
NCCL on the card, gloo when the caller asks for the CPU (the tests).

The rendezvous comes from the environment, as in the JAX package:

- torchrun's variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``, ``LOCAL_RANK``), which ``CWFA_DISTRIBUTED=auto`` asks
  for explicitly: ``env://``;
- ``CWFA_COORDINATOR=host:port`` + ``CWFA_NUM_PROCESSES=N`` +
  ``CWFA_PROCESS_ID=K``: ``tcp://host:port``, world size N, rank K (the
  local rank is ``LOCAL_RANK`` where set, else K);
- neither: one process, no group.

A group made by the caller before (a test, a worker of ``chip_smoke.py``) is
used as it is.  Every rank holds the same host data (the dataset on shared
storage, as ``assemble_global`` assumes in JAX), takes its own contiguous
rows of each global batch (``host_local_indices``' split), and gets results
back through an ``all_gather`` (``to_host``).  Host-side artifacts are
written by rank 0 (``is_primary``).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from cwfa_tpu_torch.parallel.mesh import make_mesh

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
LAUNCH_HINT = ("launch one process per GPU: torchrun --nproc_per_node {n} "
               "-m cwfa_tpu_torch.cli.{cli} ..., or set CWFA_COORDINATOR / "
               "CWFA_NUM_PROCESSES / CWFA_PROCESS_ID in each process")


def _local_rank(default: int) -> int:
    return int(os.environ.get("LOCAL_RANK", default))


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` on the card (an error,
    not a fallback, when there is no such card), the CPU otherwise."""
    if device_type != "cuda":
        return torch.device("cpu")
    rank = dist.get_rank() if dist.is_initialized() else 0
    lr = _local_rank(rank)
    n = torch.cuda.device_count()
    if lr >= n:
        raise RuntimeError(f"local rank {lr} needs cuda:{lr}, but this host "
                           f"has {n} CUDA device(s): one process per GPU")
    return torch.device("cuda", lr)


def initialize_from_env(device_type: str = "cuda") -> bool:
    """Join the process group the environment describes; a no-op without
    one.  Returns True when a group exists (made here or before), False in
    a single process.  Idempotent: a second call never makes another group.
    The backend is NCCL for ``device_type="cuda"`` (each rank on
    ``cuda:LOCAL_RANK``), gloo otherwise.  Raises RuntimeError when
    ``CWFA_DISTRIBUTED=auto`` is set without torchrun's variables."""
    if dist.is_initialized():
        return True
    mode = os.environ.get("CWFA_DISTRIBUTED", "").strip().lower()
    coord = os.environ.get("CWFA_COORDINATOR", "").strip()
    kw: dict = {}
    if coord:
        kw = dict(init_method=f"tcp://{coord}",
                  world_size=int(os.environ["CWFA_NUM_PROCESSES"]),
                  rank=int(os.environ["CWFA_PROCESS_ID"]))
        rank = kw["rank"]
    elif mode == "auto" or all(v in os.environ for v in TORCHRUN_VARS):
        missing = [v for v in TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(
                f"CWFA_DISTRIBUTED=auto reads torchrun's variables, and "
                f"{', '.join(missing)} is not set: "
                + LAUNCH_HINT.format(n="N", cli="<cli>"))
        kw = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    else:
        return False
    if device_type == "cuda":
        lr = _local_rank(rank)
        n = torch.cuda.device_count()
        if lr >= n:
            raise RuntimeError(f"local rank {lr} needs cuda:{lr}, but this "
                               f"host has {n} CUDA device(s)")
        dev = torch.device("cuda", lr)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns host-side artifact writes (rank 0)."""
    return process_index() == 0


def host_local_indices(n: int, process_id: int | None = None,
                       process_count: int | None = None) -> list[int]:
    """Partition [0, n) across processes in contiguous blocks (floor split;
    the first ``n % P`` processes take one extra), as JAX's."""
    pid = process_index() if process_id is None else process_id
    pc = world_size() if process_count is None else process_count
    base, extra = divmod(n, pc)
    start = pid * base + min(pid, extra)
    return list(range(start, start + base + (1 if pid < extra else 0)))


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order, on every
    rank (``all_gather``); the ranks' row counts may differ.  gloo gathers
    no CUDA tensor, so on the gloo path a CUDA ``t`` crosses through host
    memory and comes back to its device; NCCL gathers only CUDA tensors, so
    there a host ``t`` crosses through the card."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t
    n = dist.get_world_size(group)
    dev = t.device
    if _gloo(group):
        work = t.cpu()
    else:
        work = t if dev.type == "cuda" else t.to(torch.device(
            "cuda", torch.cuda.current_device()))
    sizes = torch.tensor([work.shape[0]], dtype=torch.int64,
                         device=work.device)
    all_sizes = [torch.zeros_like(sizes) for _ in range(n)]
    dist.all_gather(all_sizes, sizes, group=group)
    rows = [int(s) for s in all_sizes]
    top = max(rows)
    pad = work
    if work.shape[0] < top:
        pad = torch.cat([work, work.new_zeros((top - work.shape[0],)
                                              + tuple(work.shape[1:]))])
    parts = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(parts, pad.contiguous(), group=group)
    out = torch.cat([p[:r] for p, r in zip(parts, rows)])
    return out.to(dev)


def to_host(x, group=None) -> np.ndarray:
    """The global value of a batch whose rows lie across the ranks, as
    numpy on every rank (an ``all_gather``: every rank of the group must
    call it).  In one process it is ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return gather_rows(x.detach(), group).cpu().numpy()
    return np.asarray(x)


def global_batch_array(local, placement):
    """This rank's block of a global batch, as a tensor on the placement's
    device: the port's global array is the set of the ranks' blocks, and
    ``local`` is this rank's (its ``host_local_indices`` rows).  In one
    process it is the whole batch."""
    return torch.as_tensor(local).to(placement.device)


def assemble_global(x, placement):
    """Place a host-replicated array: every rank holds the same full ``x``
    (shared storage) and keeps the rows its placement gives it (all of
    them when the placement replicates or the batch does not divide)."""
    return placement.place(x)


def _tree_tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _tree_tensors(obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tree_tensors(v)
    elif hasattr(obj, "__dict__"):
        yield from _tree_tensors(vars(obj))


def check_same_on_ranks(tree, group, what: str):
    """Raise unless every tensor of ``tree`` is the same on every rank of
    ``group`` (a position-weighted f64 checksum per tensor, gathered)."""
    sums = []
    for t in _tree_tensors(tree):
        f = t.detach().double().reshape(-1)
        w = torch.arange(1, f.numel() + 1, dtype=torch.float64,
                         device=f.device) % 13 + 1
        sums.append(torch.stack([f.sum(), (f * w).sum()]))
    local = (torch.stack(sums).reshape(1, -1) if sums
             else torch.zeros((1, 0), dtype=torch.float64)).cpu()
    every = gather_rows(local, group)
    if not bool((every == every[:1]).all()):
        raise RuntimeError(f"{what} differ between the ranks")


def cli_bootstrap(device, cli: str, n_data: int = 1, n_space: int = 1,
                  flag: str = "--mesh_data_axis", replicated: bool = False):
    """A CLI's start on one or more devices: join the process group the
    environment describes (``initialize_from_env``), check the mesh the
    flags ask for against it, and pick this rank's device (``cuda`` with no
    index becomes ``cuda:LOCAL_RANK`` under a group; an explicit device is
    kept, as two ranks sharing one card need).  Returns (device, mesh or
    None).  Exits with a message for a bad environment, or a mesh whose
    size is not the world size (with ``replicated``, a run without a mesh
    may have any world size: every rank computes all of it)."""
    device = torch.device(device)
    try:
        grouped = initialize_from_env(device.type)
    except RuntimeError as e:
        sys.exit(str(e))
    n, world = n_data * n_space, world_size()
    if world != n and (n > 1 or not replicated):
        what = (f"{flag} {n}" if n_space == 1 else
                f"{flag} {n_data} --mesh_space_axis {n_space}")
        sys.exit(f"{what} asks for a mesh of {n} devices, one process "
                 f"each, and this run has a world size of {world}: "
                 + LAUNCH_HINT.format(n=n, cli=cli))
    if grouped and device.type == "cuda" and device.index is None:
        device = local_device()
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    mesh = (make_mesh(n_data, n_space, device_type=device.type) if n > 1
            else None)
    return device, mesh
