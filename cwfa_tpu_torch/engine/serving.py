"""Streaming reconstruction service: camera frames in, volumes out.

Counterpart of ``cwfa_tpu/engine/serving.py:31-365``: a fixed-batch,
double-buffered pipeline around ``XLFMReconstructor`` that overlaps host I/O
with device work, and ``serve_directory``, which reads every frame TIFF of a
directory (optionally watching it for new ones) and writes one volume TIFF
per frame.

How the work is placed on a card:

- ``submit`` copies the frame into a pinned host buffer (a ring per wire
  dtype; a slot is written again only after its last copy has landed) and
  starts its host-to-device copy on a side stream, recording an event.  The
  frame crosses in its own dtype: uint8, uint16 (2 bytes a pixel) or
  float32; any other dtype is converted to float32 on the host first.
- ``_flush`` makes the compute stream wait on those events, puts the frames
  into a zeroed float32 batch on the device (the padding of a partial batch
  stays zero), calls the reconstructor, and returns without waiting: batch
  N is dispatched, then batch N-1 is collected.
- ``fetch='full'`` starts each batch's device-to-host copy into pinned host
  memory on a second side stream as soon as its reconstruction ends, and
  hands numpy volumes to ``on_volume``; ``'barrier'`` waits on an event
  recorded after the reconstruction and hands over the tensors still on
  the device.

On the CPU (``reconstructor.device`` is the CPU, as in the tests) the same
pipeline runs with plain tensors and nothing is asynchronous.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from cwfa_tpu_torch.data import tiff as tiffio
from cwfa_tpu_torch.parallel.distributed import host_local_indices

WIRE_DTYPES = (np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.float32))


@dataclass
class ServiceStats:
    frames_in: int = 0
    frames_out: int = 0
    batches: int = 0
    padded_frames: int = 0
    t_start: float = field(default_factory=time.perf_counter)
    fetch_seconds: float = 0.0      # waiting for and taking the volumes
    fetch_bytes: int = 0
    feed_bytes: int = 0             # frame bytes sent to the device
    parse_seconds: float = 0.0      # TIFF read + decode (serve_directory)
    submit_seconds: float = 0.0     # frame checks, pinned copy, copy start
    dispatch_seconds: float = 0.0   # batch assembly + reconstructor call
    # dispatch-to-collection times: a batch is collected at the next flush
    # (double buffer) or an idle poll, so in watch mode they include up to
    # one poll interval on top of the device work and the fetch
    batch_latencies: list = field(default_factory=list)

    @property
    def throughput_fps(self) -> float:
        dt = time.perf_counter() - self.t_start
        return self.frames_out / dt if dt > 0 else 0.0

    def latency_percentile(self, q: float) -> float:
        if not self.batch_latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.batch_latencies), q))

    def summary(self) -> dict:
        return {
            "frames": self.frames_out,
            "batches": self.batches,
            "padded_frames": self.padded_frames,
            "throughput_fps": round(self.throughput_fps, 3),
            "batch_latency_p50_s": round(self.latency_percentile(50), 4),
            "batch_latency_p95_s": round(self.latency_percentile(95), 4),
            "batch_latency_p99_s": round(self.latency_percentile(99), 4),
            "fetch_seconds": round(self.fetch_seconds, 2),
            "fetch_bytes": self.fetch_bytes,
            "parse_seconds": round(self.parse_seconds, 3),
            "submit_seconds": round(self.submit_seconds, 3),
            "dispatch_seconds": round(self.dispatch_seconds, 3),
            "feed_bytes": self.feed_bytes,
        }


class _PinnedRing:
    """Pinned host buffers of one frame shape and wire dtype, used in turn;
    a buffer is handed out again only after the copy recorded on it has
    landed."""

    def __init__(self, shape, dtype: np.dtype, n: int):
        tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        self._bufs = [torch.empty(shape, dtype=tdtype, pin_memory=True)
                      for _ in range(n)]
        self._events = [None] * n
        self._next = 0

    def take(self):
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
        return i, self._bufs[i]

    def copied(self, i: int, event):
        self._events[i] = event


class ReconstructionService:
    """Fixed-batch streaming wrapper: submit frames, receive volumes.

    reconstructor: a callable (B, H, W) float32 frames on its ``device`` ->
                   (B, D, S, S) volumes, e.g. a warmed XLFMReconstructor.
    batch_size:    frames per call (partial batches are zero-padded).
    on_volume:     callback(frame_id, volume) for every finished frame, in
                   submission order.
    fetch:         'full' hands numpy volumes over; 'barrier' waits for the
                   batch and hands over the tensors still on the device
                   (the machinery's rate without the volume copy).
    """

    def __init__(self, reconstructor, batch_size: int, img_hw,
                 on_volume=None, fetch: str = "full"):
        if fetch not in ("full", "barrier"):
            raise ValueError(f"fetch mode {fetch!r}")
        self._recon = reconstructor
        self._bs = int(batch_size)
        self._img_hw = tuple(img_hw)
        self._on_volume = on_volume
        self._fetch = fetch
        self._dev = torch.device(reconstructor.device)
        self._cuda = self._dev.type == "cuda"
        if self._cuda:
            self._h2d = torch.cuda.Stream(self._dev)
            self._d2h = torch.cuda.Stream(self._dev)
            self._rings: dict = {}
        # (frame_id, frame on the device, its copy's event, uint16 bits?)
        self._buf: list = []
        self._buf_since: float | None = None
        self._inflight = None
        self.stats = ServiceStats()

    @property
    def pending(self) -> int:
        """Frames buffered but not yet dispatched."""
        return len(self._buf)

    def pending_age(self) -> float:
        """Seconds since the oldest buffered frame arrived (0.0 if none)."""
        if self._buf_since is None:
            return 0.0
        return time.perf_counter() - self._buf_since

    # ------------------------------------------------------------------ api
    def submit(self, frame, frame_id=None):
        """Queue one raw camera frame (H, W) and start its copy to the
        device; dispatches a batch when one is full.  uint8, uint16 and
        float32 frames cross as they are, any other dtype as float32
        converted here.  Raises ValueError on a frame of another shape."""
        t0 = time.perf_counter()
        frame = np.asarray(frame)
        if frame.dtype not in WIRE_DTYPES:
            frame = frame.astype(np.float32)
        if frame.shape != self._img_hw:
            raise ValueError(f"frame shape {frame.shape} != {self._img_hw}")
        if frame_id is None:
            frame_id = self.stats.frames_in
        self.stats.frames_in += 1
        if not self._buf:
            self._buf_since = time.perf_counter()
        self.stats.feed_bytes += frame.nbytes
        self._buf.append((frame_id, *self._feed(frame)))
        self.stats.submit_seconds += time.perf_counter() - t0
        if len(self._buf) >= self._bs:
            self._flush()

    def flush_partial(self):
        """Dispatch a padded partial batch now (watch mode's idle flush:
        tail frames must not wait for the batch to fill), then collect."""
        if self._buf:
            self._flush()
        self._collect()

    def drain(self):
        """Flush any partial batch and wait for all results."""
        self.flush_partial()
        return self.stats.summary()

    close = drain

    # ------------------------------------------------------------- internal
    def _feed(self, frame: np.ndarray):
        """(the frame as a tensor on the device, its copy's event or None,
        whether it holds uint16 bits).  uint16 crosses as int16 bits and is
        widened on the device, which every torch version can cast."""
        u16 = frame.dtype == np.uint16
        if u16:
            frame = frame.view(np.int16)
        if not self._cuda:
            return torch.from_numpy(frame.copy()), None, u16
        ring = self._rings.get(frame.dtype)
        if ring is None:
            ring = self._rings[frame.dtype] = _PinnedRing(
                self._img_hw, frame.dtype, 2 * self._bs)
        slot, host = ring.take()
        host.numpy()[...] = frame
        with torch.cuda.stream(self._h2d):
            dev = torch.empty_like(host, device=self._dev)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._h2d)
        ring.copied(slot, event)
        return dev, event, u16

    def _flush(self):
        batch = self._buf[:self._bs]
        self._buf = self._buf[self._bs:]
        self._buf_since = time.perf_counter() if self._buf else None
        n = len(batch)
        t0 = time.perf_counter()
        frames = torch.zeros((self._bs,) + self._img_hw, dtype=torch.float32,
                             device=self._dev)
        if self._cuda:
            compute = torch.cuda.current_stream(self._dev)
        for i, (_, dev, event, u16) in enumerate(batch):
            if event is not None:
                compute.wait_event(event)
                dev.record_stream(compute)     # allocated on the side stream
            if u16:
                dev = dev.to(torch.int32).bitwise_and_(0xFFFF)
            frames[i].copy_(dev)               # cast to f32 on the device
        self.stats.padded_frames += self._bs - n
        # dispatch the new batch first, then collect the previous one: the
        # device runs batch N while the host takes batch N-1's volumes
        out = self._recon(frames)
        handle = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record(compute)
            handle = done
            if self._fetch == "full":
                host = torch.empty((n,) + tuple(out.shape[1:]),
                                   dtype=out.dtype, pin_memory=True)
                with torch.cuda.stream(self._d2h):
                    self._d2h.wait_event(done)
                    host.copy_(out[:n], non_blocking=True)
                    out.record_stream(self._d2h)
                    fetched = torch.cuda.Event()
                    fetched.record(self._d2h)
                handle = (host, fetched)
        self.stats.dispatch_seconds += time.perf_counter() - t0
        prev = self._inflight
        self._inflight = (out, handle, [b[0] for b in batch], n, t0)
        self.stats.batches += 1
        if prev is not None:
            self._collect_entry(prev)

    def _collect(self):
        if self._inflight is None:
            return
        entry = self._inflight
        self._inflight = None
        self._collect_entry(entry)

    def _collect_entry(self, entry):
        out, handle, ids, n, t0 = entry
        t1 = time.perf_counter()
        if self._fetch == "full":
            if self._cuda:
                host, fetched = handle
                fetched.synchronize()
                vols = host.numpy()
            else:
                vols = out[:n].numpy()
            self.stats.fetch_bytes += vols.nbytes
        else:
            if self._cuda:
                handle.synchronize()
            vols = out
            self.stats.fetch_bytes += n * 8
        self.stats.fetch_seconds += time.perf_counter() - t1
        self.stats.batch_latencies.append(time.perf_counter() - t0)
        for i in range(n):
            if self._on_volume is not None:
                self._on_volume(ids[i], vols[i])
            self.stats.frames_out += 1


def _prefetch_reads(in_dir, names, stats, depth: int = 2):
    """Read TIFFs on a background thread through a bounded queue, so the
    decode of frame N+1 overlaps the submit and device work of frame N.
    Yields (name, stack | Exception); closing the generator stops the
    reader promptly."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def reader():
        for name in names:
            if stop.is_set():
                break
            t0 = time.perf_counter()
            try:
                # dtype=None: uint16 camera frames stay 2 bytes a pixel on
                # the way to the card, which casts them to f32
                item = (name, tiffio.read_tiff_stack(
                    os.path.join(in_dir, name), dtype=None))
            except Exception as e:          # handed to the consumer
                item = (name, e)
            stats.parse_seconds += time.perf_counter() - t0
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
        q.put(None)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            yield item
    finally:
        stop.set()
        while True:                         # unblock a waiting reader
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)


def serve_directory(reconstructor, batch_size, img_hw, in_dir, out_dir,
                    pattern=".tif", poll_seconds: float = 0.0,
                    limit: int | None = None, verbose: bool = True,
                    out_dtype=np.float32, max_retries: int = 5,
                    fetch: str = "full", group=None, space_group=None):
    """Reconstruct every TIFF frame of ``in_dir`` (and, with
    ``poll_seconds``, every one that appears later) into
    ``out_dir/XLFM_stack_<id>.tif``, the reference's per-frame dump loop
    (CWFA.py:1047-1055) as a service.  A multipage file gives one frame per
    page (``<name>_p<i>``).  Volume writes run on a background thread.

    A file that cannot be read is retried on later polls and quarantined
    after ``max_retries`` failures; a page of the wrong shape skips the
    rest of its file with a message.  Returns the stats summary dict, with
    one key more than the JAX package's: ``writer_tail_seconds``, the wait
    for the writer's queue after the service drained.

    ``group``: a process group of N ranks (one per device) serving the
    directory together.  Each pass rank 0 lists the new files and
    broadcasts the names (the directory may change between two listings);
    every rank takes its contiguous share of each run of ``batch_size``
    names, reads those files, reconstructs them ``ceil(batch_size / N)``
    frames a call on its own device and writes their volumes itself, so
    the writes are not funnelled through one process.  The unreadable
    files are gathered on rank 0, which counts the retries.  ``limit``
    counts the frames served over the ranks, as it counts them in one
    process, but a rank serves a multi-page file whole: the last files
    handed out may take the count past it.  The summary is the rank's own,
    with its ``rank``.

    ``space_group``: this rank's space group of a ``(data, space)`` mesh
    (``parallel.mesh.space_group``), whose ranks are consecutive ranks of
    ``group``: they serve as one, reconstructing the same frames together
    (the reconstructor splits each frame's rows over them).  Its first rank
    reads each file and broadcasts the pages, or the read's failure, to the
    others, so every rank of the group submits exactly the same pages, and
    it decides when to flush a partial batch, writes the volumes and counts
    the frames."""
    os.makedirs(out_dir, exist_ok=True)
    n_ranks = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    # servers: the space groups, runs of `space` ranks led by their first
    space = 1 if space_group is None else dist.get_world_size(space_group)
    n_servers, server = n_ranks // space, rank // space
    lead = rank % space == 0
    src = None if space_group is None else dist.get_global_rank(space_group,
                                                                 0)
    local_batch = -(-int(batch_size) // n_servers)
    writer = tiffio.BackgroundTiffWriter(maxsize=2 * local_batch)

    def enqueue(i, v):
        # the dtype conversion runs on the writer thread
        writer.put(os.path.join(out_dir, f"XLFM_stack_{i}.tif"),
                   v, dtype=out_dtype)

    svc = ReconstructionService(reconstructor, local_batch, img_hw,
                                on_volume=enqueue if fetch == "full"
                                and lead else None, fetch=fetch)
    seen = set()
    fails: dict = {}
    done = 0

    def read_files(files):
        """(name, stack | Exception) for each of ``files`` in order: read
        here, or on the space group's first rank, which broadcasts each
        result to the group."""
        if space == 1:
            yield from _prefetch_reads(in_dir, files, svc.stats)
            return
        reads = _prefetch_reads(in_dir, files, svc.stats) if lead else None
        try:
            for _ in files:
                box = [next(reads) if lead else None]
                if lead and isinstance(box[0][1], Exception):
                    # the message is what is kept; it pickles as any type
                    box = [(box[0][0], OSError(str(box[0][1])))]
                dist.broadcast_object_list(box, src=src, group=space_group)
                yield box[0]
        finally:
            if reads is not None:
                reads.close()

    def serve_files(files):
        """Read and submit ``files`` in order; returns (the unreadable
        files with their errors, whether one was read, the pages
        submitted).  In one process it stops at ``limit``."""
        failed, progressed, pages = [], False, 0
        for name, stack in read_files(files):
            if isinstance(stack, Exception):
                failed.append((name, str(stack)))
                continue
            progressed = True
            if stack.ndim == 2:
                stack = stack[None]
            base = os.path.splitext(name)[0]
            for page_ix, page in enumerate(stack):
                fid = base if stack.shape[0] == 1 else f"{base}_p{page_ix}"
                try:
                    svc.submit(page, frame_id=fid)
                except ValueError as e:
                    # a wrong-shaped page (a thumbnail, another ROI) skips
                    # the rest of its file; the service goes on
                    print(f"serve: skipped {name!r} page {page_ix}: {e}",
                          flush=True)
                    break
                pages += 1
                if group is None and limit and done + pages >= limit:
                    return failed, progressed, pages
        return failed, progressed, pages

    while True:
        names = sorted(f for f in os.listdir(in_dir)
                       if f.endswith(pattern) and f not in seen)
        if group is None:
            failed, progressed, pages = serve_files(names)
            done += pages
        else:
            box = [names]
            dist.broadcast_object_list(box, src=0, group=group)
            names = box[0]
            failed, progressed = [], False
            todo = names
            # with a limit, hand out only as many files as frames are still
            # wanted, then more where some could not be read
            while todo and not (limit and done >= limit):
                part = todo[:limit - done] if limit else todo
                todo = todo[len(part):]
                mine = [part[i + j] for i in range(0, len(part), batch_size)
                        for j in host_local_indices(
                            min(batch_size, len(part) - i), server,
                            n_servers)]
                served = serve_files(mine)
                every = [None] * n_ranks
                # a space group's ranks served the same pages: its first
                # rank counts them
                dist.all_gather_object(every, served if lead
                                       else ([], False, 0), group=group)
                failed += [f for fs, _, _ in every for f in fs]
                progressed = progressed or any(p for _, p, _ in every)
                done += sum(n for _, _, n in every)
        # a file still being written stays unseen and is retried on the next
        # poll; a corrupt one is quarantined after max_retries so that it is
        # not parsed forever
        bad = {name for name, _ in failed}
        for name, err in failed:
            fails[name] = fails.get(name, 0) + 1
            if fails[name] >= max_retries:
                seen.add(name)
                if rank == 0:
                    print(f"serve: quarantined unreadable {name!r} after "
                          f"{fails.pop(name)} attempts: {err}", flush=True)
                else:
                    fails.pop(name)
        for name in names:
            if name not in bad:
                fails.pop(name, None)
                seen.add(name)
        if (limit and done >= limit) or not poll_seconds:
            break
        # flush a partial batch on a fully idle poll, or when buffered
        # frames have waited longer than one poll interval (a trickle slower
        # than the batch would otherwise hold them for batch_size polls)
        flush = not progressed or (svc.pending and
                                   svc.pending_age() > poll_seconds)
        if space > 1:
            # a space group's ranks call the reconstructor together, when
            # its first rank says
            box = [bool(flush)]
            dist.broadcast_object_list(box, src=src, group=space_group)
            flush = box[0]
        if flush:
            svc.flush_partial()
        time.sleep(poll_seconds)
    out = svc.drain()
    t0 = time.perf_counter()
    writer.close()
    # the writer's tail: how long the volumes still queued took to write
    # after the service had drained (throughput_fps stops at the drain)
    out["writer_tail_seconds"] = round(time.perf_counter() - t0, 3)
    if group is not None:
        out["rank"] = rank
    if verbose:
        print(f"served {out['frames']} frames: {out['throughput_fps']} fps, "
              f"p95 batch latency {out['batch_latency_p95_s']} s")
    return out

