"""Multipage TIFF I/O through the native runtime (``data/native_tiff.py``).

Counterpart of ``cwfa_tpu/data/tiff.py:12-134``.  The JAX package falls back
to PIL for formats its native reader does not cover; the port has no PIL
path (the card's host has no Pillow): such a file, compressed or of another
sample type, raises a ValueError that names what it is, and the serving
loop quarantines it as it does any unreadable file.
"""

from __future__ import annotations

import numpy as np

from cwfa_tpu_torch.data import native_tiff


def read_tiff_stack(path: str, pages=None, dtype=np.float32) -> np.ndarray:
    """Read a multipage TIFF into (n_pages, H, W) of ``dtype`` (default
    float32; ``dtype=None`` keeps the file's own, so uint16 camera frames
    stay 2 bytes a pixel on the way to the card).

    pages: optional page indices to read (the reference's images_to_use
    ``key=`` selection, XLFMDataset.py:92); out-of-range ones are skipped.
    Raises ValueError when no page is selected or the file is not one the
    reader covers."""
    return native_tiff.read_tiff_stack_native(path, pages, dtype=dtype)


def count_tiff_pages(path: str) -> int:
    """Number of pages in a multipage TIFF (a walk of the IFD chain)."""
    return native_tiff.count_pages_native(path)


def write_tiff_stack(path: str, stack: np.ndarray):
    """Write a (D, H, W) or (H, W) array as a multipage TIFF: uint8, uint16
    and float32 as they are, every other dtype as float32."""
    native_tiff.write_tiff_stack_native(path, np.asarray(stack))


class BackgroundTiffWriter:
    """Background thread draining (path, array) TIFF-write jobs from a
    bounded queue, so ~100 MB volume writes overlap device compute instead
    of adding to it (``engine/serving.serve_directory``).

    Failure contract: a write exception is recorded and raised on the NEXT
    put()/close() on the caller's thread (a silently dead writer would
    deadlock the bounded queue); after a failure the remaining jobs are
    drained and dropped."""

    def __init__(self, maxsize: int = 16):
        import queue
        import threading
        self.errors: list = []
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.errors:
                continue               # drain after failure
            path, arr, dtype = item
            try:
                if dtype is not None:
                    # the cast runs on this thread, out of the serving
                    # loop's latency path
                    arr = arr.astype(dtype, copy=False)
                write_tiff_stack(path, arr)
            except Exception as e:     # raised on the caller's thread
                self.errors.append(e)

    def _check(self):
        if self.errors:
            raise RuntimeError("volume writer failed") from self.errors[0]

    def put(self, path: str, arr: np.ndarray, dtype=None):
        self._check()
        self._q.put((path, arr, dtype))

    def close(self):
        """Flush the remaining jobs, join the thread, raise any failure."""
        self._q.put(None)
        self._t.join()
        self._check()
