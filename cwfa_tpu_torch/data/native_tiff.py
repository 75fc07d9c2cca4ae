"""ctypes binding to the native TIFF runtime (``cwfa_tpu_torch/native/tiffio.cpp``).

A copy of ``cwfa_tpu/data/native_tiff.py`` that differs in three ways:

- the source is the port's copy of ``native/tiffio.cpp``, whose IFD walk
  fails cleanly on corrupt files where the original crashes (a tag with a
  count of 0) or loops (a cyclic IFD chain); see its header;
- it is compiled at first use, with ``g++ -O3 -fPIC -std=c++17 -shared
  -pthread``, into ``build/cwfa_tpu_torch/libcwfa_tiffio_<hash>.so`` at the
  repository root, the hash covering the source and the flags; nothing is
  written into ``native/``, and a build that fails raises with the
  compiler's output;
- a file the reader does not cover, or a corrupt one, raises ValueError
  (there is no other reader behind it).

The C ABI (``native/tiffio.cpp:139-371``): a reader of uncompressed
grayscale uint8 / uint16 / float32 classic TIFFs (strips, either byte
order), a single-strip little-endian writer, and a background prefetcher
that decodes page n+1 while the caller works on page n.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "cwfa_tpu_torch" / "native" / "tiffio.cpp"
BUILD_DIR = ROOT / "build" / "cwfa_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_DTYPES = {1: np.uint8, 2: np.uint16, 3: np.float32}
_DTYPE_CODES = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 2,
                np.dtype(np.float32): 3}
# tiff_page_info's return codes (native/tiffio.cpp:160-179)
_PAGE_ERRORS = {-1: "page index out of range",
                -2: "compressed or multi-sample page",
                -3: "sample type other than uint8 / uint16 / float32",
                -5: "page geometry larger than the file or zero-sized "
                    "(corrupt IFD)"}

_LIB = None
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    """The library's path; its name carries a hash of the source and the
    flags, so an edit to either builds anew."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcwfa_tiffio_{h.hexdigest()[:16]}.so"


def _build(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o",
           str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the TIFF library failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)


def _load_library():
    """The native library, built at first use; raises if the build or the
    load fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for name, restype, argtypes in (
                ("tiff_open", p, [ctypes.c_char_p]),
                ("tiff_num_pages", i32, [p]),
                ("tiff_page_info", i32, [p, i32, ctypes.POINTER(i64),
                                         ctypes.POINTER(i32)]),
                ("tiff_read_page", i32, [p, i32, p]),
                ("tiff_close", None, [p]),
                ("tiff_write", i32, [ctypes.c_char_p, p, i32, i64, i64, i32]),
                ("prefetch_start", p, [p, ctypes.POINTER(i32), i32, i32]),
                ("prefetch_next", i32, [p, p]),
                ("prefetch_error", ctypes.c_char_p, [p]),
                ("prefetch_stop", None, [p])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
        return _LIB


def _open(lib, path: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    h = lib.tiff_open(os.fsencode(path))
    if not h:
        raise ValueError(f"{path!r} is not a readable classic TIFF (bad "
                         "header or IFD chain)")
    return h


def _page_info(lib, h, page: int, path: str):
    dims = (ctypes.c_int64 * 2)()
    dt = ctypes.c_int()
    rc = lib.tiff_page_info(h, page, dims, ctypes.byref(dt))
    if rc != 0:
        raise ValueError(f"{path!r} page {page}: "
                         f"{_PAGE_ERRORS.get(rc, f'unsupported ({rc})')}; "
                         "the reader takes uncompressed grayscale uint8, "
                         "uint16 and float32 pages")
    return (int(dims[0]), int(dims[1])), _DTYPES[dt.value]


def count_pages_native(path: str) -> int:
    lib = _load_library()
    h = _open(lib, path)
    try:
        return int(lib.tiff_num_pages(h))
    finally:
        lib.tiff_close(h)


def read_tiff_stack_native(path: str, pages=None,
                           dtype=np.float32) -> np.ndarray:
    """(n_pages, H, W) of the selected pages (out-of-range indices are
    dropped), cast to ``dtype``; ``dtype=None`` keeps the file's.  Raises
    ValueError on a file the reader does not cover or a corrupt one, and
    when no page is selected."""
    lib = _load_library()
    h = _open(lib, path)
    try:
        n = lib.tiff_num_pages(h)
        page_list = (list(range(n)) if pages is None
                     else [p for p in pages if 0 <= p < n])
        out = []
        for p in page_list:
            shape, dt = _page_info(lib, h, p, path)
            arr = np.empty(shape, dt)
            rc = lib.tiff_read_page(h, p, arr.ctypes.data)
            if rc != 0:
                raise ValueError(f"{path!r} page {p}: strip data missing or "
                                 f"truncated ({rc})")
            out.append(arr)
        if not out:
            raise ValueError(
                f"no pages selected from {path!r}: requested "
                f"{None if pages is None else list(pages)!r} of {n}")
        if len({(a.shape, a.dtype) for a in out}) != 1:
            raise ValueError(f"{path!r}: pages of different shapes or types")
        stacked = np.stack(out)
        return stacked if dtype is None else stacked.astype(dtype)
    finally:
        lib.tiff_close(h)


def write_tiff_stack_native(path: str, stack: np.ndarray):
    """Write (D, H, W) (or (H, W)) uint8 / uint16 / float32 as an
    uncompressed little-endian multipage TIFF; other dtypes are written as
    float32.  Raises OSError if the file cannot be written or would pass the
    classic format's 4 GB."""
    lib = _load_library()
    stack = np.ascontiguousarray(stack)
    if stack.ndim == 2:
        stack = stack[None]
    if stack.ndim != 3 or stack.size == 0:
        raise ValueError(f"a TIFF stack is a non-empty (D, H, W) or (H, W) "
                         f"array, got shape {stack.shape}")
    code = _DTYPE_CODES.get(stack.dtype)
    if code is None:
        stack = np.ascontiguousarray(stack, dtype=np.float32)
        code = 3
    rc = lib.tiff_write(os.fsencode(path), stack.ctypes.data,
                        stack.shape[0], stack.shape[1], stack.shape[2], code)
    if rc != 0:
        raise OSError(f"writing {path!r} failed ({rc}: "
                      f"{'over 4 GB' if rc == -2 else 'cannot open'})")


class PrefetchingTiffReader:
    """Iterate a multipage TIFF with a background decode thread.

    with PrefetchingTiffReader(path, pages) as it:
        for page_ix, frame in it: ...
    """

    def __init__(self, path: str, pages=None, depth: int = 2):
        lib = _load_library()
        self._lib, self._pf = lib, None
        self._h = _open(lib, path)
        n = lib.tiff_num_pages(self._h)
        self._pages = (list(range(n)) if pages is None
                       else [p for p in pages if 0 <= p < n])
        try:
            if not self._pages:
                raise ValueError(f"no pages selected from {path!r} "
                                 f"(requested {pages!r} of {n})")
            self._shape, self._dtype = _page_info(lib, self._h,
                                                  self._pages[0], path)
            arr = (ctypes.c_int * len(self._pages))(*self._pages)
            self._pf = lib.prefetch_start(self._h, arr, len(self._pages),
                                          depth)
            if not self._pf:
                raise ValueError(f"prefetch start failed for {path!r}")
        except Exception:
            self.close()
            raise

    def __enter__(self):
        return self

    def __iter__(self):
        for _ in range(len(self._pages)):
            buf = np.empty(self._shape, self._dtype)
            ix = self._lib.prefetch_next(self._pf, buf.ctypes.data)
            if ix < 0:
                # a failure mid-stream must not read as a shorter stack
                err = self._lib.prefetch_error(self._pf)
                if err:
                    raise ValueError(f"native tiff prefetch failed: "
                                     f"{err.decode()}")
                break
            yield ix, buf

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._pf:
            self._lib.prefetch_stop(self._pf)
            self._pf = None
        if self._h:
            self._lib.tiff_close(self._h)
            self._h = None
