"""Build and load the port's CUDA kernels (``cwfa_tpu_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc -shared``, all started together,
into a shared library ``libcwfa_<source>_<hash>.so`` under
``build/cwfa_tpu_torch/`` at the repository root; the hash covers every
source, every header beside them (``csrc/*.cuh``) and the flags.  Each op
module opens its source's library with ``load(stem)`` and registers the
``argtypes`` of its own entries.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cwfa_tpu_torch"
# -Xptxas -v: registers, spills and ptxas's notes on wgmma of every kernel;
# nvcc's output stays beside each library as <library>.log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_paths() -> dict[str, Path]:
    """{source stem: library path} of every ``csrc/*.cu``.  The name carries
    a hash of the flags, of every source and of every header beside them
    (``*.cuh``): an edit to any of them builds anew."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return {p.stem: BUILD_DIR / f"libcwfa_{p.stem}_{h.hexdigest()[:16]}.so"
            for p in sources}


def build_kernels() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is not built yet; returns
    {source stem: library path}.  Raises with nvcc's output if a build
    fails.  Processes that start together (the ranks of a run on several
    devices) build one at a time, behind a file lock, so the first builds
    and the others find its libraries."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_unlocked()


def _build_unlocked() -> dict[str, Path]:
    libs = library_paths()
    sources = [CSRC / f"{stem}.cu" for stem in libs]
    procs = []
    for src in sources:
        out = libs[src.stem]
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), str(src)]
        procs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for cmd, tmp, out, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
            if (stdout + stderr).strip():
                out.with_suffix(".log").write_text(stdout + stderr)
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The library of ``csrc/<stem>.cu``, built at first use."""
    return ctypes.CDLL(str(build_kernels()[stem]))


def check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
