"""The flow-affine kernels of the CWF reverse chain: CUDA wrappers, their
plain PyTorch versions, and the build/loader of ``csrc/*.cu``.

Replace the Pallas TPU kernels of ``cwfa_tpu/ops/pallas_flow.py``:

- ``cat_affine`` (``pallas_flow.py:138``): each coupling block's affine,
  rev ``y = (x - t) * exp(-s)``, fwd ``y = exp(s) * x + t``;
- ``haar_merge_affine`` (``pallas_flow.py:118``): the input block's inverse
  affine fused with the inverse depth-Haar butterfly,
  ``diff = (z - t) * exp(-s)``, ``out[:, 2i] = (avg + diff)/sqrt(2)``,
  ``out[:, 2i+1] = (avg - diff)/sqrt(2)``.

Unlike the TPU kernels, both take the PRE-clamp ``s_raw`` and apply the soft
clamp ``s = clamp * f(s_raw)`` inside the kernel, in f32; the math is f32 and
the output keeps the storage dtype (f32 or bf16).

A wrapper dispatches on the device of its inputs: CPU tensors take the plain
version; CUDA tensors launch the kernel (or raise).  Each wrapper counts its
launches in ``<wrapper>.launches``; the plain path does not count.

The kernels are compiled at first use with nvcc into a shared library under
``build/cwfa_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from cwfa_tpu_torch.flow.coupling import CLAMP_ACTIVATIONS, clamp_fn
from cwfa_tpu_torch.flow.subnets import SQRT2_INV

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cwfa_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions (f32 math, output in the storage dtype)
# ---------------------------------------------------------------------------


def _clamped(s_raw, clamp: float, activation: str):
    return clamp * clamp_fn(activation)(s_raw.float())


def cat_affine_reference(x, st, *, clamp: float, activation: str, rev: bool):
    c = x.shape[1]
    s = _clamped(st[:, :c], clamp, activation)
    t = st[:, c:].float()
    xf = x.float()
    y = (xf - t) * torch.exp(-s) if rev else torch.exp(s) * xf + t
    return y.to(x.dtype)


def haar_merge_affine_reference(z, s_raw, t, avg, *, clamp: float,
                                activation: str):
    s = _clamped(s_raw, clamp, activation)
    diff = (z.float() - t.float()) * torch.exp(-s)
    a = avg.float()
    even = (a + diff) * SQRT2_INV
    odd = (a - diff) * SQRT2_INV
    b, c = avg.shape[:2]
    out = torch.stack([even, odd], dim=2).reshape((b, 2 * c) + avg.shape[2:])
    return out.to(avg.dtype)


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into the shared library if it is not built yet
    (its name carries a hash of the sources and flags); returns its path.
    Raises with nvcc's output if the build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libcwfa_flow_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(build_kernels()))
    p, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_int)
    lib.cwfa_cat_affine.argtypes = [p, p, p, i64, i64, i64, f32, i32, i32,
                                    i32, i32, p]
    lib.cwfa_cat_affine.restype = i32
    lib.cwfa_haar_merge_affine.argtypes = [p, p, p, p, p, i64, i64, i64, i64,
                                           f32, i32, i32, i32, p]
    lib.cwfa_haar_merge_affine.restype = i32
    return lib


def _check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_common(tensors: dict, ref_name: str):
    ref = tensors[ref_name]
    if ref.dim() != 4 or ref.numel() == 0:
        raise ValueError(f"{ref_name} must be a non-empty (B, C, H, W) "
                         f"tensor, got shape {tuple(ref.shape)}")
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{ref_name} dtype {ref.dtype} not in "
                        f"{list(_DTYPES)}")
    for name, t in tensors.items():
        if t.dtype != ref.dtype or t.device != ref.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, "
                            f"{ref_name} is {ref.dtype} on {ref.device}")
    if ref.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {ref.device}")


def _activation_code(activation: str) -> int:
    if activation not in CLAMP_ACTIVATIONS:
        raise ValueError(f"Unknown clamp activation {activation!r}")
    return CLAMP_ACTIVATIONS.index(activation)


def cat_affine(x, st, *, clamp: float, activation: str, rev: bool):
    """Soft-clamped conditional affine; no logdet (inference path).

    x: (B, C, H, W); st: the coupling tower's raw output (B, 2C, H, W),
    s_raw = st[:, :C], t = st[:, C:].  Both contiguous, same dtype
    (f32 or bf16) and device.  Returns y in x's dtype."""
    _check_common({"x": x, "st": st}, "x")
    b, c, h, w = x.shape
    if tuple(st.shape) != (b, 2 * c, h, w):
        raise ValueError(f"st shape {tuple(st.shape)} != {(b, 2 * c, h, w)}")
    if not (x.is_contiguous() and st.is_contiguous()):
        raise ValueError("cat_affine takes contiguous x and st")
    act = _activation_code(activation)
    if x.device.type == "cpu":
        return cat_affine_reference(x, st, clamp=clamp, activation=activation,
                                    rev=rev)
    y = torch.empty_like(x)
    rc = _lib().cwfa_cat_affine(
        x.data_ptr(), st.data_ptr(), y.data_ptr(), b, c, h * w, float(clamp),
        act, int(bool(rev)), _DTYPES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(rc, "cat_affine")
    cat_affine.launches += 1
    return y


cat_affine.launches = 0


def haar_merge_affine(z, s_raw, t, avg, *, clamp: float, activation: str):
    """Soft-clamped inverse input affine fused with the inverse depth-Haar.

    z, s_raw, avg: contiguous (B, C, H, W); t: (B, C, H, W), contiguous or
    expanded over the batch from one (1, C, H, W) tensor (batch stride 0).
    All of one dtype (f32 or bf16) and device.  Returns (B, 2C, H, W) in
    avg's dtype."""
    _check_common({"z": z, "s_raw": s_raw, "t": t, "avg": avg}, "z")
    b, c, h, w = z.shape
    for name, v in (("s_raw", s_raw), ("t", t), ("avg", avg)):
        if v.shape != z.shape:
            raise ValueError(f"{name} shape {tuple(v.shape)} != "
                             f"{tuple(z.shape)}")
    if not (z.is_contiguous() and s_raw.is_contiguous()
            and avg.is_contiguous()):
        raise ValueError("haar_merge_affine takes contiguous z, s_raw, avg")
    chw = c * h * w
    if not (t[0].is_contiguous() and (b == 1 or t.stride(0) in (0, chw))):
        raise ValueError("t must be contiguous or batch-broadcast "
                         f"(strides {t.stride()})")
    act = _activation_code(activation)
    if z.device.type == "cpu":
        return haar_merge_affine_reference(z, s_raw, t, avg, clamp=clamp,
                                           activation=activation)
    out = torch.empty((b, 2 * c, h, w), dtype=avg.dtype, device=avg.device)
    rc = _lib().cwfa_haar_merge_affine(
        z.data_ptr(), s_raw.data_ptr(), t.data_ptr(), avg.data_ptr(),
        out.data_ptr(), b, c, h * w, t.stride(0) if b > 1 else 0,
        float(clamp), act, _DTYPES[z.dtype], z.device.index,
        torch.cuda.current_stream(z.device).cuda_stream)
    _check_launch(rc, "haar_merge_affine")
    haar_merge_affine.launches += 1
    return out


haar_merge_affine.launches = 0
