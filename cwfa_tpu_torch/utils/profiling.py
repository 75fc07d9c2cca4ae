"""Profiling and debug helpers (counterpart of ``cwfa_tpu/utils/profiling.py``).

- ``trace(log_dir)``: ``torch.profiler`` over a scope, host and device
  (CUPTI sees the hand-written kernels too, launched through ctypes), into
  a Chrome trace ``<log_dir>/trace_<pid>.json`` (the reference's commented
  torch.profiler exports, CWFA.py:14-15,683,876-888).
- ``debug_nans(enable)``: a scope in which an operation that produces a NaN
  raises ``FloatingPointError``, as ``jax_debug_nans`` does.  A
  ``TorchDispatchMode`` sees every aten op; the hand-written kernels launch
  through ctypes, which it does not see, so each kernel wrapper hands its
  kernel's outputs to ``check_kernel_outputs``, which looks at them only
  while the scope is on (on the CPU a wrapper runs its plain version, whose
  aten ops the mode sees).
- ``FrameTimer``: per-frame times on CUDA events (the host clock on the
  CPU), with ``.mean`` and ``.min`` in seconds, as JAX's.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_NAN_SCOPES = [0]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope; on exit write ``trace_<pid>.json`` (open it in
    Perfetto or chrome://tracing) into ``log_dir``.  Yields the
    ``torch.profiler.profile`` object (``key_averages()`` and the like)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and bool(torch.isnan(t).any()))


def _flat(out):
    if isinstance(out, (list, tuple)):
        for o in out:
            yield from _flat(o)
    else:
        yield out


# uninitialized memory may hold any bits: an allocation is no NaN of an op
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}


class _NanMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _ALLOCATIONS:
            return out
        if any(_has_nan(o) for o in _flat(out)):
            raise FloatingPointError(f"{func} produced a NaN (debug_nans)")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise ``FloatingPointError`` where an op or a kernel wrapper in the
    scope produces a NaN; ``enable=False`` is a no-op scope.  Every check
    waits for the device, so the scope is for finding a fault, not for
    timing."""
    if not enable:
        yield
        return
    _NAN_SCOPES[0] += 1
    try:
        with _NanMode():
            yield
    finally:
        _NAN_SCOPES[0] -= 1


def check_kernel_outputs(name: str, out):
    """A kernel wrapper's outputs, returned as they are; inside
    ``debug_nans`` a NaN among them raises ``FloatingPointError`` naming
    the kernel."""
    if _NAN_SCOPES[0] and any(_has_nan(o) for o in _flat(out)):
        raise FloatingPointError(f"{name}: the kernel's output holds a NaN "
                                 "(debug_nans)")
    return out


class FrameTimer:
    """``start()`` / ``stop()`` around each frame; ``times`` in seconds:
    CUDA events on a card (the device's time between the two, waited for
    at ``stop``), the host clock on the CPU."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.times: list = []
        self._t0 = None

    def start(self):
        if self.device.type == "cuda":
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self):
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.times.append(self._t0.elapsed_time(end) / 1e3)
        else:
            self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self):
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def min(self):
        return float(np.min(self.times)) if self.times else 0.0
