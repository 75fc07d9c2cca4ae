"""The port's ``utils/profiling.py`` on the CPU: ``debug_nans`` raises
``FloatingPointError`` on a NaN that an aten op produces, a kernel
wrapper's plain version included, and not once the scope is off or
disabled (the hand-written kernels launch through ctypes, which a dispatch
mode does not see: each wrapper checks its kernel's outputs while the scope
is on); ``trace`` writes a Chrome trace; ``FrameTimer`` counts its
frames."""

import json
import os

import pytest
import torch

from cwfa_tpu_torch.ops import btower, cond_pair, flow_affine, qtower
from cwfa_tpu_torch.utils.profiling import (FrameTimer, check_kernel_outputs,
                                            debug_nans, trace)


def test_aten_nan_raises_in_the_scope_only():
    x = torch.tensor([-1.0, 4.0])
    with debug_nans():
        assert torch.sqrt(x[1:]).item() == 2.0
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)
    assert torch.isnan(torch.sqrt(x)).any()            # off again
    with debug_nans(False):
        torch.sqrt(x)


def test_allocations_are_not_checked():
    with debug_nans():
        torch.empty(1000).fill_(1.0)
        torch.empty_like(torch.ones(3)).zero_()


def _nan_like(t):
    return torch.full_like(t, float("nan"))


@pytest.mark.parametrize("name", ["cat_affine", "haar_merge_affine"])
def test_kernel_wrapper_output_is_checked(name):
    """On the CPU a wrapper runs its plain version, whose aten ops the
    scope's dispatch mode sees: a NaN fed in raises in the scope, and
    passes through outside it."""
    x = torch.randn(1, 2, 4, 4)
    x[0, 0, 1, 2] = float("nan")
    st = torch.randn(1, 4, 4, 4)
    call = {"cat_affine": lambda: flow_affine.cat_affine(
                x, st, clamp=2.0, activation="ATAN", rev=False),
            "haar_merge_affine": lambda: flow_affine.haar_merge_affine(
                x, x, x, x, clamp=2.0, activation="ATAN")}[name]
    assert torch.isnan(call()).any()                  # outside: no check
    with debug_nans(), pytest.raises(FloatingPointError,
                                     match="produced a NaN"):
        call()


@pytest.mark.parametrize("module, name", [
    (flow_affine, "cat_affine"), (flow_affine, "haar_merge_affine"),
    (flow_affine, "cat_affine_backward"), (btower, "fused_float_tower"),
    (btower, "float_tower_backward"), (cond_pair, "cond_pair"),
    (cond_pair, "cond_pair_backward"), (qtower, "fused_tower")])
def test_every_model_wrapper_checks(module, name):
    """The kernel's outputs, which a dispatch mode does not see, go through
    the check once, after the launch; the plain version's aten ops are the
    dispatch mode's."""
    import inspect
    import re
    src = inspect.getsource(getattr(module, name))
    calls = [m.start() for m in
             re.finditer(rf'check_kernel_outputs\(\s*"{name}"', src)]
    assert len(calls) == 1
    assert calls[0] > src.index(f"{name}.launches += 1")


def test_check_kernel_outputs_passes_clean_values_through():
    t = torch.ones(3)
    bad = _nan_like(t)
    with debug_nans():
        assert check_kernel_outputs("k", (t, [t, None])) == (t, [t, None])
        with pytest.raises(FloatingPointError, match="k:"):
            check_kernel_outputs("k", (t, [bad]))


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(tmp_path)
    assert files == [f"trace_{os.getpid()}.json"]
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_frame_timer_counts():
    ft = FrameTimer("cpu")
    assert ft.mean == ft.min == 0.0
    for _ in range(3):
        ft.start()
        torch.randn(32, 32).sum()
        ft.stop()
    assert len(ft.times) == 3 and 0 < ft.min <= ft.mean
