"""The port's host-side copies of the JAX package's numpy modules, held equal
to the bit to the originals on the same inputs: ``engine/metrics``
(per-level PSNR / MAPE, the neuron coordinates, trace filtering, the
streaming ROI-trace correlation, neurons at the volume's edge included),
``utils/projections``, ``data/splits`` (a grid over the int, one-element and
list forms, folds 0 / 5 / 30 and the group ratios), ``utils/seeding`` (the
next draws of ``random`` and ``numpy``); and the two that replace PIL:
``utils/png`` (decoded by PIL to the pixels of JAX's PIL encoding) and
``utils/tb_writer`` (an event file of either package read by the other's
reader, with the same scalars, text and image sizes).
"""

import io
import random

import numpy as np
import pytest
import torch
from PIL import Image

from cwfa_tpu.data import splits as jsplits
from cwfa_tpu.engine import metrics as jmetrics
from cwfa_tpu.utils import projections as jproj
from cwfa_tpu.utils import seeding as jseeding
from cwfa_tpu.utils import tb_writer as jtb

from cwfa_tpu_torch.data import splits as tsplits
from cwfa_tpu_torch.engine import metrics as tmetrics
from cwfa_tpu_torch.utils import png as tpng
from cwfa_tpu_torch.utils import projections as tproj
from cwfa_tpu_torch.utils import seeding as tseeding
from cwfa_tpu_torch.utils import tb_writer as ttb


def _same(a, b):
    """Equal to the bit, through nested tuples / lists / dicts."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


# ------------------------------------------------------------------ metrics
@pytest.mark.parametrize("step", [0, 1, 3])
@pytest.mark.parametrize("ths", [0.05, 0.0])
def test_compute_step_performance_equal(step, ths):
    rng = np.random.RandomState(step)
    gt = rng.randn(1, 6, 9, 9).astype(np.float32)
    pred = gt + 0.1 * rng.randn(1, 6, 9, 9).astype(np.float32)
    args = (gt, pred, step, 3.5, 1.7)
    _same(tmetrics.compute_step_performance(*args, ths=ths),
          jmetrics.compute_step_performance(*args, ths=ths))
    # equal volumes: the PSNR sentinel
    _same(tmetrics.compute_step_performance(gt, gt, step, 3.5, 1.7),
          jmetrics.compute_step_performance(gt, gt, step, 3.5, 1.7))


@pytest.mark.parametrize("width", [0, 3, 10])
def test_trace_filters_equal(width):
    x = np.random.RandomState(width).rand(17)
    _same(tmetrics.filter_trace(x, width), jmetrics.filter_trace(x, width))
    _same(tmetrics.norm_trace(x, width), jmetrics.norm_trace(x, width))


def test_read_neural_coordinates_equal(tmp_path):
    f = tmp_path / "Neural_activity_coordinates.csv"
    f.write_text("patch_n,coord_x,coord_y,coord_z,corr_coeff,is_gt\n"
                 "0,3.5,4.0,-2.0,1.0,1\n1,5,6,7,0.5,0\n2,1,2,x,1,1\n"
                 "3,8,9,1,1,1.0\n")
    got = tmetrics.read_neural_coordinates(str(f))
    _same(got, jmetrics.read_neural_coordinates(str(f)))
    assert len(got) == 2


def _stacks(t=6, d=24, hw=20, seed=0):
    rng = np.random.RandomState(seed)
    gt = rng.rand(t, d, hw, hw) * (rng.rand(t, d, hw, hw) > 0.3)
    pred = gt + 0.2 * rng.rand(t, d, hw, hw)
    return gt, pred


# neurons inside, at the edges (partial ROIs) and outside (empty ROIs)
COORDS = [(10, 10, 0), (0, 0, 2), (19, 19, -5), (2, 17, 11), (40, 3, 0),
          (5, 5, 30)]


@pytest.mark.parametrize("filter_width", [0, 3, 10])
def test_roi_trace_correlation_equal(filter_width):
    gt, pred = _stacks()
    got = tmetrics.corr_coeff_3d(gt, pred, COORDS, filter_width=filter_width)
    _same(got, jmetrics.corr_coeff_3d(gt, pred, COORDS,
                                      filter_width=filter_width))
    accs = [m.RoiTraceAccumulator(COORDS, reservoir_cap=500)
            for m in (tmetrics, jmetrics)]
    for t in range(gt.shape[0]):
        for acc in accs:
            acc.add(gt[t], pred[t])
    assert accs[0].empty_roi == accs[1].empty_roi and any(accs[0].empty_roi)
    _same(accs[0].finalize(filter_width=filter_width),
          accs[1].finalize(filter_width=filter_width))


# -------------------------------------------------------------- projections
@pytest.mark.parametrize("bars", [False, True])
def test_projections_equal(bars):
    vol = np.random.RandomState(1).randn(2, 6, 12, 10).astype(np.float32)
    _same(tproj.volume_2_projections(vol, add_scale_bars=bars),
          jproj.volume_2_projections(vol, add_scale_bars=bars))
    _same(tproj.composite_projection(vol[0]),
          jproj.composite_projection(vol[0]))


@pytest.mark.parametrize("norm", [np.max, None])
def test_image_pyramid_equal(norm):
    rng = np.random.RandomState(2)
    levels = [rng.rand(16, 12).astype(np.float32),
              rng.rand(8, 12).astype(np.float32),
              rng.rand(4, 12).astype(np.float32)]
    _same(tproj.create_image_pyramid(levels, norm=norm),
          jproj.create_image_pyramid(levels, norm=norm))


# ------------------------------------------------------------------- splits
FORMS = [10, 3, (7,), [2], (3, 9), [0, 250], (5, 600, 601)]


@pytest.mark.parametrize("ratio", [None, (2, 1), (3, 2), 0.5])
@pytest.mark.parametrize("cv", [0, 5, 30])
@pytest.mark.parametrize("form", FORMS, ids=str)
def test_resolve_train_equal(form, cv, ratio):
    for n_ds in (1, 2):
        _same(tsplits.resolve_train(form, cv=cv, n_datasets=n_ds,
                                    group_ratio=ratio),
              jsplits.resolve_train(form, cv=cv, n_datasets=n_ds,
                                    group_ratio=ratio))
        _same(tsplits.resolve_train_indices(form, cv, n_ds, ratio),
              jsplits.resolve_train_indices(form, cv, n_ds, ratio))


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("form", FORMS, ids=str)
def test_resolve_eval_and_clamp_equal(form, rescale):
    for n_test, len0, start in ((1, 2, 500), (2, 3, 700), (1, None, 500)):
        got = tsplits.resolve_eval_indices(form, n_datasets_test=n_test,
                                           group0_train_len=len0,
                                           window_start=start,
                                           rescale=rescale)
        _same(got, jsplits.resolve_eval_indices(
            form, n_datasets_test=n_test, group0_train_len=len0,
            window_start=start, rescale=rescale))
        for n_avail in (0, 4, 1000):
            _same(tsplits.clamp_indices(got, n_avail),
                  jsplits.clamp_indices(got, n_avail))


# ------------------------------------------------------------------ seeding
@pytest.mark.parametrize("seed", [0, 364898])
def test_set_all_seeds_gives_the_same_draws(seed):
    jseeding.set_all_seeds(seed)
    want = (random.random(), np.random.rand(5), np.random.randint(0, 99, 4))
    tseeding.set_all_seeds(seed)
    got = (random.random(), np.random.rand(5), np.random.randint(0, 99, 4))
    _same(got, want)
    t1 = torch.rand(3)
    tseeding.set_all_seeds(seed)
    random.random(), np.random.rand(1)
    assert torch.equal(torch.rand(3), t1)        # torch's generator too


# ---------------------------------------------------------------------- png
def _pil_png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (33, 20, 3), (5, 64, 3)])
def test_png_decodes_to_the_pixels_of_pil(shape):
    img = np.random.RandomState(len(shape)).randint(
        0, 256, shape).astype(np.uint8)
    data = tpng.encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    got = _decode(data)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _decode(_pil_png(img)))


def test_png_refuses_what_it_does_not_encode(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((0, 3), np.uint8)):
        with pytest.raises(ValueError):
            tpng.encode_png(bad)
    tpng.write_png(str(tmp_path / "a.png"), np.full((3, 2), 7, np.uint8))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "a.png")), np.full((3, 2), 7))


# --------------------------------------------------------------- tb_writer
def _write_events(mod, log_dir):
    w = mod.SummaryWriter(str(log_dir))
    rng = np.random.RandomState(0)
    w.add_text("arguments_general", "{'a': 1}", 0)
    for step in range(3):
        w.add_scalar("fine_tune/psnr/val/step_0", 10.0 + step / 3, step)
        w.add_scalar("neg", -2.5, -1 if step == 0 else step)
    w.add_image("grey", rng.rand(9, 14).astype(np.float32), 2)
    w.add_image("scaled", rng.rand(5, 6).astype(np.float32) * 40, 2)
    w.add_image("rgb", rng.randint(0, 256, (4, 7, 3)).astype(np.uint8), 3)
    w.close()
    (f,) = log_dir.glob("events.out.tfevents.*")
    return f


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_event_files_read_back_by_the_other_package(tmp_path, writer):
    mod, reader = (ttb, jtb.read_event_file) if writer == "port" else \
        (jtb, ttb.read_event_file)
    events = reader(str(_write_events(mod, tmp_path / writer)))
    want = jtb.read_event_file(str(_write_events(jtb, tmp_path / "ref")))
    assert [(e["step"], e["tag"], e["kind"], e["value"]) for e in events] \
        == [(e["step"], e["tag"], e["kind"], e["value"]) for e in want]
    kinds = {e["tag"]: e for e in events if e["tag"]}
    assert kinds["grey"]["value"] == (9, 14)
    assert kinds["arguments_general"]["kind"] == "text"


def test_event_images_are_the_pixels_of_jax(tmp_path):
    """The PNG inside the port's image summary decodes to JAX's (PIL's)
    pixels: the same normalization and grey-to-RGB stacking."""
    rng = np.random.RandomState(3)
    for img in (rng.rand(6, 5).astype(np.float32),
                rng.rand(6, 5).astype(np.float32) * 30,
                rng.randint(0, 256, (3, 4, 3)).astype(np.uint8)):
        got, want = ttb._image_value("x", img), jtb._image_value("x", img)
        start = got.index(b"\x89PNG")
        jstart = want.index(b"\x89PNG")
        np.testing.assert_array_equal(_decode(got[start:]),
                                      _decode(want[jstart:]))
