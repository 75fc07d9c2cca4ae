"""The port trainer's evaluation side on the CPU, against the JAX trainer:
``evaluate`` (non-fast reconstruction, per-level PSNR / MAPE, the neuron
trace correlation, NLLs, MIPs, TIFF dumps, ``Neural_activity_{tag}.csv``,
TensorBoard), ``finalize_results``, ``detect_ood(trainer, dataset)``, and
``load_checkpoints`` with the epoch cap, ``steps`` and
``fine_tune_use_model_args``; then the port's version-stamped NLL cache
alone (what recomputes after an optimizer step, dataset objects kept
apart, GT pyramids primed by the refresh trained on).

One synthetic fish of 3 frames written by the JAX package's
``make_synthetic_dataset``; 16 depths at 32^2, two flow steps of two 8-wide
blocks, f32, batch 2 (a full and a ragged mini-batch), z temperature 0 and
the LRNN's drop rates 0, so that the two packages compute the same
function.  Both get the same weights (``load_jax_params``), the same mean
caches and the same GT pyramids (the JAX trainer's, carried across as
numpy), so that nothing hinges on the two RNGs' 1e-3 pyramid noise.
Bounds: PSNR / MAPE / CC within 1e-4 relative; NLLs within
1e-4 * max(1, |ref|); volumes and f32 projections within 1e-4 of max|ref|
(the float16 MIPs within one float16 step more).  The UNet is 256
channels wide at 32^2, so the module runs torch on one thread.
"""

import csv
import dataclasses
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from cwfa_tpu import data as jdata
from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.engine.ood import detect_ood as jdetect_ood
from cwfa_tpu.engine.trainer import CWFATrainer as JTrainer
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel
from cwfa_tpu.utils.tb_writer import read_event_file

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.dataset import ConcatXLFMDataset, load_xlfm_data
from cwfa_tpu_torch.data.tiff import read_tiff_stack
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.engine.jax_params import (export_jax_params,
                                              load_jax_params)
from cwfa_tpu_torch.engine.metrics import read_neural_coordinates
from cwfa_tpu_torch.engine.ood import detect_ood
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.models.cwfa_model import CWFAModel

from test_torch_port_layers import randomize_fixed_leaves

N_DEPTHS, VOL_SIDE, IMG, NLENS, VIEW = 16, 32, 96, 4, 32
CFG = dict(n_depths=N_DEPTHS, volume_side_size=VIEW, n_lenslets=NLENS,
           INN_max_down_steps=3, INN_n_blocks=2, INN_internal_chans=8,
           INN_cond_chans=4, epochs=3, use_half_precision=0, batch_size=2,
           save_images=1, create_dist_plots=1, fine_tune_optimize_steps=())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_drop(spec):
    unet = dataclasses.replace(spec.unet, drop_out=0.0)
    return dataclasses.replace(spec, unet=unet, convnext_drop=0.0,
                               unet_drop=0.0)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_eval")
    info = jdata.make_synthetic_dataset(str(root / "data"), n_fish=1,
                                        n_frames=3, n_depths=N_DEPTHS,
                                        vol_side=VOL_SIDE, img_size=IMG,
                                        n_lenslets=NLENS, view_size=VIEW)
    fish = info["fish_dirs"][0] + "/SLNet_preprocessed"
    kw = dict(vol_shape=(VOL_SIDE, VOL_SIDE, N_DEPTHS), img_shape=(IMG, IMG),
              images_to_use=[0, 1, 2], n_depths_to_fill=N_DEPTHS,
              ds_id="fish_0")
    tds = ConcatXLFMDataset(load_xlfm_data(fish, info["lenslet_file"], **kw))
    jds = jdata.ConcatXLFMDataset(
        jdata.load_xlfm_data(fish, info["lenslet_file"], **kw))
    return {"root": root, "tds": tds, "jds": jds,
            "stats": tds.get_statistics(),
            "vidx": make_view_indices(tds.datasets[0].lenslet_coords,
                                      (IMG, IMG), (VIEW, VIEW)),
            "coords": [read_neural_coordinates(
                fish + "/Neural_activity_coordinates.csv")],
            "lenslet_file": info["lenslet_file"]}


def _port_trainer(data, params=None, mstate=None, path=None, **cfg):
    model = CWFAModel.build(CWFAConfig(**{**CFG, **cfg}).decode_lrs(),
                            torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_params(model, params, mstate)
    model.lrnn.spec = _zero_drop(model.lrnn.spec)
    model.lrnn.unet.spec = model.lrnn.spec.unet
    return CWFATrainer(model, data["stats"], data["vidx"], output_path=path,
                       device="cpu")


def _jax_trainer(data, path=None, **cfg):
    jm = JModel.build(JConfig(**{**CFG, **cfg}).decode_lrs())
    jm = dataclasses.replace(jm, lrnn_spec=_zero_drop(jm.lrnn_spec))
    return JTrainer(jm, JStats(*data["stats"].astuple()), data["vidx"],
                    output_path=path)


@pytest.fixture(scope="module")
def evaluated(data):
    """Both trainers' ``evaluate`` of the 3 frames under "val", with the
    same weights, mean caches and GT pyramids."""
    jt = _jax_trainer(data, str(data["root"] / "jax"))
    rng = np.random.RandomState(0)
    params = randomize_fixed_leaves(jt.params, rng)
    mstate = randomize_fixed_leaves(jt.mstate, rng)
    jt.params, jt.mstate = _jtree(params), _jtree(mstate)
    jres = jt.evaluate(data["jds"], "val", neural_coords=data["coords"],
                       epoch=4)
    tt = _port_trainer(data, params, mstate, str(data["root"] / "port"))
    tds = data["tds"]
    tt.mean_caches = {0: [torch.from_numpy(np.array(c))
                          for c in jt.mean_caches[0]]}
    for ix, levels in jt.gt_cache["val"].items():
        tt.gt_cache.put(("val", tds.cache_tag, ix),
                        [torch.from_numpy(np.array(lvl)) for lvl in levels])
    buffers = {k: v.clone() for k, v in tt.model.named_buffers()}
    tres = tt.evaluate(tds, "val", neural_coords=data["coords"], epoch=4)
    return jt, jres, tt, tres, buffers


def _close(got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bound * max(float(np.abs(want).max()), 1e-30), err


def test_evaluate_metrics_match_jax(evaluated):
    _, jres, _, tres, _ = evaluated
    assert sorted(tres) == sorted(jres)
    assert len(tres["psnr"]) == len(tres["times"]) == 3
    for key in ("psnr", "MAPE"):
        np.testing.assert_allclose(np.asarray(tres[key]),
                                   np.asarray(jres[key]), rtol=1e-4)
    assert jres["CC"] is not None
    np.testing.assert_allclose(tres["CC"], jres["CC"], rtol=1e-4)
    for got, want in zip(tres["nll"], jres["nll"]):
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(
            1.0, float(np.abs(want).max())))
    assert all(t > 0 for t in tres["times"])


def test_evaluate_volumes_and_projections_match_jax(evaluated):
    _, jres, _, tres, _ = evaluated
    for key in ("volumes_gt", "volumes_pred", "projections_pred_steps",
                "projections_gt_steps", "projections_diff_steps"):
        assert len(tres[key]) == len(jres[key]) == 3, key
        for got, want in zip(tres[key], jres[key]):
            for g, w in (zip(got, want) if isinstance(got, list)
                         else [(got, want)]):
                _close(g, w, 1e-4)
    for key in ("projections_gt", "projections_predicted"):
        assert len(tres[key]) == len(jres[key]) == 3
        for got, want in zip(tres[key], jres[key]):
            assert got.dtype == want.dtype == np.float16
            step = float(np.spacing(np.float16(np.abs(want).max())))
            err = float(np.abs(got.astype(np.float64) - want).max())
            assert err <= 1e-4 * float(np.abs(want).max()) + step, err


def test_evaluate_files_and_logs_match_jax(evaluated, data):
    jt, _, tt, _, _ = evaluated
    jdir, tdir = data["root"] / "jax", data["root"] / "port"
    for sub in ("gt", "pred"):
        names = sorted(p.name for p in (tdir / "stacks" / "val" / sub)
                       .iterdir())
        assert names == sorted(p.name for p in (jdir / "stacks" / "val" /
                                                 sub).iterdir()) \
            == ["stack_000.tif", "stack_001.tif", "stack_002.tif"]
        for n in names:
            _close(read_tiff_stack(str(tdir / "stacks" / "val" / sub / n)),
                   read_tiff_stack(str(jdir / "stacks" / "val" / sub / n)),
                   1e-4)
    rows = []
    for d in (tdir, jdir):
        with open(d / "Neural_activity_val.csv") as f:
            rows.append(list(csv.DictReader(f)))
    assert len(rows[0]) == len(rows[1]) > 0
    assert list(rows[0][0]) == list(rows[1][0])
    for a, b in zip(*rows):
        assert a["sample_id"] == b["sample_id"] == "fish_0"
        np.testing.assert_allclose(
            [float(a[k]) for k in a if k != "sample_id"],
            [float(b[k]) for k in b if k != "sample_id"],
            rtol=1e-4, atol=1e-6)
    assert sorted(tt.log.scalars) == sorted(jt.log.scalars)
    for tag, values in jt.log.scalars.items():
        assert [s for s, _ in tt.log.scalars[tag]] == [s for s, _ in values]
    jt.log.tb_writer.flush()             # the port's evaluate flushes
    events = [read_event_file(str(next(d.glob("events.out.tfevents.*"))))
              for d in (tdir, jdir)]
    kinds = [sorted((e["tag"], e["kind"], e["step"],
                     e["value"] if e["kind"] == "image" else None)
                    for e in ev if e["tag"]) for ev in events]
    assert kinds[0] == kinds[1]
    assert ("fine_tune/psnr/val/step_2", "scalar", 4, None) in kinds[0]
    assert any(k[0] == "posterior/val/step0" for k in kinds[0])


def test_evaluate_leaves_the_batchnorm_statistics(evaluated):
    tt, buffers = evaluated[2], evaluated[4]
    assert any("running_var" in k for k in buffers)
    for k, v in tt.model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    assert not tt.model.training


def test_evaluate_on_an_empty_dataset_keeps_the_shape(evaluated):
    jt, _, tt, _, _ = evaluated
    got = tt.evaluate(ConcatXLFMDataset(), "test")
    want = jt.evaluate(jdata.ConcatXLFMDataset(), "test")
    assert got == want


def test_finalize_results_matches_jax(evaluated, data, capsys):
    jt, jres, tt, _, _ = evaluated
    results = {"val": jres}
    capsys.readouterr()
    jt.finalize_results(results, output_posfix="CV0")
    want = capsys.readouterr().out
    tt.finalize_results(results, output_posfix="CV0")
    got = capsys.readouterr().out
    assert got == want and "Mean psnr" in got
    jdir, tdir = data["root"] / "jax", data["root"] / "port"
    for name in ("stack_MIP_gt.tif", "stack_MIP_prediction.tif"):
        a = read_tiff_stack(str(tdir / name), dtype=None)
        b = read_tiff_stack(str(jdir / name), dtype=None)
        assert a.shape == (3,) + jres["projections_gt"][0].shape
        np.testing.assert_array_equal(a, b)
    pngs = sorted(p.name for p in tdir.glob("*.png"))
    assert pngs == sorted(p.name for p in jdir.glob("*.png"))
    assert len(pngs) == 9
    for name in pngs:
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO((tdir / name).read_bytes()))),
            np.asarray(Image.open(io.BytesIO((jdir / name).read_bytes()))))
    jt.log.tb_writer.flush()
    final = {"time/mean", "time/min", "corr_coeff_mean/val"} | {
        f"{m}/step_{k}" for m in ("psnr", "MAPE") for k in range(3)}
    scalars = [{e["tag"]: e["value"] for e in read_event_file(
        str(next(d.glob("events.out.tfevents.*")))) if e["tag"] in final}
        for d in (tdir, jdir)]
    assert scalars[0] == scalars[1] and set(scalars[0]) == final
    # nothing to finalize
    tt.finalize_results({})
    tt.finalize_results({"val": {"psnr": []}})
    assert capsys.readouterr().out == ""


def test_detect_ood_over_the_trainer_matches_jax(evaluated, data):
    jt, _, tt, _, _ = evaluated
    # the "val" caches of both trainers hold the same GT pyramids
    got = detect_ood(tt, data["tds"], tag="val")
    want = jdetect_ood(jt, data["jds"], tag="val")
    np.testing.assert_allclose(got.nll_per_frame, want.nll_per_frame,
                               rtol=0, atol=1e-4 * max(1.0, float(
                                   np.abs(want.nll_per_frame).max())))
    assert got.nll_per_frame.dtype == want.nll_per_frame.dtype
    np.testing.assert_array_equal(got.is_ood, want.is_ood)
    assert (got.threshold, got.step_used) == (want.threshold, want.step_used)
    empty = detect_ood(tt, ConcatXLFMDataset())
    jempty = jdetect_ood(jt, jdata.ConcatXLFMDataset())
    for key in ("nll_per_frame", "scores", "is_ood"):
        a, b = getattr(empty, key), getattr(jempty, key)
        assert a.shape == b.shape and a.dtype == b.dtype
    assert (empty.threshold, empty.step_used) == (jempty.threshold,
                                                  jempty.step_used)


# ------------------------------------------------------------ checkpoints
def test_load_checkpoints_caps_the_epoch_and_takes_the_stored_lr(data,
                                                                 tmp_path):
    """A directory with epochs 3 and 10: under max_test_load_epoch 5 both
    packages load epoch 3, not the newest; ``steps`` loads only those
    files; under fine_tune_use_model_args each flow step's Lion takes the
    checkpoint's learning rate."""
    writer = _jax_trainer(data, str(tmp_path), learning_rate=300)
    writer.save_checkpoints(3)
    at3 = jax.tree_util.tree_map(np.asarray, writer.params)
    writer.params = _jtree(randomize_fixed_leaves(
        writer.params, np.random.RandomState(1)))
    writer.params = jax.tree_util.tree_map(lambda v: v + 1.0, writer.params)
    writer.save_checkpoints(10)
    reader = _jax_trainer(data, max_test_load_epoch=5)
    assert reader.load_checkpoints(str(tmp_path)) == [1, 2, 3]
    tt = _port_trainer(data, max_test_load_epoch=5,
                       fine_tune_use_model_args=1)
    version = tt._params_version
    assert tt.load_checkpoints(str(tmp_path)) == [1, 2, 3]
    assert tt._params_version > version
    got = export_jax_params(tt.model)[0]
    for a, b, c in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(reader.params),
                       jax.tree_util.tree_leaves(at3)):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    lr = JConfig(learning_rate=300).decode_lrs().learning_rate
    assert [o.lr for o in tt.opt_flow] == [lr, lr] != [
        CWFAConfig().decode_lrs().learning_rate] * 2
    assert tt.opt_cond[0].lr == CWFAConfig().decode_lrs().learning_rate_cond
    # no cap above epoch 10: the newest files
    assert tt.load_checkpoints(str(tmp_path), max_epoch=10) == [1, 2, 3]
    flow0 = export_jax_params(tt.model)[0]["flow"][0]
    np.testing.assert_array_equal(
        jax.tree_util.tree_leaves(flow0)[0],
        np.asarray(jax.tree_util.tree_leaves(writer.params["flow"][0])[0]))
    # only file step 2: flow step and cond net 1
    part = _port_trainer(data)
    before = export_jax_params(part.model)[0]
    assert part.load_checkpoints(str(tmp_path), steps=[2.0]) == [2]
    after = export_jax_params(part.model)[0]
    for key, k, changed in (("flow", 0, False), ("flow", 1, True),
                            ("cond", 1, True), ("cond", 0, False)):
        same = all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(before[key][k]),
            jax.tree_util.tree_leaves(after[key][k])))
        assert same != changed, (key, k)
    assert part.opt_flow[1].lr == CWFAConfig().decode_lrs().learning_rate


# ----------------------------------------------------------- the NLL cache
class _Calls:
    """Batch sizes of the model's forward pyramids and pyramid refreshes."""

    def __init__(self, model):
        self.forward, self.refresh = [], []
        fwd, ref = model.forward_pyramid, model.nll_from_pyramid

        def forward(v, *a, **k):
            self.forward.append(v.shape[0])
            return fwd(v, *a, **k)

        def refresh(cache):
            self.refresh.append(cache[0].shape[0])
            return ref(cache)
        model.forward_pyramid, model.nll_from_pyramid = forward, refresh

    def take(self):
        out = (self.forward, self.refresh)
        self.forward, self.refresh = [], []
        return out


def test_nll_cache_recomputes_what_is_stale_and_only_that(data):
    tt, ds = _port_trainer(data, batch_size=1), data["tds"]
    calls = _Calls(tt.model)
    tt._refresh_nlls(ds, "val", [0, 1, 2])
    assert calls.take() == ([3], [])              # one batched forward
    tt._refresh_nlls(ds, "val", [0, 1, 2])
    first = tt._frame_nll(ds, "val", 1).copy()
    assert calls.take() == ([], [])               # fresh: nothing runs
    assert tt.transfer_log["volume_uploads"] == 3
    version = tt._params_version
    tt.train_epoch(ds, 1)                         # flow step 1, 3 steps
    assert tt._params_version == version + 3
    calls.take()
    tt._refresh_nlls(ds, "val", [0])
    assert calls.take() == ([], [1])              # from the cached pyramid
    tt._refresh_nlls(ds, "val", [0, 1, 2])
    assert calls.take() == ([], [2])              # only the two stale ones
    assert not np.array_equal(tt._frame_nll(ds, "val", 1), first)
    assert tt.transfer_log["volume_uploads"] == 6  # 3 more for "train"
    # another dataset object over the same fish reads nothing of ds's
    other = ConcatXLFMDataset(*ds.datasets)
    tt._frame_nll(other, "val", 0)
    assert calls.take() == ([1], [])
    assert ("val", other.cache_tag, 0) in tt.nll_cache
    # a cleared tag scores its volumes again
    tt.clear_gt_cache("val")
    tt._params_version += 1
    tt._refresh_nlls(ds, "val", [2])
    assert calls.take() == ([1], [])
    # the default OOD tag is the dataset's own
    detect_ood(tt, ds)
    detect_ood(tt, other)
    tags = {k[0] for k in tt.nll_cache if k[0].startswith("ood:")}
    assert tags == {f"ood:{ds.cache_tag}", f"ood:{other.cache_tag}"}


def test_pyramids_primed_by_the_refresh_train(data):
    """GT pyramids that entered the cache from the scorer's inference
    mode train through the LRNN and a flow stage, and no volume uploads
    again."""
    tt, ds = _port_trainer(data, batch_size=1), data["tds"]
    tt._refresh_nlls(ds, "train", [0, 1, 2])
    for epoch in range(2):
        assert np.isfinite(tt.train_epoch(ds, epoch))
    assert tt.transfer_log["volume_uploads"] == 3
    assert tt.opt_flow[1].count == 3


def test_evaluate_in_bf16_runs_a_compute_dtype_copy(data):
    """JAX's default precision: the reconstruction runs a bf16 copy of the
    model (as XLFMReconstructor computes), the trainer's own weights and
    BatchNorm buffers stay f32 and unmoved, and every metric is finite."""
    tt = _port_trainer(data, use_half_precision=1, batch_size=1,
                       save_images=0, create_dist_plots=0)
    assert tt.compute_dtype == torch.bfloat16
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    res = tt.evaluate(data["tds"], "test")
    assert len(res["psnr"]) == 3
    assert np.isfinite(np.asarray(res["psnr"])).all()
    assert np.isfinite(np.asarray(res["nll"])).all()
    assert res["volumes_pred"][0].dtype == np.float32
    after = tt.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(p.dtype == torch.float32 for p in tt.model.parameters())
