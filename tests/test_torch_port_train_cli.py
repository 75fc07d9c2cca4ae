"""The port's training CLI (``python -m cwfa_tpu_torch.cli.train``,
``main(argv, device="cpu")``) end to end on the CPU, on a two-fish tree
written by the JAX package's ``make_synthetic_dataset``: 16 depths at 32^2,
two flow steps of two 8-wide blocks, f32, ``--epochs 3 --eval_every 3
--max_samples 2``.

- It finishes, prints the JAX CLI's lines (the parameter counts equal to
  JAX's ``param_counts``), and its run directory holds the checkpoints, the
  mean caches, ``files.zip``, an event file that JAX's reader reads and
  ``stacks/{train,val,test}``.
- Its fold groups equal JAX's ``cross_validation_groups`` on the same tree,
  and its frame indices those of JAX's ``splits`` for the flags given.
- ``--pretrain_models_path`` to a directory written by the JAX trainer,
  with ``--fine_tune_load_checkpoints`` and ``--fine_tune_use_model_args``,
  loads the same parameters and learning rates.
- A data or space mesh without its processes and
  ``CWFA_DISTRIBUTED=auto`` without torchrun's variables exit with a
  message; without ``device="cpu"`` it raises here (no card).  (``--INN_net_type 2``
  is ``tests/test_torch_port_xlfmnet.py``.)
"""

import os
import re

import numpy as np
import jax
import pytest
import torch

from cwfa_tpu import data as jdata
from cwfa_tpu.cli import train as jtrain
from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data import splits as jsplits
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.engine.trainer import CWFATrainer as JTrainer
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel
from cwfa_tpu.utils.tb_writer import read_event_file

from cwfa_tpu_torch.cli import train
from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.dataset import read_lenslet_centers
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.engine.jax_params import export_jax_params

SMALL = ["--n_depths", "16", "--volume_side_size", "32",
         "--INN_max_down_steps", "3", "--INN_n_blocks", "2",
         "--INN_internal_chans", "8", "--INN_cond_chans", "4",
         "--use_half_precision", "0", "--img_size", "96"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_cli")
    info = jdata.make_synthetic_dataset(str(root / "data"), n_fish=2,
                                        n_frames=3, n_depths=16, vol_side=32,
                                        img_size=96, n_lenslets=4,
                                        view_size=32)
    return {"root": root, "data": str(root / "data"),
            "lenslets": info["lenslet_file"]}


def _argv(tree, out, *extra):
    return ["--main_data_path", tree["data"], "--lenslet_file",
            tree["lenslets"], "--output_testing_path", str(out) + "/",
            *SMALL, *extra]


@pytest.fixture(scope="module")
def run(tree):
    import contextlib
    import io
    out = tree["root"] / "runs"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = train.main(_argv(tree, out, "--epochs", "3",
                                   "--eval_every", "3", "--max_samples", "2",
                                   "--cross_validation_nFold", "0"),
                             device="cpu")
    (run_dir,) = list(out.iterdir())
    return results, buf.getvalue(), run_dir


def test_cli_runs_end_to_end(run):
    results, _, run_dir = run
    assert sorted(results) == ["test", "train", "val"]
    frames = {"train": 2, "val": 1, "test": 2}
    for tag, n in frames.items():
        res = results[tag]
        assert len(res["psnr"]) == len(res["times"]) == len(res["nll"]) == n
        assert np.isfinite(np.asarray(res["psnr"])).all()
        assert np.isfinite(np.asarray(res["nll"])).all()
        for sub in ("gt", "pred"):
            assert sorted(os.listdir(run_dir / "stacks" / tag / sub)) == [
                f"stack_{i:03d}.tif" for i in range(n)]
    names = set(os.listdir(run_dir))
    assert {f"model_step_{s}__ep_2.msgpack" for s in (1, 2, 3)} <= names
    assert "mean_vols_cache_ds_0.msgpack" in names and "files.zip" in names
    assert re.fullmatch(r"\d{4}_\d\d_\d\d__\d\d_\d\d_\d\d_3E_CV0_0\.0T_",
                        run_dir.name)
    (events,) = run_dir.glob("events.out.tfevents.*")
    tags = {e["tag"] for e in read_event_file(str(events))}
    for tag in frames:
        assert {f"fine_tune/psnr/{tag}/step_{k}" for k in range(3)} <= tags
    assert {"arguments_general", "sampling_temperature", "loss_LL/step_0",
            "fine_tune/loss/train", "step_to_optimize", "psnr/step_0",
            "projections_pred/test"} <= tags


def test_cli_prints_the_jax_lines(run, tree):
    _, text, run_dir = run
    lines = text.splitlines()
    cfg = JConfig(n_depths=16, volume_side_size=32, INN_max_down_steps=3,
                  INN_n_blocks=2, INN_internal_chans=8, INN_cond_chans=4,
                  n_lenslets=4).decode_lrs()
    jm = JModel.build(cfg)
    counts = jm.param_counts(jm.init(jax.random.PRNGKey(0))[0])
    assert lines[0] == (
        f"nParameters: WF: {counts['WF']}\tOmega: {counts['Omega']}\t"
        f"LRNN: {counts['LRNN']}\t\ttotal: {sum(counts.values())}")
    assert [re.sub(r"loss=\S+", "", ln) for ln in lines[1:4]] == [
        f"epoch {e}/3 stage={s} " for e, s in ((1, 2), (2, 1), (3, 0))]
    table = lines.index(40 * "#" + "  Results  " + 40 * "#")
    assert lines[table + 2] == 40 * "-" + "  Per Layer  " + 40 * "-"
    assert lines[table + 3] == "metric\t\t1\t2\t3\t"
    assert re.fullmatch(r"\t Mean CC: \t\t-?\d+\.\d{4}", lines[table + 7])
    for tag in ("train", "val", "test"):
        assert any(re.fullmatch(
            rf"\[{tag}\] level-0 PSNR -?\d+\.\d{{3}}  mean time \d+\.\d{{4}}s"
            rf"  min \d+\.\d{{4}}s", ln) for ln in lines)
    assert re.fullmatch(r"OOD frames: \d/2 \(threshold -1\.33 at step 0\)",
                        lines[-2])
    assert lines[-1] == f"Saving directory: {run_dir}"


def test_folds_and_frame_indices_equal_jax(tree):
    groups, paths = train.cross_validation_groups(tree["data"], True)
    jgroups, jpaths = jtrain.cross_validation_groups(tree["data"], True)
    assert groups == jgroups and paths == jpaths
    assert sorted(groups) == [0, 1, 30, 31]
    assert train.cross_validation_groups(tree["data"], False)[1] \
        == jtrain.cross_validation_groups(tree["data"], False)[1]
    for cv in sorted(groups):
        group = groups[cv]
        for flags in ({}, {"images_to_use": 7},
                      {"images_to_use": [2, 5, 9],
                       "images_to_use_test": [3],
                       "images_to_use_fine_tune_val": 2}):
            cfg = CWFAConfig(**flags)
            got = train.resolve_frame_indices(cfg, None, groups, group, cv)
            # the JAX CLI's resolution, cwfa_tpu/cli/train.py:156-186
            ratio = (len(groups[0]["train"]), len(group["train"]))
            want_train, start = jsplits.resolve_train(
                cfg.images_to_use, cv=cv, n_datasets=len(group["train"]),
                group_ratio=ratio)
            want = (want_train, jsplits.resolve_eval_indices(
                cfg.images_to_use_fine_tune_val, window_start=start),
                jsplits.resolve_eval_indices(
                    cfg.images_to_use_test,
                    n_datasets_test=len(group["test"]),
                    group0_train_len=len(groups[0]["train"]),
                    window_start=start, rescale=True))
            assert got == want, (cv, flags)
    assert train.resolve_frame_indices(CWFAConfig(), 5, groups, groups[0],
                                       0) == ([0, 1, 2, 3, 4], [0, 1],
                                              [0, 1, 2, 3, 4])


def test_pretrained_jax_run_is_loaded(tree, tmp_path, monkeypatch):
    """A checkpoint directory of the JAX trainer, file steps 1 and 2 asked
    for, the stored learning rate taken."""
    cfg = JConfig(n_depths=16, volume_side_size=32, INN_max_down_steps=3,
                  INN_n_blocks=2, INN_internal_chans=8, INN_cond_chans=4,
                  n_lenslets=4, learning_rate=500).decode_lrs()
    coords = read_lenslet_centers(tree["lenslets"]) + 50
    vidx = make_view_indices(coords, (96, 96), (32, 32))
    jt = JTrainer(JModel.build(cfg), JStats(1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
                  vidx, output_path=str(tmp_path / "jax"), seed=7)
    jt.save_checkpoints(4)
    seen = {}

    def fit(self, *args, **kwargs):
        seen["params"] = export_jax_params(self.model)[0]
        seen["lr"] = [o.lr for o in self.opt_flow]
        return {}
    monkeypatch.setattr(train.CWFATrainer, "fit", fit)
    train.main(_argv(tree, tmp_path / "runs", "--epochs", "1",
                     "--max_samples", "2", "--pretrain_models_path",
                     str(tmp_path / "jax"), "--fine_tune_load_checkpoints",
                     "1", "2", "--fine_tune_use_model_args", "1"),
               device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jt.params)
    for key in ("flow", "cond"):
        for k in range(2):
            for a, b in zip(jax.tree_util.tree_leaves(seen["params"][key][k]),
                            jax.tree_util.tree_leaves(params[key][k])):
                np.testing.assert_array_equal(a, b)
    # file step 3 (the LRNN) was not asked for: the port's own init stays
    assert not all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(seen["params"]["lrnn"]),
        jax.tree_util.tree_leaves(params["lrnn"])))
    assert seen["lr"] == [cfg.learning_rate] * 2


@pytest.mark.parametrize("flags, item", [
    (["--mesh_data_axis", "2"], "mesh of 2 devices.*world size of 1"),
    (["--mesh_space_axis", "2"], "--mesh_space_axis 2 asks for a mesh of 2 "
                                 "devices.*world size of 1"),
    ([], "torchrun")])
def test_unported_paths_exit_naming_the_item(tree, tmp_path, monkeypatch,
                                             flags, item):
    """A data or space mesh without its processes exits naming both sizes,
    and ``CWFA_DISTRIBUTED=auto`` without torchrun's variables naming
    them."""
    if not flags:
        monkeypatch.setenv("CWFA_DISTRIBUTED", "auto")
        for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=item):
        train.main(_argv(tree, tmp_path, *flags), device="cpu")


def test_main_raises_without_a_card(tree, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(_argv(tree, tmp_path, "--epochs", "1"))
    assert not os.listdir(tmp_path)


def test_load_pretrained_networks_picks_the_newest_run_of_the_fold(
        tmp_path, monkeypatch, capsys):
    """``--load_pretrained_networks`` without a path: the newest run
    directory under ``pretrained_networks/`` naming the fold, else the
    newest (``cwfa_tpu/cli/train.py:246-264``)."""
    monkeypatch.chdir(tmp_path)
    on = CWFAConfig(load_pretrained_networks=1)
    assert train._pretrain_path(on, 0) == ""
    assert "no runs under pretrained_networks/" in capsys.readouterr().out
    for name in ("2024_a_CV0_", "2024_b_CV1_", "2024_c_CV3_"):
        (tmp_path / "pretrained_networks" / name).mkdir(parents=True)
    assert train._pretrain_path(on, 1) == os.path.join(
        "pretrained_networks", "2024_b_CV1_")
    assert train._pretrain_path(on, 5) == os.path.join(
        "pretrained_networks", "2024_c_CV3_")
    assert "using pretrained_networks/2024_c_CV3_" in capsys.readouterr().out
    assert train._pretrain_path(CWFAConfig(pretrain_models_path="x",
                                           load_pretrained_networks=1),
                                1) == "x"
    assert train._pretrain_path(CWFAConfig(), 1) == ""
