"""The port's trainer (``engine/trainer.py``) on the CPU: ``train_epoch``
through every stage of the small rig on a dataset written by the JAX
package's ``make_synthetic_dataset`` (the LRNN, then flow steps 1 and 0),
with finite losses and only the stage's groups changed by each epoch; the
per-frame caches keyed on the dataset's tag; and ``save_checkpoints`` read
back by the JAX trainer's ``load_checkpoints`` (parameters, BatchNorm
statistics and Lion momenta equal), and the JAX trainer's files read back
by the port.

f32; 16 depths at 32^2, two flow steps of two 8-wide blocks.  The UNet is
256 channels wide at 32^2, above the 32,768-element grain where this CPU's
multithreaded elementwise ops are not steady, so the module runs torch on
one thread.
"""

import numpy as np
import jax
import pytest
import torch

from cwfa_tpu import data as jdata
from cwfa_tpu.config import CWFAConfig as JConfig
from cwfa_tpu.data.stats import DatasetStatistics as JStats
from cwfa_tpu.engine.trainer import CWFATrainer as JTrainer
from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

from cwfa_tpu_torch.config import CWFAConfig
from cwfa_tpu_torch.data.dataset import ConcatXLFMDataset, load_xlfm_data
from cwfa_tpu_torch.data.views import make_view_indices
from cwfa_tpu_torch.engine.jax_params import export_jax_params
from cwfa_tpu_torch.engine.trainer import CWFATrainer
from cwfa_tpu_torch.models.cwfa_model import CWFAModel

N_DEPTHS, VOL_SIDE, IMG, NLENS, VIEW = 16, 32, 96, 4, 32
SMALL = dict(n_depths=N_DEPTHS, volume_side_size=VIEW, n_lenslets=NLENS,
             INN_max_down_steps=3, INN_n_blocks=2, INN_internal_chans=8,
             INN_cond_chans=4, epochs=3, use_half_precision=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_train"))
    info = jdata.make_synthetic_dataset(root, n_fish=1, n_frames=3,
                                        n_depths=N_DEPTHS, vol_side=VOL_SIDE,
                                        img_size=IMG, n_lenslets=NLENS,
                                        view_size=VIEW)
    ds = load_xlfm_data(info["fish_dirs"][0] + "/SLNet_preprocessed",
                        info["lenslet_file"],
                        vol_shape=(VOL_SIDE, VOL_SIDE, N_DEPTHS),
                        img_shape=(IMG, IMG), images_to_use=[0, 1, 2],
                        n_depths_to_fill=N_DEPTHS, ds_id="fish_0")
    cat = ConcatXLFMDataset(ds)
    vidx = make_view_indices(ds.lenslet_coords, (IMG, IMG), (VIEW, VIEW))
    return {"cat": cat, "vidx": vidx, "stats": cat.get_statistics()}


def _trainer(rig, seed=0):
    model = CWFAModel.build(CWFAConfig(**SMALL).decode_lrs(),
                            torch.Generator().manual_seed(seed))
    return CWFATrainer(model, rig["stats"], rig["vidx"], device="cpu")


def _group(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in ("flow", "cond") else parts[0]


@pytest.fixture(scope="module")
def trained(rig):
    """A trainer after one epoch per stage: [(stage, loss, groups changed)]."""
    tr = _trainer(rig)
    epochs = []
    for epoch in range(SMALL["epochs"]):
        before = {n: p.detach().clone()
                  for n, p in tr.model.named_parameters()}
        loss = tr.train_epoch(rig["cat"], epoch)
        changed = {_group(n) for n, p in tr.model.named_parameters()
                   if not torch.equal(p, before[n])}
        epochs.append((tr.stage_for_epoch(epoch), loss, changed))
    return tr, epochs


def test_train_epoch_through_every_stage(trained):
    tr, epochs = trained
    assert [s for s, _, _ in epochs] == [2, 1, 0]
    assert [c for _, _, c in epochs] == [{"lrnn"}, {"flow.1", "cond.1"},
                                         {"flow.0", "cond.0"}]
    assert all(np.isfinite(loss) for _, loss, _ in epochs)
    assert tr.log.last("step_to_optimize") == 0
    assert np.isfinite(tr.log.last("loss_LL/step_0"))
    # every frame and volume went to the device once, and the stage inputs
    # of steps 1 and 0 came from the coarser stage's captured outputs
    assert tr.transfer_log["frame_uploads"] == 3
    assert tr.transfer_log["volume_uploads"] == 3
    assert tr.opt_lrnn.count == tr.opt_flow[1].count == 3
    assert tr.opt_cond[0].count == 3


def test_train_epoch_in_bf16(rig):
    """JAX's default precision, bf16 activations over f32 masters (autocast
    for the cond nets and the LRNN; the towers, CAT affines and 3-D pairs
    through their Functions with f32 weights under a bf16 x): every stage's
    loss finite, the gradients and the parameters f32."""
    model = CWFAModel.build(CWFAConfig(**{**SMALL, "use_half_precision": 1})
                            .decode_lrs(), torch.Generator().manual_seed(3))
    tr = CWFATrainer(model, rig["stats"], rig["vidx"], device="cpu")
    assert tr.compute_dtype == torch.bfloat16
    for epoch in range(SMALL["epochs"]):
        assert np.isfinite(tr.train_epoch(rig["cat"], epoch))
    for p in model.parameters():
        assert p.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32
               for p in model.flow[0].parameters())


def test_caches_follow_the_dataset_tag(rig):
    """A dataset mutated in place, or another dataset object, is read and
    uploaded anew; the same dataset again is not."""
    tr = _trainer(rig, seed=1)
    cat = rig["cat"]
    for ix in range(3):
        tr._views_for(cat, "train", ix)
    tr._views_for(cat, "train", 0)
    assert tr.transfer_log["frame_uploads"] == 3
    other = ConcatXLFMDataset(*cat.datasets)
    tr._views_for(other, "train", 0)
    assert tr.transfer_log["frame_uploads"] == 4
    cat.datasets[0].version += 1                  # as an in-place mutation
    try:
        tr._views_for(cat, "train", 0)
        assert tr.transfer_log["frame_uploads"] == 5
    finally:
        cat.datasets[0].version -= 1


def _jax_trainer(rig, path=None):
    jcfg = JConfig(**SMALL).decode_lrs()
    return JTrainer(JModel.build(jcfg), JStats(*rig["stats"].astuple()),
                    rig["vidx"], output_path=path)


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_checkpoints_resume_in_jax_and_back(trained, rig, tmp_path):
    tr, _ = trained
    files = tr.save_checkpoints(2, str(tmp_path / "port"))
    assert len(files) == 4                        # 3 steps + the mean caches
    jt = _jax_trainer(rig)
    assert jt.load_checkpoints(str(tmp_path / "port")) == [1, 2, 3]
    params, state = export_jax_params(tr.model)
    _assert_trees_equal(jt.params, params)
    _assert_trees_equal(jt.mstate, state)
    for k in range(2):
        for mine, theirs in ((tr.opt_flow[k], jt.opt_flow[k]),
                             (tr.opt_cond[k], jt.opt_cond[k])):
            _assert_trees_equal(theirs[0].mu, mine.state_tree()["0"]["mu"])
            assert int(theirs[0].count) == mine.count
    _assert_trees_equal(jt.opt_lrnn[0].mu, tr.opt_lrnn.state_tree()["0"]["mu"])
    assert int(jt.opt_lrnn[0].count) == tr.opt_lrnn.count == 3

    # ... and the JAX trainer's own files resume the port
    jt.output_path = str(tmp_path / "jax")
    jt.save_checkpoints(5)
    back = _trainer(rig, seed=2)
    assert back.load_checkpoints(str(tmp_path / "jax")) == [1, 2, 3]
    _assert_trees_equal(export_jax_params(back.model)[0], params)
    for k in range(2):
        _assert_trees_equal(back.opt_flow[k].state_tree()["0"]["mu"],
                            tr.opt_flow[k].state_tree()["0"]["mu"])
    assert back.opt_lrnn.count == 3
