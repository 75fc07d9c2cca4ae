"""The port's process bootstrap and batch placement (``cwfa_tpu_torch.
parallel``) on the CPU: ``initialize_from_env`` with no environment gives
False; two real processes meet over gloo through ``CWFA_COORDINATOR``; rank
0 is primary; ``host_local_indices`` equals JAX's split; ``assemble_global``
/ ``global_batch_array`` / ``to_host`` hold a batch's rows where they belong
(position-weighted checksums, as ``tests/_dist_worker.py`` uses); and the
placement's per-leaf fallbacks of ``tests/test_sharding.py:126-147``: a
batch that does not divide the ``data`` axis is replicated, a 0-d or
non-array leaf passes through; a trainer on a ``space`` mesh takes its
rank's rows.  The two ranks run in
``tests/_torch_port_dist_worker.py``, which imports no JAX."""

import numpy as np
import pytest
import torch

from cwfa_tpu.parallel.distributed import host_local_indices as jax_split

from cwfa_tpu_torch.parallel import distributed as D
from cwfa_tpu_torch.parallel import mesh as M

from _torch_port_dist_worker import run_ranks


@pytest.fixture(scope="module")
def ranks():
    return run_ranks("distributed", n=2)


def test_initialize_without_environment_is_a_no_op(monkeypatch):
    for var in ("CWFA_DISTRIBUTED", "CWFA_COORDINATOR", *D.TORCHRUN_VARS):
        monkeypatch.delenv(var, raising=False)
    assert D.initialize_from_env("cpu") is False
    assert D.initialize_from_env("cuda") is False
    assert D.is_primary() and D.world_size() == 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_bootstrap_in_one_process(monkeypatch, device):
    """One process, no mesh: the device as asked (an index-less ``cuda``
    stays so, the current card), no mesh, nothing touched; a mesh of 2
    exits naming both sizes and the launch line."""
    for var in ("CWFA_DISTRIBUTED", "CWFA_COORDINATOR", *D.TORCHRUN_VARS):
        monkeypatch.delenv(var, raising=False)
    assert D.cli_bootstrap(device, "serve") == (torch.device(device), None)
    with pytest.raises(SystemExit, match="mesh of 2 devices.*world size of "
                                         "1.*torchrun --nproc_per_node 2 -m "
                                         "cwfa_tpu_torch.cli.serve"):
        D.cli_bootstrap(device, "serve", n_data=2)


def test_auto_without_torchrun_raises(monkeypatch):
    monkeypatch.setenv("CWFA_DISTRIBUTED", "auto")
    for var in ("CWFA_COORDINATOR", *D.TORCHRUN_VARS):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        D.initialize_from_env("cpu")


@pytest.mark.parametrize("n, p", [(n, p) for n in (0, 1, 3, 4, 7, 8, 13)
                                  for p in (1, 2, 3, 4)])
def test_host_local_indices_equal_jax(n, p):
    ours = [D.host_local_indices(n, i, p) for i in range(p)]
    assert ours == [jax_split(n, i, p) for i in range(p)]
    assert sum(ours, []) == list(range(n))


class _SpaceMesh:
    """Place 1 of a (1, 2) mesh, without the two processes it needs."""
    mesh_dim_names = ("data", "space")
    device_type = "cpu"

    def size(self, i):
        return (1, 2)[i]

    def get_local_rank(self, name):
        return {"data": 0, "space": 1}[name]

    def get_group(self, name):
        return None


def test_space_axis_names_the_next_slice(monkeypatch):
    """The space axis serves and trains: a (1, 2) mesh asks for its two
    processes and ``batch_sharding(with_space=True)`` places a leaf's second
    half of rows on place 1 (all of them where ``space_rows`` does not split
    H: H odd, or a rank's rows not a multiple of ``row_multiple``); a
    trainer on it takes place 1's rows of each step, at the UNet's multiple
    (its replica check, which needs the two processes, aside)."""
    from cwfa_tpu_torch.config import CWFAConfig
    from cwfa_tpu_torch.engine.trainer import CWFATrainer
    from cwfa_tpu_torch.models.cwfa_model import CWFAModel

    with pytest.raises(ValueError, match="needs 2 processes"):
        M.make_mesh(1, 2)
    place = M.batch_sharding(_SpaceMesh(), with_space=True).place
    x = np.arange(2 * 3 * 8 * 5, dtype=np.float32).reshape(2, 3, 8, 5)
    np.testing.assert_array_equal(place(x).numpy(), x[:, :, 4:])
    assert tuple(place(x[:, :, :7]).shape) == (2, 3, 7, 5)
    by4 = M.batch_sharding(_SpaceMesh(), with_space=True, row_multiple=4)
    np.testing.assert_array_equal(by4.place(x).numpy(), x[:, :, 4:])
    by8 = M.batch_sharding(_SpaceMesh(), with_space=True, row_multiple=8)
    assert tuple(by8.place(x).shape) == x.shape
    assert tuple(M.batch_sharding(_SpaceMesh()).place(x).shape) == x.shape
    monkeypatch.setattr(CWFATrainer, "check_replicas", lambda self: None)
    cfg = CWFAConfig(n_depths=8, volume_side_size=16, n_lenslets=4,
                     INN_max_down_steps=3, INN_n_blocks=2,
                     INN_internal_chans=8, INN_cond_chans=4)
    tr = CWFATrainer(CWFAModel.build(cfg, torch.Generator().manual_seed(0)),
                     None, {}, device="cpu", mesh=_SpaceMesh())
    shard, rows = tr.step_shards(2)
    assert shard is None
    assert (rows.index, rows.size, rows.start, rows.stop) == (1, 2, 8, 16)
    assert tr.model.lrnn_spec.unet.depth == 3 and rows.rows % 4 == 0


def test_two_process_rendezvous(ranks):
    assert [r["world"] for r in ranks] == [2, 2]
    assert [r["primary"] for r in ranks] == [True, False]
    assert ranks[0]["mesh"] == (2, 1)


def test_placement_and_gather_hold_the_rows(ranks):
    rng = np.random.RandomState(7)
    x = rng.randn(4, 3, 8, 8).astype(np.float32)
    w = (np.arange(x.size, dtype=np.float64).reshape(x.shape) % 13
         ).astype(np.float32)
    want = [(x.astype(np.float64) ** 2).sum(),
            (x.astype(np.float64) * w).sum()]
    for r in ranks:
        np.testing.assert_allclose(r["checksums"], want, rtol=1e-12)
        np.testing.assert_array_equal(r["gathered"], x)
        np.testing.assert_array_equal(r["gathered_local"], x)
        np.testing.assert_array_equal(r["ragged"], [0.0, 0.0, 1.0])


def test_placement_fallbacks(ranks):
    for r in ranks:
        assert r["places"] == {"(4, 3, 8, 8)": (2, 3, 8, 8),
                               "(3, 3, 8, 8)": (3, 3, 8, 8),
                               "(1, 3, 7, 8)": (1, 3, 7, 8)}
        assert r["places_rep"] == (4, 3)
        assert r["scalar"] == np.float32(2.0) and r["static"] == 5
