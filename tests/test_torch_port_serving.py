"""The port's streaming service (cwfa_tpu_torch.engine.serving) on the CPU:
the nine cases of tests/test_serving.py against the port's engine, with a
torch fake reconstructor, plus the wire-dtype whitelist of submit (uint8,
uint16 and float32 cross as they are; float16, float64 and int32 are
converted to float32 on the host).  The real-pipeline case also holds the
port's service output to the JAX package's service output, f32, within
1e-4 of max|ref|."""

import os
import time

import numpy as np
import pytest
import torch

import cwfa_tpu_torch.data.tiff as tiffmod
from cwfa_tpu_torch.data.tiff import read_tiff_stack, write_tiff_stack
from cwfa_tpu_torch.engine.serving import (ReconstructionService,
                                           serve_directory)


class FakeRecon:
    """volume = the frame's mean, broadcast (checkable); records the dtype
    and device of every batch it is given."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = 0
        self.batches = []

    def __call__(self, frames):
        self.calls += 1
        self.batches.append(frames.clone())
        m = frames.mean(dim=(1, 2))
        return m[:, None, None, None].expand(frames.shape[0], 2, 4, 4) + 0.0


def test_service_batching_padding_and_order():
    fr = FakeRecon()
    got = []
    svc = ReconstructionService(fr, batch_size=4, img_hw=(8, 8),
                                on_volume=lambda i, v: got.append((i, v)))
    for i in range(10):
        svc.submit(np.full((8, 8), float(i), np.float32), frame_id=i)
    out = svc.drain()
    assert fr.calls == 3                     # 4 + 4 + 2 padded to 4
    assert out["frames"] == 10 and out["batches"] == 3
    assert out["padded_frames"] == 2
    assert [i for i, _ in got] == list(range(10))
    for i, v in got:
        assert isinstance(v, np.ndarray)
        np.testing.assert_allclose(v, np.full((2, 4, 4), float(i)),
                                   rtol=1e-6)
    # the padding is zeros, the batches f32
    assert all(b.dtype == torch.float32 and b.shape == (4, 8, 8)
               for b in fr.batches)
    assert torch.equal(fr.batches[2][2:], torch.zeros(2, 8, 8))


def test_serve_directory_roundtrip(tmp_path):
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    rng = np.random.RandomState(0)
    frames = [rng.rand(8, 8).astype(np.float32) for _ in range(3)]
    for i, f in enumerate(frames):
        write_tiff_stack(str(in_dir / f"frame_{i}.tif"), f)
    out = serve_directory(FakeRecon(), batch_size=2, img_hw=(8, 8),
                          in_dir=str(in_dir), out_dir=str(out_dir),
                          verbose=False)
    assert out["frames"] == 3 and out["writer_tail_seconds"] >= 0.0
    vols = sorted(os.listdir(out_dir))
    assert vols == [f"XLFM_stack_frame_{i}.tif" for i in range(3)]
    for i, name in enumerate(vols):
        v = read_tiff_stack(str(out_dir / name), dtype=None)
        assert v.shape == (2, 4, 4) and v.dtype == np.float32
        np.testing.assert_allclose(v, frames[i].mean(), rtol=1e-6)


def test_watch_mode_quarantines_corrupt_file(tmp_path, monkeypatch, capsys):
    """A permanently unreadable frame file is retried max_retries times,
    then quarantined; the good frames still come through."""
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    with open(in_dir / "a_bad.tif", "wb") as f:
        f.write(b"II*\x00not a real tiff body")
    real_read = tiffmod.read_tiff_stack
    bad_attempts = [0]

    def counting_read(path, pages=None, **kw):
        if path.endswith("a_bad.tif"):
            bad_attempts[0] += 1
            if bad_attempts[0] == 3:
                rng = np.random.RandomState(1)
                write_tiff_stack(str(in_dir / "frame_0.tif"),
                                 rng.rand(8, 8).astype(np.float32))
        return real_read(path, pages, **kw)

    monkeypatch.setattr(tiffmod, "read_tiff_stack", counting_read)
    out = serve_directory(FakeRecon(), batch_size=1, img_hw=(8, 8),
                          in_dir=str(in_dir), out_dir=str(out_dir),
                          poll_seconds=0.01, limit=1, verbose=False,
                          max_retries=3)
    assert out["frames"] == 1
    assert len(os.listdir(out_dir)) == 1
    assert bad_attempts[0] == 3
    assert "quarantined" in capsys.readouterr().out


def test_flush_partial_emits_waiting_frames():
    fr = FakeRecon()
    got = []
    svc = ReconstructionService(fr, batch_size=4, img_hw=(8, 8),
                                on_volume=lambda i, v: got.append(i))
    svc.submit(np.zeros((8, 8), np.float32), frame_id="a")
    assert got == []
    svc.flush_partial()
    assert got == ["a"]
    assert svc.stats.padded_frames == 3


def test_writer_failure_surfaces(tmp_path, monkeypatch):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(4):
        write_tiff_stack(str(in_dir / f"f{i}.tif"),
                         np.zeros((8, 8), np.float32))

    def boom(path, stack):
        raise OSError("disk full")

    monkeypatch.setattr(tiffmod, "write_tiff_stack", boom)
    with pytest.raises(RuntimeError, match="volume writer failed"):
        serve_directory(FakeRecon(), batch_size=2, img_hw=(8, 8),
                        in_dir=str(in_dir), out_dir=str(tmp_path / "out"),
                        verbose=False)


@pytest.fixture
def one_thread():
    """Bit-equal comparisons run on one thread (multithreaded CPU ops can
    round one chunk differently between two runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_service_with_real_pipeline(tmp_path, one_thread):
    """The port's reconstructor (small rig, f32, deterministic, the JAX
    package's weights) through the service equals the direct batched call
    to the bit, and the JAX package's service within 1e-4 of max|ref|."""
    import jax
    import jax.numpy as jnp
    from cwfa_tpu.config import CWFAConfig as JConfig
    from cwfa_tpu.data.stats import DatasetStatistics as JStats
    from cwfa_tpu.data.views import make_view_indices as jvidx
    from cwfa_tpu.engine.inference import XLFMReconstructor as JRecon
    from cwfa_tpu.engine.serving import ReconstructionService as JService
    from cwfa_tpu.models.cwfa_model import CWFAModel as JModel

    from cwfa_tpu_torch.config import CWFAConfig
    from cwfa_tpu_torch.data.stats import DatasetStatistics
    from cwfa_tpu_torch.data.views import make_view_indices
    from cwfa_tpu_torch.engine.inference import XLFMReconstructor
    from cwfa_tpu_torch.engine.jax_params import load_jax_params
    from cwfa_tpu_torch.models.cwfa_model import CWFAModel

    nd, view, img = 8, 32, 96
    kw = dict(n_depths=nd, volume_side_size=view, n_lenslets=4,
              INN_max_down_steps=2, INN_n_blocks=2, INN_internal_chans=4,
              INN_cond_chans=2)
    jmodel = JModel.build(JConfig(**kw).decode_lrs())
    params, mstate = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    coords = np.array([[24, 24], [24, 72], [72, 24], [72, 72]])
    caches = [rng.randn(1, nd // 2 ** (k + 1), view, view).astype(np.float32)
              for k in range(jmodel.n_flow_steps + 1)]
    stats = (10.0, 5.0, 10.0, 5.0, 1.0, 0.5)
    jrecon = JRecon(jmodel, params, mstate, JStats(*stats),
                    jvidx(coords, (img, img), (view, view)),
                    [jnp.asarray(c) for c in caches], deterministic=True)
    model = CWFAModel.build(CWFAConfig(**kw).decode_lrs(),
                            torch.Generator().manual_seed(0))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, mstate))
    recon = XLFMReconstructor(model, DatasetStatistics(*stats),
                              make_view_indices(coords, (img, img),
                                                (view, view)),
                              caches, device="cpu", deterministic=True)

    frames = (rng.rand(3, img, img) * 100).astype(np.float32)
    got, want = {}, {}
    for svc_cls, r, sink in ((ReconstructionService, recon, got),
                             (JService, jrecon, want)):
        svc = svc_cls(r, batch_size=2, img_hw=(img, img),
                      on_volume=lambda i, v, s=sink: s.__setitem__(
                          i, np.asarray(v)))
        for i in range(3):
            svc.submit(frames[i], frame_id=i)
        assert svc.drain()["frames"] == 3
    direct = recon(frames[:2]).numpy()
    np.testing.assert_array_equal(got[0], direct[0])
    np.testing.assert_array_equal(got[1], direct[1])
    pad = np.concatenate([frames[2:], np.zeros_like(frames[:1])])
    np.testing.assert_array_equal(got[2], recon(pad).numpy()[0])
    for i in range(3):
        ref = want[i]
        assert np.abs(got[i] - ref).max() <= 1e-4 * np.abs(ref).max()


def test_pending_age_tracks_buffer():
    svc = ReconstructionService(FakeRecon(), batch_size=4, img_hw=(8, 8))
    assert svc.pending == 0 and svc.pending_age() == 0.0
    svc.submit(np.zeros((8, 8), np.float32))
    assert svc.pending == 1
    time.sleep(0.02)
    assert svc.pending_age() >= 0.02
    svc.flush_partial()
    assert svc.pending == 0 and svc.pending_age() == 0.0


def test_barrier_fetch_mode_segments_and_no_full_fetch():
    fr = FakeRecon()
    seen = []
    svc = ReconstructionService(fr, batch_size=4, img_hw=(8, 8),
                                on_volume=lambda i, v: seen.append((i, v)),
                                fetch="barrier")
    for i in range(8):
        svc.submit(np.full((8, 8), float(i), np.float32), frame_id=i)
    out = svc.drain()
    assert out["frames"] == 8
    assert out["fetch_bytes"] == 8 * 8
    assert [i for i, _ in seen] == list(range(8))
    assert all(isinstance(v, torch.Tensor) for _, v in seen)
    assert all(out[k] >= 0.0 for k in
               ("submit_seconds", "dispatch_seconds", "parse_seconds"))
    with pytest.raises(ValueError):
        ReconstructionService(fr, 4, (8, 8), fetch="bogus")


def test_serve_directory_barrier_writes_nothing(tmp_path):
    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(in_dir)
    for i in range(3):
        write_tiff_stack(os.path.join(in_dir, f"f_{i}.tif"),
                         np.full((8, 8), float(i), np.float32))
    out = serve_directory(FakeRecon(), 2, (8, 8), in_dir, out_dir, limit=3,
                          verbose=False, fetch="barrier")
    assert out["frames"] == 3
    assert out["parse_seconds"] >= 0.0
    assert os.listdir(out_dir) == []


@pytest.mark.parametrize("dtype,wire_bytes", [
    (np.uint8, 1), (np.uint16, 2), (np.float32, 4),
    (np.float16, 4), (np.float64, 4), (np.int32, 4)])
def test_submit_dtype_whitelist(dtype, wire_bytes):
    """uint8 / uint16 / float32 cross as they are (uint16 counts 2 bytes a
    pixel in feed_bytes); any other dtype is converted to float32 on the
    host.  Every frame reaches the reconstructor as exact float32."""
    fr = FakeRecon()
    svc = ReconstructionService(fr, batch_size=2, img_hw=(4, 8))
    vals = np.array([0, 1, 200, 255], np.float64)
    if dtype in (np.uint16, np.int32, np.float32, np.float64):
        vals = np.array([0, 1, 40000, 65535], np.float64)
    frame = np.tile(vals[:, None], (1, 8)).astype(dtype)
    svc.submit(frame, frame_id="x")
    assert svc.stats.feed_bytes == 4 * 8 * wire_bytes
    kept = svc._buf[0][1]
    if dtype in (np.uint8, np.float32):
        assert kept.dtype == torch.from_numpy(frame).dtype
    elif dtype == np.uint16:
        assert kept.dtype == torch.int16     # uint16 bits, widened later
    else:
        assert kept.dtype == torch.float32
    svc.drain()
    np.testing.assert_array_equal(fr.batches[0][0].numpy(),
                                  frame.astype(np.float32))
    assert fr.batches[0].dtype == torch.float32


def test_wrong_shape_raises():
    svc = ReconstructionService(FakeRecon(), batch_size=2, img_hw=(8, 8))
    with pytest.raises(ValueError, match="frame shape"):
        svc.submit(np.zeros((4, 4), np.float32))
    assert svc.pending == 0 and svc.stats.frames_in == 0
