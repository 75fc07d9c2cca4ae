"""The port's TIFF I/O (cwfa_tpu_torch.data.tiff / native_tiff) against the
JAX package's (cwfa_tpu.data.tiff), in both directions, and on damaged
files: the port reads through the same native C++ runtime, built from
native/tiffio.cpp into build/cwfa_tpu_torch/, and has no PIL fallback, so a
file its reader does not cover, or a corrupt one, raises ValueError."""

import os
import struct

import numpy as np
import pytest
from PIL import Image

import cwfa_tpu.data.tiff as jtiff
from cwfa_tpu_torch.data import native_tiff, tiff

DTYPES = (np.uint8, np.uint16, np.float32)


def _stack(dtype, pages=3, h=6, w=9, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.float32:
        return (rng.randn(pages, h, w) * 100).astype(dtype)
    return rng.randint(0, np.iinfo(dtype).max, (pages, h, w)).astype(dtype)


def test_library_builds_into_build_dir_not_native():
    so = native_tiff.library_path()
    assert so.parent == native_tiff.ROOT / "build" / "cwfa_tpu_torch"
    native_tiff._load_library()
    assert so.exists()
    assert sorted(os.listdir(native_tiff.ROOT / "native")) == [
        "Makefile", "libcwfa_tiffio.so", "tiffio.cpp"]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_port_reads_what_jax_writes(tmp_path, dtype):
    want = _stack(dtype)
    path = str(tmp_path / "j.tif")
    jtiff.write_tiff_stack(path, want)
    got = tiff.read_tiff_stack(path, dtype=None)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tiff.read_tiff_stack(path),
                                  want.astype(np.float32))
    assert tiff.count_tiff_pages(path) == jtiff.count_tiff_pages(path) == 3


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_jax_reads_what_the_port_writes(tmp_path, dtype):
    want = _stack(dtype, seed=1)
    path = str(tmp_path / "t.tif")
    tiff.write_tiff_stack(path, want)
    got = jtiff.read_tiff_stack(path, dtype=None)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # PIL, the JAX package's other reader, reads the file too
    with Image.open(path) as im:
        assert im.n_frames == 3
        im.seek(2)
        np.testing.assert_array_equal(np.asarray(im), want[2])


@pytest.mark.parametrize("pages", [[2, 0], [1], [0, 5, 2, -1]])
def test_page_selection_matches_jax(tmp_path, pages):
    path = str(tmp_path / "p.tif")
    jtiff.write_tiff_stack(path, _stack(np.uint16, pages=4))
    np.testing.assert_array_equal(tiff.read_tiff_stack(path, pages),
                                  jtiff.read_tiff_stack(path, pages))


def test_no_page_selected_raises(tmp_path):
    path = str(tmp_path / "p.tif")
    tiff.write_tiff_stack(path, _stack(np.uint8))
    with pytest.raises(ValueError, match="no pages selected"):
        tiff.read_tiff_stack(path, [7])


def test_2d_and_other_dtypes_write_as_jax_does(tmp_path):
    a, b = str(tmp_path / "a.tif"), str(tmp_path / "b.tif")
    frame = _stack(np.float32)[0].astype(np.float64)
    tiff.write_tiff_stack(a, frame)
    jtiff.write_tiff_stack(b, frame)
    got = tiff.read_tiff_stack(a, dtype=None)
    assert got.shape == (1, 6, 9) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jtiff.read_tiff_stack(b, dtype=None))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_compressed_file_raises_value_error_naming_it(tmp_path):
    """A file the JAX package reads only through PIL (compressed): the port
    raises and says what the file is."""
    path = str(tmp_path / "lzw.tif")
    Image.fromarray(_stack(np.uint16)[0]).save(path, compression="tiff_lzw")
    assert jtiff.read_tiff_stack(path).shape == (1, 6, 9)
    with pytest.raises(ValueError, match="compressed"):
        tiff.read_tiff_stack(path)


def test_rgb_file_raises_value_error(tmp_path):
    path = str(tmp_path / "rgb.tif")
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match="multi-sample"):
        tiff.read_tiff_stack(path)


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        tiff.read_tiff_stack(str(tmp_path / "none.tif"))


def _expect_value_error_or_array(path):
    """A damaged file raises ValueError or reads as a real array."""
    try:
        out = tiff.read_tiff_stack(path)
    except ValueError:
        return
    assert isinstance(out, np.ndarray) and out.ndim == 3 and out.size > 0


def _valid(tmp_path, pages=3):
    path = str(tmp_path / "ok.tif")
    tiff.write_tiff_stack(path, _stack(np.float32, pages=pages))
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", ["junk", "magic", "trunc", "flip"])
def test_corrupt_files_raise_value_error(tmp_path, case):
    """The damaged files of tests/test_tiff_fuzz.py."""
    rng = np.random.RandomState({"junk": 42, "magic": 7, "trunc": 0,
                                 "flip": 3}[case])
    data = _valid(tmp_path)
    if case == "junk":
        bodies = [rng.bytes(n) for n in (0, 1, 7, 64, 512, 4096)]
    elif case == "magic":
        bodies = [b"II*\x00" + rng.bytes(n) for n in (4, 16, 200, 2048)]
    elif case == "trunc":
        bodies = [data[:max(1, int(len(data) * f))]
                  for f in (0.02, 0.1, 0.3, 0.6, 0.9, 0.99)]
    else:
        bodies = []
        for _ in range(12):
            mut = bytearray(data)
            for _ in range(4):
                mut[rng.randint(256)] ^= 1 << rng.randint(8)
            for _ in range(4):
                mut[rng.randint(len(mut))] ^= 1 << rng.randint(8)
            bodies.append(bytes(mut))
    for i, body in enumerate(bodies):
        path = str(tmp_path / f"{case}{i}.tif")
        with open(path, "wb") as f:
            f.write(body)
        _expect_value_error_or_array(path)
    if case in ("junk", "trunc"):
        with pytest.raises(ValueError):
            tiff.read_tiff_stack(str(tmp_path / f"{case}0.tif"))


def _ifd_tiff(dim_type, dim_val):
    entries = [(256, dim_type, 1, dim_val), (257, dim_type, 1, dim_val),
               (258, 3, 1, 16), (259, 3, 1, 1), (262, 3, 1, 1),
               (273, 4, 1, 200), (277, 3, 1, 1), (278, dim_type, 1, dim_val),
               (279, 4, 1, 8), (339, 3, 1, 1)]
    buf = struct.pack("<2sHI", b"II", 42, 8) + struct.pack("<H", len(entries))
    for tag, typ, cnt, val in entries:
        buf += struct.pack("<HHII", tag, typ, cnt, val)
    return (buf + struct.pack("<I", 0)).ljust(200, b"\0") + b"\x01\x02" * 4


@pytest.mark.parametrize("dim_type,dim_val", [(4, 65536), (3, 65536), (4, 0)])
def test_absurd_dimension_claims_raise(tmp_path, dim_type, dim_val):
    path = str(tmp_path / "absurd.tif")
    with open(path, "wb") as f:
        f.write(_ifd_tiff(dim_type, dim_val))
    with pytest.raises(ValueError, match="geometry"):
        tiff.read_tiff_stack(path)


def _two_ifds(second_entries, next_of_second=0):
    """A valid 2x2 uint16 page whose IFD links to a second IFD of
    ``second_entries``."""
    def ifd(entries, nxt):
        out = struct.pack("<H", len(entries))
        for e in entries:
            out += struct.pack("<HHII", *e)
        return out + struct.pack("<I", nxt)
    first = [(256, 4, 1, 2), (257, 4, 1, 2), (258, 3, 1, 16),
             (273, 4, 1, 8), (279, 4, 1, 8)]
    second_at = 16 + 2 + 12 * len(first) + 4
    return (struct.pack("<2sHI", b"II", 42, 16) + b"\x01\x00" * 4
            + ifd(first, second_at)
            + ifd(second_entries, next_of_second))


@pytest.mark.parametrize("case", ["count0", "loop", "huge_count"])
def test_ifd_walk_faults_of_the_original_raise(tmp_path, case):
    """Files on which native/tiffio.cpp crashes (a tag of count 0: a read
    of vals[0] of an empty vector), loops without end (an IFD chain back to
    itself) or allocates without bound: the port's copy of the source
    raises ValueError.  (Not run through the JAX reader, which would take
    this process down.)"""
    first_len = 16 + 2 + 12 * 5 + 4
    second = {"count0": ([(256, 4, 0, 2)], 0),
              "loop": ([(256, 4, 1, 2)], first_len),
              "huge_count": ([(273, 4, 2 ** 31, 8)], 0)}[case]
    path = str(tmp_path / f"{case}.tif")
    with open(path, "wb") as f:
        f.write(_two_ifds(*second))
    with pytest.raises(ValueError):
        tiff.read_tiff_stack(path)


def test_prefetching_reader_matches_and_fails_cleanly(tmp_path):
    want = _stack(np.uint16, pages=4)
    path = str(tmp_path / "pf.tif")
    jtiff.write_tiff_stack(path, want)
    with native_tiff.PrefetchingTiffReader(path, [3, 1]) as it:
        got = list(it)
    assert [i for i, _ in got] == [3, 1]
    np.testing.assert_array_equal(np.stack([f for _, f in got]),
                                  want[[3, 1]])
    with pytest.raises(ValueError, match="no pages selected"):
        native_tiff.PrefetchingTiffReader(path, [9])
    data = bytearray(open(path, "rb").read())
    rng = np.random.RandomState(11)
    for i in range(6):
        mut = bytearray(data)
        for _ in range(5):
            mut[rng.randint(len(mut))] ^= 1 << rng.randint(8)
        p = str(tmp_path / f"pf{i}.tif")
        with open(p, "wb") as f:
            f.write(bytes(mut))
        try:
            with native_tiff.PrefetchingTiffReader(p) as it:
                for _, frame in it:
                    assert frame.size > 0
        except ValueError:
            pass


def test_background_writer_writes_and_surfaces_failures(tmp_path,
                                                        monkeypatch):
    w = tiff.BackgroundTiffWriter(maxsize=2)
    vols = [_stack(np.float32, seed=s).astype(np.float64) for s in range(3)]
    for i, v in enumerate(vols):
        w.put(str(tmp_path / f"v{i}.tif"), v, dtype=np.float32)
    w.close()
    for i, v in enumerate(vols):
        np.testing.assert_array_equal(
            jtiff.read_tiff_stack(str(tmp_path / f"v{i}.tif")),
            v.astype(np.float32))

    import threading
    import time
    gate, calls = threading.Event(), []

    def boom(path, stack):
        calls.append(path)
        gate.wait(10)
        raise OSError("disk full")

    monkeypatch.setattr(tiff, "write_tiff_stack", boom)
    w = tiff.BackgroundTiffWriter(maxsize=2)
    w.put("a", vols[0])
    w.put("b", vols[1])                      # queued behind the failure
    gate.set()
    for _ in range(500):
        if w.errors:
            break
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="volume writer failed"):
        w.put("c", vols[2])                  # raised on the next put ...
    with pytest.raises(RuntimeError, match="volume writer failed"):
        w.close()                            # ... and on close
    assert calls == ["a"]                    # the later jobs drained
