"""The port's msgpack codec (cwfa_tpu_torch.engine.msgpack_io) against
flax.serialization and the msgpack package, in both directions.

Trees of numpy arrays pack to the bytes flax writes; what either side
writes, the other reads back to equal trees (arrays: same dtype, shape and
values; bfloat16 as torch.bfloat16 tensors on the port's side).
"""

import numpy as np
import jax.numpy as jnp
import msgpack
import pytest
import torch
from flax import serialization
from hypothesis import given, settings, strategies as st

from cwfa_tpu_torch.engine import msgpack_io

DTYPES = (np.float32, np.float16, np.int8, np.int32, np.int64, np.uint16,
          np.bool_, np.uint8, np.float64)
INTS = (0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2 ** 31, -2 ** 31 - 1, -2 ** 63)


def _tree(rng):
    return {
        "arrays": {np.dtype(d).name: (rng.randn(3, 5) * 50).astype(d)
                   for d in DTYPES},
        "zero_d": np.array(7, np.int32),
        "empty": np.zeros((0, 4), np.float32),
        "scalars": [np.float32(1.5), np.int64(-3), np.uint16(9),
                    np.bool_(True), np.float64(2.25)],
        "ints": list(INTS),
        "misc": [None, True, False, 0.5, -1e300, "", "x" * 31, "y" * 32,
                 "z" * 300, "é", b"", b"\x00" * 300, complex(1.5, -2)],
        "nested": {"0": [{"a": [1, [2, [3]]]}], "1": {}, "10": [], "2": 3},
        "long_list": list(range(70000)),
    }


def assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), type(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got == want
    else:
        assert type(got) is type(want) and got == want, (got, want)


def test_packs_the_bytes_flax_writes():
    tree = _tree(np.random.RandomState(0))
    assert msgpack_io.packb(tree) == serialization.msgpack_serialize(tree)


def test_reads_what_flax_writes():
    tree = _tree(np.random.RandomState(1))
    got = msgpack_io.unpackb(serialization.msgpack_serialize(tree))
    assert_tree_equal(got, tree)
    assert got["arrays"]["float32"].flags.writeable


def test_flax_reads_what_the_port_writes():
    tree = _tree(np.random.RandomState(2))
    assert_tree_equal(serialization.msgpack_restore(msgpack_io.packb(tree)),
                      tree)


def test_plain_msgpack_both_ways():
    # keys in sorted order: the port writes them so, as flax does
    tree = {"a": [1, -2, 3.5, None, True, "s", b"b"], "m": {"k": {"j": []}},
            "n": INTS[:10]}
    want = msgpack.unpackb(msgpack.packb(tree), raw=False)
    assert msgpack_io.packb(tree) == msgpack.packb(tree)
    assert msgpack_io.unpackb(msgpack.packb(tree)) == want
    assert msgpack.unpackb(msgpack_io.packb(tree), raw=False) == want
    # float32 on the wire (flax never writes it) reads as a Python float
    f32 = msgpack.packb(1.25, use_single_float=True)
    assert f32[0] == 0xCA and msgpack_io.unpackb(f32) == 1.25


def test_bfloat16_both_ways():
    bf = np.asarray(jnp.linspace(-3, 3, 12, dtype=jnp.bfloat16).reshape(3, 4))
    data = serialization.msgpack_serialize({"w": bf, "s": bf[0, 0]})
    got = msgpack_io.unpackb(data)
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (3, 4)
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  bf.astype(np.float32))
    assert got["s"].dtype == torch.bfloat16 and got["s"].shape == ()
    # a bfloat16 scalar comes back as a 0-d tensor, which writes as a 0-d
    # array (ext 1, not ext 3); the array writes back to flax's bytes
    assert msgpack_io.packb({"w": got["w"]}) == \
        serialization.msgpack_serialize({"w": bf})
    back = serialization.msgpack_restore(msgpack_io.packb(got))
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(back["w"], bf)


def test_torch_tensors_pack_as_their_arrays():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert msgpack_io.packb({"t": t}) == serialization.msgpack_serialize(
        {"t": t.numpy()})


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays above the chunk size are split as flax splits them (the
    limit lowered on both sides so a small array crosses it)."""
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10),
            "small": np.ones(3, np.int8)}
    data = serialization.msgpack_serialize(tree)
    assert msgpack_io.packb(tree) == data
    assert_tree_equal(msgpack_io.unpackb(data), tree)
    assert_tree_equal(serialization.msgpack_restore(msgpack_io.packb(tree)),
                      tree)


def test_state_dict_lists_round_trip():
    tree = {"flow": [{"blocks": [np.ones(2), np.zeros(2)]}], "x": {"y": 1}}
    sd = msgpack_io.to_state_dict(tree)
    assert_tree_equal(sd, serialization.to_state_dict(tree))
    assert_tree_equal(msgpack_io.restore_lists(sd), tree)
    assert msgpack_io.restore_lists({"1": 1, "2": 2}) == {"1": 1, "2": 2}
    assert msgpack_io.restore_lists({}) == {}


@pytest.mark.parametrize("data", [b"", b"\x92\x01", b"\xc1", b"\x01\x02",
                                  b"\xc7\x03\x09abc"])
def test_malformed_data_raises(data):
    with pytest.raises(ValueError):
        msgpack_io.unpackb(data)


_leaf = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40),
    st.binary(max_size=40),
    st.builds(lambda s, d: (np.arange(int(np.prod(s)) if s else 1)
                            .astype(d).reshape(s)),
              st.lists(st.integers(0, 3), max_size=3).map(tuple),
              st.sampled_from(DTYPES)))
_trees = st.recursive(
    _leaf, lambda kids: st.one_of(
        st.lists(kids, max_size=5),
        st.dictionaries(st.text(max_size=8), kids, max_size=5)),
    max_leaves=20)


@settings(max_examples=60, deadline=None)
@given(_trees)
def test_property_nested_trees_round_trip_with_flax(tree):
    data = msgpack_io.packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    assert_tree_equal(msgpack_io.unpackb(data),
                      serialization.msgpack_restore(data))
