"""The msgpack codec of the JAX package's checkpoints, in Python and numpy.

``cwfa_tpu`` writes its checkpoints and mean-volume caches with
``flax.serialization.msgpack_serialize`` and reads them with
``msgpack_restore`` (``cwfa_tpu/engine/checkpoints.py:65-68,119-121``,
``trainer.py:401-428``).  Neither flax nor the ``msgpack`` package is
installed beside the card, so the port carries its own codec of that
format:

- msgpack's types: nil, bool, int (every width), float32 / float64, str,
  bin, array (read back as a list), map (a dict);
- ext 1, an ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
  ext 3, a numpy scalar, the same at 0-d; ext 2, a complex, the msgpack of
  ``(real, imag)``;
- dtype ``"bfloat16"`` (no numpy dtype without ``ml_dtypes``) is read as a
  ``torch.bfloat16`` tensor, and a bfloat16 tensor is written under that
  name (a bfloat16 scalar reads as a 0-d tensor and writes back as a 0-d
  array); every other torch tensor is written as its numpy array;
- an array above 2^30 bytes is split, as flax splits it, into a map
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of flat chunks, and such a map is put back together on reading.

``packb`` chooses the encodings msgpack's packer chooses (the shortest
one) and writes a map's keys in sorted order, as flax's copy of the tree
has them, so a tree of numpy arrays packs to the bytes flax writes.
``to_state_dict`` turns lists into ``{"0": ..., "1": ...}`` maps, as flax's
``to_state_dict`` does before writing; ``restore_lists`` is its inverse for
maps whose keys are exactly "0".."n-1".
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30          # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# --------------------------------------------------------------------- pack
def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple, what: str):
    """A header: the fix form below fix_max, else the 8- / 16- / 32-bit
    length forms in ``codes`` (None where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += bytes((codes[0], n))
    elif n < 2 ** 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 2 ** 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"{what} of {n} entries or bytes is too long for "
                         "msgpack")


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                              (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if v < hi:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} is too large for msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                              (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= lo:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} is too small for msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9), "ext")
    out.append(code)
    out += data


def _array_parts(x):
    """(shape, dtype name, C-order bytes) of an ndarray or a tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return tuple(int(d) for d in x.shape), x.dtype.name, x.tobytes("C")


def _chunk(x) -> dict:
    """flax's ``_chunk``: a big array as flat chunks of <= 2^30 bytes."""
    flat = x.reshape(-1)
    size = max(1, MAX_CHUNK_SIZE // flat.element_size()
               if isinstance(flat, torch.Tensor)
               else MAX_CHUNK_SIZE // flat.dtype.itemsize)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _nbytes(x) -> int:
    return (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
            else x.nbytes)


def _pack(out: bytearray, x):
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str")
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6), "bin")
        out += b
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(out, _chunk(x))
        else:
            _pack_ext(out, EXT_NDARRAY, packb(_array_parts(x)))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, packb(_array_parts(np.asarray(x))))
    elif isinstance(x, complex):
        _pack_ext(out, EXT_COMPLEX, packb((x.real, x.imag)))
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD), "array")
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF), "map")
        try:
            # as flax's copy of the tree orders them; flax builds a chunked
            # array's map after that copy
            keys = list(x) if _CHUNKED in x else sorted(x)
        except TypeError:
            keys = list(x)
        for k in keys:
            _pack(out, k)
            _pack(out, x[k])
    else:
        raise TypeError(f"cannot pack {type(x).__name__} as msgpack")


def packb(tree) -> bytes:
    """The msgpack bytes of ``tree`` (nested dicts, lists and tuples of
    None, bool, int, float, str, bytes, complex, numpy arrays and scalars
    and torch tensors), as ``flax.serialization.msgpack_serialize``
    writes them."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ------------------------------------------------------------------- unpack
_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",          # bin
        0xD9: ">B", 0xDA: ">H", 0xDB: ">I",          # str
        0xDC: ">H", 0xDD: ">I",                      # array
        0xDE: ">H", 0xDF: ">I",                      # map
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}          # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data is truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def fmt(self, f: str):
        return struct.unpack(f, self.take(struct.calcsize(f)))[0]

    def value(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0xA0 <= c <= 0xBF:
            return self._str(c & 0x1F)
        if 0x90 <= c <= 0x9F:
            return self._array(c & 0x0F)
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in _FIXED:
            return self.fmt(_FIXED[c])
        if c in _FIXEXT:
            return self._ext(_FIXEXT[c])
        if c in _LEN:
            n = self.fmt(_LEN[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self._ext(n)
            if c <= 0xDB:
                return self._str(n)
            return self._array(n) if c <= 0xDD else self._map(n)
        raise ValueError(f"byte 0x{c:02x} at offset {self.pos - 1} starts no "
                         "msgpack value")

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int):
        code = self.fmt(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            a = _array_from(data)
            return a if isinstance(a, torch.Tensor) else a[()]
        if code == EXT_COMPLEX:
            re, im = unpackb(bytes(data))
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not one of the "
                         "checkpoint format's (1 ndarray, 2 complex, 3 numpy "
                         "scalar)")


def _array_from(data):
    shape, name, raw = unpackb(bytes(data), unchunk=False)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``, on a copy."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def unpackb(data, unchunk: bool = True):
    """The tree in msgpack bytes ``data``, as
    ``flax.serialization.msgpack_restore`` reads it: maps as dicts, arrays
    as lists, ext 1 as writable numpy arrays (bfloat16 as torch tensors),
    chunked arrays put back together.  Raises ValueError on malformed or
    trailing data."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack value")
    return _unchunk(tree) if unchunk else tree


# ------------------------------------------------------------- state dicts
def to_state_dict(tree):
    """Lists and tuples as ``{"0": ..., "1": ...}`` maps, all the way down
    (flax's ``to_state_dict`` of a params tree)."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def restore_lists(tree):
    """The inverse of ``to_state_dict``: every map whose keys are exactly
    "0".."n-1" (n >= 1) becomes a list."""
    if isinstance(tree, dict):
        out = {k: restore_lists(v) for k, v in tree.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out
    if isinstance(tree, list):
        return [restore_lists(v) for v in tree]
    return tree
