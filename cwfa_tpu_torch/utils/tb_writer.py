"""Minimal TensorBoard event-file writer (no tensorflow/tensorboard deps; a
copy of ``cwfa_tpu/utils/tb_writer.py`` whose images are encoded by the
port's own ``utils/png.py``, not PIL).

The reference logs everything through torch's SummaryWriter
(CWFA.py:550-563,1126-1169): scalars (losses, NLL, PSNR, timing), text
(arguments), and images.  This module writes the same event-file format —
TFRecord framing with masked CRC32C, hand-encoded Event/Summary protobufs —
so standard TensorBoard can read the runs.  Supported: add_scalar, add_text,
add_image (PNG), add_figure (matplotlib, where the host has it).
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from cwfa_tpu_torch.utils.png import encode_png

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) with TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_make_table()


try:
    # C implementation (~GB/s) where the host has it; the pure-python
    # table loop below runs at ~6 MB/s
    from google_crc32c import value as _crc32c_native
except ImportError:                                  # pragma: no cover
    _crc32c_native = None


def _crc32c(data: bytes) -> int:
    if _crc32c_native is not None:
        return _crc32c_native(data)
    crc = 0xFFFFFFFF
    for b in data:
        crc = (_CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)) & 0xFFFFFFFF
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Tiny protobuf encoder
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    # protobuf encodes negative int64 two's-complement as 10 bytes; the
    # unmasked shift would leave a negative python int negative forever
    # (an infinite loop on e.g. a negative global_step)
    if n < 0:
        n &= (1 << 64) - 1
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field, v) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field, v) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_varint(field, v) -> bytes:
    return _key(field, 0) + _varint(v)


def _pb_bytes(field, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _pb_str(field, s: str) -> bytes:
    return _pb_bytes(field, s.encode())


# ---------------------------------------------------------------------------
# Summary / Event messages
# ---------------------------------------------------------------------------


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    return _pb_str(1, tag) + _pb_float(2, float(value))


def _text_value(tag: str, text: str) -> bytes:
    # TensorProto{ dtype=1 (DT_STRING=7), string_val=8 }
    tensor = _pb_varint(1, 7) + _pb_bytes(8, text.encode())
    # SummaryMetadata{ plugin_data=1{ plugin_name=1 } }
    meta = _pb_bytes(1, _pb_str(1, "text"))
    return _pb_str(1, tag) + _pb_bytes(8, tensor) + _pb_bytes(9, meta)


def _image_value(tag: str, img: np.ndarray) -> bytes:
    """img: (H, W) or (H, W, 3) float [0,1] or uint8."""
    if img.dtype != np.uint8:
        arr = np.clip(img, 0, 1) if img.max() <= 1.0 + 1e-6 else \
            img / max(img.max(), 1e-9)
        img = (arr * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    # Summary.Image{ height=1, width=2, colorspace=3, encoded_image_string=4 }
    image_pb = (_pb_varint(1, img.shape[0]) + _pb_varint(2, img.shape[1])
                + _pb_varint(3, 3) + _pb_bytes(4, encode_png(img)))
    return _pb_str(1, tag) + _pb_bytes(4, image_pb)


def _event(step: int, summary_value: bytes | None = None,
           file_version: str | None = None) -> bytes:
    # Event{ wall_time=1, step=2, file_version=3 | summary=5 }
    out = _pb_double(1, time.time()) + _pb_varint(2, step)
    if file_version is not None:
        out += _pb_str(3, file_version)
    if summary_value is not None:
        out += _pb_bytes(5, _pb_bytes(1, summary_value))  # Summary.value=1
    return out


class SummaryWriter:
    """Drop-in subset of torch.utils.tensorboard.SummaryWriter."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(log_dir, fname), "wb")
        self.log_dir = log_dir
        self._write(_event(0, file_version="brain.Event:2"))

    def _write(self, record: bytes):
        hdr = struct.pack("<Q", len(record))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag: str, value, global_step: int = 0):
        self._write(_event(int(global_step), _scalar_value(tag, float(value))))

    def add_text(self, tag: str, text: str, global_step: int = 0):
        self._write(_event(int(global_step), _text_value(tag, text)))

    def add_image(self, tag: str, img, global_step: int = 0):
        self._write(_event(int(global_step),
                           _image_value(tag, np.asarray(img))))
        self._f.flush()

    def add_figure(self, tag: str, figure, global_step: int = 0):
        """Render a matplotlib figure to RGB and log it as an image (the
        reference's writer.add_figure calls, CWFA.py:1070-1155)."""
        from cwfa_tpu_torch.utils.plots import figure_to_array
        self.add_image(tag, figure_to_array(figure), global_step)
        import matplotlib.pyplot as plt
        plt.close(figure)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# Event-file reader (tests / verification; TensorBoard-independent)
# ---------------------------------------------------------------------------


def _read_pb_fields(data: bytes):
    """Yield (field, wire, value) triples from one protobuf message."""
    i = 0
    while i < len(data):
        key = 0
        shift = 0
        while True:
            b = data[i]; i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = 0; shift = 0
            while True:
                b = data[i]; i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            v = data[i:i + 8]; i += 8
        elif wire == 5:
            v = data[i:i + 4]; i += 4
        elif wire == 2:
            ln = 0; shift = 0
            while True:
                b = data[i]; i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            v = data[i:i + ln]; i += ln
        else:
            raise ValueError(f"wire {wire}")
        yield field, wire, v


def read_event_file(path: str):
    """Parse an event file back into a list of
    {'step', 'tag', 'kind': 'scalar'|'image'|'text', 'value'} dicts.
    Images return (height, width) only (payload is PNG)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i + 12 <= len(data):
        (ln,) = struct.unpack("<Q", data[i:i + 8])
        rec = data[i + 12:i + 12 + ln]
        i += 12 + ln + 4
        step = 0
        summ = None
        for field, wire, v in _read_pb_fields(rec):
            if field == 2 and wire == 0:
                step = v
            elif field == 5 and wire == 2:
                summ = v
        if summ is None:
            continue
        for field, _, val in _read_pb_fields(summ):
            if field != 1:
                continue
            tag, kind, value = None, None, None
            for f2, w2, v2 in _read_pb_fields(val):
                if f2 == 1:
                    tag = v2.decode()
                elif f2 == 2 and w2 == 5:
                    kind, value = "scalar", struct.unpack("<f", v2)[0]
                elif f2 == 4 and w2 == 2:
                    h = w = 0
                    for f3, _, v3 in _read_pb_fields(v2):
                        if f3 == 1:
                            h = v3
                        elif f3 == 2:
                            w = v3
                    kind, value = "image", (h, w)
                elif f2 == 8 and w2 == 2:
                    kind = kind or "text"
            out.append({"step": step, "tag": tag, "kind": kind,
                        "value": value})
    return out
