"""PNG encoder on the standard library (``zlib``, ``struct``): 8-bit grey
and RGB, no interlace, every row with filter 0.

The JAX package encodes its TensorBoard images and result PNGs with PIL
(``cwfa_tpu/utils/tb_writer.py:129-137``, ``engine/trainer.py:1064-1087``);
the card's host has no PIL, so the port writes the format itself.  Any PNG
reader decodes the result to the same pixels PIL's encoder would give.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of ``img``: uint8 (H, W) grey or (H, W, 3) RGB."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"encode_png: empty image {img.shape}")
    # each scanline: the filter byte 0 (None), then its pixels
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    """Write ``encode_png(img)`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
