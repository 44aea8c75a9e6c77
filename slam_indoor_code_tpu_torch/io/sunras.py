"""Sun raster photos (``.ras``, ``.sr``) without OpenCV, read as OpenCV
5.0's ``imread`` reads them in colour (grfmt_sunras.cpp).

A big-endian 32-byte header: the magic ``59 a6 6a 95``, the width and
height (above 0), the depth (1, 8, 24 or 32 bits), the data's length
(not used), the type, the colour map's type and its length in bytes,
which the map follows.  OpenCV 5.0 reads types 0 (old) and 1 (standard)
only: run-length coded (2) and RGB-ordered (3) files give None, as they
give OpenCV no image.  The map is none (its length 0) or an RGB map
(type 1: a depth of 8 or less, a length above 0 and at most three bytes
per possible index) of its length / 3 entries, all red bytes, then the
green, then the blue; indices past it are black.  Without a map, 1 and
8-bit pixels are gray levels (a set bit white).

The rows follow the map, top first, each padded to 16 bits: 1-bit
indices from the high bit, 8-bit indices, 24-bit B, G, R, and 32-bit
pixels of a pad byte then B, G, R.  Data that ends before the last row's
padding gives None.  A size past OpenCV's limits raises ``ValueError``
(``imread`` raises there).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

MAGIC = b"\x59\xa6\x6a\x95"
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30


def decode(data: bytes) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of the Sun raster ``data``; None where OpenCV's
    reader fails; ``ValueError`` for a size ``imread`` refuses."""
    if len(data) < 32 or data[:4] != MAGIC:
        return None
    w, h, depth, _, kind, maptype, maplength = struct.unpack(
        ">iiiIiii", data[4:32])
    if w <= 0 or h <= 0 or depth not in (1, 8, 24, 32):
        return None
    if w > _MAX_SIDE or h > _MAX_SIDE or w * h > _MAX_PIXELS:
        raise ValueError(f"Sun raster: a size OpenCV refuses ({w}x{h})")
    pal_size = (1 << depth) * 3 if depth <= 8 else 0
    if kind not in (0, 1) or not (
            (maptype == 0 and maplength == 0)
            or (maptype == 1 and 0 < maplength <= pal_size)):
        return None
    if len(data) < 32 + maplength:
        return None
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    at = 32 + maplength
    if len(data) - at < h * pitch:
        return None
    rows = np.frombuffer(data, np.uint8, h * pitch, at).reshape(h, pitch)
    if depth >= 24:
        px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)
        return np.ascontiguousarray(px[..., -1:-4:-1])
    if maplength:
        n = maplength // 3
        m = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n).T
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = m
    else:
        levels = np.arange(256) * 255 // ((1 << depth) - 1)
        palette = np.repeat(levels.astype(np.uint8)[:, None], 3, 1)
    if depth == 1:
        index = np.unpackbits(rows, axis=1)[:, :w]
    else:
        index = rows[:, :w]
    return palette[index]
