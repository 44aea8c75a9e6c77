"""Lossy WebP photos without libwebp: the RIFF container walked here, its
``VP8 `` key frame decoded by ``native/vp8.cpp`` (VP8 decodes exactly in
integers, so its Y, U and V planes are libwebp's), and the planes turned
into RGB by libwebp's own output stage as OpenCV's ``imread`` gets it: the
"fancy" chroma upsampler and ``VP8YUVToR/G/B`` with their 14-bit
constants (``vp8dec_webp_rgb``), not swscale's conversion.  The simple
(``VP8 `` alone) and extended (``VP8X``) layouts are read; an ``ALPH``
chunk's alpha is dropped and an ``EXIF`` chunk's orientation is returned
for io/exif.py.  Lossless (``VP8L``) and animated WebP raise
``NotImplementedError`` naming them; a damaged file raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from . import vp8


def _chunks(data: bytes):
    """(fourcc, payload) of each chunk in the RIFF ``WEBP`` form."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    pos = 12
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + n > len(data):
            raise ValueError(f"WebP: {kind!r} chunk cut short")
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)


def decode(data: bytes) -> tuple[np.ndarray, Optional[bytes]]:
    """(HxWx3 uint8 RGB, the EXIF block or None) of the WebP ``data``."""
    frame, block = None, None
    for kind, body in _chunks(data):
        if kind == b"VP8L":
            raise NotImplementedError("lossless WebP photos are not read by "
                                      "the port")
        if kind in (b"ANIM", b"ANMF") or (kind == b"VP8X" and body
                                            and body[0] & 0x02):
            raise NotImplementedError("animated WebP photos are not read by "
                                      "the port")
        if kind == b"VP8 " and frame is None:
            frame = body
        elif kind == b"EXIF" and block is None:
            block = body
    if frame is None or len(frame) < 10 or frame[0] & 1:
        raise ValueError("WebP without a VP8 key frame")
    dec = vp8.Decoder()
    try:
        img = dec.decode_webp(frame)
    finally:
        dec.close()
    if img is None:
        raise ValueError("WebP: the VP8 frame does not decode")
    return img, block
