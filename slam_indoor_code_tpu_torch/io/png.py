"""A small PNG reader and writer in numpy and the standard library's
``zlib``: the decoder of photo media where the native one (io/native.py,
libpng and libjpeg) cannot be built.  8-bit gray, gray+alpha, RGB and RGBA,
non-interlaced, all five row filters; anything else raises ``ValueError``.
Rows filtered None, Sub or Up are undone with numpy, Average and Paeth rows
byte by byte (they depend on the byte to their left).  ``write_png``
writes 8-bit RGB, every row filtered Up."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type → samples per pixel


def _avg_row(f: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    r = bytearray(f.tobytes())
    p = prior.tobytes()
    for i in range(len(r)):
        a = r[i - bpp] if i >= bpp else 0
        r[i] = (r[i] + ((a + p[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(r), np.uint8)


def _paeth_row(f: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    r = bytearray(f.tobytes())
    p = prior.tobytes()
    for i in range(len(r)):
        a = r[i - bpp] if i >= bpp else 0
        b = p[i]
        c = p[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        r[i] = (r[i] + pred) & 0xFF
    return np.frombuffer(bytes(r), np.uint8)


def unfilter(data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of decompressed scanlines [H, 1+stride]
    (the filter type byte first) → [H, stride] u8."""
    h, stride = data.shape[0], data.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, f = int(data[y, 0]), data[y, 1:]
        if ft == 0:
            row = f
        elif ft == 1:
            row = np.cumsum(f.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:
            row = f + prior
        elif ft == 3:
            row = _avg_row(f, prior, bpp)
        elif ft == 4:
            row = _paeth_row(f, prior, bpp)
        else:
            raise ValueError(f"PNG: unknown row filter {ft}")
        out[y] = row
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to HxWx3 uint8 RGB (gray is repeated into the
    three channels, alpha is dropped)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}: only 8-bit, "
                         "non-interlaced gray, gray+alpha, RGB and RGBA "
                         "are read")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: {raw.size} bytes of scanlines for "
                         f"{w}x{h}x{ch}")
    img = unfilter(raw.reshape(h, 1 + w * ch), ch).reshape(h, w, ch)
    if ch <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write ``rgb`` [H,W,3] uint8 as an 8-bit RGB PNG, every row filtered
    Up (``read_png`` reads it back exactly)."""
    h, w, _ = rgb.shape
    rows = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(h, w * 3)
    up = rows.copy()
    up[1:] -= rows[:-1]
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1).tobytes()
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, 1)) + _chunk(b"IEND", b""))
