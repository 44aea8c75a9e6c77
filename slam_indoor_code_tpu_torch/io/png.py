"""A PNG reader and writer that need no libpng: the chunks are walked and
the image data inflated here with the standard library's ``zlib`` (which
releases the GIL), and ``native/png.cpp`` unfilters, de-interlaces and
converts the rows.  It reads what libpng 1.6 reads for OpenCV's
``imread`` in colour, to the same pixels: bit depths 1, 2, 4, 8 and 16 of
gray, gray+alpha, RGB, RGBA and palette images (with or without
``tRNS``), non-interlaced or Adam7; 16-bit samples become their high byte,
gray below 8 bits is scaled to 8 bits, and alpha is dropped.  A file that
libpng refuses (a bad header, a critical chunk whose CRC fails, image data
that is short or does not inflate) raises ``ValueError``.  ``exif`` gives
an ``eXIf`` chunk's payload, whose orientation OpenCV applies
(io/exif.py).  ``write_png`` writes 8-bit RGB, every row filtered Up.

The library is built at first use with ``g++ -O2 -fPIC -shared`` into
``_build/`` inside the package (ignored by git).  If the build fails,
every decode raises with the compiler's message.  The calls release the
GIL.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SOURCE = _PKG_DIR / "native" / "png.cpp"
LIBRARY = _PKG_DIR / "_build" / "libpngdec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 128
# colour type -> the bit depths it may have
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_MAX_SIDE = 1_000_000                          # libpng's user limits
MAX_PIXELS = 1 << 30                           # OpenCV's imread limit
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT")        # a bad CRC is an error


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def _bind(lib: ctypes.CDLL) -> None:
    I, I64, U8 = ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    lib.pngdec_rgb.argtypes = [ctypes.c_char_p, I64, I, I, I, I, I,
                               ctypes.c_char_p, U8, ctypes.c_char_p, I]
    lib.pngdec_rgb.restype = I


def chunks(data: bytes):
    """(type, payload) of each chunk of the PNG ``data`` up to IEND;
    ``ValueError`` where a critical chunk is cut short or fails its CRC
    (an ancillary one that does is left out, as libpng discards it)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        pos += 12 + n
        good = (len(crc) == 4 and struct.unpack(">I", crc)[0]
                == zlib.crc32(kind + body) & 0xFFFFFFFF)
        if not good and kind in _CRITICAL:
            raise ValueError(f"PNG: {kind.decode(errors='replace')} chunk "
                             "cut short or with a bad CRC")
        if good:
            yield kind, body
        if kind == b"IEND":
            return


def decode(data: bytes) -> np.ndarray:
    """HxWx3 uint8 RGB of the PNG ``data``; ``ValueError`` where libpng
    refuses it."""
    hdr, idat, palette = None, [], None
    for kind, body in chunks(data):
        if hdr is None and kind != b"IHDR":
            raise ValueError("PNG: IHDR is not the first chunk")
        if kind == b"IHDR" and len(body) == 13:
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = (body[:768] + bytes(768))[:768]
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if (ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or comp or filt
            or interlace > 1 or not 0 < w <= _MAX_SIDE
            or not 0 < h <= _MAX_SIDE or w * h > MAX_PIXELS):
        raise ValueError(f"PNG: invalid header {hdr}")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: palette image without PLTE")
    if not idat:
        raise ValueError("PNG without image data")
    try:                     # a stream cut after the last row still reads
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: {e}") from e
    out = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    rc = load().pngdec_rgb(raw, len(raw), w, h, depth, ctype, interlace,
                           palette or bytes(768),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           msg, _MSG_LEN)
    if rc != 0:
        raise ValueError(f"PNG: {msg.value.decode(errors='replace')}")
    return out


def exif(data: bytes) -> Optional[bytes]:
    """The payload of the PNG ``data``'s ``eXIf`` chunk, or None."""
    try:
        for kind, body in chunks(data):
            if kind == b"eXIf":
                return body
    except ValueError:
        pass
    return None


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to HxWx3 uint8 RGB (see ``decode``)."""
    with open(path, "rb") as fh:
        return decode(fh.read())


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
