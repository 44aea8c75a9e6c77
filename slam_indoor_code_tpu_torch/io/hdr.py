"""Radiance HDR (RGBE) photos without OpenCV: the header read here as
OpenCV's ``imread`` reads it (grfmt_hdr.cpp over rgbe.c's
``RGBE_ReadHeader``), the pixels by ``native/hdr.cpp``.

The file starts ``#?RADIANCE`` or ``#?RGBE``.  Its header is read a line
at a time as C's ``fgets`` reads it into 128 bytes (a line of more than
127 bytes is read in pieces): lines up to an empty one, one of which
must be exactly ``FORMAT=32-bit_rle_rgbe`` (``EXPOSURE``, ``GAMMA`` and
every other line are ignored: OpenCV applies no exposure), then one that
``sscanf`` reads as ``-Y %d +X %d``: the height and the width, rows from
the top, as every writer of the format stores them.  So
``32-bit_rle_xyze`` (CIE XYZ), a header without a FORMAT line, and any
other orientation give None, as they give OpenCV no image.  The pixels
follow (native/hdr.cpp: new-style runs or flat RGBE), each float times
255 to 8 bits.

A size of zero gives None; one past OpenCV's limits raises
``ValueError`` (``imread`` raises there).

The library is built at first use with ``g++ -O2 -fPIC -shared`` into
``_build/`` inside the package (ignored by git).  If the build fails,
every decode raises with the compiler's message.  The calls release the
GIL.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

MAGICS = (b"#?RADIANCE", b"#?RGBE")
SOURCE = _PKG_DIR / "native" / "hdr.cpp"
LIBRARY = _PKG_DIR / "_build" / "libhdrdec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_LINE = 127                              # fgets into char buf[128]
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30
# sscanf("-Y %d +X %d"): format whitespace matches any (or none), %d
# skips whitespace first
_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*([+-]?\d+)[ \t\n\v\f\r]*\+X"
                   rb"[ \t\n\v\f\r]*([+-]?\d+)")


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def _bind(lib: ctypes.CDLL) -> None:
    I, I64 = ctypes.c_int, ctypes.c_int64
    lib.hdr_rgb.argtypes = [ctypes.c_char_p, I64, I, I,
                            ctypes.POINTER(ctypes.c_uint8)]
    lib.hdr_rgb.restype = I


def _fgets(data: bytes, pos: int) -> tuple[Optional[bytes], int]:
    """C's fgets into 128 bytes: up to 127 bytes or through a line feed,
    as a C string (to its first NUL); None at the end of the data."""
    if pos >= len(data):
        return None, pos
    nl = data.find(b"\n", pos, pos + _LINE)
    end = nl + 1 if nl >= 0 else min(pos + _LINE, len(data))
    return data[pos:end].split(b"\0", 1)[0], end


def _header(data: bytes) -> tuple[int, int, int]:
    """(height, width, where the pixels start); ``ValueError`` where
    ``RGBE_ReadHeader`` fails."""
    line, pos = _fgets(data, 0)
    has_format = False
    while True:
        if line is None:
            raise ValueError("HDR: the header is cut short")
        if line in (b"", b"\n"):
            if not has_format:
                raise ValueError("HDR: no FORMAT=32-bit_rle_rgbe line")
            break
        has_format |= line == _FORMAT
        line, pos = _fgets(data, pos)
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line or b"")
    if not m:
        raise ValueError("HDR: no '-Y height +X width' line")
    return int(m.group(1)), int(m.group(2)), pos


def decode(data: bytes) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of the Radiance HDR ``data``; None where OpenCV's
    reader fails; ``ValueError`` for a size ``imread`` refuses."""
    try:
        h, w, pos = _header(data)
    except ValueError:
        return None
    if w <= 0 or h <= 0:
        return None
    if w > _MAX_SIDE or h > _MAX_SIDE or w * h > _MAX_PIXELS:
        raise ValueError(f"HDR: a size OpenCV refuses ({w}x{h})")
    out = np.empty((h, w, 3), np.uint8)
    if load().hdr_rgb(data[pos:], len(data) - pos, w, h,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))):
        return None
    return out
