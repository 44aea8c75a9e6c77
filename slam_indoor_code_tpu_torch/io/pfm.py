"""Portable float maps (PFM, ``PF``) without OpenCV, read as OpenCV's
``imread`` reads one in colour (grfmt_pfm.cpp).

The header is ``PF``, a line feed, then three numbers, each ended by the
first whitespace byte after it (read as C's ``atoi``/``atof`` read the
bytes before it: ``15abc`` is 15, an empty one 0): the width, the height
and the scale, whose sign gives the byte order (negative: little-endian).
The samples follow that byte at once: float32 RGB, rows from the bottom
up.  Each is multiplied by 1/|scale| and converted as OpenCV converts
float to 8 bits: rounded half to even and saturated, NaN, the
infinities and whatever passes 32-bit integers giving 0.  So a map in
[0, 1] gives only 0 and 1, and one of 0-255 floats the 8-bit image.

A gray map (``Pf``) gives None, as OpenCV's colour read of it fails; so
do a header byte past 127, a zero or NaN scale, and a file cut short.  A
size of zero, or past OpenCV's limits, raises ``ValueError`` (``imread``
raises there).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

_TOKEN = 2048                            # read_number's buffer
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30
_INT = re.compile(rb"[+-]?\d+")
_FLOAT = re.compile(
    rb"[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
    rb"(?:[pP][+-]?\d+)?|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    rb"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN])")
_SPACE = b" \t\n\v\f\r"


def _atoi(token: bytes) -> int:
    m = _INT.match(token)
    return int(m.group()) if m else 0


def _atof(token: bytes) -> float:
    m = _FLOAT.match(token)
    if not m:
        return 0.0
    t = m.group().decode()
    body = t.lstrip("+-")
    if body[:2].lower() == "0x":
        v = float.fromhex(body)
        return -v if t.startswith("-") else v
    return float(t)


def _number(data: bytes, pos: int) -> tuple[bytes, int]:
    """OpenCV's read_number: the bytes up to the first whitespace one (at
    most 2048), and where the next number starts."""
    end = pos
    while end < len(data) and end - pos < _TOKEN:
        if data[end] > 127:
            raise ValueError("PFM: a header byte past 127")
        if data[end] in _SPACE:
            return data[pos:end], end + 1
        end += 1
    if end - pos < _TOKEN:
        raise ValueError("PFM: the header is cut short")
    return data[pos:end], end


def _to_uint8(x: np.ndarray) -> np.ndarray:
    """float32 to uint8 as OpenCV's ``saturate_cast`` (cvRound: half to
    even; 0 where the rounded value is not a 32-bit integer)."""
    r = np.rint(x)
    with np.errstate(invalid="ignore"):     # NaN compares false
        ok = (r >= np.float32(-2.0 ** 31)) & (r < np.float32(2.0 ** 31))
    return np.where(ok, np.clip(r, 0, 255), 0).astype(np.uint8)


def decode(data: bytes) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of the PFM ``data``; None where OpenCV's reader
    fails; ``ValueError`` for a size ``imread`` refuses."""
    if len(data) < 3 or data[:1] != b"P" or data[1:2] not in b"fF":
        return None
    if data[1:2] == b"f" or data[2] != 0x0A:
        return None
    try:
        tw, pos = _number(data, 3)
        th, pos = _number(data, pos)
        ts, pos = _number(data, pos)
    except ValueError:
        return None
    w, h, scale = _atoi(tw), _atoi(th), _atof(ts)
    if (w <= 0 or h <= 0 or w > _MAX_SIDE or h > _MAX_SIDE
            or w * h > _MAX_PIXELS):
        raise ValueError(f"PFM: a size OpenCV refuses ({w}x{h})")
    if not abs(scale) > 0:
        return None
    n = w * h * 3
    if len(data) - pos < 4 * n:
        return None
    x = np.frombuffer(data, "<f4" if scale < 0 else ">f4", n, pos)
    x = x.astype(np.float32).reshape(h, w, 3)[::-1]
    with np.errstate(invalid="ignore", over="ignore"):
        return _to_uint8(x * np.float32(1.0 / abs(scale)))
