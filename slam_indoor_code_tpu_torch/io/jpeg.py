"""Baseline and progressive JPEG decoding without libjpeg: a ctypes
binding of ``native/jpeg.cpp``, which needs nothing but the C++ standard
library.

It gives libjpeg-turbo 3.1's default decode bit for bit (the ISLOW IDCT
with its SIMD code's 16-bit arithmetic, fancy upsampling, the fixed-point YCbCr->RGB tables; for progressive JPEG
the whole-image coefficient buffer and block smoothing where the scan
script stops short) for sequential and progressive Huffman JPEG with 8-bit
samples, 1 or 3 components at any integral sampling factors, restart
intervals and optimized or absent Huffman tables (Motion-JPEG frames
without a DHT take the Annex K tables, as libjpeg does).  Arithmetic-coded,
lossless, hierarchical and 12-bit JPEG raise ``ValueError`` naming the
process; a corrupt or truncated stream decodes to None, or, with
``lenient`` (a photo file as ``cv2.imread`` reads it, a Motion-JPEG frame,
a JPEG-in-TIFF strip), to libjpeg-turbo 3.1's reading of its damaged
data: bad codes read as zero, data that runs out as zero bits, restart
markers resynchronised as jpeg_resync_to_restart does, damaged and cut
progressive scans read into the coefficient buffer and smoothed by the
progression as it stood before a scan that did not finish, reads past the
end given its fake EOI.
This module applies no EXIF orientation: io/photo.py applies it to a JPEG
photo (io/exif.py), as ``cv2.imread`` does, and Motion-JPEG video frames
are left as stored, as OpenCV's video readers leave them.

Built at first use with ``g++ -O2 -fPIC -shared`` into ``_build/`` inside
the package (ignored by git).  If the build fails, every decode raises
with the compiler's message.  The calls release the GIL, so the workers of
a thread pool decode in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

SOURCE = _PKG_DIR / "native" / "jpeg.cpp"
LIBRARY = _PKG_DIR / "_build" / "libjpegdec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 256


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.POINTER, ctypes.c_int, ctypes.c_int64
    lib.jpegdec_info.argtypes = [ctypes.c_char_p, I64, I, P(I), P(I),
                                 ctypes.c_char_p, I]
    lib.jpegdec_info.restype = I
    lib.jpegdec_decode.argtypes = [ctypes.c_char_p, I64, I,
                                   P(ctypes.c_uint8), I64, P(I), P(I),
                                   ctypes.c_char_p, I]
    lib.jpegdec_decode.restype = I


def decode(data: bytes, lenient: bool = False,
           colour: str = "guess") -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of the JPEG ``data``; None if it is corrupt or
    truncated (with ``lenient``: only if its headers are, its damage read
    as libjpeg-turbo reads it); ``ValueError`` naming the process for a
    JPEG this decoder does not read.  ``colour`` sets the colour space of
    three components as libtiff sets it: "guess" (libjpeg's, from
    JFIF/Adobe markers and component ids), "ycbcr" (converted to RGB) or
    "none" (the samples as stored)."""
    lib = load()
    h, w = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    flags = int(lenient) | {"guess": 0, "ycbcr": 2, "none": 4}[colour]
    rc = lib.jpegdec_info(data, len(data), flags, ctypes.byref(h),
                          ctypes.byref(w), msg, _MSG_LEN)
    if rc == 0:
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = lib.jpegdec_decode(
            data, len(data), flags,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.nbytes, ctypes.byref(h), ctypes.byref(w), msg, _MSG_LEN)
        if rc == 0:
            return out
    if rc == 2:
        raise ValueError(msg.value.decode(errors="replace"))
    return None


def imread_rgb(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG file as ``cv2.imread`` does, damage recovered (see
    ``decode``), with no EXIF orientation."""
    with open(path, "rb") as fh:
        return decode(fh.read(), lenient=True)
