"""Uncompressed video frames, as OpenCV's ``I420``/``IYUV``/``Y800``
writers (and fourcc 0, stored as ``I420``) put them in AVI: planar YUV
4:2:0 converted to RGB by ``native/rawvideo.cpp`` (native/swscale_rgb.h,
the conversion OpenCV's FFmpeg backend returns), gray replicated into
three channels (swscale's gray->bgr24 palette is the identity), its rows
4-byte aligned where the chunk is long enough, as FFmpeg reads them.  A
chunk shorter than a frame decodes to None, as FFmpeg's rawvideo decoder
refuses it.

Built at first use with ``g++ -O2 -fPIC -shared`` into ``_build/`` inside
the package (ignored by git).  If the build fails, every decode raises
with the compiler's message.  The calls release the GIL.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

SOURCE = _PKG_DIR / "native" / "rawvideo.cpp"
HEADERS = (_PKG_DIR / "native" / "swscale_rgb.h",)
LIBRARY = _PKG_DIR / "_build" / "librawvideo.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()

# AVI fourcc -> pixel format
FOURCCS = {b"I420": "yuv420p", b"IYUV": "yuv420p", b"Y800": "gray"}


def load() -> ctypes.CDLL:
    """The converter library, built on first use; raises with the
    compiler's message when it cannot be built (and on every later
    call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind, HEADERS)


def _bind(lib: ctypes.CDLL) -> None:
    I, I64 = ctypes.c_int, ctypes.c_int64
    lib.rawvideo_i420_rgb.argtypes = [ctypes.c_char_p, I64, I, I,
                                      ctypes.POINTER(ctypes.c_uint8), I64]
    lib.rawvideo_i420_rgb.restype = I


def decode(data: bytes, pix_fmt: str, width: int, height: int
           ) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of one frame of ``pix_fmt`` ("yuv420p" or "gray");
    None if ``data`` is shorter than a frame."""
    if pix_fmt == "gray":
        if len(data) < width * height:
            return None
        # FFmpeg's rawvideo decoder reads gray rows 4-byte aligned where
        # the frame holds that many bytes (OpenCV's Y800 writer stores
        # I420-sized frames, so it does at widths not divisible by 4)
        stride = (width + 3) & ~3
        if stride * height > len(data):
            stride = width
        y = np.frombuffer(data, np.uint8, stride * height)
        y = y.reshape(height, stride)[:, :width]
        return np.repeat(y[:, :, None], 3, axis=2)
    out = np.empty((height, width, 3), np.uint8)
    rc = load().rawvideo_i420_rgb(
        data, len(data), width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    return out if rc == 0 else None
