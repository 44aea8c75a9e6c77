"""VP8 video decoding without FFmpeg or libvpx: a ctypes binding of
``native/vp8.cpp``, which needs nothing but the C++ standard library.

It decodes what RFC 6386 defines (key and inter frames, segmentation,
1-8 token partitions, the simple and normal loop filters, the 6-tap and
bilinear predictors of versions 0-3, golden and altref references, hidden
frames) to FFmpeg's pixels bit for bit, and converts to RGB as OpenCV's
FFmpeg backend does (native/swscale_rgb.h), or, for a lossy WebP photo's
key frame (io/webp.py), as libwebp does (``decode_webp``).  A frame with
``show_frame`` 0 gives no frame (None) and updates the references.  A
frame whose token data ends early is given where FFmpeg gives it, decoded
to where FFmpeg stops (the rest is the last frame's); one with a corrupt
or truncated header gives None, sets ``failed`` and leaves the references
as they were (with ``webp=True``, so does a frame libwebp refuses).  A key frame that changes the size, and full-range colour,
raise ``ValueError`` naming them.

Built at first use with ``g++ -O2 -fPIC -shared`` into ``_build/`` inside
the package (ignored by git).  If the build fails, every decoder raises
with the compiler's message.  The calls release the GIL.  A decoder holds
the reference frames, so one decoder reads one stream, in decode order, on
one thread at a time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

SOURCE = _PKG_DIR / "native" / "vp8.cpp"
HEADERS = (_PKG_DIR / "native" / "swscale_rgb.h",
           _PKG_DIR / "native" / "vpx_rac.h")
LIBRARY = _PKG_DIR / "_build" / "libvp8dec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 256
_FRAME, _UNSUPPORTED, _FAILED = 0, 2, 3      # vp8dec_decode return codes


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind, HEADERS)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64, U8 = (ctypes.POINTER, ctypes.c_int, ctypes.c_int64,
                     ctypes.POINTER(ctypes.c_uint8))
    lib.vp8dec_open.argtypes = []
    lib.vp8dec_open.restype = ctypes.c_void_p
    lib.vp8dec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, I64,
                                  P(I), P(I), ctypes.c_char_p, I]
    lib.vp8dec_decode.restype = I
    lib.vp8dec_rgb.argtypes = [ctypes.c_void_p, U8, I64]
    lib.vp8dec_rgb.restype = I
    lib.vp8dec_webp_rgb.argtypes = [ctypes.c_void_p, U8, I64]
    lib.vp8dec_webp_rgb.restype = I
    lib.vp8dec_planes.argtypes = [ctypes.c_void_p, U8, U8, U8, I64, I64]
    lib.vp8dec_planes.restype = I
    lib.vp8dec_set_webp.argtypes = [ctypes.c_void_p, I]
    lib.vp8dec_set_webp.restype = None
    lib.vp8dec_close.argtypes = [ctypes.c_void_p]
    lib.vp8dec_close.restype = None
    lib.vp8dec_table.argtypes = [ctypes.c_char_p, P(ctypes.c_int32), I]
    lib.vp8dec_table.restype = I


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def table(name: str) -> np.ndarray:
    """One of the decoder's constant tables (``dc_qlookup``,
    ``coeff_default_probs``, ``kf_bmode_probs``, ...), flattened."""
    lib = load()
    n = lib.vp8dec_table(name.encode(), None, 0)
    if n < 0:
        raise KeyError(name)
    out = np.empty(n, np.int32)
    lib.vp8dec_table(name.encode(),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    return out


class Decoder:
    """One VP8 stream, fed its frames in decode order; ``failed`` tells
    whether the last frame failed (a damaged header), which ends a stream
    where OpenCV's reader ends it.  ``webp=True`` reads a lossy WebP
    photo's key frame with libwebp's refusals: a frame whose header,
    partition 0 or tokens need a byte past their partition fails, where a
    video frame is read on as FFmpeg reads it."""

    failed = False

    def __init__(self, webp: bool = False):
        self._lib = load()
        self._handle = ctypes.c_void_p(self._lib.vp8dec_open())
        self._lib.vp8dec_set_webp(self._handle, int(webp))

    def _decode(self, frame: bytes) -> Optional[tuple[int, int]]:
        if not self._handle:
            raise ValueError("decoder is closed")
        w, h = ctypes.c_int(), ctypes.c_int()
        msg = ctypes.create_string_buffer(_MSG_LEN)
        rc = self._lib.vp8dec_decode(self._handle, frame, len(frame),
                                     ctypes.byref(w), ctypes.byref(h), msg,
                                     _MSG_LEN)
        if rc == _UNSUPPORTED:
            raise ValueError(msg.value.decode(errors="replace"))
        self.failed = rc == _FAILED
        return (h.value, w.value) if rc == _FRAME else None

    def decode(self, frame: bytes) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of ``frame``; None when it gives no frame
        (``show_frame`` 0, or ``failed``)."""
        hw = self._decode(frame)
        if hw is None:
            return None
        out = np.empty(hw + (3,), np.uint8)
        self._lib.vp8dec_rgb(self._handle, _u8(out), out.nbytes)
        return out

    def decode_webp(self, frame: bytes) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of ``frame`` as libwebp outputs a lossy WebP
        (its fancy upsampler and YUV->RGB), or None as ``decode``."""
        hw = self._decode(frame)
        if hw is None:
            return None
        out = np.empty(hw + (3,), np.uint8)
        self._lib.vp8dec_webp_rgb(self._handle, _u8(out), out.nbytes)
        return out

    def decode_yuv(self, frame: bytes):
        """(Y, U, V) uint8 planes of ``frame`` (U and V at half size,
        rounded up), or None as ``decode``."""
        hw = self._decode(frame)
        if hw is None:
            return None
        h, w = hw
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.vp8dec_planes(self._handle, _u8(y), _u8(u), _u8(v),
                                y.nbytes, u.nbytes)
        return y, u, v

    def close(self) -> None:
        if self._handle:
            self._lib.vp8dec_close(self._handle)
            self._handle = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

