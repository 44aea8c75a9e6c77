"""VP9 video decoding without FFmpeg or libvpx: a ctypes binding of
``native/vp9.cpp``, which needs nothing but the C++ standard library.

It decodes profile 0 (8-bit 4:2:0: what libvpx writes for WebM, MKV, AVI
and MP4, and OpenCV's ``VP90`` writer) to FFmpeg's pixels bit for bit:
key and inter frames, superframes with hidden alt-ref frames,
show_existing_frame, compound prediction, the 8-tap and bilinear filters,
tiles, segmentation, lossless frames, error-resilient and frame-parallel
streams and backward probability adaptation; and converts to RGB as
OpenCV's FFmpeg backend does (native/swscale_rgb.h).  A packet whose
frames are all hidden gives no frame (None) and updates the references.
A corrupt frame gives None, sets ``failed`` and leaves the references as
they were.  Profiles 1-3, intra-only frames, a size change and a
reference of another size raise ``ValueError`` naming them.

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

SOURCE = _PKG_DIR / "native" / "vp9.cpp"
HEADERS = tuple(_PKG_DIR / "native" / h for h in
                ("swscale_rgb.h", "vp9_dsp.h", "vp9_tables.h",
                 "vpx_rac.h"))
LIBRARY = _PKG_DIR / "_build" / "libvp9dec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 256
_FRAME, _UNSUPPORTED, _FAILED = 0, 2, 3      # vp9dec_decode return codes
_STATS = ("frames", "hidden", "show_existing", "compound_blocks", "adapted",
          "tile_cols", "tile_rows", "switchable", "segmented", "lossless",
          "error_resilient", "subblock_inter")


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind, HEADERS)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64, U8 = (ctypes.POINTER, ctypes.c_int, ctypes.c_int64,
                     ctypes.POINTER(ctypes.c_uint8))
    lib.vp9dec_open.argtypes = []
    lib.vp9dec_open.restype = ctypes.c_void_p
    lib.vp9dec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, I64,
                                  P(I), P(I), ctypes.c_char_p, I]
    lib.vp9dec_decode.restype = I
    lib.vp9dec_rgb.argtypes = [ctypes.c_void_p, U8, I64]
    lib.vp9dec_rgb.restype = I
    lib.vp9dec_planes.argtypes = [ctypes.c_void_p, U8, U8, U8, I64, I64]
    lib.vp9dec_planes.restype = I
    lib.vp9dec_close.argtypes = [ctypes.c_void_p]
    lib.vp9dec_close.restype = None
    lib.vp9dec_stats.argtypes = [ctypes.c_void_p, P(ctypes.c_int64), I]
    lib.vp9dec_stats.restype = I
    lib.vp9dec_table.argtypes = [ctypes.c_char_p, P(ctypes.c_int32), I]
    lib.vp9dec_table.restype = I


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def table(name: str) -> np.ndarray:
    """One of the decoder's constant tables by libvpx's symbol name
    (``dc_qlookup``, ``default_coef_probs_8x8``, ``vp9_kf_y_mode_prob``,
    ...) or one of the defaults kept in code (``default_skip_probs``,
    ...), flattened."""
    lib = load()
    n = lib.vp9dec_table(name.encode(), None, 0)
    if n < 0:
        raise KeyError(name)
    out = np.empty(n, np.int32)
    lib.vp9dec_table(name.encode(),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    return out


class Decoder:
    """One VP9 stream, fed its packets in decode order; ``failed`` tells
    whether the last packet failed (a corrupt frame), which ends a stream
    where OpenCV's reader ends it."""

    failed = False

    def __init__(self):
        self._lib = load()
        self._handle = ctypes.c_void_p(self._lib.vp9dec_open())

    def _decode(self, frame: bytes) -> Optional[tuple[int, int]]:
        if not self._handle:
            raise ValueError("decoder is closed")
        w, h = ctypes.c_int(), ctypes.c_int()
        msg = ctypes.create_string_buffer(_MSG_LEN)
        rc = self._lib.vp9dec_decode(self._handle, frame, len(frame),
                                     ctypes.byref(w), ctypes.byref(h), msg,
                                     _MSG_LEN)
        if rc == _UNSUPPORTED:
            raise ValueError(msg.value.decode(errors="replace"))
        self.failed = rc == _FAILED
        return (h.value, w.value) if rc == _FRAME else None

    def decode(self, frame: bytes) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of the packet ``frame``; None when it gives no
        frame (hidden frames only, or ``failed``)."""
        hw = self._decode(frame)
        if hw is None:
            return None
        out = np.empty(hw + (3,), np.uint8)
        self._lib.vp9dec_rgb(self._handle, _u8(out), out.nbytes)
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
        self._lib.vp9dec_planes(self._handle, _u8(y), _u8(u), _u8(v),
                                y.nbytes, u.nbytes)
        return y, u, v

    def stats(self) -> dict:
        """What the stream has used so far: frames decoded (hidden ones
        too), hidden frames, show_existing_frame packets, compound-predicted
        blocks, frames adapted backward, the most tile columns and rows,
        frames with switchable filters, segmentation, lossless coding or
        error resilience, and inter blocks below 8x8."""
        if not self._handle:
            raise ValueError("decoder is closed")
        out = (ctypes.c_int64 * len(_STATS))()
        self._lib.vp9dec_stats(self._handle, out, len(_STATS))
        return dict(zip(_STATS, out))

    def close(self) -> None:
        if self._handle:
            self._lib.vp9dec_close(self._handle)
            self._handle = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

