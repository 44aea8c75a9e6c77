"""MPEG-4 Part 2 video decoding without FFmpeg: a ctypes binding of
``native/mpeg4.cpp``, which needs nothing but the C++ standard library.

It gives FFmpeg's decode bit for bit for Simple and Advanced Simple
Profile streams, as FFmpeg's ``mpeg4`` encoder writes them (OpenCV's
``mp4v`` and ``XVID``/``DIVX`` writers) and as Xvid and DivX code them:
I-, P- and B-VOPs (direct, interpolated, forward and backward
macroblocks; output in display order with FFmpeg's one-frame delay, the
last reference given by ``flush``), DivX's packed bitstream (a B-VOP held
after a P-VOP in one sample, decoded in place of the N-VOP that follows),
INTER4V, quarter-pel, H.263 or MPEG quantisation (default or loaded
matrices), video packets, interlace (field DCT, field motion vectors in
P- and B-VOPs, field direct mode, the alternate vertical scan), the
simple IDCT or Xvid's for a stream FFmpeg
takes to be Xvid's, and the workarounds FFmpeg applies by the encoder
build the user data names (FF_BUG_EDGE, DC_CLIP, QPEL_CHROMA(2)), with
the x86 build's inexact 8-wide averages and its SSE2 Xvid IDCT; and
converts to RGB as OpenCV's FFmpeg backend does
(native/swscale_rgb.h).  Data partitioning, RVLC, sprites/GMC,
the short video header (H.263 pictures in an MPEG-4 stream, which
FFmpeg's mpeg4 decoder refuses too; io/h263.py reads them where the
container names them H.263) and the other tools it does not decode raise
``ValueError`` naming the tool.  A VOP whose macroblock data is damaged
or cut short gives a frame, as FFmpeg's concealment does (the
macroblocks from the damage on are predicted from the references); a
sample without a VOP, or with a damaged VOP header, gives None and sets
``failed``; a VOP with ``vop_coded`` 0 gives no frame (None), as in
FFmpeg.

Built at first use with ``g++ -O2 -fPIC -shared`` into ``_build/`` inside
the package (ignored by git).  If the build fails, every decoder raises
with the compiler's message.  The calls release the GIL.  A decoder holds
the reference frames, so one decoder reads one stream, in decode order,
on one thread at a time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

SOURCE = _PKG_DIR / "native" / "mpeg4.cpp"
HEADERS = tuple(_PKG_DIR / "native" / h
                for h in ("mpegvideo_bits.h", "mpegvideo_dsp.h",
                          "swscale_rgb.h"))
LIBRARY = _PKG_DIR / "_build" / "libmpeg4dec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 256
_FRAME, _UNSUPPORTED, _FAILED = 0, 2, 3      # mpeg4dec_* return codes
_STATS = ("vops", "b_vops", "interlaced_vops", "alternate_scan_vops",
          "field_dct_mbs", "field_mc_mbs", "field_direct_mbs",
          "partitioned_packets", "concealed_vops")


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind, HEADERS)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64, U8 = (ctypes.POINTER, ctypes.c_int, ctypes.c_int64,
                     ctypes.POINTER(ctypes.c_uint8))
    lib.mpeg4dec_open.argtypes = [ctypes.c_char_p, I64, ctypes.c_uint32,
                                  P(ctypes.c_void_p), ctypes.c_char_p, I]
    lib.mpeg4dec_open.restype = I
    lib.mpeg4dec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, I64,
                                    I64, P(I), P(I), P(I64),
                                    ctypes.c_char_p, I]
    lib.mpeg4dec_decode.restype = I
    lib.mpeg4dec_flush.argtypes = [ctypes.c_void_p, P(I), P(I), P(I64)]
    lib.mpeg4dec_flush.restype = I
    lib.mpeg4dec_rgb.argtypes = [ctypes.c_void_p, U8, I64]
    lib.mpeg4dec_rgb.restype = I
    lib.mpeg4dec_planes.argtypes = [ctypes.c_void_p, U8, U8, U8, I64, I64]
    lib.mpeg4dec_planes.restype = I
    lib.mpeg4dec_stats.argtypes = [ctypes.c_void_p, P(I64), I]
    lib.mpeg4dec_stats.restype = I
    lib.mpeg4dec_close.argtypes = [ctypes.c_void_p]
    lib.mpeg4dec_close.restype = None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class Decoder:
    """One MPEG-4 Part 2 stream: ``extradata`` holds its VOS/VOL headers
    when the container keeps them out of band (an MP4 ``esds``); an AVI
    stream carries them in its first sample.  ``fourcc`` is the
    container's tag for the stream (AVI ``strf``, MP4 sample entry), from
    which, with the user data, the decoder tells an Xvid stream as FFmpeg
    does.  Samples go in in decode order; frames come out in display
    order, each with ``tag``, the tag of the sample it was decoded from.
    ``failed`` tells whether the last sample failed (no VOP, or a damaged
    VOP header), which ends a stream where OpenCV's reader ends it."""

    failed = False
    tag = -1
    _hw = None

    def __init__(self, extradata: bytes = b"", fourcc: bytes = b""):
        self._lib = load()
        self._handle = ctypes.c_void_p()
        msg = ctypes.create_string_buffer(_MSG_LEN)
        tag = int.from_bytes(fourcc[:4].ljust(4, b"\0"), "little")
        rc = self._lib.mpeg4dec_open(extradata, len(extradata), tag,
                                     ctypes.byref(self._handle), msg,
                                     _MSG_LEN)
        if rc != 0:
            self._handle = ctypes.c_void_p()
            text = msg.value.decode(errors="replace")
            raise ValueError(text) if rc == _UNSUPPORTED else IOError(text)

    def _call(self, sample: Optional[bytes], tag: int
              ) -> Optional[tuple[int, int]]:
        if not self._handle:
            raise ValueError("decoder is closed")
        w, h, out = ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
        if sample is None:
            rc = self._lib.mpeg4dec_flush(self._handle, ctypes.byref(w),
                                          ctypes.byref(h), ctypes.byref(out))
        else:
            msg = ctypes.create_string_buffer(_MSG_LEN)
            rc = self._lib.mpeg4dec_decode(
                self._handle, sample, len(sample), tag, ctypes.byref(w),
                ctypes.byref(h), ctypes.byref(out), msg, _MSG_LEN)
            if rc == _UNSUPPORTED:
                raise ValueError(msg.value.decode(errors="replace"))
        self.failed = rc == _FAILED
        if rc != _FRAME:
            return None
        self.tag = out.value
        self._hw = h.value, w.value
        return self._hw

    def _rgb(self, hw) -> Optional[np.ndarray]:
        if hw is None:
            return None
        out = np.empty(hw + (3,), np.uint8)
        self._lib.mpeg4dec_rgb(self._handle, _u8(out), out.nbytes)
        return out

    def _yuv(self, hw):
        if hw is None:
            return None
        h, w = hw
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.mpeg4dec_planes(self._handle, _u8(y), _u8(u), _u8(v),
                                  y.nbytes, u.nbytes)
        return y, u, v

    def decode(self, sample: bytes, tag: int = -1) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of the frame ``sample`` gives (its own VOP's, or,
        with B-VOPs, the reference before it); None when it gives none
        (``vop_coded`` 0, a reference held back, or ``failed``)."""
        return self._rgb(self._call(sample, tag))

    def decode_yuv(self, sample: bytes, tag: int = -1):
        """(Y, U, V) uint8 planes (U and V at half size, rounded up) of the
        frame ``sample`` gives, or None as ``decode``."""
        return self._yuv(self._call(sample, tag))

    def rgb(self) -> Optional[np.ndarray]:
        """The RGB of the frame last given (after ``decode_yuv``, say);
        None before the first."""
        return self._rgb(self._hw)

    def flush(self) -> Optional[np.ndarray]:
        """At the end of the stream, the RGB of the reference a stream with
        B-VOPs holds back; None when there is none."""
        return self._rgb(self._call(None, -1))

    def flush_yuv(self):
        """``flush`` as (Y, U, V) planes."""
        return self._yuv(self._call(None, -1))

    def stats(self) -> dict:
        """What the stream has used so far: VOPs decoded, B-VOPs,
        interlaced VOPs and those with the alternate vertical scan,
        macroblocks with field DCT, with field motion vectors (P and B) and
        in field direct mode, data-partitioned video packets, and VOPs
        concealed from a damaged macroblock on."""
        if not self._handle:
            raise ValueError("decoder is closed")
        out = (ctypes.c_int64 * len(_STATS))()
        self._lib.mpeg4dec_stats(self._handle, out, len(_STATS))
        return dict(zip(_STATS, out))

    def close(self) -> None:
        if self._handle:
            self._lib.mpeg4dec_close(self._handle)
            self._handle = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

