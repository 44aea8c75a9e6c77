"""H.263 video decoding without FFmpeg: a ctypes binding of
``native/h263.cpp``, which needs nothing but the C++ standard library, and
the raw ``.h263`` elementary stream.

The decoder gives FFmpeg's ``h263`` decode bit for bit for baseline H.263
(the five standard sizes, as OpenCV's ``H263`` writer codes them, Annex
D's long vectors, Annex F's 4MV and OBMC) and H.263+ with the annexes
FFmpeg's ``h263p`` encoder writes: the custom picture format up to
2048x1152, RTYPE, D (unrestricted vectors with the reversible code), F,
I (advanced intra coding), J (deblocking), K (slices), S (the
alternative inter VLC) and T (modified quantisation); GOB and slice
headers; and converts to RGB as OpenCV's FFmpeg backend does
(native/swscale_rgb.h); and Sorenson Spark (FLV1: Flash Video, OpenCV's
``FLV1`` writer) as FFmpeg's flv decoder reads it (``sorenson=True``).
Each picture is its own frame (H.263 has no
reordering).  The tools it does not decode (PB-frames, CPM, annexes E,
M, N, O, P, Q, R, rectangular slices, supplemental enhancement
information) raise ``ValueError`` naming the tool.  A picture whose
header does not parse, or that is too short for its size, gives None
and sets ``failed``, which ends a stream where OpenCV's reader ends it; a
damaged GOB or slice is concealed.

``split_pictures`` cuts a raw H.263 stream into the packets FFmpeg's
``h263`` parser makes (one per byte-aligned picture start code);
``EsVideo`` is such a stream: a raw ``.h263``/``.263`` file.

Built at first use with ``g++ -O2 -fPIC -shared`` into ``_build/`` inside
the package (ignored by git).  If the build fails, every decoder raises
with the compiler's message.  The calls release the GIL.  A decoder holds
the reference frame, so one decoder reads one stream, in order, on one
thread at a time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

SOURCE = _PKG_DIR / "native" / "h263.cpp"
HEADERS = tuple(_PKG_DIR / "native" / h
                for h in ("mpegvideo_bits.h", "mpegvideo_dsp.h",
                          "swscale_rgb.h"))
LIBRARY = _PKG_DIR / "_build" / "libh263dec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 256
_FRAME, _UNSUPPORTED, _FAILED = 0, 2, 3      # h263dec_* return codes
_STATS = ("frames", "plus_pictures", "custom_format", "no_rounding_pictures",
          "intra_mbs", "inter_mbs", "inter4v_mbs", "skipped_mbs",
          "obmc_mbs", "aic_blocks", "aic_pred_mbs", "deblocked_edges",
          "gob_headers", "slice_headers", "umv_outside", "long_vectors",
          "umv_codes", "alt_vlc_blocks", "mq_escapes", "mq_chroma_mbs",
          "concealed_mbs", "umv_pictures", "obmc_pictures", "aic_pictures",
          "loop_filter_pictures", "slice_pictures", "aiv_pictures",
          "mq_pictures", "sorenson_pictures", "disposable_pictures",
          "flv_escapes_7", "flv_escapes_11")


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind, HEADERS)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64, U8 = (ctypes.POINTER, ctypes.c_int, ctypes.c_int64,
                     ctypes.POINTER(ctypes.c_uint8))
    lib.h263dec_open.argtypes = [P(ctypes.c_void_p)]
    lib.h263dec_open.restype = I
    lib.h263dec_set_sorenson.argtypes = [ctypes.c_void_p, I]
    lib.h263dec_set_sorenson.restype = None
    lib.h263dec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, I64,
                                   P(I), P(I), ctypes.c_char_p, I]
    lib.h263dec_decode.restype = I
    lib.h263dec_rgb.argtypes = [ctypes.c_void_p, U8, I64]
    lib.h263dec_rgb.restype = I
    lib.h263dec_planes.argtypes = [ctypes.c_void_p, U8, U8, U8, I64, I64]
    lib.h263dec_planes.restype = I
    lib.h263dec_stats.argtypes = [ctypes.c_void_p, P(ctypes.c_int64), I]
    lib.h263dec_stats.restype = I
    lib.h263dec_close.argtypes = [ctypes.c_void_p]
    lib.h263dec_close.restype = None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class Decoder:
    """One H.263 stream, a picture per packet (a container's sample, or a
    packet of ``split_pictures``).  A stream that starts with a P-picture
    predicts it from FFmpeg's dummy reference (luma 16, chroma 128).
    ``failed`` tells whether the last packet failed.  ``sorenson=True``
    reads Sorenson Spark (FLV1) pictures: flvdec.c's header, FLV's escape,
    disposable pictures (given, kept from the reference, and no frame
    before the first reference); a size change within the stream raises
    ``ValueError`` naming it."""

    failed = False
    _hw = None

    def __init__(self, sorenson: bool = False):
        self._lib = load()
        self._handle = ctypes.c_void_p()
        self._lib.h263dec_open(ctypes.byref(self._handle))
        self._lib.h263dec_set_sorenson(self._handle, int(sorenson))

    def _call(self, sample: bytes) -> Optional[tuple[int, int]]:
        if not self._handle:
            raise ValueError("decoder is closed")
        w, h = ctypes.c_int(), ctypes.c_int()
        msg = ctypes.create_string_buffer(_MSG_LEN)
        rc = self._lib.h263dec_decode(self._handle, sample, len(sample),
                                      ctypes.byref(w), ctypes.byref(h), msg,
                                      _MSG_LEN)
        if rc == _UNSUPPORTED:
            raise ValueError(msg.value.decode(errors="replace"))
        self.failed = rc == _FAILED
        if rc != _FRAME:
            return None
        self._hw = h.value, w.value
        return self._hw

    def _rgb(self, hw) -> Optional[np.ndarray]:
        if hw is None:
            return None
        out = np.empty(hw + (3,), np.uint8)
        self._lib.h263dec_rgb(self._handle, _u8(out), out.nbytes)
        return out

    def _yuv(self, hw):
        if hw is None:
            return None
        h, w = hw
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.h263dec_planes(self._handle, _u8(y), _u8(u), _u8(v),
                                 y.nbytes, u.nbytes)
        return y, u, v

    def decode(self, sample: bytes) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of the picture ``sample`` holds; None when it
        gives none (``failed``)."""
        return self._rgb(self._call(sample))

    def decode_yuv(self, sample: bytes):
        """(Y, U, V) uint8 planes (U and V at half size) of the picture
        ``sample`` holds, or None as ``decode``."""
        return self._yuv(self._call(sample))

    def rgb(self) -> Optional[np.ndarray]:
        """The RGB of the frame last given (after ``decode_yuv``, say);
        None before the first."""
        return self._rgb(self._hw)

    def flush(self) -> Optional[np.ndarray]:
        """None: H.263 holds no frame back."""
        return None

    def flush_yuv(self):
        return None

    def stats(self) -> dict:
        """What the stream has used so far: frames given, pictures with
        PLUSPTYPE, with a custom picture format and with RTYPE 1; intra,
        1MV, 4MV and skipped macroblocks, macroblocks predicted with OBMC;
        blocks coded with advanced intra coding and its macroblocks with
        AC prediction; 8-pixel edges deblocked; GOB and slice headers;
        inter macroblocks that read beyond the picture; vectors beyond
        baseline's [-16, 15.5]; reversible (Annex D) vector codes; blocks
        read again with Annex S's table; Annex T's extended escapes, and
        coded macroblocks whose chroma quantiser its table set apart from
        the luma one; concealed macroblocks; the
        pictures coded with each mode of OPPTYPE: D (under PLUSPTYPE), F,
        I, J, K, S and T; and Sorenson pictures, disposable ones, and FLV
        escapes with a 7-bit and with an 11-bit level."""
        if not self._handle:
            raise ValueError("decoder is closed")
        out = (ctypes.c_int64 * len(_STATS))()
        self._lib.h263dec_stats(self._handle, out, len(_STATS))
        return dict(zip(_STATS, out))

    def close(self) -> None:
        if self._handle:
            self._lib.h263dec_close(self._handle)
            self._handle = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def split_pictures(data: bytes) -> list[tuple[int, int]]:
    """(offset, size) of the packets FFmpeg's ``h263`` parser cuts ``data``
    into: each ends where the next byte-aligned picture start code begins,
    the first takes whatever precedes the second start code, the last runs
    to the end."""
    arr = np.frombuffer(data, np.uint8)
    if len(arr) < 4:
        return [(0, len(data))] if data else []
    hits = np.flatnonzero((arr[:-3] == 0) & (arr[1:-2] == 0)
                          & ((arr[2:-1] & 0xFC) == 0x80))
    cuts = [int(p) for p in hits[1:]]
    starts = [0] + cuts
    ends = cuts + [len(data)]
    return [(s, e - s) for s, e in zip(starts, ends) if e > s]


def is_elementary_stream(head: bytes) -> bool:
    """Whether ``head`` begins with an H.263 picture start code."""
    return (len(head) >= 5 and head[0] == 0 and head[1] == 0
            and head[2] & 0xFC == 0x80)


class EsVideo:
    """A raw H.263 stream held in memory: ``frames`` lists (offset, size,
    shown) of each packet of ``split_pictures``; ``read`` gives its bytes.
    ``codec`` is "h263"."""

    codec = "h263"
    extradata = b""
    fourcc = b"H263"
    width = height = 0

    def __init__(self, data: bytes, path: str = ""):
        self.path = path
        self._data = data
        self.frames = [(o, n, True) for o, n in split_pictures(data)]

    @classmethod
    def open(cls, path: str) -> "EsVideo":
        try:
            with open(path, "rb") as fh:
                return cls(fh.read(), path)
        except OSError as e:
            raise IOError(f"Video wasn't opened: {path}") from e

    def read(self, frame: tuple[int, int, bool]) -> bytes:
        off, n, _ = frame
        return self._data[off:off + n]

    def close(self) -> None:
        self._data = b""
