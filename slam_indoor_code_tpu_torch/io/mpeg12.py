"""MPEG-1 and MPEG-2 video decoding without FFmpeg: a ctypes binding of
``native/mpeg12.cpp``, which needs nothing but the C++ standard library,
and the elementary-stream side of the MPEG containers.

The decoder gives FFmpeg's ``mpeg1video``/``mpeg2video`` decode bit for
bit for Main Profile 4:2:0 and 4:2:2 Profile frame pictures: I, P and B pictures (output in
display order with FFmpeg's one-frame delay, none under ``low_delay``,
the last reference given by ``flush``), MPEG-1's full-pel vectors and
escapes, MPEG-2's field DCT and field motion compensation in frame
pictures, 4:2:2 chroma (eight blocks a macroblock, the chroma matrices,
chroma at full height in motion compensation and field DCT), alternate
scan, B-15 intra VLCs, non-linear quantiser scale,
intra DC precision 8-11, loaded matrices, concealment vectors, and FFmpeg's
rules for a stream joined mid-way (open-GOP B pictures without their
older reference skipped); and converts to RGB as OpenCV's FFmpeg backend
does (native/swscale_rgb.h) with the sequence's colour matrix, BT.601 or
BT.709 (4:2:2 through swscale's unscaled converter).  Field pictures,
dual-prime, 4:4:4, 4:2:2 at an odd height, the scalable
extensions, D-pictures and other colour matrices raise ``ValueError``
naming them.  A packet FFmpeg fails (a slice start code at its end or
below the picture, a packet too small for its picture) gives None and
sets ``failed``, which ends a stream where OpenCV's reader ends it; a
picture before the first sequence header is parsed at the size the
container reports, as FFmpeg's decoder opened by OpenCV parses it (its P
and open-GOP B pictures are skipped); a damaged slice is concealed.

``split_pictures`` cuts an elementary stream into the packets FFmpeg's
``mpegvideo`` parser makes (each picture with the headers before it);
``EsVideo`` is a stream of them: a raw ``.m1v``/``.m2v``/``.mpv`` file, or
what io/mpegps.py and io/mpegts.py demux.

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

SOURCE = _PKG_DIR / "native" / "mpeg12.cpp"
HEADERS = tuple(_PKG_DIR / "native" / h
                for h in ("mpegvideo_dsp.h", "swscale_rgb.h"))
LIBRARY = _PKG_DIR / "_build" / "libmpeg12dec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 256
_FRAME, _UNSUPPORTED, _FAILED = 0, 2, 3      # mpeg12dec_* return codes
_STATS = ("frames", "mpeg1_pictures", "b_pictures", "field_dct_mbs",
          "field_mc_mbs", "alternate_scan", "non_linear_quant", "intra_vlc",
          "max_dc_precision", "loaded_matrices", "matrix_coefficients",
          "concealed_mbs", "skipped_pictures", "repeat_first_field",
          "top_field_first", "interlaced_frames", "concealment_vectors",
          "full_pel", "closed_gops", "chroma_422_frames")
ES_MAGIC = b"\x00\x00\x01\xb3"          # a sequence header
_SEQ_START, _SEQ_END, _EXT = 0x1B3, 0x1B7, 0x1B5
_SLICE_MIN, _SLICE_MAX = 0x101, 0x1AF


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind, HEADERS)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64, U8 = (ctypes.POINTER, ctypes.c_int, ctypes.c_int64,
                     ctypes.POINTER(ctypes.c_uint8))
    lib.mpeg12dec_open.argtypes = [ctypes.c_char_p, I64, I, I,
                                   P(ctypes.c_void_p), ctypes.c_char_p, I]
    lib.mpeg12dec_open.restype = I
    lib.mpeg12dec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, I64,
                                     I64, P(I), P(I), P(I64),
                                     ctypes.c_char_p, I]
    lib.mpeg12dec_decode.restype = I
    lib.mpeg12dec_flush.argtypes = [ctypes.c_void_p, P(I), P(I), P(I64)]
    lib.mpeg12dec_flush.restype = I
    lib.mpeg12dec_rgb.argtypes = [ctypes.c_void_p, U8, I64]
    lib.mpeg12dec_rgb.restype = I
    lib.mpeg12dec_planes.argtypes = [ctypes.c_void_p, U8, U8, U8, I64, I64]
    lib.mpeg12dec_planes.restype = I
    lib.mpeg12dec_chroma_format.argtypes = [ctypes.c_void_p]
    lib.mpeg12dec_chroma_format.restype = I
    lib.mpeg12dec_interlaced.argtypes = [ctypes.c_void_p]
    lib.mpeg12dec_interlaced.restype = I
    lib.mpeg12dec_stats.argtypes = [ctypes.c_void_p, P(ctypes.c_int64), I]
    lib.mpeg12dec_stats.restype = I
    lib.mpeg12dec_close.argtypes = [ctypes.c_void_p]
    lib.mpeg12dec_close.restype = None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class Decoder:
    """One MPEG-1/2 video stream: ``extradata`` holds the sequence header a
    container keeps out of band (an MP4 ``esds``, a Matroska
    CodecPrivate), else nothing; ``width`` and ``height`` the size the
    container reports (0: none).  Packets go in in decode order, each a
    picture with its headers (``split_pictures``, or one container
    sample); frames come out in display order, each with ``tag``, the tag
    of the packet it was decoded from.  ``failed`` tells whether the last
    packet failed, which ends a stream where OpenCV's reader ends it;
    ``interlaced`` whether the frame last given is flagged interlaced."""

    failed = False
    tag = -1
    _hw = None

    def __init__(self, extradata: bytes = b"", width: int = 0,
                 height: int = 0):
        self._lib = load()
        self._handle = ctypes.c_void_p()
        msg = ctypes.create_string_buffer(_MSG_LEN)
        rc = self._lib.mpeg12dec_open(extradata, len(extradata), width,
                                      height, ctypes.byref(self._handle),
                                      msg, _MSG_LEN)
        if rc != 0:
            self._handle = ctypes.c_void_p()
            raise ValueError(msg.value.decode(errors="replace"))

    def _call(self, sample: Optional[bytes], tag: int
              ) -> Optional[tuple[int, int]]:
        if not self._handle:
            raise ValueError("decoder is closed")
        w, h, out = ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
        if sample is None:
            rc = self._lib.mpeg12dec_flush(self._handle, ctypes.byref(w),
                                           ctypes.byref(h), ctypes.byref(out))
        else:
            msg = ctypes.create_string_buffer(_MSG_LEN)
            rc = self._lib.mpeg12dec_decode(
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
        self._lib.mpeg12dec_rgb(self._handle, _u8(out), out.nbytes)
        return out

    def _yuv(self, hw):
        if hw is None:
            return None
        h, w = hw
        y = np.empty((h, w), np.uint8)
        ch = h if self._lib.mpeg12dec_chroma_format(self._handle) == 2 \
            else (h + 1) // 2
        u = np.empty((ch, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.mpeg12dec_planes(self._handle, _u8(y), _u8(u), _u8(v),
                                   y.nbytes, u.nbytes)
        return y, u, v

    def decode(self, sample: bytes, tag: int = -1) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of the frame ``sample`` gives (its own picture's,
        or, with B pictures, the reference before it); None when it gives
        none (a reference held back, a skipped picture, or ``failed``)."""
        return self._rgb(self._call(sample, tag))

    def decode_yuv(self, sample: bytes, tag: int = -1):
        """(Y, U, V) uint8 planes (U and V at half width, rounded up, and
        at half height for 4:2:0, full height for 4:2:2) of the frame
        ``sample`` gives, or None as ``decode``."""
        return self._yuv(self._call(sample, tag))

    def rgb(self) -> Optional[np.ndarray]:
        """The RGB of the frame last given (after ``decode_yuv``, say);
        None before the first."""
        return self._rgb(self._hw)

    def flush(self) -> Optional[np.ndarray]:
        """At the end of the stream, the RGB of the reference held back;
        None when there is none (``low_delay``)."""
        return self._rgb(self._call(None, -1))

    def flush_yuv(self):
        """``flush`` as (Y, U, V) planes."""
        return self._yuv(self._call(None, -1))

    @property
    def interlaced(self) -> bool:
        return bool(self._handle and self._lib.mpeg12dec_interlaced(
            self._handle))

    def stats(self) -> dict:
        """What the stream has used so far: frames given, pictures coded
        as MPEG-1, B pictures, macroblocks with field DCT and with field
        motion compensation, pictures with alternate scan, non-linear
        quantiser scale and B-15 intra VLCs, the largest intra DC
        precision (0-3: 8-11 bits), matrices loaded, the colour matrix
        (matrix_coefficients: 1 BT.709, 2 unknown, 5/6 BT.601), concealed
        macroblocks, pictures skipped as FFmpeg skips them, pictures with
        repeat_first_field and top_field_first, frames flagged
        interlaced, intra macroblocks with concealment vectors, full-pel
        vector sets, closed GOPs and 4:2:2 pictures."""
        if not self._handle:
            raise ValueError("decoder is closed")
        out = (ctypes.c_int64 * len(_STATS))()
        self._lib.mpeg12dec_stats(self._handle, out, len(_STATS))
        return dict(zip(_STATS, out))

    def close(self) -> None:
        if self._handle:
            self._lib.mpeg12dec_close(self._handle)
            self._handle = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def luma_read(rgb: np.ndarray) -> np.ndarray:
    """The Y plane OpenCV's ``CAP_PROP_CONVERT_RGB=0`` read gives for a
    frame of even height whose colour matrix is not BT.601 (a BT.709
    one): its swscale call then converts through BGR with the frame's
    matrix, and takes Y back from that with BT.601's limited-range
    coefficients (libswscale's unscaled rgb24toyv12), here from the
    frame's RGB as ``Decoder.decode`` gives it.  At an odd height swscale
    takes its scaling path for the second step, which this does not
    reproduce."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    y = (8414 * r + 16519 * g + 3208 * b + (16 << 15)) >> 15
    return y.astype(np.uint8)


def split_pictures(es: bytes) -> list[tuple[int, int]]:
    """(offset, size) of each packet FFmpeg's MPEG video parser
    (ff_mpeg1_find_frame_end) cuts ``es`` into: a packet ends where a
    start code other than a slice's follows the slices of its picture (a
    field picture's pair kept together), or just after a sequence end
    code."""
    out, start, found, pos, n = [], 0, 0, 0, len(es)
    while True:
        k = es.find(b"\x00\x00\x01", pos)
        if k < 0 or k + 3 >= n:
            break
        i = k + 3                          # the code's byte
        code = 0x100 | es[i]
        pos = i + 1
        slice_code = _SLICE_MIN <= code <= _SLICE_MAX
        if found == 0 and slice_code:
            found = 4
            pos = i + 2
        if code == _SEQ_END:
            out.append((start, i + 1 - start))
            start, found = i + 1, 0
            continue
        if found == 2 and code == _SEQ_START:
            found = 0
        if found < 4 and code == _EXT:
            found += 1
        if found == 4 and not slice_code:
            out.append((start, k - start))
            start, found = k, 0
            continue
        if found & 1:                      # an extension: which one
            if i + 1 < n and es[i + 1] & 0xF0 != 0x80:
                found -= 1
            elif i + 3 < n:
                found = 0 if es[i + 3] & 3 == 3 else (found + 1) & 3
                pos = i + 4
    if start < n:
        out.append((start, n - start))
    return out


def has_sequence_header(data: bytes) -> bool:
    """Whether ``data`` holds an MPEG-1/2 sequence header as FFmpeg's
    probe (mpegvideo_probe) tells one: its marker bit set, and zero bits
    up to the next start code after the matrices it loads (an MPEG-4
    GOV header shares the start code)."""
    k = data.find(ES_MAGIC)
    while 0 <= k and k + 12 <= len(data):
        p = k + 4
        j = -1
        if data[p + 6] & 0x20:
            if data[p + j + 8] & 2:
                j += 64
            if p + j + 8 < len(data) and data[p + j + 8] & 1:
                j += 64
            tail = data[p + j + 9:p + j + 12]
            if len(tail) == 3 and not int.from_bytes(tail, "big") & 0xFFFFFE:
                return True
        k = data.find(ES_MAGIC, k + 4)
    return False


def is_elementary_stream(head: bytes) -> bool:
    """Whether a file's first bytes look like MPEG-1/2 video: a sequence
    header and a picture start code among them (a stream joined mid-way
    starts elsewhere)."""
    return b"\x00\x00\x01\x00" in head and has_sequence_header(head)


def sequence_size(es: bytes) -> tuple[int, int]:
    """(width, height) of the first sequence header in ``es``; (0, 0)
    without one."""
    k = es.find(ES_MAGIC)
    if k < 0 or k + 7 > len(es):
        return 0, 0
    v = int.from_bytes(es[k + 4:k + 7], "big")
    return v >> 12, v & 0xFFF


class EsVideo:
    """An MPEG-1/2 video elementary stream held in memory (``es``): a raw
    ``.m1v``/``.m2v`` file, or the video a program or transport stream
    carries.  ``frames`` lists (offset, size, shown) of each packet of
    ``split_pictures``; ``read`` gives its bytes.  ``codec`` is
    "mpeg12"."""

    codec = "mpeg12"
    extradata = b""

    def __init__(self, es: bytes, path: str = ""):
        self.path = path
        self._es = es
        self.frames = [(o, n, True) for o, n in split_pictures(es)]
        self.width, self.height = sequence_size(es)

    @classmethod
    def open(cls, path: str) -> "EsVideo":
        try:
            with open(path, "rb") as fh:
                return cls(fh.read(), path)
        except OSError as e:
            raise IOError(f"Video wasn't opened: {path}") from e

    def read(self, frame: tuple[int, int, bool]) -> bytes:
        off, n, _ = frame
        return self._es[off:off + n]

    def close(self) -> None:
        self._es = b""
