"""WebP photos without libwebp: the RIFF container walked here as OpenCV's
reader walks it through libwebp.  The RIFF size must lie within the file;
bytes after it are ignored.  A still image's chunks are read to its image
chunk, each of them whole with its padding.  An animation, and the EXIF
chunk of a still image (where the VP8X flags announce one), are read only
where libwebp's demuxer takes the whole file (``_demux``).  Then one of:

- lossy (``VP8 ``): the key frame decoded by ``native/vp8.cpp`` (VP8
  decodes exactly in integers, so its Y, U and V planes are libwebp's),
  and the planes turned into RGB by libwebp's own output stage as
  OpenCV's ``imread`` gets it: the "fancy" chroma upsampler and
  ``VP8YUVToR/G/B`` with their 14-bit constants (``vp8dec_webp_rgb``), not
  swscale's conversion;
- lossless (``VP8L``): the bitstream decoded by ``native/vp8l.cpp`` as
  libwebp's ``vp8l_dec.c`` decodes it (prefix codes, colour cache, LZ77,
  meta prefix codes, the four transforms), its bits read on to the end
  of the file as libwebp reads them;
- animated (``VP8X`` with the animation flag, ``ANIM``, ``ANMF``): the
  first frame as cv2 5.0's ``imread`` gives it through libwebp's
  ``WebPAnimDecoder``.  The canvas starts as zeros (black: ``ANIM``'s
  background colour is not used) and the first frame, lossy or lossless,
  is decoded into it at its offset.  Its RGB is kept under every alpha,
  transparent pixels included, whatever its blending and disposal methods
  say, so its ``ALPH`` chunk is not decoded; a lossless frame's bits are
  read to the end of its ``ANMF`` chunk.  The frame's size is its
  bitstream's (not the one ``ANMF`` states); a frame that does not lie
  inside the canvas is an error.

The simple (``VP8 ``/``VP8L`` alone) and extended (``VP8X``) layouts are
read; OpenCV takes no file under 32 bytes for a WebP.  In the extended
one a still image must have the canvas's size, an ``ALPH`` chunk's alpha
is dropped (a lossy image's is decoded, and must decode, as libwebp
decodes it) and an ``EXIF`` chunk's orientation is returned for
io/exif.py.  A damaged or truncated file raises ``ValueError`` where
libwebp refuses it; damaged VP8 data (a lossy image or frame) too, with
libwebp's tests: the frame tag and header, the partition table, and a
header, partition 0 or macroblock that needs a byte past its partition
(native/vp8.cpp's ``webp`` mode).

The lossless decoder is built at first use with ``g++ -O2 -fPIC -shared``
into ``_build/`` inside the package (ignored by git).  If the build fails,
every lossless decode raises with the compiler's message.  The calls
release the GIL.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional

import numpy as np

from . import vp8
from .native import _PKG_DIR, load_shared

SOURCE = _PKG_DIR / "native" / "vp8l.cpp"
LIBRARY = _PKG_DIR / "_build" / "libvp8ldec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_ANIMATION, _EXIF = 0x02, 0x08         # VP8X flags
_VALID_FLAGS = 0x3E                     # ICC, alpha, EXIF, XMP, animation
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30  # OpenCV's imread limits
_IMAGES = (b"VP8 ", b"VP8L")
_SIGNATURE_LEN = 32                     # OpenCV sniffs WebP in 32 bytes


def load() -> ctypes.CDLL:
    """The lossless decoder library, built on first use; raises with the
    compiler's message when it cannot be built (and on every later
    call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.POINTER, ctypes.c_int, ctypes.c_int64
    lib.vp8l_info.argtypes = [ctypes.c_char_p, I64, P(I), P(I)]
    lib.vp8l_info.restype = I
    lib.vp8l_rgb.argtypes = [ctypes.c_char_p, I64, ctypes.c_void_p]
    lib.vp8l_rgb.restype = I
    lib.vp8l_alpha_check.argtypes = [ctypes.c_char_p, I64, I, I]
    lib.vp8l_alpha_check.restype = I


def _chunks(data: bytes, start: int, end: int):
    """(fourcc, payload offset, payload size) of each chunk of
    ``data[start:end]``; every chunk and its padding must fit."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise ValueError("WebP: a chunk header cut short")
        kind = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + n + (n & 1) > end:
            raise ValueError(f"WebP: {kind!r} chunk cut short")
        yield kind, pos + 8, n
        pos += 8 + n + (n & 1)


def _u24(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16


def _lossy(data: bytes, at: int, n: int, end: int) -> np.ndarray:
    """The VP8 key frame of the ``n``-byte chunk at ``at``, its last token
    partition read on to ``end`` as libwebp's ``ParsePartitions`` reads
    it, with libwebp's refusals (io/vp8.py, ``webp=True``)."""
    _bitstream_size(data, b"VP8 ", at, n)
    dec = vp8.Decoder(webp=True)
    try:
        img = dec.decode_webp(data[at:end])
    finally:
        dec.close()
    if img is None:
        raise ValueError("WebP: the VP8 frame does not decode")
    return img


def _check_alpha(alpha: Optional[bytes], kind: bytes,
                 hw: tuple[int, int]) -> None:
    """libwebp decodes the ``ALPH`` chunk of a lossy image (the last one
    before it in a still image) even where OpenCV drops the alpha, and
    refuses the image where it does not decode."""
    if (alpha is not None and kind == b"VP8 "
            and load().vp8l_alpha_check(alpha, len(alpha), hw[1], hw[0])):
        raise ValueError("WebP: the ALPH chunk does not decode")


def _lossless_size(stream: bytes) -> tuple[int, int]:
    w, h = ctypes.c_int(), ctypes.c_int()
    if load().vp8l_info(stream, len(stream), ctypes.byref(w),
                        ctypes.byref(h)):
        raise ValueError("WebP: not a VP8L stream")
    return h.value, w.value


def _image(data: bytes, kind: bytes, at: int, n: int, end: int) -> np.ndarray:
    """The image chunk at ``at`` (``n`` bytes); a VP8L stream, and a VP8
    frame's last token partition, may be read on to ``end``, as libwebp
    reads them."""
    if kind == b"VP8 ":
        return _lossy(data, at, n, end)
    stream = data[at:end]
    out = np.empty(_lossless_size(stream) + (3,), np.uint8)
    if load().vp8l_rgb(stream, len(stream), out.ctypes.data):
        raise ValueError("WebP: the VP8L stream is damaged or truncated")
    return out


def _bitstream_size(data: bytes, kind: bytes, at: int,
                    n: int) -> tuple[int, int]:
    """(h, w) of an image chunk as libwebp's ``WebPGetFeatures`` reads it:
    a VP8L header, or a shown VP8 key frame of version 0-3 with its start
    code and a first partition inside the chunk."""
    if kind == b"VP8L":
        return _lossless_size(data[at:at + n])
    f = data[at:at + n]
    bits = int.from_bytes(f[:3], "little")
    if (n < 10 or bits & 1 or (bits >> 1) & 7 > 3 or not bits >> 4 & 1
            or bits >> 5 >= n or f[3:6] != b"\x9d\x01\x2a"):
        raise ValueError("WebP: not a VP8 key frame")
    w, h = _u16(f, 6) & 0x3FFF, _u16(f, 8) & 0x3FFF
    if not w or not h:
        raise ValueError("WebP: a VP8 frame of no size")
    return h, w


def _u16(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8


def _store_frame(data: bytes, pos: int, end: int):
    """libwebp's ``StoreFrame``: the chunks from ``pos`` read up to the
    first that is not one ALPH followed by one image chunk → (the ALPH
    payload or None, the image as (kind, offset, size, (h, w)) or None,
    where the walk stopped)."""
    alpha, image = None, None
    while True:
        if pos + 8 > end:
            raise ValueError("WebP: a frame's chunks cut short")
        kind = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + n + (n & 1) > end:
            raise ValueError(f"WebP: {kind!r} chunk cut short")
        if kind == b"ALPH" and alpha is None:
            alpha = data[pos + 8:pos + 8 + n]
        elif kind in _IMAGES and image is None:
            if kind == b"VP8L" and alpha is not None:
                raise ValueError("WebP: ALPH before a VP8L image")
            image = (kind, pos + 8, n,
                     _bitstream_size(data, kind, pos + 8, n))
        else:
            return alpha, image, pos
        pos += 8 + n + (n & 1)
        if pos == end:
            return alpha, image, pos


def _demux(data: bytes, at: int, end: int, flags: int,
           canvas: tuple[int, int]):
    """The frames of an extended WebP whose VP8X chunk ends at ``at``, as
    libwebp's demuxer finds them → ([(x, y, ALPH payload or None, image
    as _store_frame gives it)], the first EXIF payload where the flags
    announce one, or None).
    ``ValueError`` where it refuses the file: a chunk cut short or
    reaching past the RIFF size, unknown VP8X flags, a second VP8X, an
    image outside ``ANMF`` in an animation or a second one in a still, an
    ``ANMF`` before ``ANIM`` or overrunning its size, a frame with no
    image, none at all, or one outside the canvas (a still's exactly on
    it).  A frame's chunks are read to its image; what follows in the
    ``ANMF`` is walked as top-level chunks, and a frame that starts with
    another chunk is no frame."""
    if flags & ~_VALID_FLAGS:
        raise ValueError("WebP: unknown VP8X flags")
    animated = bool(flags & _ANIMATION)
    frames, anim, exif = [], False, None
    pos = at
    while pos < end:
        if pos + 8 > end:
            raise ValueError("WebP: a chunk header cut short")
        kind = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        padded = n + (n & 1)
        if pos + 8 + padded > end:
            raise ValueError(f"WebP: {kind!r} chunk cut short")
        if kind == b"VP8X":
            raise ValueError("WebP: a second VP8X chunk")
        if kind in (b"ALPH",) + _IMAGES:
            if animated or anim or frames:
                raise ValueError("WebP: an image outside the frames")
            alpha, image, pos = _store_frame(data, pos, end)
            frames.append((0, 0, alpha, image))
            continue
        if kind == b"ANIM" and padded < 6:
            raise ValueError("WebP: ANIM chunk cut short")
        anim |= kind == b"ANIM"
        if kind == b"ANMF":
            if not anim or padded < 16:
                raise ValueError("WebP: ANMF before ANIM, or cut short")
            alpha, image, nxt = _store_frame(data, pos + 24, end)
            if nxt - (pos + 24) > padded - 16:
                raise ValueError("WebP: a frame overruns its ANMF chunk")
            if animated and (alpha is not None or image):
                if frames and frames[-1][3] is None:
                    raise ValueError("WebP: a frame without an image")
                frames.append((2 * _u24(data, pos + 8),
                               2 * _u24(data, pos + 11), alpha, image))
            pos = nxt
            continue
        if kind == b"EXIF" and flags & _EXIF and exif is None:
            exif = data[pos + 8:pos + 8 + n]
        pos += 8 + padded
    if not frames or any(f[3] is None for f in frames):
        raise ValueError("WebP: no frame, or one without an image")
    for x, y, _, (_, _, _, (h, w)) in frames:
        if (x + w > canvas[1] or y + h > canvas[0]
                or not animated and (h, w) != canvas):
            raise ValueError("WebP: a frame leaves the canvas")
    return frames, exif


def decode(data: bytes) -> tuple[np.ndarray, Optional[bytes]]:
    """(HxWx3 uint8 RGB, the EXIF block or None) of the WebP ``data``."""
    if (len(data) < _SIGNATURE_LEN or data[:4] != b"RIFF"
            or data[8:12] != b"WEBP"):
        raise ValueError("not a WebP file (of 32 bytes or more)")
    end = 8 + struct.unpack_from("<I", data, 4)[0]
    if end > len(data):
        raise ValueError("WebP: the file is shorter than its RIFF size")
    chunks = _chunks(data, 12, end)
    kind, at, n = next(chunks, (None, 0, 0))
    if kind in _IMAGES:
        return _image(data, kind, at, n, len(data)), None
    if kind != b"VP8X" or n < 10:
        raise ValueError(f"WebP: {kind!r} is not an image or VP8X chunk")
    flags = data[at]
    canvas = (1 + _u24(data, at + 7), 1 + _u24(data, at + 4))
    if max(canvas) > _MAX_SIDE or canvas[0] * canvas[1] > _MAX_PIXELS:
        raise ValueError("WebP: a canvas past OpenCV's size limits")
    try:
        frames, exif = _demux(data, at + n + (n & 1), end, flags, canvas)
    except ValueError:
        if flags & _ANIMATION:
            raise
        frames, exif = None, None
    if flags & _ANIMATION:                # the first frame on the canvas
        x, y, alpha, (kind, a, m, (h, w)) = frames[0]
        _check_alpha(alpha, kind, (h, w))
        out = np.zeros(canvas + (3,), np.uint8)
        out[y:y + h, x:x + w] = _image(data, kind, a, m, a + m + (m & 1))
        return out, None
    alpha = image = None
    for c in chunks:
        if c[0] in _IMAGES:
            image = c
            break
        if c[0] == b"ALPH":
            alpha = data[c[1]:c[1] + c[2]]
    if image is None:
        raise ValueError("WebP without an image chunk")
    img = _image(data, *image, len(data))
    _check_alpha(alpha, image[0], img.shape[:2])
    if img.shape[:2] != canvas:
        raise ValueError("WebP: the image's size is not the canvas's")
    return img, exif
