"""A PNG reader and writer that need no libpng: the chunks are walked and
the image data inflated here with the standard library's ``zlib`` (which
releases the GIL), and ``native/png.cpp`` unfilters, de-interlaces and
converts the rows.  It reads what libpng 1.6 reads for OpenCV's
``imread`` in colour, to the same pixels: bit depths 1, 2, 4, 8 and 16 of
gray, gray+alpha, RGB, RGBA and palette images (with or without
``tRNS``), non-interlaced or Adam7; 16-bit samples become their high byte,
gray below 8 bits is scaled to 8 bits, and alpha is dropped.  A file that
libpng refuses (a bad header, a critical chunk whose CRC fails, image data
that is short or does not inflate) raises ``ValueError``.  ``exif`` gives
an ``eXIf`` chunk's payload, whose orientation OpenCV applies
(io/exif.py).  ``decode_video_frame`` reads a PNG video frame as FFmpeg's
png decoder gives it to OpenCV's video reader.  ``write_png`` writes 8-bit RGB, every row filtered Up.

The library is built at first use with ``g++ -O2 -fPIC -shared`` into
``_build/`` inside the package (ignored by git).  If the build fails,
every decode raises with the compiler's message.  The calls release the
GIL.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SOURCE = _PKG_DIR / "native" / "png.cpp"
LIBRARY = _PKG_DIR / "_build" / "libpngdec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 128
# colour type -> the bit depths it may have
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_MAX_SIDE = 1_000_000                          # libpng's user limits
MAX_PIXELS = 1 << 30                           # OpenCV's imread limit
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT")        # a bad CRC is an error
_MNG_SIGNATURE = b"\x8aMNG\r\n\x1a\n"          # FFmpeg's png takes it too
_VIDEO = 1                                     # pngdec_rgb: FFmpeg's rules
_SIGNATURES64 = (int.from_bytes(SIGNATURE, "big"),
                 int.from_bytes(_MNG_SIGNATURE, "big"))


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def _bind(lib: ctypes.CDLL) -> None:
    I, I64, U8 = ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    lib.pngdec_rgb.argtypes = [ctypes.c_char_p, I64, I, I, I, I, I,
                               ctypes.c_char_p, I, U8, ctypes.c_char_p, I]
    lib.pngdec_rgb.restype = I


def chunks(data: bytes):
    """(type, payload) of each chunk of the PNG ``data`` up to IEND;
    ``ValueError`` where a critical chunk is cut short or fails its CRC
    (an ancillary one that does is left out, as libpng discards it), and
    where the data ends before IEND (libpng's png_read_end, which OpenCV
    calls, fails on a file cut after its image data)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        pos += 12 + n
        good = (len(crc) == 4 and struct.unpack(">I", crc)[0]
                == zlib.crc32(kind + body) & 0xFFFFFFFF)
        if not good and kind in _CRITICAL:
            raise ValueError(f"PNG: {kind.decode(errors='replace')} chunk "
                             "cut short or with a bad CRC")
        if good:
            yield kind, body
        if kind == b"IEND":
            return
    raise ValueError("PNG: the data ends before IEND")


def decode(data: bytes) -> np.ndarray:
    """HxWx3 uint8 RGB of the PNG ``data``; ``ValueError`` where libpng
    refuses it."""
    hdr, idat, palette = None, [], None
    for kind, body in chunks(data):
        if hdr is None and kind != b"IHDR":
            raise ValueError("PNG: IHDR is not the first chunk")
        if kind == b"IHDR" and len(body) == 13:
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = (body[:768] + bytes(768))[:768]
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if (ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or comp or filt
            or interlace > 1 or not 0 < w <= _MAX_SIDE
            or not 0 < h <= _MAX_SIDE or w * h > MAX_PIXELS):
        raise ValueError(f"PNG: invalid header {hdr}")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: palette image without PLTE")
    if not idat:
        raise ValueError("PNG without image data")
    try:                     # a stream cut after the last row still reads
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: {e}") from e
    out = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    rc = load().pngdec_rgb(raw, len(raw), w, h, depth, ctype, interlace,
                           palette or bytes(768), 0,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           msg, _MSG_LEN)
    if rc != 0:
        raise ValueError(f"PNG: {msg.value.decode(errors='replace')}")
    return out


def _raw_size(w: int, h: int, bits: int, interlace: int) -> int:
    """The inflated bytes every row of the image needs, filter bytes
    included."""
    if not interlace:
        return h * (1 + (w * bits + 7) // 8)
    n = 0
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:
            n += ph * (1 + (pw * bits + 7) // 8)
    return n


def parser_packets(samples, read) -> list:
    """The packets FFmpeg's png parser (libavcodec/png_parser.c) cuts a
    container's samples into, where the demuxer runs it (AVI and
    Matroska): the samples, (offset, size) each, read by ``read`` and
    taken as one stream, cut right after each IEND chunk's CRC, as the
    chunk lengths walked from each PNG signature find it (bytes before a
    signature join the packet; a length past 2^31 - 1 drops the search to
    the next sample; what is left at the end is the last packet).  Each
    packet is a tuple of its (offset, size) pieces."""
    packets, pending = [], []
    found, state64, state, pos, clen, remaining = False, 0, 0, 0, 0, 0
    for off, size in samples:
        buf = read(off, size)
        size = len(buf)
        start = 0
        while start < size:              # png_parse on what is left
            i, nxt = start, -1
            if not found:
                while i < size:
                    state64 = ((state64 << 8) | buf[i]) & ((1 << 64) - 1)
                    i += 1
                    if state64 in _SIGNATURES64:
                        found = True
                        break
            elif remaining:
                i = start + min(remaining, size - start)
                remaining -= i - start
                if remaining:
                    i = size             # the chunk goes on
                elif pos == -1:
                    nxt = i              # IEND's CRC ends here
            while found and nxt < 0 and i < size:
                state = ((state << 8) | buf[i]) & 0xFFFFFFFF
                if pos == 3:
                    clen = state
                    if clen > 0x7FFFFFFF:
                        pos, found = 0, False
                        break
                    clen += 4
                elif pos == 7:
                    if clen >= size - i:
                        remaining = clen - size + i + 1
                    if state == 0x49454E44:          # IEND
                        if remaining:
                            pos = -1
                        else:
                            nxt = clen + i + 1
                        break
                    pos = 0
                    if remaining:
                        break
                    i += clen + 1
                    continue
                pos += 1
                i += 1
            if nxt < 0:                  # no cut: the rest joins
                pending.append((off + start, size - start))
                break
            if nxt > start:
                pending.append((off + start, nxt - start))
            packets.append(tuple(pending))
            pending = []
            pos, found = 0, False
            start = nxt
    if pending:
        packets.append(tuple(pending))
    return packets


def _enough_rows(n: int, w: int, h: int, bits: int, interlace: bool) -> bool:
    """Whether ``n`` inflated bytes reach as many rows as FFmpeg needs to
    give a frame whose data ends early (measured against cv2): a
    twentieth of a plain image's rows, or every row of an Adam7 image's
    first pass."""
    if interlace:
        return n >= -(-h // 8) * (1 + (-(-w // 8) * bits + 7) // 8)
    return 20 * (n // (1 + (w * bits + 7) // 8)) >= h


def parsed_frames(frames: list, fd: int) -> list:
    """A container's (offset, size, shown) PNG samples in the file ``fd``
    as the (pieces, size, True) packets of ``parser_packets``, which
    ``read_pieces`` reads."""
    return [(p, sum(n for _, n in p), True) for p in parser_packets(
        [f[:2] for f in frames], lambda o, n: os.pread(fd, n, o))]


def read_pieces(fd: int, pieces) -> bytes:
    return b"".join(os.pread(fd, n, o) for o, n in pieces)


def decode_video_frame(data: bytes) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of one PNG video frame (``MPNG`` in AVI or
    Matroska, ``png `` in QuickTime) as OpenCV's FFmpeg backend gives it:
    FFmpeg's png decoder, then swscale to BGR.  It parts from ``decode``
    (libpng, for ``imread``) where FFmpeg does: no CRC is checked; chunks
    are walked to IEND, each whole in the data (its CRC's bytes too), IHDR
    before IDAT and once, a bad PLTE ignored; the frame is given where
    the image data reaches its last row, or ends early before IEND having
    reached a twentieth of the rows (of an Adam7 image, its first pass),
    and then the rows it does not reach are zero bytes; 16-bit gray
    rounds
    to 8 bits (swscale's gray16 conversion).  None where FFmpeg gives no
    frame (a bad signature, header or chunk, data that does not inflate,
    no IEND before the rows end); 16-bit RGB and RGBA, which swscale
    dithers to 8 bits, raise ``NotImplementedError``."""
    if data[:8] not in (SIGNATURE, _MNG_SIGNATURE):
        return None
    pos, hdr, idat, palette, iend = 8, None, [], None, False
    while len(data) - pos > 0:
        if len(data) - pos < 4:
            return None
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        if n > 0x7FFFFFFF or n + 8 > len(data) - pos:
            return None
        kind, body = data[pos:pos + 4], data[pos + 4:pos + 4 + n]
        pos += 8 + n
        if kind == b"IHDR":
            if len(body) != 13 or idat or hdr is not None:
                return None
            hdr = struct.unpack(">IIBBBBB", body)
            w, h, depth, ctype, comp = hdr[:5]
            if (not (0 < w and 0 < h and (w + 128) * (h + 128) < (1 << 28))
                    or depth not in (1, 2, 4, 8, 16) or comp):
                return None
        elif kind == b"IDAT":
            if hdr is None or ctype not in _DEPTHS or \
                    depth not in _DEPTHS[ctype]:
                return None
            if depth == 16 and ctype in (2, 6):
                raise NotImplementedError(
                    "PNG video frames of 16-bit RGB or RGBA (swscale "
                    "dithers them to 8 bits) are not read by the port")
            idat.append(body)
        elif kind == b"PLTE":
            if n % 3 == 0 and n <= 768:
                palette = (body + bytes(768))[:768]
        elif kind == b"IEND":
            if not idat:
                return None
            iend = True
            break
    if not idat:
        return None
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error:
        return None
    w, h, depth, ctype, _, _, interlace = hdr
    bits = depth * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if len(raw) < _raw_size(w, h, bits, interlace != 0):
        # IEND before the last row: FFmpeg gives the frame where the data
        # reached a twentieth of the rows (of an Adam7 image: its first
        # pass's last row)
        if not iend or not _enough_rows(len(raw), w, h, bits,
                                        interlace != 0):
            return None
    out = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(_MSG_LEN)
    load().pngdec_rgb(raw, len(raw), w, h, depth, ctype, int(interlace != 0),
                      palette or bytes(768), _VIDEO,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      msg, _MSG_LEN)
    return out


def exif(data: bytes) -> Optional[bytes]:
    """The payload of the PNG ``data``'s ``eXIf`` chunk, or None."""
    try:
        for kind, body in chunks(data):
            if kind == b"eXIf":
                return body
    except ValueError:
        pass
    return None


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to HxWx3 uint8 RGB (see ``decode``)."""
    with open(path, "rb") as fh:
        return decode(fh.read())


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write ``rgb`` [H,W,3] uint8 as an 8-bit RGB PNG, every row filtered
    Up (``read_png`` reads it back exactly)."""
    h, w, _ = rgb.shape
    rows = np.ascontiguousarray(rgb, dtype=np.uint8).reshape(h, w * 3)
    up = rows.copy()
    up[1:] -= rows[:-1]
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1).tobytes()
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw, 1)) + _chunk(b"IEND", b""))
