"""Video files: AVI parsed here, MP4/QuickTime handed to io/mp4.py and
Matroska/WebM to io/matroska.py.

In AVI, the video stream's fourcc and size come from ``hdrl``/``strl``/
``strh``/``strf``; its frames are the ``movi`` list's ``##dc``/``##db``
chunks of that stream in file order (``rec `` lists entered, empty chunks
skipped), through every ``AVIX`` extension RIFF of an OpenDML file.
Motion-JPEG (``MJPG``: OpenCV's ``VideoWriter(..., 'MJPG')``, USB
webcams) decodes each chunk by io/jpeg.py, in any order; MPEG-4 Part 2
(``XVID``, ``DIVX``, ``DX50``, ``FMP4``, ``mp4v``: OpenCV's ``XVID``
writer) decodes the chunks in order by io/mpeg4.py, which finds the VOL
headers in band; VP8 (``VP80``: OpenCV's ``VP80`` writer into ``.avi``)
in order by io/vp8.py; VP9 (``VP90``: OpenCV's ``VP90`` writer into
``.avi``) in order by io/vp9.py; H.263 and H.263+ (``H263``, ``U263``
and the other tags FFmpeg's riff.c gives them: OpenCV's ``H263`` writer)
in order by io/h263.py, each chunk a picture, and Sorenson Spark (``FLV1``:
OpenCV's ``FLV1`` writer into ``.avi``) by its Sorenson mode; PNG
(``MPNG``: OpenCV's ``MPNG`` writer) each by io/png.py, in the packets
FFmpeg's png parser cuts the chunks into; FFV1 (``FFV1``) in order by
io/ffv1.py and HuffYUV (``HFYU``, ``FFVH``) by io/huffyuv.py, each chunk a
frame, with the extradata that follows the bitmap header in ``strf``
(OpenCV's ``FFV1``, ``HFYU`` and ``FFVH`` writers); MPEG-1/2 video
(``MPEG``, ``mpg1``, ``mpg2``, ``PIM1``, ...: OpenCV's writers of those
fourccs) in order by io/mpeg12.py, each chunk a picture with its headers;
uncompressed planar 4:2:0 and gray (``I420``, ``IYUV``, ``Y800``; OpenCV's writer stores
fourcc 0 as ``I420``) each by io/rawvideo.py.  ``open_video`` reads any
of the three containers, MPEG program streams (io/mpegps.py), MPEG
transport streams (io/mpegts.py), MPEG-1/2 video elementary streams
(io/mpeg12.py), raw H.263 streams (io/h263.py) and Flash Video
(io/flv.py); other codecs raise ``NotImplementedError`` naming them,
Intel's ``I263`` (an H.263 dialect) by name.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from . import (flv, h263, jpeg, matroska, mp4, mpeg12, mpegps, mpegts,
               png, rawvideo)

MJPEG_FOURCCS = (b"MJPG", b"mjpg", b"AVI1", b"jpeg")
MPEG4_FOURCCS = (b"XVID", b"xvid", b"DIVX", b"divx", b"DX50", b"FMP4",
                 b"fmp4", b"mp4v", b"MP4V")
VP8_FOURCCS = (b"VP80", b"vp80")
VP9_FOURCCS = (b"VP90", b"vp90")
# the tags FFmpeg's riff.c maps to H.263 or H.263+ (U263), as it matches
# them: upper-cased, save lsvm
H263_FOURCCS = (b"H263", b"h263", b"X263", b"x263", b"T263", b"t263",
                b"L263", b"l263", b"M263", b"m263", b"VX1K", b"vx1k",
                b"lsvm", b"U263", b"u263")
# H.263 dialects FFmpeg decodes with decoders of their own
H263_DIALECTS = {b"I263": "Intel H.263", b"i263": "Intel H.263"}
FLV1_FOURCCS = (b"FLV1", b"flv1")      # Sorenson Spark: io/h263.py's mode
PNG_FOURCCS = (b"MPNG", b"mpng")       # a PNG file per frame: io/png.py
MPEG12_FOURCCS = (b"MPEG", b"mpeg", b"mpg1", b"MPG1", b"PIM1", b"mpg2",
                  b"MPG2", b"PIM2", b"mpgv", b"MMES", b"LMP2", b"EM2V")
# the lossless codecs: their extradata follows the bitmap header in strf
FFV1_FOURCCS = (b"FFV1", b"ffv1")
HUFFYUV_FOURCCS = (b"HFYU", b"hfyu", b"FFVH", b"ffvh")


def open_video(path: str):
    """The video of an AVI (``AviVideo``), MP4/QuickTime
    (``mp4.Mp4Video``) or Matroska/WebM file (``matroska.MkvVideo``), an
    MPEG program or transport stream or an MPEG-1/2 elementary stream
    (``mpeg12.EsVideo``), a raw H.263 stream (``h263.EsVideo``: one
    that starts with a picture start code, or named ``.h263``/``.263``)
    or a Flash Video file (``flv.FlvVideo``);
    ``IOError`` when it does not open,
    ``NotImplementedError`` for a codec the port does not read."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(_HEAD)
    except OSError as e:
        raise IOError(f"Video wasn't opened: {path}") from e
    if matroska.is_matroska(head):
        return matroska.MkvVideo(path)
    if mp4.is_mp4(head):
        return mp4.Mp4Video(path)
    if head[:4] == mpeg12.ES_MAGIC:
        return mpeg12.EsVideo.open(path)
    if (h263.is_elementary_stream(head)
            or path.lower().endswith((".h263", ".263"))):
        return h263.EsVideo.open(path)
    if flv.is_flv(head):
        return flv.FlvVideo(path)
    container = mpeg_container(head)
    if container == "MPEG program stream":
        return mpegps.open_video(path)
    if container == "MPEG transport stream":
        return mpegts.open_video(path)
    if container == "MPEG video elementary stream":
        return mpeg12.EsVideo.open(path)
    return AviVideo(path)


_HEAD = 1 << 16       # a DVD pack is 2048 bytes; a TS layout needs ~2 kB


def mpeg_container(head: bytes) -> Optional[str]:
    """"MPEG program stream" for data that starts with a pack header
    (``00 00 01 BA``), "MPEG transport stream" where sync bytes 0x47 repeat
    every 188, 192 or 204 bytes from one of the first packet's bytes (at
    least three), "MPEG program stream" again for other data holding a
    pack header (a program stream cut mid-pack), "MPEG video elementary
    stream" for data holding a sequence header and a picture (one joined
    mid-way), else None; an AVI's ``RIFF`` is none of them."""
    if head[:4] == b"RIFF":
        return None
    if head[:4] == mpegps.PACK_START:
        return "MPEG program stream"
    if mpegts.is_transport_stream(head[:9 * 204]):
        return "MPEG transport stream"
    if mpegps.is_program_stream(head):
        return "MPEG program stream"
    if mpeg12.is_elementary_stream(head):
        return "MPEG video elementary stream"
    return None


def _chunks(fh, start: int, end: int):
    """(fourcc, data offset, data size, list type or None) of the chunks
    between ``start`` and ``end``; sizes are clipped to ``end``."""
    pos = start
    while pos + 8 <= end:
        fh.seek(pos)
        head = fh.read(12)
        if len(head) < 8:
            return
        fcc, size = head[:4], struct.unpack("<I", head[4:8])[0]
        size = min(size, end - pos - 8)
        if fcc in (b"RIFF", b"LIST") and len(head) == 12:
            yield fcc, pos + 12, size - 4, head[8:12]
        else:
            yield fcc, pos + 8, size, None
        pos += 8 + size + (size & 1)


class AviVideo:
    """The video stream of an AVI file: ``frames`` lists (offset, size,
    shown) of each chunk in file order (for PNG, (pieces, size, True) of
    each packet), ``codec`` is "mjpeg", "mpeg4", "mpeg12", "vp8", "vp9",
    "h263", "flv1", "png", "ffv1", "huffyuv" or "raw"
    (``pix_fmt`` "yuv420p" or "gray"); ``extradata`` is what follows an
    FFV1 or HuffYUV stream's bitmap header (its configuration record or
    Huffman tables), ``bits_per_coded_sample`` its biBitCount;
    ``read`` reads one chunk and ``decode_frame`` decodes a Motion-JPEG or
    uncompressed one (thread-safe: ``os.pread`` on one descriptor)."""

    extradata = b""     # MPEG-4 and MPEG-1/2 in AVI carry headers in band
    bits_per_coded_sample = 0

    def __init__(self, path: str):
        self.path = path
        try:
            fh = open(path, "rb")
        except OSError as e:
            raise IOError(f"Video wasn't opened: {path}") from e
        with fh:
            magic = fh.read(12)
            if magic[:4] != b"RIFF" or magic[8:12] != b"AVI ":
                raise IOError(f"Video wasn't opened: {path}")
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            self.fourcc: Optional[bytes] = None
            self.width = self.height = 0
            self._stream: Optional[int] = None
            self.frames: list[tuple[int, int, bool]] = []
            for fcc, off, n, kind in _chunks(fh, 0, size):
                if fcc == b"RIFF" and kind in (b"AVI ", b"AVIX"):
                    self._riff(fh, off, off + n)
        if self._stream is None:
            raise IOError(f"Video wasn't opened: {path} (no video stream)")
        if self.fourcc in MJPEG_FOURCCS:
            self.codec = "mjpeg"
        elif self.fourcc in MPEG4_FOURCCS:
            self.codec = "mpeg4"
        elif self.fourcc in VP8_FOURCCS:
            self.codec = "vp8"
        elif self.fourcc in VP9_FOURCCS:
            self.codec = "vp9"
        elif self.fourcc in MPEG12_FOURCCS:
            self.codec = "mpeg12"
        elif self.fourcc in H263_FOURCCS:
            self.codec = "h263"
        elif self.fourcc in FLV1_FOURCCS:
            self.codec = "flv1"
        elif self.fourcc in PNG_FOURCCS:
            self.codec = "png"
        elif self.fourcc in FFV1_FOURCCS + HUFFYUV_FOURCCS:
            self.codec = ("ffv1" if self.fourcc in FFV1_FOURCCS
                          else "huffyuv")
            self.extradata = self._strf[40:]
        elif self.fourcc in rawvideo.FOURCCS:
            self.codec = "raw"
            self.pix_fmt = rawvideo.FOURCCS[self.fourcc]
        else:
            name = H263_DIALECTS.get(self.fourcc, "video codec")
            raise NotImplementedError(
                f"{path}: {name} {self.fourcc.decode(errors='replace')!r}"
                " needs a decoder the port does not have; in AVI only "
                "Motion-JPEG (MJPG), MPEG-4 Part 2 (XVID, DIVX, DX50, "
                "FMP4, mp4v), MPEG-1/2 (MPEG, mpg1, mpg2, PIM1), VP8 "
                "(VP80), VP9 (VP90), H.263 (H263, U263, X263, T263, L263, "
                "M263, VX1K, lsvm), Sorenson Spark (FLV1), FFV1, HuffYUV "
                "(HFYU, FFVH), PNG (MPNG) and uncompressed I420, IYUV and "
                "Y800 are decoded")
        self._fd = os.open(path, os.O_RDONLY)
        if self.codec == "png":   # FFmpeg's png parser cuts the chunks
            self.frames = png.parsed_frames(self.frames, self._fd)

    def _riff(self, fh, start: int, end: int) -> None:
        for fcc, off, n, kind in _chunks(fh, start, end):
            if fcc == b"LIST" and kind == b"hdrl":
                self._header(fh, off, off + n)
            elif fcc == b"LIST" and kind == b"movi":
                self._movi(fh, off, off + n)

    def _header(self, fh, start: int, end: int) -> None:
        index = 0
        for fcc, off, n, kind in _chunks(fh, start, end):
            if fcc != b"LIST" or kind != b"strl":
                continue
            strh = strf = None
            for f2, o2, n2, _ in _chunks(fh, off, off + n):
                fh.seek(o2)
                if f2 == b"strh":
                    strh = fh.read(min(n2, 8))
                elif f2 == b"strf":
                    strf = fh.read(min(n2, 1 << 20))
            if (self._stream is None and strh is not None
                    and strh[:4] == b"vids"):
                self._stream = index
                handler = strh[4:8]
                codec = strf[16:20] if strf and len(strf) >= 20 else b""
                # the codec is the bitmap header's compression; the
                # stream header's handler where that is empty
                self.fourcc = (codec if codec.strip(b"\0 ") else handler)
                self._strf = strf or b""
                if strf and len(strf) >= 12:
                    self.width, h = struct.unpack("<ii", strf[4:12])
                    self.height = abs(h)
                if strf and len(strf) >= 16:
                    self.bits_per_coded_sample = struct.unpack(
                        "<H", strf[14:16])[0]
            index += 1

    def _movi(self, fh, start: int, end: int) -> None:
        if self._stream is None:
            return
        ids = (b"%02ddc" % self._stream, b"%02ddb" % self._stream)
        for fcc, off, n, kind in _chunks(fh, start, end):
            if fcc == b"LIST" and kind == b"rec ":
                self._movi(fh, off, off + n)
            elif fcc in ids and n > 0:
                self.frames.append((off, n, True))

    def read(self, frame: tuple[int, int, bool]) -> bytes:
        """The bytes of one chunk (fewer where the file is cut short), or
        of a PNG packet's pieces."""
        off, n, _ = frame
        if isinstance(off, tuple):
            return png.read_pieces(self._fd, off)
        return os.pread(self._fd, n, off)

    def decode_frame(self, frame: tuple[int, int, bool]
                     ) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of one Motion-JPEG, PNG or uncompressed chunk;
        None if it does not decode."""
        if self.codec == "raw":
            return rawvideo.decode(self.read(frame), self.pix_fmt,
                                   self.width, self.height)
        if self.codec == "png":
            return png.decode_video_frame(self.read(frame))
        return jpeg.decode(self.read(frame), lenient=True)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
