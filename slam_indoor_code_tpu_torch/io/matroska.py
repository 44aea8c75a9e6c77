"""Matroska and WebM video: the EBML elements parsed in Python with
``os.pread``, without FFmpeg.

The EBML header must name the DocType ``webm`` or ``matroska``.  In the
Segment, Info gives the TimecodeScale and Tracks the first video track
(TrackType 1): its TrackNumber, CodecID, CodecPrivate, FlagLacing and
Video/PixelWidth/PixelHeight.  Its frames are that track's SimpleBlocks and
BlockGroup/Blocks in file order, through every Cluster; Xiph, EBML and
fixed lacing are split into their frames.  Void, CRC-32, SeekHead, Cues,
Tags, Chapters, Attachments and every other element are skipped.  A
Segment or Cluster of unknown size (the norm in what browsers'
MediaRecorder writes, which has no Cues) ends at the first element that
cannot be its child.  A block that runs past the end of the file is
dropped, as FFmpeg's demuxer drops it.

Codecs: ``V_VP8`` is "vp8" (io/vp8.py), ``V_VP9`` "vp9" (io/vp9.py),
``V_FFV1`` "ffv1" with CodecPrivate as its configuration record
(io/ffv1.py: OpenCV's ``FFV1`` writer into ``.mkv``),
``V_MPEG4/ISO/SP|ASP|AP`` "mpeg4"
with CodecPrivate as its VOL headers (io/mpeg4.py), ``V_MPEG1`` and
``V_MPEG2`` "mpeg12" with CodecPrivate as its sequence header
(io/mpeg12.py), ``V_MJPEG`` "mjpeg"
(io/jpeg.py); ``V_MS/VFW/FOURCC`` takes the codec of its bitmap header's
fourcc, as in AVI, with the extradata that follows the header (H.263 and
HuffYUV among them: OpenCV's ``H263``, ``HFYU`` and ``FFVH`` writers into
``.mkv``; ``FLV1``, Sorenson Spark, and ``MPNG``, a PNG file a frame:
its ``FLV1`` and ``MPNG`` writers).  Every other CodecID (AV1, H.264, HEVC, ...)
and any ContentEncoding (header stripping, compression, encryption) raise
``NotImplementedError`` naming it.  ``MkvVideo`` has the interface of
``avi.AviVideo`` and ``mp4.Mp4Video``.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from . import jpeg, png

EBML = 0x1A45DFA3
SEGMENT = 0x18538067
CLUSTER = 0x1F43B675
# the Segment's children: where a Cluster of unknown size ends
_LEVEL1 = {0x114D9B74, 0x1549A966, 0x1654AE6B, CLUSTER, 0x1C53BB6B,
           0x1254C367, 0x1043A770, 0x1941A469}
_INFO, _TRACKS, _TRACK_ENTRY = 0x1549A966, 0x1654AE6B, 0xAE
_SIMPLE_BLOCK, _BLOCK_GROUP, _BLOCK = 0xA3, 0xA0, 0xA1
_UNKNOWN = -1

_MPEG4 = ("V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP")
_CODEC_NAMES = {"V_AV1": "AV1", "V_MPEG4/ISO/AVC": "H.264",
                "V_MPEGH/ISO/HEVC": "HEVC", "V_THEORA": "Theora",
                "V_PRORES": "ProRes", "V_UNCOMPRESSED": "uncompressed video",
                "V_MPEG4/MS/V3": "MS-MPEG4 v3", "V_REAL/RV40": "RealVideo 4"}
_COMPRESSION = {0: "zlib compression", 1: "bzlib compression",
                2: "lzo1x compression", 3: "header stripping"}
_LACING = {1: "Xiph", 2: "fixed-size", 3: "EBML"}


def is_matroska(head: bytes) -> bool:
    """Whether a file's first bytes start an EBML (Matroska/WebM) file."""
    return head[:4] == b"\x1a\x45\xdf\xa3"


def _vint(data: bytes, pos: int, keep_marker: bool):
    """(value, length) of the EBML variable-size integer at data[pos];
    a size whose bits are all ones is ``_UNKNOWN``."""
    if pos >= len(data) or data[pos] == 0:
        raise IOError("bad EBML integer")
    first = data[pos]
    n = 8 - first.bit_length() + 1
    if pos + n > len(data):
        raise IOError("EBML integer past the end")
    value = first if keep_marker else first & (0xFF >> n)
    for b in data[pos + 1:pos + n]:
        value = (value << 8) | b
    if not keep_marker and value == (1 << (7 * n)) - 1:
        return _UNKNOWN, n
    return value, n


def _uint(data: bytes) -> int:
    return int.from_bytes(data, "big") if data else 0


class MkvVideo:
    """The first video track of a Matroska or WebM file: ``frames`` lists
    (offset, size, shown) of each frame in file order, ``codec`` is "vp8",
    "vp9", "mpeg4", "mpeg12", "h263", "ffv1", "huffyuv" or "mjpeg",
    ``extradata`` its CodecPrivate (a VfW track's: what follows the bitmap
    header); ``read`` reads one frame and ``decode_frame`` decodes a
    Motion-JPEG one (thread-safe: ``os.pread`` on one descriptor);
    ``fourcc`` is a VfW track's fourcc, ``bits_per_coded_sample`` its
    biBitCount."""

    fourcc = b""
    bits_per_coded_sample = 0

    def __init__(self, path: str):
        self.path = path
        try:
            self._fd = os.open(path, os.O_RDONLY)
        except OSError as e:
            raise IOError(f"Video wasn't opened: {path}") from e
        try:
            self._size = os.fstat(self._fd).st_size
            self._parse()
        except IOError as e:
            self.close()
            raise IOError(f"Video wasn't opened: {path} ({e})") from e
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------ elements

    def _header(self, pos: int):
        """(id, data start, data end or ``_UNKNOWN``) of the element at
        ``pos``; None past the end of the file."""
        head = os.pread(self._fd, 12, pos)
        if len(head) < 2:
            return None
        eid, n = _vint(head, 0, True)
        size, m = _vint(head, n, False)
        start = pos + n + m
        return eid, start, (_UNKNOWN if size == _UNKNOWN else start + size)

    def _children(self, start: int, end: int):
        """(id, data start, data end) of the elements in [start, end); an
        element of unknown size is given with end ``_UNKNOWN`` and ends
        the walk, as does an EBML header."""
        pos = start
        while pos < end:
            try:
                h = self._header(pos)
            except IOError:
                return
            if h is None:
                return
            eid, s, e = h
            if eid == EBML:
                return
            yield eid, s, e
            if e == _UNKNOWN:
                return
            pos = e

    def _read(self, start: int, end: int) -> bytes:
        return os.pread(self._fd, max(0, min(end, self._size) - start),
                        start)

    # -------------------------------------------------------------- layout

    def _parse(self) -> None:
        h = self._header(0)
        if h is None or h[0] != EBML or h[2] == _UNKNOWN:
            raise IOError("not an EBML file")
        doctype = b"matroska"   # the EBML default
        for eid, s, e in self._children(h[1], h[2]):
            if eid == 0x4282:
                doctype = self._read(s, e).rstrip(b"\0")
        if doctype not in (b"webm", b"matroska"):
            raise IOError(f"DocType {doctype!r} is not Matroska or WebM")
        self.timecode_scale = 1_000_000
        self.track: Optional[int] = None
        self.codec_id = ""
        self.extradata = b""
        self.width = self.height = 0
        self._lacing = True
        self.frames: list[tuple[int, int, bool]] = []
        self._clusters: list[tuple[int, int]] = []
        pos = h[2]
        while True:
            seg = self._header(pos) if pos < self._size else None
            if seg is None:
                break
            eid, s, e = seg
            if eid == SEGMENT:
                self._segment(s, self._size if e == _UNKNOWN else e)
                break       # the first Segment holds the video
            if e == _UNKNOWN:
                break
            pos = e
        if self.track is None:
            raise IOError("no video track")
        self._set_codec()
        for s, e in self._clusters:
            self._cluster(s, e)
        if self.codec == "png":   # FFmpeg's png parser cuts the blocks
            self.frames = png.parsed_frames(self.frames, self._fd)

    def _segment(self, start: int, end: int) -> None:
        pos = start
        while pos < end:
            try:
                h = self._header(pos)
            except IOError:     # cut inside an element's header
                return
            if h is None or h[0] == EBML:
                return
            eid, s, e = h
            if eid == _INFO and e != _UNKNOWN:
                for cid, cs, ce in self._children(s, e):
                    if cid == 0x2AD7B1:
                        self.timecode_scale = _uint(self._read(cs, ce))
            elif eid == _TRACKS and e != _UNKNOWN and self.track is None:
                for cid, cs, ce in self._children(s, e):
                    if cid == _TRACK_ENTRY and ce != _UNKNOWN:
                        self._track_entry(cs, ce)
                        if self.track is not None:
                            break
            elif eid == CLUSTER:
                if e == _UNKNOWN:
                    e = self._cluster_end(s, end)
                self._clusters.append((s, e))
            if e == _UNKNOWN:     # another element of unknown size
                return
            pos = e

    def _cluster_end(self, start: int, end: int) -> int:
        """Where a Cluster of unknown size ends: at the first element that
        cannot be its child (a Segment child, an EBML header)."""
        pos = start
        while pos < end:
            try:
                h = self._header(pos)
            except IOError:
                return pos
            if h is None:
                return pos
            eid, s, e = h
            if eid in _LEVEL1 or eid == EBML or e == _UNKNOWN:
                return pos
            pos = e
        return end

    def _track_entry(self, start: int, end: int) -> None:
        fields: dict = {}
        encodings = None
        for eid, s, e in self._children(start, end):
            if e == _UNKNOWN:
                break
            if eid in (0xD7, 0x83, 0x9C):      # number, type, lacing
                fields[eid] = _uint(self._read(s, e))
            elif eid == 0x86:
                fields[eid] = self._read(s, e).rstrip(b"\0").decode(
                    "ascii", "replace")
            elif eid == 0x63A2:
                fields[eid] = self._read(s, e)
            elif eid == 0xE0:
                for vid, vs, ve in self._children(s, e):
                    if vid in (0xB0, 0xBA) and ve != _UNKNOWN:
                        fields[vid] = _uint(self._read(vs, ve))
            elif eid == 0x6D80:
                encodings = (s, e)
        if fields.get(0x83) != 1:
            return
        self.track = fields.get(0xD7, 0)
        self.codec_id = fields.get(0x86, "")
        self.extradata = fields.get(0x63A2, b"")
        self.width, self.height = fields.get(0xB0, 0), fields.get(0xBA, 0)
        self._lacing = bool(fields.get(0x9C, 1))
        if encodings is not None:
            self._refuse_encoding(*encodings)

    def _refuse_encoding(self, start: int, end: int) -> None:
        for eid, s, e in self._children(start, end):
            if eid != 0x6240 or e == _UNKNOWN:       # ContentEncoding
                continue
            what = "content encoding"
            for cid, cs, ce in self._children(s, e):
                if cid == 0x5034 and ce != _UNKNOWN:     # ContentCompression
                    algo = 0
                    for aid, a_s, a_e in self._children(cs, ce):
                        if aid == 0x4254:
                            algo = _uint(self._read(a_s, a_e))
                    what = _COMPRESSION.get(algo, f"compression {algo}")
                elif cid == 0x5035:
                    what = "encryption"
            raise NotImplementedError(
                f"{self.path}: Matroska ContentEncoding ({what}) of the "
                "video track is not read")

    def _set_codec(self) -> None:
        cid = self.codec_id
        if cid == "V_MS/VFW/FOURCC" and len(self.extradata) >= 20:
            from . import avi

            fourcc = self.fourcc = self.extradata[16:20]
            w, h = struct.unpack("<ii", self.extradata[4:12])
            self.bits_per_coded_sample = struct.unpack(
                "<H", self.extradata[14:16])[0]
            self.width, self.height = self.width or w, self.height or abs(h)
            extra = self.extradata[40:]
            self.extradata = b""
            for codec, fourccs in (("mjpeg", avi.MJPEG_FOURCCS),
                                   ("mpeg4", avi.MPEG4_FOURCCS),
                                   ("mpeg12", avi.MPEG12_FOURCCS),
                                   ("vp8", avi.VP8_FOURCCS),
                                   ("vp9", avi.VP9_FOURCCS),
                                   ("h263", avi.H263_FOURCCS),
                                   ("flv1", avi.FLV1_FOURCCS),
                                   ("png", avi.PNG_FOURCCS),
                                   ("ffv1", avi.FFV1_FOURCCS),
                                   ("huffyuv", avi.HUFFYUV_FOURCCS)):
                if fourcc in fourccs:
                    self.codec = codec
                    self.extradata = (extra if codec in ("mpeg4", "mpeg12",
                                                         "ffv1", "huffyuv")
                                      else b"")
                    return
            name = avi.H263_DIALECTS.get(fourcc, "video codec")
            raise NotImplementedError(
                f"{self.path}: {name} "
                f"{fourcc.decode(errors='replace')!r} needs a decoder the "
                "port does not have")
        if cid == "V_VP8":
            self.codec = "vp8"
        elif cid == "V_VP9":
            self.codec = "vp9"
        elif cid == "V_FFV1":
            self.codec = "ffv1"
        elif cid in _MPEG4:
            self.codec = "mpeg4"
        elif cid in ("V_MPEG1", "V_MPEG2"):
            self.codec = "mpeg12"
        elif cid == "V_MJPEG":
            self.codec = "mjpeg"
        else:
            name = _CODEC_NAMES.get(cid, cid)
            raise NotImplementedError(
                f"{self.path}: {name} video ({cid}) needs a decoder the port "
                "does not have; in Matroska/WebM only VP8, VP9, MPEG-4 "
                "Part 2, MPEG-1/2, FFV1, Motion-JPEG and (as VfW) H.263 and "
                "HuffYUV are decoded")

    # --------------------------------------------------------------- blocks

    def _cluster(self, start: int, end: int) -> None:
        for eid, s, e in self._children(start, end):
            if e == _UNKNOWN:
                return
            if eid == _SIMPLE_BLOCK:
                self._block(s, e)
            elif eid == _BLOCK_GROUP:
                for bid, bs, be in self._children(s, min(e, end)):
                    if bid == _BLOCK and be != _UNKNOWN:
                        self._block(bs, be)

    def _block(self, start: int, end: int) -> None:
        if end > self._size:        # cut by the end of the file: dropped
            return
        head = os.pread(self._fd, min(end - start, 4096), start)
        try:
            track, n = _vint(head, 0, False)
        except IOError:
            return
        if track != self.track or len(head) < n + 3:
            return
        flags = head[n + 2]
        pos = n + 3
        lacing = (flags >> 1) & 3
        if not lacing:
            self.frames.append((start + pos, end - start - pos, True))
            return
        if not self._lacing:
            raise ValueError(f"{self.path}: {_LACING[lacing]} lacing in a "
                             "track whose FlagLacing is 0")
        if pos >= len(head):
            raise ValueError(f"{self.path}: a laced block cut short")
        count = head[pos] + 1
        pos += 1
        sizes: list[int] = []
        try:
            if lacing == 1:                     # Xiph
                for _ in range(count - 1):
                    size = 0
                    while True:
                        b = head[pos]
                        pos += 1
                        size += b
                        if b != 255:
                            break
                    sizes.append(size)
            elif lacing == 3:                   # EBML
                size, m = _vint(head, pos, False)
                pos += m
                sizes.append(size)
                for _ in range(count - 2):
                    raw, m = _vint(head, pos, False)
                    pos += m
                    size += raw - ((1 << (7 * m - 1)) - 1)
                    sizes.append(size)
        except (IndexError, IOError) as e:
            raise ValueError(f"{self.path}: {_LACING[lacing]} lacing "
                             "header cut short") from e
        total = end - start - pos
        if lacing == 2:                         # fixed
            if total % count:
                raise ValueError(f"{self.path}: fixed-size lacing of "
                                 f"{total} bytes into {count} frames")
            sizes = [total // count] * (count - 1)
        last = total - sum(sizes)
        if last < 0 or any(s < 0 for s in sizes):
            raise ValueError(f"{self.path}: {_LACING[lacing]} lacing sizes "
                             "past the block's end")
        off = start + pos
        for size in sizes + [last]:
            self.frames.append((off, size, True))
            off += size

    # ---------------------------------------------------------------- reads

    def read(self, frame: tuple[int, int, bool]) -> bytes:
        """The bytes of one frame (of a PNG packet's pieces)."""
        off, n, _ = frame
        if isinstance(off, tuple):
            return png.read_pieces(self._fd, off)
        return os.pread(self._fd, n, off)

    def decode_frame(self, frame: tuple[int, int, bool]
                     ) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of one Motion-JPEG or PNG frame; None if it
        does not decode."""
        if self.codec == "png":
            return png.decode_video_frame(self.read(frame))
        return jpeg.decode(self.read(frame), lenient=True)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
