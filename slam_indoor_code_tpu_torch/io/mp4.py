"""MPEG-4 Part 2, MPEG-1/2, VP9, H.263, Sorenson Spark, FFV1, HuffYUV, PNG
and Motion-JPEG video in MP4/QuickTime/3GPP: the ISO BMFF boxes parsed in
Python, each sample decoded by io/mpeg4.py, io/mpeg12.py, io/vp9.py,
io/h263.py, io/ffv1.py, io/huffyuv.py, io/png.py or io/jpeg.py.

The first track whose ``hdlr`` is ``vide`` is read: its ``stsd`` sample
entry must be ``mp4v`` with an ``esds`` whose objectTypeIndication is 0x20
(MPEG-4 Visual), whose DecoderSpecificInfo holds the VOS/VOL headers,
0x60-0x65 (MPEG-2 video: OpenCV's ``MPEG`` writer into ``.mp4``) or 0x6A
(MPEG-1 video), or 0x6C (Motion-JPEG, what OpenCV's ``MJPG`` writer puts
in ``.mp4``), or ``m2v1``/``m1v `` (MPEG-2/MPEG-1 video, OpenCV's ``MPEG``
writer into ``.mov``; ``xd5*``: XDCAM HD422's MPEG-2 4:2:2), or ``jpeg``
(Motion-JPEG, OpenCV's ``MJPG`` writer into ``.mov``), or ``s263`` (H.263 in 3GP, 3G2 and MP4: OpenCV's
``H263`` writer into ``.3gp``/``.3g2``, phones' clips) or ``h263``
(H.263 in QuickTime, OpenCV's ``H263`` writer into ``.mov``), or
``FLV1`` (Sorenson Spark, OpenCV's ``FLV1`` writer into ``.mov``), or
``png `` (a PNG file a sample: QuickTime PNG, OpenCV's ``png `` writer
into ``.mov``; ``mp4v`` with objectTypeIndication 0x6D in ``.mp4``), or
``vp09`` (VP9, OpenCV's ``vp09`` writer; its ``vpcC`` must name profile 0,
8-bit, or ``ValueError`` names what it holds), or ``FFV1``, ``HFYU`` or
``FFVH`` (OpenCV's lossless writers into ``.mov``: the configuration
record or Huffman tables in a ``glbl`` box, the depth field as the bits a
pixel).  The
samples come in decode order from ``stsz``/``stz2`` (sizes), ``stco``/
``co64`` (chunk offsets) and ``stsc`` (samples per chunk); ``stts`` and
``ctts`` give their times.  An ``edts/elst`` edit is applied as FFmpeg's
mov demuxer applies it: reading starts at the sync sample (``stss``)
before its media time, samples presented outside it are decoded but not
shown, and reading stops after the first sync sample past its end (the
second with ``ctts``, for the B-frames after it).  This is what OpenCV's
``VideoWriter(..., 'mp4v')`` writes.  Other sample entries (H.264, HEVC,
VP8, AV1, Motion-JPEG format A/B, ...) raise ``NotImplementedError`` naming
the codec.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from . import jpeg, png

# sample entry -> the codec it names, for the refusal
_CODECS = {b"avc1": "H.264", b"avc3": "H.264", b"hvc1": "HEVC",
           b"hev1": "HEVC", b"vp08": "VP8", b"vp09": "VP9", b"av01": "AV1",
           b"mjpa": "Motion-JPEG format A", b"mjpb": "Motion-JPEG format B",
           b"apch": "ProRes", b"apcn": "ProRes",
           b"ap4h": "ProRes"}
# esds objectTypeIndication -> codec
_OBJECT_TYPES = {0x20: "MPEG-4 Part 2", 0x21: "H.264", 0x60: "MPEG-2 video",
                 0x61: "MPEG-2 video", 0x62: "MPEG-2 video",
                 0x63: "MPEG-2 video", 0x64: "MPEG-2 video",
                 0x65: "MPEG-2 video", 0x6A: "MPEG-1 video",
                 0x6C: "Motion-JPEG"}
# H.263: the 3GPP and QuickTime sample entries
H263_ENTRIES = (b"s263", b"h263", b"H263")
# Sorenson Spark and PNG (a PNG file a sample): QuickTime's entries
OTHER_ENTRIES = {b"FLV1": "flv1", b"png ": "png"}
_PNG_OBJECT_TYPE = 0x6D
# the lossless sample entries QuickTime gives FFmpeg's encoders
LOSSLESS_ENTRIES = {b"FFV1": "ffv1", b"HFYU": "huffyuv", b"FFVH": "huffyuv"}
# MPEG-1/2 video: esds object types and QuickTime sample entries
MPEG12_OBJECT_TYPES = (0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x6A)
MPEG12_ENTRIES = (b"m1v ", b"m1v1", b"m2v1", b"mp1v", b"mp2v", b"hdv2",
                  b"hdv3", b"hdv6",
                  # XDCAM HD422 (MPEG-2 4:2:2 at 720p and 1080i/p)
                  b"xd51", b"xd54", b"xd55", b"xd59", b"xd5a", b"xd5b",
                  b"xd5c", b"xd5d", b"xd5e", b"xd5f")
_TOP = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot",
        b"uuid", b"meta")


def is_mp4(head: bytes) -> bool:
    """Whether the first 12 bytes of a file start an ISO BMFF/QuickTime
    file."""
    return len(head) >= 8 and head[4:8] in _TOP


def _boxes(data: bytes, start: int, end: int):
    """(type, body start, body end) of the boxes in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                return
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            return
        yield kind, pos + head, min(pos + size, end)
        pos += size


def _find(data: bytes, start: int, end: int, kind: bytes):
    for k, s, e in _boxes(data, start, end):
        if k == kind:
            return s, e
    return None


def _read_box(fh, kind: bytes) -> Optional[bytes]:
    """The body of the first top-level box ``kind`` of the open file, read
    without reading the boxes before it (mdat may be gigabytes)."""
    end = fh.seek(0, os.SEEK_END)
    pos = 0
    while pos + 8 <= end:
        fh.seek(pos)
        head = fh.read(16)
        size, k = struct.unpack(">I4s", head[:8])
        skip = 8
        if size == 1 and len(head) == 16:
            size, skip = struct.unpack(">Q", head[8:16])[0], 16
        elif size == 0:
            size = end - pos
        if size < skip:
            return None
        if k == kind:
            fh.seek(pos + skip)
            return fh.read(min(size, end - pos) - skip)
        pos += size
    return None


def _descriptor(data: bytes, pos: int):
    """(tag, body start, body end) of the MPEG-4 descriptor at pos."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def _esds(body: bytes) -> tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an esds box body."""
    tag, s, e = _descriptor(body, 4)           # after version/flags
    if tag != 3:
        raise IOError("esds without an ES_Descriptor")
    flags = body[s + 2]
    p = s + 3
    if flags & 0x80:
        p += 2                                  # dependsOn_ES_ID
    if flags & 0x40:
        p += 1 + body[p]                        # URL
    if flags & 0x20:
        p += 2                                  # OCR_ES_Id
    while p < e:
        tag, s2, e2 = _descriptor(body, p)
        if tag == 4:                            # DecoderConfigDescriptor
            oti = body[s2]
            q = s2 + 13
            while q < e2:
                t3, s3, e3 = _descriptor(body, q)
                if t3 == 5:
                    return oti, bytes(body[s3:e3])
                q = e3
            return oti, b""
        p = e2
    raise IOError("esds without a DecoderConfigDescriptor")


def _full(body: bytes) -> tuple[int, bytes]:
    """(version, rest) of a full box body."""
    return body[0], body[4:]


class Mp4Video:
    """The video track of an MP4/QuickTime file: ``frames`` lists (offset,
    size, shown) of each sample in decode order, ``codec`` "mpeg4",
    "mpeg12", "vp9", "h263", "flv1", "ffv1", "huffyuv", "png" or "mjpeg",
    ``extradata``
    its VOS/VOL headers (an MPEG-1/2 sequence header, a ``glbl`` box),
    ``width``/``height`` its sample entry's size, ``bits_per_coded_sample``
    its depth; ``decode_frame`` decodes a Motion-JPEG sample
    (thread-safe: ``os.pread`` on one descriptor)."""

    codec = "mpeg4"
    extradata = b""
    bits_per_coded_sample = 0

    def __init__(self, path: str):
        self.path = path
        try:
            with open(path, "rb") as fh:
                data = _read_box(fh, b"moov")
                self._file_size = fh.seek(0, os.SEEK_END)
        except OSError as e:
            raise IOError(f"Video wasn't opened: {path}") from e
        if data is None:
            raise IOError(f"Video wasn't opened: {path} (no moov box)")
        try:
            movie_scale = 1000
            mvhd = _find(data, 0, len(data), b"mvhd")
            if mvhd is not None:
                v, rest = _full(data[mvhd[0]:mvhd[1]])
                movie_scale = struct.unpack(">I", rest[16:20] if v == 1
                                            else rest[8:12])[0] or 1000
            found = any(kind == b"trak"
                        and self._video_track(data, s, e, movie_scale)
                        for kind, s, e in _boxes(data, 0, len(data)))
        except (IndexError, struct.error) as e:
            raise IOError(f"Video wasn't opened: {path} (malformed boxes: "
                          f"{e})") from e
        if not found:
            raise IOError(f"Video wasn't opened: {path} (no video track)")
        self._fd = os.open(path, os.O_RDONLY)

    def _video_track(self, data: bytes, start: int, end: int,
                     movie_scale: int) -> bool:
        mdia = _find(data, start, end, b"mdia")
        if mdia is None:
            return False
        hdlr = _find(data, *mdia, b"hdlr")
        if hdlr is None or data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            return False
        mdhd = self._path(data, mdia, (b"mdhd",))
        v, rest = _full(data[mdhd[0]:mdhd[1]])
        media_scale = struct.unpack(">I", rest[16:20] if v == 1
                                    else rest[8:12])[0] or 1
        stbl = data[slice(*self._path(data, mdia, (b"minf", b"stbl")))]
        tables = {k: stbl[s:e] for k, s, e in _boxes(stbl, 0, len(stbl))}
        self._sample_entry(tables.get(b"stsd", b""))
        sizes = self._sizes(tables)
        offsets = self._offsets(tables, sizes)
        dts, times = self._times(tables, len(sizes))
        edit = self._edit(data, start, end, movie_scale, media_scale)
        self.frames: list[tuple[int, int, bool]] = []
        if edit is None:
            self.frames = [(o, n, True) for o, n in zip(offsets, sizes)]
            return True
        keys = self._sync(tables, len(sizes))
        ctts = b"ctts" in tables
        first, stop = edit
        after = False
        for i in range(self._edit_start(dts, times, keys, first),
                       len(offsets)):
            t = times[i]
            self.frames.append((offsets[i], sizes[i], first <= t < stop))
            dur = dts[i + 1] - dts[i] if i + 1 < len(dts) else stop - first
            if t + dur >= stop and keys[i]:
                if ctts and not after:   # B-frames may follow it in the edit
                    after = True
                    continue
                break
        return True

    @staticmethod
    def _sync(tables: dict, n: int) -> list[bool]:
        """Whether each sample is a sync sample (``stss``; all without
        one)."""
        if b"stss" not in tables:
            return [True] * n
        _, rest = _full(tables[b"stss"])
        count = struct.unpack(">I", rest[:4])[0]
        keys = [False] * n
        for k in struct.unpack(f">{count}I", rest[4:4 + 4 * count]):
            if 0 < k <= n:
                keys[k - 1] = True
        return keys

    @staticmethod
    def _edit_start(dts: list[int], times: list[int], keys: list[bool],
                    first: int) -> int:
        """The sample FFmpeg's mov demuxer starts an edit at
        (find_prev_closest_index): the last sync sample whose decode time
        is at most the edit's media time, then back to one whose
        presentation time is too; 0 when there is none."""
        i = max((k for k in range(len(dts)) if dts[k] <= first and keys[k]),
                default=-1)
        while i >= 0 and not (times[i] <= first and keys[i]):
            i -= 1
        return max(i, 0)

    def _vpcc(self, entry: bytes) -> None:
        """A ``vp09`` entry's ``vpcC`` (VP Codec Configuration, version 1:
        profile, level, bit depth, chroma subsampling, full range): a
        stream the decoder refuses is refused here by the same name, before
        any sample is read.  The frames' own headers decide the rest."""
        box = _find(entry, 86, len(entry), b"vpcC")
        if box is None or box[1] - box[0] < 7:
            return
        cfg = entry[box[0]:box[1]]
        profile, depth = cfg[4], cfg[6] >> 4
        if profile != 0 or depth not in (0, 8):
            raise ValueError(f"{self.path}: VP9 profile {profile} "
                             f"({depth}-bit) is not decoded; only profile 0 "
                             "(8-bit 4:2:0) is")

    def _path(self, data, box, kinds):
        for kind in kinds:
            box = _find(data, *box, kind)
            if box is None:
                raise IOError(f"Video wasn't opened: {self.path} (no "
                              f"{kind.decode()} box)")
        return box

    def _sample_entry(self, stsd: bytes) -> None:
        if len(stsd) < 16:
            raise IOError(f"Video wasn't opened: {self.path} (no stsd)")
        entry = stsd[8:8 + struct.unpack(">I", stsd[8:12])[0]]
        kind = self.fourcc = entry[4:8]
        if kind not in ((b"mp4v", b"jpeg", b"vp09") + MPEG12_ENTRIES
                        + H263_ENTRIES + tuple(LOSSLESS_ENTRIES)
                        + tuple(OTHER_ENTRIES)):
            fourcc = kind.decode(errors="replace")
            raise NotImplementedError(
                f"{self.path}: video codec {_CODECS.get(kind, fourcc)} "
                f"({fourcc!r}) needs a decoder the port does not have; in MP4 "
                "only MPEG-4 Part 2 (mp4v), MPEG-1/2 (mp4v, m1v, m2v1), VP9 "
                "(vp09), H.263 (s263, h263), Sorenson Spark (FLV1), FFV1, "
                "HuffYUV (HFYU, FFVH), PNG (png , mp4v 0x6D) and "
                "Motion-JPEG (jpeg, mp4v 0x6C) are decoded")
        self.width, self.height = struct.unpack(">HH", entry[32:36])
        if kind in LOSSLESS_ENTRIES:
            self.codec = LOSSLESS_ENTRIES[kind]
            self.bits_per_coded_sample = struct.unpack(">H",
                                                       entry[82:84])[0]
            glbl = _find(entry, 86, len(entry), b"glbl")
            self.extradata = b"" if glbl is None else entry[slice(*glbl)]
            return
        if kind in H263_ENTRIES:
            self.codec = "h263"
            return
        if kind in OTHER_ENTRIES:
            self.codec = OTHER_ENTRIES[kind]
            return
        if kind in MPEG12_ENTRIES:
            self.codec = "mpeg12"
            return
        if kind == b"jpeg":
            self.codec = "mjpeg"
            return
        if kind == b"vp09":
            self.codec = "vp9"
            self._vpcc(entry)
            return
        esds = _find(entry, 86, len(entry), b"esds")
        if esds is None:
            raise IOError(f"Video wasn't opened: {self.path} (mp4v without "
                          "esds)")
        oti, extradata = _esds(entry[esds[0]:esds[1]])
        if oti in (0x6C, _PNG_OBJECT_TYPE):
            self.codec = "mjpeg" if oti == 0x6C else "png"
            return
        self.extradata = extradata
        if oti in MPEG12_OBJECT_TYPES:
            self.codec = "mpeg12"
            return
        if oti != 0x20:
            name = _OBJECT_TYPES.get(oti, f"object type 0x{oti:02x}")
            raise NotImplementedError(
                f"{self.path}: video codec {name} (mp4v, objectType"
                f"Indication 0x{oti:02x}) needs a decoder the port does not "
                "have; only MPEG-4 Part 2 (0x20), MPEG-1/2 (0x60-0x65, "
                "0x6A), Motion-JPEG (0x6C) and PNG (0x6D) are decoded")

    def _sizes(self, tables: dict) -> list[int]:
        if b"stsz" in tables:
            _, rest = _full(tables[b"stsz"])
            fixed, count = struct.unpack(">II", rest[:8])
            if fixed:                       # no file holds more samples
                return [fixed] * min(count, self._file_size // fixed + 1)
            return list(struct.unpack(f">{count}I", rest[8:8 + 4 * count]))
        if b"stz2" in tables:
            _, rest = _full(tables[b"stz2"])
            field, count = rest[3], struct.unpack(">I", rest[4:8])[0]
            raw = rest[8:]
            if field == 16:
                return list(struct.unpack(f">{count}H", raw[:2 * count]))
            if field == 8:
                return list(raw[:count])
            return [(raw[i // 2] >> (4 * (1 - i % 2))) & 15
                    for i in range(count)]
        return []

    @staticmethod
    def _offsets(tables: dict, sizes: list[int]) -> list[int]:
        """File offset of each sample: the chunks' offsets, each chunk's
        samples back to back."""
        if b"stco" in tables:
            _, rest = _full(tables[b"stco"])
            count = struct.unpack(">I", rest[:4])[0]
            chunks = struct.unpack(f">{count}I", rest[4:4 + 4 * count])
        else:
            _, rest = _full(tables.get(b"co64", bytes(8)))
            count = struct.unpack(">I", rest[:4])[0]
            chunks = struct.unpack(f">{count}Q", rest[4:4 + 8 * count])
        _, rest = _full(tables.get(b"stsc", bytes(8)))
        count = struct.unpack(">I", rest[:4])[0]
        runs = [struct.unpack(">III", rest[4 + 12 * i:16 + 12 * i])
                for i in range(count)]
        offsets = []
        for i, (first, per, _) in enumerate(runs):
            last = runs[i + 1][0] if i + 1 < len(runs) else len(chunks) + 1
            for chunk in range(first - 1, min(last - 1, len(chunks))):
                pos = chunks[chunk]
                for _ in range(per):
                    if len(offsets) == len(sizes):
                        return offsets
                    offsets.append(pos)
                    pos += sizes[len(offsets) - 1]
        return offsets

    @staticmethod
    def _times(tables: dict, n: int) -> tuple[list[int], list[int]]:
        """Decode and presentation time of each sample in media units, both
        moved up by the largest negative ``ctts`` offset, as FFmpeg's
        dts_shift moves them."""
        _, rest = _full(tables.get(b"stts", bytes(8)))
        count = struct.unpack(">I", rest[:4])[0]
        dts, t = [], 0
        for i in range(count):
            k, delta = struct.unpack(">II", rest[4 + 8 * i:12 + 8 * i])
            k = min(k, n - len(dts))
            dts += range(t, t + k * delta, delta) if delta else [t] * k
            t += k * delta
            if len(dts) == n:
                break
        dts += [t] * (n - len(dts))
        pts = list(dts)
        if b"ctts" in tables:
            v, rest = _full(tables[b"ctts"])
            count = struct.unpack(">I", rest[:4])[0]
            i = 0
            for j in range(count):
                if i >= n:
                    break
                k, off = struct.unpack(">I" + ("i" if v else "I"),
                                       rest[4 + 8 * j:12 + 8 * j])
                end = min(i + k, n)
                for m in range(i, end):
                    pts[m] += off
                i = end
            shift = max(0, max((d - p for d, p in zip(dts, pts)), default=0))
            dts = [d + shift for d in dts]
            pts = [p + shift for p in pts]
        return dts, pts

    def _edit(self, data: bytes, start: int, end: int, movie_scale: int,
              media_scale: int) -> Optional[tuple[int, int]]:
        """(first shown time, end time) in media units of the track's one
        edit; None without an edit list."""
        edts = _find(data, start, end, b"edts")
        elst = edts and _find(data, *edts, b"elst")
        if not elst:
            return None
        v, rest = _full(data[elst[0]:elst[1]])
        count = struct.unpack(">I", rest[:4])[0]
        fmt, step = (">QqI", 20) if v == 1 else (">IiI", 12)
        edits = [struct.unpack(fmt, rest[4 + step * i:4 + step * (i + 1)])
                 for i in range(count)]
        edits = [e for e in edits if e[1] != -1]   # empty edits: a delay
        if not edits:
            return None
        if len(edits) > 1:
            raise NotImplementedError(
                f"{self.path}: an edit list of {len(edits)} segments is not "
                "applied; one segment only")
        duration, media_time, _ = edits[0]
        # a zero duration shows nothing, as in FFmpeg
        return media_time, media_time + (
            duration * media_scale + movie_scale // 2) // movie_scale

    def read(self, frame: tuple[int, int, bool]) -> bytes:
        """The bytes of one sample (fewer where the file is cut short)."""
        off, size, _ = frame
        return os.pread(self._fd, max(0, min(size, self._file_size - off)),
                        off)

    def decode_frame(self, frame: tuple[int, int, bool]
                     ) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of one Motion-JPEG or PNG sample; None if it
        does not decode."""
        if self.codec == "png":
            return png.decode_video_frame(self.read(frame))
        return jpeg.decode(self.read(frame), lenient=True)

    def close(self) -> None:
        if getattr(self, "_fd", -1) >= 0:
            os.close(self._fd)
            self._fd = -1
