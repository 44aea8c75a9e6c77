"""Flash Video (``.flv``) without FFmpeg: the tags walked as FFmpeg's flv
demuxer (libavformat/flvdec.c) walks them, for OpenCV's FFmpeg backend.

The file starts with ``FLV``, a version byte, the flags (audio 4, video 1)
and the data offset, where the first previous-tag size and the tags
begin.  Each tag is its type (8 audio, 9 video, 18 script data; the low
five bits), a 24-bit size, a 24-bit timestamp and its extension byte, a
24-bit stream id and its data, followed by the size of the whole tag.
A video tag's first byte holds the frame type (high nibble; 5 is a
command frame, skipped) and the codec id (low nibble); its other bytes
are one picture.  Audio and script tags are skipped, and so are empty
ones.

Sorenson Spark (codec id 2, ``FLV1``: Flash Video's H.263, what OpenCV's
``FLV1`` writer stores) is decoded by io/h263.py in its Sorenson mode.
Every other video codec raises ``NotImplementedError`` naming it: Screen
Video 1 and 2, On2 VP6 (with alpha too), H.264, and the FourCC of an
enhanced-FLV tag (the high bit of its first byte set).

Damage is read as FFmpeg reads it: a tag cut short by the end of the file
gives the bytes there are; a previous-tag size that matches none of the
sizes FFmpeg takes (the tag's size plus 11 or 10, the size itself, or the
sum of every tag so far) drops the tag just read and resyncs, byte by
byte from its second byte, to the first place where two tags follow each
other with sizes that agree (flvdec.c's ``resync``), or ends the video
where there is none.
"""

from __future__ import annotations

import os
from typing import Optional

MAGIC = b"FLV"
SORENSON = 2
# a video tag's codec id -> its name
CODECS = {2: "Sorenson Spark (FLV1, Flash Video H.263)", 3: "Screen Video",
          4: "On2 VP6", 5: "On2 VP6 with alpha", 6: "Screen Video 2",
          7: "H.264"}
_VIDEO = 9
_COMMAND_FRAME = 5
_RESYNC_BUFFER = 1 << 20


def is_flv(head: bytes) -> bool:
    """FFmpeg's flv probe: ``FLV``, a version under 5 and a data offset
    past the nine-byte header."""
    return (len(head) >= 9 and head[:3] == MAGIC and head[3] < 5
            and head[5] == 0 and int.from_bytes(head[5:9], "big") > 8)


def _u24(b: bytes, at: int) -> int:
    return int.from_bytes(b[at:at + 3], "big")


def _u32(b: bytes, at: int) -> int:
    return int.from_bytes(b[at:at + 4], "big")


def _resync(data: bytes, start: int) -> Optional[int]:
    """flvdec.c's ``resync`` from ``start``: the first tag, as the bytes
    are read one by one, that ends two tags whose stated sizes agree with
    the previous-tag sizes after them; None at the end of the file."""
    for i in range(len(data) - start):
        e = start + i + 1                    # the bytes read so far end here
        if i <= 22:
            continue
        room = min(i, _RESYNC_BUFFER)
        lsize2 = _u32(data, e - 4)
        if lsize2 < 11 or lsize2 + 8 >= room:
            continue
        t2 = e - 4 - lsize2
        lsize1 = _u32(data, t2 - 4)
        if lsize1 < 11 or lsize1 + 8 + lsize2 >= room:
            continue
        t1 = t2 - 4 - lsize1
        if (_u24(data, t1 + 1) == lsize1 - 11
                and _u24(data, t2 + 1) == lsize2 - 11):
            return t1
    return None


class FlvVideo:
    """The video of an FLV file: ``frames`` lists (offset, size, shown) of
    each video tag's picture in file order, ``codec`` is "flv1" (the
    Sorenson Spark pictures io/h263.py decodes); ``read`` gives one
    picture's bytes.  ``NotImplementedError`` names another codec."""

    codec = "flv1"
    fourcc = b"FLV1"
    extradata = b""
    width = height = 0

    def __init__(self, path: str):
        self.path = path
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as e:
            raise IOError(f"Video wasn't opened: {path}") from e
        if not is_flv(data[:9]):
            raise IOError(f"Video wasn't opened: {path} (not FLV)")
        self.frames = self._walk(data, _u32(data, 5) + 4)
        if not self.frames:
            raise IOError(f"Video wasn't opened: {path} (no video tag)")
        self._fd = os.open(path, os.O_RDONLY)

    def _walk(self, data: bytes, pos: int) -> list[tuple[int, int, bool]]:
        """flv_read_packet over the whole file from ``pos``."""
        frames: list[tuple[int, int, bool]] = []
        n, total = len(data), 0
        while True:
            start = pos
            if pos + 8 > n:                       # the header's dts cut
                return frames
            kind, size = data[pos] & 0x1F, _u24(data, pos + 1)
            total += size + 11
            pos += 11
            frame = None
            if size:
                if kind == _VIDEO and pos < n:
                    flags = data[pos]
                    if flags >> 4 != _COMMAND_FRAME:
                        if flags & 0x80 or flags & 0x0F != SORENSON:
                            fourcc = data[pos + 1:pos + 5].decode("latin-1")
                            name = (f"enhanced-FLV {fourcc!r}" if flags & 0x80
                                    else CODECS.get(flags & 0x0F, "codec id "
                                                    f"{flags & 0x0F}"))
                            raise NotImplementedError(
                                f"{self.path}: Flash Video with {name} "
                                "video is not read by the port; of FLV's "
                                "codecs only Sorenson Spark (FLV1) is "
                                "decoded")
                        m = min(size - 1, n - pos - 1)
                        if m > 0:
                            frame = (pos + 1, m, True)
                pos += size
            if pos + 4 > n:                       # avio_feof: no test
                if frame is not None:
                    frames.append(frame)
                return frames
            last = _u32(data, pos)
            pos += 4
            if (last not in (size + 11, size + 10, total)
                    and (last != size or not last)):
                found = _resync(data, start + 1)
                if found is None:
                    return frames
                pos = found
                continue
            if frame is not None:
                frames.append(frame)

    def read(self, frame: tuple[int, int, bool]) -> bytes:
        off, n, _ = frame
        return os.pread(self._fd, n, off)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
