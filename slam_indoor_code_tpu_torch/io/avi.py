"""Motion-JPEG in AVI: the RIFF container parsed in Python, each frame a
JPEG decoded by io/jpeg.py.

The video stream's fourcc and size come from ``hdrl``/``strl``/``strh``/
``strf``; its frames are the ``movi`` list's ``##dc``/``##db`` chunks of
that stream in file order (``rec `` lists entered, empty chunks skipped),
through every ``AVIX`` extension RIFF of an OpenDML file.  This is what
OpenCV's ``VideoWriter(..., 'MJPG')`` writes and what USB webcams record.
Other codecs need a decoder the port does not have.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from . import jpeg

MJPEG_FOURCCS = (b"MJPG", b"mjpg", b"AVI1", b"jpeg")
# (offset, bytes) that mark containers other than AVI
_OTHER_CONTAINERS = ((4, b"ftyp", "MP4/QuickTime"),
                     (0, b"\x1a\x45\xdf\xa3", "Matroska/WebM"))


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


class MjpegAvi:
    """The frames of an MJPEG AVI file: ``frames`` lists (offset, size) of
    each JPEG chunk in file order; ``decode_frame`` reads and decodes one
    (thread-safe: ``os.pread`` on one descriptor)."""

    def __init__(self, path: str):
        self.path = path
        try:
            fh = open(path, "rb")
        except OSError as e:
            raise IOError(f"Video wasn't opened: {path}") from e
        with fh:
            magic = fh.read(12)
            for at, mark, name in _OTHER_CONTAINERS:
                if magic[at:at + len(mark)] == mark:
                    raise NotImplementedError(
                        f"{path}: a {name} file; only Motion-JPEG in AVI is "
                        "decoded (no decoder for its codec)")
            if magic[:4] != b"RIFF" or magic[8:12] != b"AVI ":
                raise IOError(f"Video wasn't opened: {path}")
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            self.fourcc: Optional[bytes] = None
            self.width = self.height = 0
            self._stream: Optional[int] = None
            self.frames: list[tuple[int, int]] = []
            for fcc, off, n, kind in _chunks(fh, 0, size):
                if fcc == b"RIFF" and kind in (b"AVI ", b"AVIX"):
                    self._riff(fh, off, off + n)
        if self._stream is None:
            raise IOError(f"Video wasn't opened: {path} (no video stream)")
        if self.fourcc not in MJPEG_FOURCCS:
            raise NotImplementedError(
                f"{path}: video codec {self.fourcc.decode(errors='replace')!r}"
                " needs a decoder the port does not have; only Motion-JPEG "
                "(MJPG) in AVI is decoded")
        self._fd = os.open(path, os.O_RDONLY)

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
                    strf = fh.read(min(n2, 20))
            if (self._stream is None and strh is not None
                    and strh[:4] == b"vids"):
                self._stream = index
                handler = strh[4:8]
                codec = strf[16:20] if strf and len(strf) >= 20 else b""
                # the codec is the bitmap header's compression; the
                # stream header's handler where that is empty
                self.fourcc = (codec if codec.strip(b"\0 ") else handler)
                if strf and len(strf) >= 12:
                    self.width, h = struct.unpack("<ii", strf[4:12])
                    self.height = abs(h)
            index += 1

    def _movi(self, fh, start: int, end: int) -> None:
        if self._stream is None:
            return
        ids = (b"%02ddc" % self._stream, b"%02ddb" % self._stream)
        for fcc, off, n, kind in _chunks(fh, start, end):
            if fcc == b"LIST" and kind == b"rec ":
                self._movi(fh, off, off + n)
            elif fcc in ids and n > 0:
                self.frames.append((off, n))

    def decode_frame(self, frame: tuple[int, int]) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of one frame chunk; None if it does not decode."""
        off, n = frame
        return jpeg.decode(os.pread(self._fd, n, off))

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
