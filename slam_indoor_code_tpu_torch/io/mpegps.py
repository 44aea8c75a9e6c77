"""MPEG program streams (``.mpg``, ``.mpeg``, ``.vob``, ``.mod``, ``.tod``:
DVDs, tape and HDD camcorders, OpenCV's ``MPEG``/``mpg1``/``mpg2`` writers
into ``.mpg``), demuxed as FFmpeg's ``mpeg`` demuxer reads them.

Pack headers (MPEG-1 and MPEG-2) and system headers are passed over as
FFmpeg passes them, by scanning for the next start code; padding (0xBE)
and private stream 2 (0xBF, DVD navigation packs) are skipped by their
length; audio (0xC0-0xDF) and private stream 1 (0xBD: AC-3, LPCM, DVD
subtitles) are parsed and dropped.  The video is the first stream
0xE0-0xEF to appear, its PES payloads (MPEG-1 syntax with stuffing, STD
buffer and time stamps, or MPEG-2 syntax) joined into one elementary
stream, which io/mpeg12.py cuts into pictures.  A file cut short gives
what its last PES packet holds.  A video stream that is not MPEG-1/2 (no
sequence header) raises ``NotImplementedError``.  The file is read whole
and its video held in memory (a DVD's VOB of 1 GB would take as much).
"""

from __future__ import annotations

import os

from . import mpeg12

PACK_START = b"\x00\x00\x01\xba"
_PADDING, _PRIVATE_2 = 0xBE, 0xBF


def is_program_stream(head: bytes) -> bool:
    """Whether a file's first bytes hold a pack header (a file cut before
    its first pack has one further on)."""
    return PACK_START in head


def _pes_payload(data: bytes, p: int, end: int) -> tuple[int, int]:
    """(start, end) of the payload of the PES packet whose length field is
    at ``p`` (after its start code), as FFmpeg's mpegps_read_pes_header
    parses its header; (-1, next) when the header does not parse."""
    length = int.from_bytes(data[p:p + 2], "big")
    q, stop = p + 2, min(p + 2 + length, end)
    while q < stop and data[q] == 0xFF:            # MPEG-1 stuffing
        q += 1
    if q >= stop:
        return -1, stop
    c = data[q]
    if c & 0xC0 == 0x40:                           # STD buffer
        q += 2
        c = data[q] if q < stop else 0
    if c & 0xE0 == 0x20:                           # PTS, or PTS and DTS
        q += 10 if c & 0x10 else 5
    elif c & 0xC0 == 0x80:                         # MPEG-2 PES header
        if q + 3 > stop:
            return -1, stop
        header = data[q + 2]
        if header > stop - q - 3:
            return -1, stop
        q += 3 + header
    elif c == 0x0F:
        q += 1
    else:
        return -1, q
    return min(q, stop), stop


def demux(data: bytes) -> bytes:
    """The video elementary stream of program-stream bytes ``data``."""
    video, parts = None, []
    end, pos = len(data), 0
    while True:
        k = data.find(b"\x00\x00\x01", pos)
        if k < 0 or k + 4 > end:
            break
        code = data[k + 3]
        p = k + 4
        if code in (_PADDING, _PRIVATE_2):
            pos = p + 2 + int.from_bytes(data[p:p + 2], "big")
            continue
        if not (0xC0 <= code <= 0xEF or code in (0xBD, 0xFD)):
            pos = p                     # pack and system headers, junk
            continue
        start, stop = _pes_payload(data, p, end)
        pos = max(stop, p)
        if start < 0 or not 0xE0 <= code <= 0xEF:
            continue
        if video is None:
            video = code
        if code == video:
            parts.append(data[start:stop])
    return b"".join(parts)


def open_video(path: str) -> mpeg12.EsVideo:
    """The video of the program stream at ``path`` as an
    ``mpeg12.EsVideo``; ``IOError`` when it does not open or holds no
    video, ``NotImplementedError`` for video other than MPEG-1/2."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        raise IOError(f"Video wasn't opened: {path}") from e
    es = demux(data)
    if not es:
        raise IOError(f"Video wasn't opened: {path} (no video stream)")
    if not mpeg12.has_sequence_header(es):
        raise NotImplementedError(
            f"{path}: the program stream's video is not MPEG-1/2 video "
            "(no sequence header); only MPEG-1/2 video is decoded in a "
            "program stream")
    return mpeg12.EsVideo(es, os.fspath(path))
