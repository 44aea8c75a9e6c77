"""MPEG transport streams (``.ts``, ``.m2t``, and 192-byte-packet
``.m2ts``/``.mts``: broadcast and DVR recordings, HDV camcorders, OpenCV's
``MPEG`` writer into ``.ts``), demuxed as FFmpeg's ``mpegts`` demuxer reads
them.

The packet size (188, 192 with a 4-byte time code before each packet, or
204 with 16 bytes of FEC after it) and the first packet are found by the
sync bytes, as for a file that starts mid-packet; where the sync is lost
the next packet is found by them again; a short last packet is dropped,
as FFmpeg drops it (it reads a whole packet's bytes from each sync byte,
an M2TS packet's time code being the last four of the chunk before).  The PAT gives the programs'
PMT PIDs; the first PMT read gives the streams; the video is its first
video entry: ``stream_type`` 0x01 (MPEG-1) or 0x02 (MPEG-2) is read, and
MPEG-4 Part 2 (0x10), H.264 (0x1B), HEVC (0x24), VVC (0x33), CAVS (0x42),
Dirac (0xD1) and VC-1 (0xEA) raise ``NotImplementedError`` naming the
codec.  PES packets are reassembled from ``payload_unit_start`` on, past
adaptation fields; data of the video PID before the PMT, or before its
first PES start, is dropped; a continuity-counter gap (a lost packet)
only leaves its bytes out, as FFmpeg marks such a packet corrupt and
passes it on; the last PES packet is given however short.  The joined
payloads form one elementary stream, which io/mpeg12.py cuts into
pictures.  The file is read whole and its video held in memory.
"""

from __future__ import annotations

import os
from typing import Optional

from . import mpeg12

SYNC = 0x47
VIDEO_TYPES = (0x01, 0x02)                      # MPEG-1, MPEG-2
OTHER_VIDEO = {0x10: "MPEG-4 Part 2", 0x1B: "H.264", 0x24: "HEVC",
               0x33: "VVC", 0x42: "CAVS", 0xD1: "Dirac", 0xEA: "VC-1"}
_NO_PES_HEADER = (0xBC, 0xBE, 0xBF, 0xF0, 0xF1, 0xF2, 0xF8, 0xFF)


def packet_layout(data: bytes) -> Optional[tuple[int, int]]:
    """(packet size, offset of the first sync byte) of transport-stream
    bytes: the size and offset whose sync bytes repeat most over the first
    packets (at least three in a row); None when none does."""
    best = None
    for size in (188, 192, 204):
        for off in range(min(size, max(len(data) - 2 * size, 0))):
            if data[off] != SYNC:
                continue
            n = 0
            while off + n * size < len(data) and data[off + n * size] == SYNC \
                    and n < 8:
                n += 1
            if n >= 3 and (best is None or n > best[0]):
                best = (n, size, off)
            if n >= 8:
                break
    return None if best is None else (best[1], best[2])


def is_transport_stream(head: bytes) -> bool:
    return packet_layout(head) is not None


class _Sections:
    """PSI sections of one PID, reassembled over packets."""

    def __init__(self):
        self.buf = b""

    def push(self, payload: bytes, start: bool) -> list[bytes]:
        if start:
            pointer = payload[0] if payload else 0
            rest = self.buf + payload[1:1 + pointer] if self.buf else b""
            self.buf = payload[1 + pointer:]
            out = [rest] if rest else []
        else:
            if not self.buf:
                return []
            self.buf += payload
            out = []
        while len(self.buf) >= 3 and self.buf[0] != 0xFF:
            n = 3 + ((self.buf[1] & 0x0F) << 8 | self.buf[2])
            if len(self.buf) < n:
                break
            out.append(self.buf[:n])
            self.buf = self.buf[n:]
        return [s for s in out if len(s) >= 3 and s[0] != 0xFF]


def _pmt_pids(section: bytes) -> list[int]:
    if section[0] != 0x00 or len(section) < 12:
        return []
    n = 3 + ((section[1] & 0x0F) << 8 | section[2])
    body = section[8:min(n, len(section)) - 4]
    out = []
    for i in range(0, len(body) - 3, 4):
        program = body[i] << 8 | body[i + 1]
        if program != 0:
            out.append((body[i + 2] & 0x1F) << 8 | body[i + 3])
    return out


def _video_entry(section: bytes, path: str) -> Optional[int]:
    """The PID of the first video stream a PMT section lists (raising for
    a codec the port does not decode); None without one."""
    if section[0] != 0x02 or len(section) < 16:
        return None
    n = min(3 + ((section[1] & 0x0F) << 8 | section[2]), len(section)) - 4
    i = 12 + ((section[10] & 0x0F) << 8 | section[11])
    while i + 5 <= n:
        kind, pid = section[i], (section[i + 1] & 0x1F) << 8 | section[i + 2]
        i += 5 + ((section[i + 3] & 0x0F) << 8 | section[i + 4])
        if kind in VIDEO_TYPES:
            return pid
        if kind in OTHER_VIDEO:
            raise NotImplementedError(
                f"{path}: the transport stream's video is "
                f"{OTHER_VIDEO[kind]} (stream_type 0x{kind:02X}), which needs "
                "a decoder the port does not have; MPEG-1 and MPEG-2 video "
                "are decoded in a transport stream")
    return None


def _pes_start(pes: bytes) -> int:
    """The offset of the payload in a PES packet's first bytes; -1 when
    they do not start a PES packet."""
    if len(pes) < 9 or pes[:3] != b"\x00\x00\x01":
        return -1
    if pes[3] in _NO_PES_HEADER:
        return 6
    return 9 + pes[8]


def demux(data: bytes, path: str = "") -> bytes:
    """The video elementary stream of transport-stream bytes ``data``."""
    layout = packet_layout(data)
    if layout is None:
        return b""
    size, p = layout
    psi: dict[int, _Sections] = {0: _Sections()}
    pmts: set[int] = set()
    video: Optional[int] = None
    parts: list[bytes] = []
    pes = bytearray()
    collecting = False

    def flush():
        start = _pes_start(bytes(pes[:9]))
        length = int.from_bytes(pes[4:6], "big") if len(pes) >= 6 else 0
        stop = 6 + length if length and start >= 0 else len(pes)
        if start >= 0 and stop > start:
            parts.append(bytes(pes[start:stop]))
        pes.clear()

    while p + size <= len(data):
        if data[p] != SYNC:                    # lost: find the next packet
            p += 1
            while p + size <= len(data) and not (
                    data[p] == SYNC and (p + 2 * size > len(data)
                                         or data[p + size] == SYNC)):
                p += 1
            continue
        packet = data[p:p + 188]
        p += size
        pid = (packet[1] & 0x1F) << 8 | packet[2]
        start = bool(packet[1] & 0x40)
        control = packet[3] >> 4 & 3
        q = 4
        if control & 2:
            q += 1 + packet[4] if len(packet) > 4 else 188
        if not control & 1 or q >= len(packet):
            continue
        payload = packet[q:]
        if pid in psi:
            for section in psi[pid].push(payload, start):
                if pid == 0:
                    for pmt in _pmt_pids(section):
                        if pmt not in psi:
                            psi[pmt] = _Sections()
                            pmts.add(pmt)
                elif pid in pmts and video is None:
                    video = _video_entry(section, path)
            continue
        if pid != video:
            continue
        if start:
            if collecting:
                flush()
            collecting = True
        if collecting:
            pes.extend(payload)
    if collecting:
        flush()
    return b"".join(parts)


def open_video(path: str) -> mpeg12.EsVideo:
    """The video of the transport stream at ``path`` as an
    ``mpeg12.EsVideo``; ``IOError`` when it does not open or holds no
    MPEG-1/2 video, ``NotImplementedError`` for another video codec."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        raise IOError(f"Video wasn't opened: {path}") from e
    es = demux(data, os.fspath(path))
    if not es:
        raise IOError(f"Video wasn't opened: {path} (no MPEG video stream)")
    return mpeg12.EsVideo(es, os.fspath(path))
