"""MPEG-1/2 video into MPEG program and transport streams, in numpy-free
Python, for tests and fixtures: what DVD authoring tools, camcorders and
broadcast multiplexers write, with the parts a demuxer must pass over.

``write_ts`` packs pictures (the packets ``io.mpeg12.split_pictures``
gives, or an encoder's) into a transport stream: a PAT and a PMT (their
PIDs, the program number and the video's ``stream_type`` chosen by the
caller, CRC-32 as MPEG-2 computes it) before the first picture and every
few pictures after, one PES packet per picture with PTS and DTS, a PCR in
an adaptation field on each picture's first packet, adaptation-field
stuffing in its last, and optionally a second stream (MPEG-1 Layer II
silence, ``stream_type`` 0x03) interleaved; ``packet_size`` 192 writes
M2TS (a 4-byte arrival time code before each packet).

``write_ps`` packs them into a program stream: MPEG-1 or MPEG-2 pack
headers (MPEG-2 with pack stuffing), a system header, the video in PES
packets of at most ``pes_size`` bytes (MPEG-1 syntax with stuffing bytes,
or MPEG-2 syntax), and optionally MPEG audio, padding streams and
DVD-style navigation packs (private stream 2, PCI and DSI).

``display_pts`` gives each picture's presentation time from its GOP and
temporal_reference.
"""

from __future__ import annotations

import struct

_CLOCK = 90000


def crc32_mpeg(data: bytes) -> int:
    """CRC-32/MPEG-2 (polynomial 0x04C11DB7, init all ones, no reflection,
    no final xor), which PSI sections carry."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


def display_pts(pictures: list, fps: float = 25.0) -> list:
    """(pts, dts) in 90 kHz ticks of each picture (decode order): its
    display index is the picture count before its GOP plus its
    temporal_reference; dts runs one frame behind decode order."""
    tick = round(_CLOCK / fps)
    base, seen, out = 0, 0, []
    for i, pic in enumerate(pictures):
        k = pic.find(b"\x00\x00\x01\x00")
        if pic.find(b"\x00\x00\x01\xb8") >= 0 and 0 <= k:
            base, seen = base + seen, 0
        tref = (pic[k + 4] << 2 | pic[k + 5] >> 6) if k >= 0 else seen
        seen += 1
        out.append(((base + tref + 2) * tick, (i + 1) * tick))
    return out


def _stamp(marker: int, t: int) -> bytes:
    t &= (1 << 33) - 1
    return bytes([marker << 4 | (t >> 29) & 0x0E | 1,
                  (t >> 22) & 0xFF, (t >> 14) & 0xFE | 1,
                  (t >> 7) & 0xFF, (t << 1) & 0xFE | 1])


def pes(stream_id: int, payload: bytes, pts=None, dts=None,
        mpeg1: bool = False, stuffing: int = 0,
        bounded: bool = True) -> bytes:
    """One PES packet: MPEG-2 header syntax, or MPEG-1's (``stuffing``
    0xFF bytes, then the time stamps); length 0 when not ``bounded`` (a
    transport stream's video)."""
    if mpeg1:
        head = b"\xff" * stuffing
        if pts is not None and dts is not None and dts != pts:
            head += _stamp(3, pts) + _stamp(1, dts)
        elif pts is not None:
            head += _stamp(2, pts)
        else:
            head += b"\x0f"
    else:
        flags, stamps = 0, b""
        if pts is not None:
            flags = 0x80
            stamps = _stamp(2 if dts is None else 3, pts)
            if dts is not None:
                flags, stamps = 0xC0, stamps + _stamp(1, dts)
        stamps += b"\xff" * stuffing
        head = bytes([0x80, flags, len(stamps)]) + stamps
    body = head + payload
    length = len(body) if bounded and len(body) < 65536 else 0
    return b"\x00\x00\x01" + bytes([stream_id]) + struct.pack(">H", length) \
        + body


def mp2_silence(n: int) -> bytes:
    """``n`` frames of MPEG-1 Layer II, 48 kHz mono at 128 kbit/s, every
    subband unallocated (silence): 384 bytes each."""
    return (b"\xff\xfd\x84\xc0" + bytes(380)) * n


def _section(table_id: int, ext_id: int, body: bytes) -> bytes:
    sec = bytes([table_id]) + struct.pack(
        ">HHBBB", 0xB000 | (len(body) + 9), ext_id, 0xC1, 0, 0) + body
    return sec + struct.pack(">I", crc32_mpeg(sec))


def pat(programs: list) -> bytes:
    """A PAT section for (program_number, PMT PID) pairs."""
    return _section(0x00, 1, b"".join(struct.pack(">HH", n, 0xE000 | pid)
                                      for n, pid in programs))


def pmt(program: int, pcr_pid: int, streams: list) -> bytes:
    """A PMT section for (stream_type, PID) pairs."""
    body = struct.pack(">HH", 0xE000 | pcr_pid, 0xF000)
    for kind, pid in streams:
        body += bytes([kind]) + struct.pack(">HH", 0xE000 | pid, 0xF000)
    return _section(0x02, program, body)


class _TsWriter:
    def __init__(self, packet_size: int):
        self.out = bytearray()
        self.cc: dict = {}
        self.size = packet_size
        self.clock = 0

    def packet(self, pid: int, payload: bytes, start: bool,
               adaptation: bytes = b"") -> None:
        cc = self.cc.get(pid, 0)
        self.cc[pid] = (cc + 1) & 15
        room = 184 - len(payload)
        if adaptation or room > 0:
            af = adaptation
            need = room - 1                     # the length byte
            if need < len(af):
                raise ValueError("adaptation field does not fit")
            if not af and need > 0:
                af = b"\x00"                    # flags, no fields
            af += b"\xff" * (need - len(af))
            field = bytes([len(af)]) + af
            control = 3
        else:
            field, control = b"", 1
        head = bytes([0x47, (0x40 if start else 0) | pid >> 8, pid & 0xFF,
                      control << 4 | cc])
        if self.size == 192:
            self.clock += 1000
            self.out += struct.pack(">I", self.clock & 0x3FFFFFFF)
        self.out += head + field + payload

    def section(self, pid: int, sec: bytes) -> None:
        self.packet(pid, (b"\x00" + sec).ljust(184, b"\xff"), True)

    def stream(self, pid: int, data: bytes, pcr=None) -> None:
        first = True
        while data:
            af = b""
            if first and pcr is not None:
                base = pcr & ((1 << 33) - 1)
                af = b"\x10" + struct.pack(">IH", base >> 1,
                                           (base & 1) << 15 | 0x7E00)
            take = 184 - (len(af) + 1 if af else 0)
            if len(data) < take and not af:
                take = min(len(data), 182)
            self.packet(pid, data[:take], first, af)
            data, first = data[take:], False


def write_ts(path, pictures: list, *, fps: float = 25.0, video_pid=0x1011,
             pmt_pid=0x0100, program=1, stream_type=0x02, audio_pid=0x1100,
             audio: bool = True, packet_size: int = 188, psi_every: int = 4,
             extra_programs: tuple = ()) -> None:
    """A transport stream of ``pictures`` (decode order) at ``fps``: PAT
    and PMT before every ``psi_every``-th picture (``extra_programs``:
    more (program, PMT PID, streams) whose PMTs come first), one video PES
    per picture, PCR on its first packet, and MP2 silence on
    ``audio_pid`` after each picture when ``audio``."""
    w = _TsWriter(packet_size)
    streams = [(stream_type, video_pid)] + ([(0x03, audio_pid)]
                                            if audio else [])
    programs = [(p, pid) for p, pid, _ in extra_programs] + [(program,
                                                               pmt_pid)]
    stamps = display_pts(pictures, fps)
    for i, pic in enumerate(pictures):
        if i % psi_every == 0:
            w.section(0, pat(programs))
            for p, pid, s in extra_programs:
                w.section(pid, pmt(p, s[0][1], s))
            w.section(pmt_pid, pmt(program, video_pid, streams))
        pts, dts = stamps[i]
        w.stream(video_pid, pes(0xE0, pic, pts, dts, bounded=False),
                 pcr=dts * 300)
        if audio:
            w.stream(audio_pid, pes(0xC0, mp2_silence(1), pts))
    with open(path, "wb") as fh:
        fh.write(bytes(w.out))


def _pack_header(scr: int, mpeg1: bool, stuffing: int = 0) -> bytes:
    if mpeg1:
        s = _stamp(2, scr)
        return b"\x00\x00\x01\xba" + s + bytes([0x80, 0x1B, 0x83])
    scr &= (1 << 33) - 1
    v = (1 << 46 | (scr >> 30) << 43 | 1 << 42 | ((scr >> 15) & 0x7FFF) << 27
         | 1 << 26 | (scr & 0x7FFF) << 11 | 1 << 10 | 1)
    return (b"\x00\x00\x01\xba" + v.to_bytes(6, "big")
            + bytes([0x01, 0x89, 0xC3, 0xF8 | stuffing]) + b"\xff" * stuffing)


def _system_header() -> bytes:
    body = bytes([0x80, 0x1B, 0x83, 0x04, 0xE1, 0xFF,
                  0xE0, 0xE0, 0xE8, 0xC0, 0xC0, 0x20])
    return b"\x00\x00\x01\xbb" + struct.pack(">H", len(body)) + body


def nav_pack() -> bytes:
    """A DVD navigation pack's two private-stream-2 PES packets: PCI
    (substream 0x00, 980 bytes) and DSI (0x01, 1018 bytes)."""
    return (b"\x00\x00\x01\xbf" + struct.pack(">H", 980) + b"\x00"
            + bytes(979) + b"\x00\x00\x01\xbf" + struct.pack(">H", 1018)
            + b"\x01" + bytes(1017))


def write_ps(path, pictures: list, *, fps: float = 25.0, mpeg1: bool = False,
             pes_size: int = 2000, audio: bool = True, padding: bool = True,
             nav: bool = False, pack_stuffing: int = 0) -> None:
    """A program stream of ``pictures`` (decode order): a pack header (and
    the system header in the first) before each PES packet of at most
    ``pes_size`` payload bytes; MP2 silence (stream 0xC0) after each
    picture when ``audio``; a padding stream after each picture when
    ``padding``; a navigation pack before each GOP when ``nav``."""
    out = bytearray()
    stamps = display_pts(pictures, fps)
    scr = 0
    first = True
    for i, pic in enumerate(pictures):
        pts, dts = stamps[i]
        if nav and pic.find(b"\x00\x00\x01\xb8") >= 0:
            out += _pack_header(scr, mpeg1, pack_stuffing) + nav_pack()
        for k in range(0, len(pic), pes_size):
            out += _pack_header(scr, mpeg1, pack_stuffing)
            if first:
                out += _system_header()
                first = False
            stamp = (pts, dts) if k == 0 else (None, None)
            out += pes(0xE0, pic[k:k + pes_size], *stamp, mpeg1=mpeg1,
                       stuffing=3 if mpeg1 else 0)
            scr += 300
        if audio:
            out += _pack_header(scr, mpeg1, pack_stuffing) + pes(
                0xC0, mp2_silence(1), pts, mpeg1=mpeg1)
        if padding:
            out += (b"\x00\x00\x01\xbe" + struct.pack(">H", 100)
                    + b"\xff" * 100)
    out += b"\x00\x00\x01\xb9"                 # program end
    with open(path, "wb") as fh:
        fh.write(bytes(out))


# picture_coding_extension flags: (byte after the extension's start code,
# mask); picture_structure is two bits
_PCE_BITS = {"picture_structure": (2, 0x03), "top_field_first": (3, 0x80),
             "frame_pred_frame_dct": (3, 0x40), "alternate_scan": (3, 0x04),
             "repeat_first_field": (3, 0x02), "progressive_frame": (4, 0x80)}


def set_picture_coding(es: bytes, which=None, **flags) -> bytes:
    """``es`` (a picture or a stream of them) with fields of each picture
    coding extension set by hand (``which``: the indices of the
    extensions to change, all by default): ``progressive_frame``,
    ``top_field_first``, ``repeat_first_field``, ``frame_pred_frame_dct``,
    ``alternate_scan`` (0/1) or ``picture_structure`` (1-3).  Setting
    ``progressive_frame`` to 1 on an interlaced coded picture changes
    nothing in its decoding, only the flag FFmpeg gives with the frame."""
    out = bytearray(es)
    k, n = 0, 0
    while True:
        k = out.find(b"\x00\x00\x01\xb5", k)
        if k < 0 or k + 9 > len(out):
            return bytes(out)
        if out[k + 4] >> 4 == 8:
            if which is None or n in which:
                for name, value in flags.items():
                    byte, mask = _PCE_BITS[name]
                    shift = (mask & -mask).bit_length() - 1
                    i = k + 4 + byte
                    out[i] = out[i] & ~mask | (value << shift) & mask
            n += 1
        k += 4
