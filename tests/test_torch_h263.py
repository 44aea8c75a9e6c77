"""The port's H.263 video (io/h263.py over native/h263.cpp, and the H.263
entries of io/avi.py, io/mp4.py and io/matroska.py) on the CPU, against
OpenCV's default FFmpeg backend: RGB frames bit for bit and frame for
frame against ``cv2.VideoCapture(p)``, the Y plane bit for bit against
its ``CAP_PROP_CONVERT_RGB=0`` read, in cv2's frame count.

Every stream is coded here: by cv2's ``H263`` writer at the five standard
sizes into each container it writes (AVI, Matroska, QuickTime, 3GP and
3G2, the last two as ``s263``), and by the ``h263`` and ``h263p``
encoders of the libavcodec cv2's wheel carries (``lavc_encode``) over a
pan of a blurred-noise texture: baseline with 4MV, OBMC and GOB headers;
H.263+ with each annex FFmpeg writes alone and all together (D
unrestricted vectors, F 4MV and OBMC, I advanced intra coding with T
modified quantisation, J deblocking, K slices, S the alternative inter
VLC) at custom sizes (not whole macroblocks, and FHD); several GOPs at
quantisers 1, 2, 8 and 31; intra pictures with AC prediction written
here by a small bit writer (FFmpeg's encoder never predicts AC).  The
streams go into raw ``.h263`` files (FFmpeg's parser's cut), 3GP files
written here (``write_3gp``), AVIs under each fourcc FFmpeg maps to
H.263, and Matroska; a stream joined at a P-picture (FFmpeg's dummy
reference).  Damage: a cut file and a damaged GOB or slice
(cv2's count; FFmpeg's concealment held to
``damaged_frame_holds_to_cv2``); random damage raises nothing but
refusals.  Refusals by name: the annexes the decoder does not read,
Intel's I263 and Sorenson's FLV1, and MPEG-4's short video header (an
``mp4v`` whose samples are H.263 pictures: FFmpeg's mpeg4 decoder
refuses each sample, and cv2 reads no frame of it).  Against the JAX
package: ``MediaSource`` and ``slam_main`` on a 540x960 H.263+ 3GP.
The committed fixtures in ``testing/video_fixtures/`` (the FHD headline
``headline_h263p.3gp`` and the small ones) against their recorded cv2
sha256, which chip_smoke.py holds the card to.

Rewrite the fixtures with ``PYTHONPATH=.:tests python
tests/test_torch_h263.py --write-fixtures`` (~10 s)."""

import json
import pathlib
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, h263, mp4
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg
from test_torch_mp4 import (FIXTURE as MP4_FIXTURE, _Bits, _box, _esds,
                            _rebuild, cv2_rgb, damaged_frame_holds_to_cv2,
                            lavc_encode, write_cv2_video)
from test_torch_mpeg2 import _sha, cv2_luma
from test_torch_vp9 import pan
from test_torch_webm import write_mkv

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures"
FIXTURE = FIXTURES / "headline_h263p.3gp"
DIGESTS = FIXTURES / "cv2_sha256.json"
# cv2's H263 writer into each container; a 4CIF baseline stream with 4MV,
# OBMC and GOB headers; a raw H.263+ stream with every annex; a U263 AVI
SMALL_FIXTURES = ("h263_cv2.avi", "h263_cv2.3gp", "h263_cv2.3g2",
                  "h263_cv2.mov", "h263_cv2.mkv", "h263_4cif_obmc.avi",
                  "h263p_annexes.h263", "h263p_u263.avi")
# every annex FFmpeg's h263p encoder writes: D, F (4MV, OBMC), I (with T),
# J, K (slices: ps gives several per picture), S
ALL_ANNEXES = {"flags": "+aic+loop+mv4", "umv": "1", "aiv": "1",
               "structured_slices": "1", "obmc": "1"}
# the headline: every annex at a fixed quantiser of 8, an I-picture every
# 16 and about three slices a picture
HEADLINE_OPTIONS = {**ALL_ANNEXES, "ps": "16000", "qmin": "8", "qmax": "8",
                    "g": "16"}


# ------------------------------------------------------------- streams

def encode(frames, options: dict, codec: str = "h263p") -> list:
    """``frames`` coded by libavcodec's ``h263p`` (or ``h263``), one packet
    per picture."""
    return lavc_encode(codec, frames, dict(options))[0]


def header_fields(packet: bytes) -> dict:
    """The bit offsets of a picture header's fields FFmpeg's encoders write
    (PTYPE's, or PLUSPTYPE's with OPPTYPE), and the picture type."""
    b = _Bits(packet[:32])
    b.get(22 + 8 + 5)
    fmt = b.get(3)
    if fmt != 7:
        at = b.pos
        return {"plus": False, "intra": b.get(1) == 0, "type": at,
                "umv": at + 1, "sac": at + 2, "ap": at + 3, "pb": at + 4,
                "cpm": at + 10, "pei": at + 11}
    ufep = b.get(3)
    out = {"plus": True, "ufep": ufep}
    if ufep == 1:
        at = b.pos
        out.update(format=b.get(3), pcf=at + 3, sac=at + 5, rps=at + 10,
                   isd=at + 11, reserved=at + 15)
        b.get(15)
    at = b.pos
    out.update(type=at, intra=b.get(3) == 0, rpr=at + 3, rru=at + 4,
               mpp_reserved=at + 6, cpm=at + 9)
    return out


def set_bits(packet: bytes, pos: int, n: int, value: int) -> bytes:
    """``packet`` with the ``n`` bits at bit ``pos`` set to ``value``."""
    v = int.from_bytes(packet, "big")
    shift = 8 * len(packet) - pos - n
    v = v & ~(((1 << n) - 1) << shift) | (value << shift)
    return v.to_bytes(len(packet), "big")


def write_3gp(path, packets, w: int, h: int, entry: bytes = b"s263",
              brand: bytes = b"3gp4") -> None:
    """A 3GPP file as FFmpeg's mov muxer writes one for H.263: an ``s263``
    sample entry with its ``d263`` box, one chunk, a picture per sample
    at 10 frames/s, the I-pictures as sync samples."""
    def full(kind, body, flags=0):
        return _box(kind, struct.pack(">I", flags) + body)

    n = len(packets)
    intra = [header_fields(p)["intra"] for p in packets]
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                         0x40000000)
    ftyp = _box(b"ftyp", brand + struct.pack(">I", 512) + brand + b"isom")
    mdat_off = len(ftyp) + 8
    mdat = _box(b"mdat", b"".join(packets))
    sample = (bytes(6) + struct.pack(">H", 1) + bytes(16)
              + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1)
              + bytes(32) + struct.pack(">Hh", 0x18, -1)
              + _box(b"d263", b"FFMP" + bytes([0, 10, 0])))
    stbl = _box(b"stbl", b"".join([
        full(b"stsd", struct.pack(">I", 1) + _box(entry, sample)),
        full(b"stts", struct.pack(">III", 1, n, 1000)),
        full(b"stss", struct.pack(">I", sum(intra)) + b"".join(
            struct.pack(">I", i + 1) for i in range(n) if intra[i])),
        full(b"stsc", struct.pack(">IIII", 1, 1, n, 1)),
        full(b"stsz", struct.pack(">II", 0, n) + b"".join(
            struct.pack(">I", len(p)) for p in packets)),
        full(b"stco", struct.pack(">II", 1, mdat_off))]))
    minf = _box(b"minf", full(b"vmhd", bytes(8), flags=1) + _box(
        b"dinf", full(b"dref", struct.pack(">I", 1) + full(
            b"url ", b"", flags=1))) + stbl)
    mdia = _box(b"mdia", full(b"mdhd", struct.pack(">IIIIHH", 0, 0, 10000,
                                                   n * 1000, 0x55C4, 0))
                + full(b"hdlr", bytes(4) + b"vide" + bytes(12)
                       + b"VideoHandler\0") + minf)
    ms = n * 100
    trak = _box(b"trak", full(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, ms)
                              + bytes(8) + struct.pack(">hhhH", 0, 0, 0, 0)
                              + matrix + struct.pack(">II", w << 16, h << 16),
                              flags=3) + mdia)
    mvhd = full(b"mvhd", struct.pack(">IIIIIH", 0, 0, 1000, ms, 0x10000,
                                     0x100) + bytes(10) + matrix + bytes(24)
                + struct.pack(">I", 2))
    pathlib.Path(path).write_bytes(ftyp + mdat + _box(b"moov", mvhd + trak))


def write_stream(path, packets, w: int, h: int,
                 fourcc: bytes = b"H263") -> pathlib.Path:
    """The packets in the container of ``path``'s extension: a raw stream
    (.h263), a 3GPP/MP4 file (.3gp), an AVI or a Matroska file (a VfW
    bitmap header) under ``fourcc``."""
    path = pathlib.Path(path)
    ext = path.suffix
    if ext == ".3gp":
        write_3gp(path, packets, w, h)
    elif ext == ".avi":
        mjpeg.write_avi(str(path), packets, w, h, fourcc=fourcc)
    elif ext == ".mkv":
        bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc,
                          w * h * 3, 0, 0, 0, 0)
        write_mkv(path, packets, w, h, codec="V_MS/VFW/FOURCC",
                  doctype=b"matroska", private=bih)
    else:
        path.write_bytes(b"".join(packets))
    return path


def port_planes(path):
    """The (Y, U, V) planes of the frames the port's decoder gives."""
    video = avi.open_video(str(path))
    dec = h263.Decoder()
    out = []
    for f in video.frames:
        planes = dec.decode_yuv(video.read(f))
        if dec.failed:
            break
        out.append(planes)
    video.close()
    return out, dec.stats()


def check_equal_cv2(path, n=None) -> dict:
    """Every frame through MediaSource equals cv2's in RGB and every Y plane
    cv2's Y read, in cv2's count (``n`` if given); the decoder's stats."""
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           prefetch=3))
    assert len(got) == len(want)
    if n is not None:
        assert len(got) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    planes, stats = port_planes(path)
    want_y = cv2_luma(path)
    assert len(planes) == len(want_y) == len(got)
    for p, y in zip(planes, want_y):
        np.testing.assert_array_equal(p[0], y)
    return stats


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("ext", ["avi", "mkv", "mov", "3gp", "3g2"])
@pytest.mark.parametrize("hw", [(96, 128), (144, 176), (288, 352),
                                (576, 704), (1152, 1408)])
def test_cv2_writer_each_size_and_container(tmp_path, hw, ext):
    """cv2's H263 writer at each standard size (sub-QCIF to 16CIF) into each
    container it writes: the container's codec is "h263" and every frame
    equals cv2's."""
    path = tmp_path / f"v.{ext}"
    write_cv2_video(path, pan(3 if hw[0] > 600 else 4, *hw, dy=2, dx=3),
                    "H263")
    assert avi.open_video(str(path)).codec == "h263"
    check_equal_cv2(path, 3 if hw[0] > 600 else 4)


_BASELINE = {
    "plain": ({}, {}),
    "mv4": ({"flags": "+mv4"}, {"inter4v_mbs": 1}),
    "obmc": ({"obmc": "1"}, {"obmc_mbs": 1, "obmc_pictures": 5}),
    "mv4_obmc": ({"flags": "+mv4", "obmc": "1"},
                 {"inter4v_mbs": 1, "obmc_mbs": 1}),
    "gobs": ({"flags": "+mv4", "obmc": "1", "ps": "300"},
             {"gob_headers": 5}),
}


@pytest.mark.parametrize("hw", [(144, 176), (576, 704)])
@pytest.mark.parametrize("tool", list(_BASELINE))
def test_baseline_tools(tmp_path, tool, hw):
    """libavcodec's h263 encoder (baseline PTYPE) with 4MV, OBMC and GOB
    headers, alone and together: the tools show in the decoder's counts
    and every frame equals cv2's."""
    options, shows = _BASELINE[tool]
    frames = pan(5, *hw, dy=2, dx=3)
    path = write_stream(tmp_path / "s.h263", encode(frames, options, "h263"),
                        hw[1], hw[0])
    stats = check_equal_cv2(path, 5)
    assert stats["plus_pictures"] == 0
    for k, v in shows.items():
        assert stats[k] >= v, (k, stats)


_ANNEXES = {
    "none": ({}, {"no_rounding_pictures": 2}),
    "D": ({"umv": "1"}, {"umv_pictures": 6, "umv_codes": 1,
                         "umv_outside": 1}),
    "F": ({"flags": "+mv4", "obmc": "1"}, {"inter4v_mbs": 1,
                                           "obmc_mbs": 1}),
    "I_T": ({"flags": "+aic"}, {"aic_blocks": 1, "mq_pictures": 6}),
    "J": ({"flags": "+loop"}, {"deblocked_edges": 1,
                               "loop_filter_pictures": 6}),
    "K": ({"structured_slices": "1", "ps": "200"}, {"slice_headers": 6}),
    "S": ({"aiv": "1"}, {"alt_vlc_blocks": 1, "aiv_pictures": 6}),
    "all": ({**ALL_ANNEXES, "ps": "250"},
            {"umv_codes": 1, "obmc_mbs": 1, "aic_blocks": 1,
             "deblocked_edges": 1, "slice_headers": 6, "alt_vlc_blocks": 1}),
}


@pytest.mark.parametrize("hw", [(52, 68), (100, 148), (96, 176)])
@pytest.mark.parametrize("annex", list(_ANNEXES))
def test_h263p_annexes(tmp_path, annex, hw):
    """libavcodec's h263p encoder with each annex it writes alone and all
    together, at custom sizes that are not whole macroblocks (and QCIF's
    width): the annex shows in the decoder's counts, every frame equals
    cv2's in RGB and Y."""
    options, shows = _ANNEXES[annex]
    frames = pan(6, *hw, dy=3, dx=4)
    path = write_stream(tmp_path / "s.h263", encode(frames, options),
                        hw[1], hw[0])
    stats = check_equal_cv2(path, 6)
    assert stats["plus_pictures"] == 6
    for k, v in shows.items():
        assert stats[k] >= v, (k, stats)


@pytest.mark.parametrize("codec", ["h263", "h263p"])
@pytest.mark.parametrize("q", [1, 2, 8, 31])
def test_quantisers_over_several_gops(tmp_path, q, codec):
    """Three GOPs (an I-picture every 3) at a fixed quantiser of 1, 2, 8 and
    31, baseline with 4MV and OBMC or H.263+ with every annex: at 1 H.263+
    reaches Annex T's extended escape; every frame equals cv2's."""
    hw = (144, 176) if codec == "h263" else (100, 148)
    options = ({"flags": "+mv4", "obmc": "1"} if codec == "h263"
               else {**ALL_ANNEXES, "ps": "400"})
    frames = pan(9, *hw, dy=2, dx=3, noise=6.0)
    packets = encode(frames, {**options, "g": "3", "qmin": str(q),
                              "qmax": str(q)}, codec)
    assert [header_fields(p)["intra"] for p in packets] == [
        True, False, False] * 3
    stats = check_equal_cv2(write_stream(tmp_path / "s.3gp", packets,
                                         hw[1], hw[0]), 9)
    if codec == "h263p" and q == 1:
        assert stats["mq_escapes"] > 0, stats


def test_fhd_custom_format_all_annexes(tmp_path):
    """Three FHD pictures (a custom format, 1080 not whole macroblocks)
    with every annex, in a 3GP: equal to cv2's."""
    frames = pan(3, 1080, 1920, dy=4, dx=6)
    path = write_stream(tmp_path / "s.3gp", encode(
        frames, {**ALL_ANNEXES, "ps": "8000", "qmin": "6", "qmax": "6"}),
        1920, 1080)
    stats = check_equal_cv2(path, 3)
    assert stats["custom_format"] == 3 and stats["slice_headers"] >= 3


@pytest.mark.parametrize("fourcc", [b"H263", b"h263", b"X263", b"T263",
                                    b"L263", b"M263", b"VX1K", b"lsvm",
                                    b"U263", b"u263"])
def test_avi_fourccs(tmp_path, fourcc):
    """The AVI tags FFmpeg's riff.c gives H.263 (U263: H.263+), upper-cased
    as it matches them: each read as "h263" and equal to cv2's."""
    frames = pan(4, 96, 128, dy=1, dx=2)
    path = write_stream(tmp_path / "s.avi", encode(frames, {}, "h263"),
                        128, 96, fourcc=fourcc)
    check_equal_cv2(path, 4)


def test_raw_stream_split_as_ffmpeg_parses_it(tmp_path):
    """A raw .h263 stream is cut at each byte-aligned picture start code;
    data before the first stays with the first picture; a stream named
    .263 that does not start with one is still read as H.263, as cv2
    reads it."""
    packets = encode(pan(5, 96, 128, dy=1, dx=2), {"flags": "+aic"})
    data = b"".join(packets)
    assert h263.split_pictures(data) == [
        (sum(map(len, packets[:i])), len(p)) for i, p in enumerate(packets)]
    path = tmp_path / "junk.263"
    path.write_bytes(b"\x00\x01\x02" + data)
    video = avi.open_video(str(path))
    assert video.codec == "h263" and len(video.frames) == 5
    check_equal_cv2(path, 5)


@pytest.mark.parametrize("ext,fourcc", [("h263", b"H263"),
                                         ("avi", b"H263"),
                                         ("avi", b"U263")])
def test_stream_joined_at_a_p_picture(tmp_path, ext, fourcc):
    """A stream that starts with a P-picture (a recording joined mid-way):
    FFmpeg predicts it from its dummy reference, luma 16 and chroma 128,
    for H.263 and H.263+ tags alike; the port's frames equal cv2's."""
    packets = encode(pan(6, 144, 176, dy=2, dx=3), {"g": "12"}, "h263")
    assert not header_fields(packets[2])["intra"]
    check_equal_cv2(write_stream(tmp_path / f"j.{ext}", packets[2:], 176,
                                 144, fourcc=fourcc), 4)


# ------------------------------------------- AC prediction (Annex I)

class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, n: int, v: int) -> None:
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def _aic_table():
    """Annex I's TCOEF codes by (last, run, level), from native/h263.cpp's
    kAicTcoef (ordered by last, run, level)."""
    src = (ROOT / "slam_indoor_code_tpu_torch" / "native" / "h263.cpp"
           ).read_text()
    body = src[src.index("kAicTcoef[103] = {"):]
    codes = [tuple(map(int, c.split(","))) for c in
             body[body.index("{") + 1:body.index("};")].replace(
                 " ", "").replace("\n", "")[1:-1].split("},{")]
    lmax = ([25, 7, 4, 4, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1],
            [10, 4, 3, 3, 2, 2, 2, 2] + [1] * 16)
    table, k = {}, 0
    for last in (0, 1):
        for run, n in enumerate(lmax[last]):
            for level in range(1, n + 1):
                table[last, run, level] = codes[k]
                k += 1
    return table, codes[102]


def aic_intra_picture(mbw: int, mbh: int, seed: int, q: int = 6) -> bytes:
    """An H.263+ I-picture of mbw x mbh macroblocks (a custom format) with
    Annex I (and T, as FFmpeg's encoder pairs them), each macroblock's
    INTRA_MODE drawn from DC-only, vertical and horizontal prediction, and
    random levels in every block, some by escape: what FFmpeg's encoder,
    which never predicts AC, does not write."""
    rng = np.random.default_rng(seed)
    table, esc = _aic_table()
    intra_mcbpc = {0: (1, 1), 1: (1, 3), 2: (2, 3), 3: (3, 3)}
    cbpy_codes = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6),
                  (11, 4), (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4),
                  (6, 4), (3, 2)]
    b = _BitWriter()
    b.put(22, 0x20)
    b.put(8, seed & 0xFF)                       # TR
    b.put(5, 0b10000)                           # marker, 0, split, cam, frz
    b.put(3, 7)                                 # PLUSPTYPE
    b.put(3, 1)                                 # UFEP
    b.put(3, 6)                                 # custom format
    b.put(15, 0b000010000011000)               # AIC and T, "1", reserved
    b.put(3, 0)                                 # I-picture
    b.put(6, 0b000001)                          # RPR RRU RTYPE 0 0 1
    b.put(1, 0)                                 # CPM
    b.put(4, 1)                                 # PAR 1:1
    b.put(9, mbw * 4 - 1)
    b.put(1, 1)
    b.put(9, mbh * 4)
    b.put(5, q)
    b.put(1, 0)                                 # PEI
    for _ in range(mbw * mbh):
        cbp = int(rng.integers(0, 64))
        code, n = intra_mcbpc[cbp & 3]
        b.put(n, code)
        mode = int(rng.integers(0, 3))
        b.put(*((1, 0), (2, 2), (2, 3))[mode])
        code, n = cbpy_codes[cbp >> 2]
        b.put(n, code)
        for blk in range(6):
            if not cbp & (32 >> blk):
                continue
            events = int(rng.integers(1, 5))
            for e in range(events):
                last = int(e == events - 1)
                run = int(rng.integers(0, 3))
                level = int(rng.choice([1, 2, 3, -1, -2, 40, -90]))
                key = (last, run, abs(level))
                if key in table:
                    code, n = table[key]
                    b.put(n, code)
                    b.put(1, int(level < 0))
                else:
                    b.put(esc[1], esc[0])
                    b.put(1, last)
                    b.put(6, run)
                    b.put(8, level & 0xFF)
                if last:
                    break
    b.put(16, 0)
    return b.bytes()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_aic_ac_prediction_written_by_hand(tmp_path, seed):
    """Intra pictures with Annex I's vertical and horizontal DC/AC
    prediction and its three scans (each macroblock's mode at random, 7x5
    and 3x9 macroblocks): the port's frames equal cv2's."""
    for k, (mbw, mbh) in enumerate([(7, 5), (3, 9)]):
        path = write_stream(tmp_path / f"aic{k}.h263", [
            aic_intra_picture(mbw, mbh, seed + 10 * j) for j in range(2)],
            0, 0)
        stats = check_equal_cv2(path, 2)
        assert stats["aic_pred_mbs"] > 0 and stats["concealed_mbs"] == 0


# --------------------------------------------------------- damage

def test_truncated_files_give_cv2s_count(tmp_path):
    """A 3GP and a raw stream cut mid-picture, and cut inside a picture
    header: cv2's frame count, the frames before the cut equal; a picture
    cut short of its size's bits is dropped (FFmpeg's test), one cut
    deeper concealed as FFmpeg conceals it."""
    frames = pan(8, 144, 176, dy=2, dx=3)
    packets = encode(frames, {**ALL_ANNEXES, "ps": "300"})
    full = b"".join(packets)
    for cut in (sum(map(len, packets[:6])) + 6,
                sum(map(len, packets[:6])) + len(packets[6]) * 2 // 3):
        path = tmp_path / f"cut{cut}.h263"
        path.write_bytes(full[:cut])
        want = cv2_rgb(path)
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert len(got) == len(want) in (6, 7)
        for a, b in zip(got[:6], want[:6]):
            np.testing.assert_array_equal(a, b)
        if len(got) == 7:
            clean = list(MediaSource(video_path=str(write_stream(
                tmp_path / "clean.h263", packets, 176, 144)),
                use_photos=False))[6]
            damaged_frame_holds_to_cv2(got[6], want[6], clean)


@pytest.mark.parametrize("structured", [False, True])
def test_damaged_gob_or_slice_is_concealed(tmp_path, structured):
    """Eight bytes zeroed two fifths into a P-picture of several GOBs (or
    slices): FFmpeg and the port resync at the next header, the damaged part is
    concealed (``damaged_frame_holds_to_cv2``), the pictures before equal
    cv2's, the count is cv2's."""
    frames = pan(6, 288, 352, dy=2, dx=3)
    options = ({"structured_slices": "1", "ps": "600"} if structured
               else {"ps": "600"})
    packets = encode(frames, options, "h263p" if structured else "h263")
    p = bytearray(packets[3])
    for i in range(len(p) * 2 // 5, len(p) * 2 // 5 + 8):
        p[i] = 0
    bad = packets[:3] + [bytes(p)] + packets[4:]
    path = write_stream(tmp_path / "d.3gp", bad, 352, 288)
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == 6
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    clean = list(MediaSource(video_path=str(write_stream(
        tmp_path / "c.3gp", packets, 352, 288)), use_photos=False))
    damaged_frame_holds_to_cv2(got[3], want[3], clean[3])
    _, stats = port_planes(path)
    assert 0 < stats["concealed_mbs"] < 396


def test_damaged_input_raises_only_the_documented_errors(tmp_path):
    """Forty streams with random bytes flipped or cut: the port gives a
    frame count no larger than the packets and raises nothing but
    ``ValueError`` (a damaged header that reads as a refused tool)."""
    rng = np.random.default_rng(3)
    packets = encode(pan(4, 96, 128, dy=1, dx=2), {**ALL_ANNEXES,
                                                    "ps": "200"})
    for case in range(40):
        data = bytearray(b"".join(packets))
        for _ in range(int(rng.integers(1, 12))):
            data[int(rng.integers(0, len(data)))] ^= int(
                rng.integers(1, 256))
        if case % 3 == 0:
            data = data[:int(rng.integers(4, len(data)))]
        path = tmp_path / f"r{case}.h263"
        path.write_bytes(bytes(data))
        try:
            got = list(MediaSource(video_path=str(path), use_photos=False))
        except ValueError as e:
            assert "is not decoded" in str(e)
            continue
        assert len(got) <= len(h263.split_pictures(bytes(data)))


# --------------------------------------------------------- refusals

_REFUSED_V1 = {"sac": "Annex E", "pb": "Annex G", "cpm": "CPM",
               "pei": "annexes L and W"}
_REFUSED_PLUS = {"sac": "Annex E", "rps": "Annex N", "isd": "Annex R",
                 "rpr": "Annex P", "rru": "Annex Q", "cpm": "CPM",
                 "reserved": "U or V", "mpp_reserved": "U or V"}


@pytest.mark.parametrize("field", list(_REFUSED_V1) + [
    f"plus_{k}" for k in _REFUSED_PLUS] + ["type_2", "type_3", "type_5",
                                             "rectangular"])
def test_refusals_name_the_tool(tmp_path, field):
    """A tool the decoder does not read, set in a real picture header,
    raises ValueError naming it (PTYPE's SAC, PB-frames, CPM and PEI;
    OPPTYPE's SAC, RPS, ISD and reserved bits; MPPTYPE's improved PB, B
    and EP pictures, RPR, RRU and reserved bits; CPM; rectangular
    slices)."""
    frames = pan(2, 96, 128)
    if not field.startswith(("plus_", "type_", "rectangular")):
        pic = encode(frames, {}, "h263")[0]
        pic = set_bits(pic, header_fields(pic)[field], 1, 1)
        name = _REFUSED_V1[field]
    elif field == "rectangular":
        pic = encode(frames, {"structured_slices": "1"})[0]
        f = header_fields(pic)
        assert f["ufep"] == 1
        # after CPM: no CPFMT at sub-QCIF, the custom picture clock (CPCFC
        # and ETR) where OPPTYPE says so, then SSS's first bit
        pcf = _Bits(pic[:16])
        pcf.get(f["pcf"])
        pic = set_bits(pic, f["cpm"] + 1 + 10 * pcf.get(1), 1, 1)
        name = "rectangular slices"
    else:
        pic = encode(frames, {})[0]
        f = header_fields(pic)
        assert f["plus"] and f["ufep"] == 1
        if field.startswith("type_"):
            t = int(field[5:])
            pic = set_bits(pic, f["type"], 3, t)
            name = {2: "Annex M", 3: "Annex O", 5: "Annex O"}[t]
        else:
            key = field[5:]
            pic = set_bits(pic, f[key], 1, 1)
            name = _REFUSED_PLUS[key]
    path = write_stream(tmp_path / "r.h263", [pic], 128, 96)
    with pytest.raises(ValueError, match=name):
        list(MediaSource(video_path=str(path), use_photos=False))


@pytest.mark.parametrize("fourcc", [b"I263", b"FLV1"])
@pytest.mark.parametrize("ext", ["avi", "mkv"])
def test_h263_dialects_refused_by_name(tmp_path, fourcc, ext):
    """Intel's H.263, which FFmpeg reads with a decoder of its own, is
    refused naming it.  Sorenson Spark (FLV1), refused so until the port
    read it, now gives cv2's frames (io/h263.py's Sorenson mode; more in
    tests/test_torch_flv.py)."""
    flv1 = fourcc == b"FLV1"
    path = write_stream(tmp_path / f"d.{ext}", encode(
        pan(2, 96, 128), {}, "flv" if flv1 else "h263"), 128, 96,
        fourcc=fourcc)
    if flv1:
        got = list(MediaSource(video_path=str(path), use_photos=False))
        want = cv2_rgb(path)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    with pytest.raises(NotImplementedError, match="Intel H.263"):
        avi.open_video(str(path))


def test_flash_video_is_refused_naming_it_and_its_codec(tmp_path):
    """cv2's ``FLV1`` writer into ``.flv`` (Flash Video, Sorenson Spark):
    cv2 reads every frame back, and so does the port now (io/flv.py).
    The same file with its video tags' codec id made On2 VP6 is refused
    naming the container and the codec."""
    path = tmp_path / "spark.flv"
    frames = pan(3, 96, 128)
    write_cv2_video(path, frames, "FLV1")
    data = path.read_bytes()
    assert data[:4] == b"FLV\x01"
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    vp6 = bytearray(data)
    pos = int.from_bytes(data[5:9], "big") + 4
    while pos + 11 < len(vp6):
        size = int.from_bytes(vp6[pos + 1:pos + 4], "big")
        if vp6[pos] == 9:
            vp6[pos + 11] = vp6[pos + 11] & 0xF0 | 4
        pos += 15 + size
    path.write_bytes(bytes(vp6))
    with pytest.raises(NotImplementedError,
                       match=r"Flash Video.*On2 VP6"):
        avi.open_video(str(path))
    with pytest.raises(NotImplementedError, match="Flash Video"):
        list(MediaSource(video_path=str(path), use_photos=False))


def test_short_video_header_in_mp4v_refused(tmp_path):
    """H.263 pictures in an ``mp4v`` sample entry (MPEG-4's short video
    header): FFmpeg's mpeg4 decoder refuses every sample, so cv2 reads no
    frame; the port refuses the stream naming the short video header.  The
    same samples as ``s263`` read as H.263."""
    frames = pan(4, 144, 176, dy=1, dx=2)
    src = tmp_path / "c.mov"
    write_cv2_video(src, frames, "H263")
    data = src.read_bytes()

    def entry(kind, fields, children):
        body = fields + _esds(b"\0\0\1\xb0\1")  # a VOS, no VOL
        return struct.pack(">I4s", 8 + len(body), b"mp4v") + body
    out = b""
    for kind, s, e in mp4._boxes(data, 0, len(data)):
        out += (_box(kind, _rebuild(data, s, e, entry)) if kind == b"moov"
                else data[s - 8:e])
    path = tmp_path / "short.mp4"
    path.write_bytes(out)
    assert cv2_rgb(path) == []
    assert avi.open_video(str(path)).codec == "mpeg4"
    with pytest.raises(ValueError, match="short video header"):
        list(MediaSource(video_path=str(path), use_photos=False))
    assert len(list(MediaSource(video_path=str(src), use_photos=False))) == 4


# ------------------------------------------------- against the JAX package

def _write_3gp(path, frames) -> None:
    h, w = frames[0].shape[:2]
    write_3gp(path, encode(frames, {**ALL_ANNEXES, "ps": "4000",
                                    "qmin": "3", "qmax": "3"}), w, h)


def test_slam_main_on_h263p_3gp_against_jax(tmp_path):
    """``slam_main`` on a 540x960 H.263+ 3GP with every annex: the port's
    MediaSource gives the frames the JAX package's (cv2's) gives, bit for
    bit; the cameras as many as the JAX package's, the ATE within 0.02 of
    the extent of the median of its RANSAC seeds 0-2."""
    from test_torch_mp4 import slam_main_against_jax

    slam_main_against_jax(tmp_path, "", "3gp", write=_write_3gp)


# ---------------------------------------------------------- fixtures

def _digest(path) -> dict:
    rgb = cv2_rgb(path)
    return {"frames": len(rgb), "shape": list(rgb[0].shape),
            "rgb_sha256": [_sha(f) for f in rgb],
            "y_sha256": [_sha(y) for y in cv2_luma(path)]}


def write_fixtures() -> None:
    """The 32 headline FHD frames (as cv2 decodes headline_mp4v.mp4) coded
    with HEADLINE_OPTIONS into a 3GP, and the small fixtures, with the
    sha256 of cv2's RGB frames and Y planes beside the other fixtures' in
    cv2_sha256.json."""
    frames = cv2_rgb(MP4_FIXTURE)
    write_3gp(FIXTURE, encode(frames, HEADLINE_OPTIONS), 1920, 1080)
    small = pan(6, 144, 176, dy=1, dx=2)
    for ext in ("avi", "3gp", "3g2", "mov", "mkv"):
        write_cv2_video(FIXTURES / f"h263_cv2.{ext}", small, "H263")
    write_stream(FIXTURES / "h263_4cif_obmc.avi", encode(
        pan(3, 576, 704, dy=2, dx=3), {"flags": "+mv4", "obmc": "1",
                                       "ps": "1200", "qmin": "12",
                                       "qmax": "12"}, "h263"), 704, 576)
    write_stream(FIXTURES / "h263p_annexes.h263", encode(
        pan(6, 100, 148, dy=3, dx=4), {**ALL_ANNEXES, "ps": "300",
                                       "qmin": "2", "qmax": "2"}), 148, 100)
    write_stream(FIXTURES / "h263p_u263.avi", encode(
        pan(6, 96, 128, dy=2, dx=2), {"flags": "+aic+loop", "g": "3"}),
        128, 96, fourcc=b"U263")
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        table[name] = _digest(FIXTURES / name)
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256():
    """The committed fixtures (what chip_smoke.py holds the port to on the
    card): cv2's decode still gives the recorded sha256, and so does the
    port's, frame by frame, in RGB and Y; the FHD headline uses every
    annex (D, F, I, J, K, S, T) and the custom format."""
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        path = FIXTURES / name
        want = table[name]
        assert path.stat().st_size <= (2_500_000 if name == FIXTURE.name
                                       else 120_000), name
        assert [_sha(f) for f in cv2_rgb(path)] == want["rgb_sha256"], name
        assert [_sha(y) for y in cv2_luma(path)] == want["y_sha256"], name
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert len(got) == want["frames"], name
        assert [_sha(f) for f in got] == want["rgb_sha256"], name
        planes, stats = port_planes(path)
        assert [_sha(p[0]) for p in planes] == want["y_sha256"], name
        if name == FIXTURE.name:
            assert want["frames"] == 32 and stats["custom_format"] == 32
            for k in ("umv_pictures", "obmc_pictures", "aic_pictures",
                      "loop_filter_pictures", "slice_pictures",
                      "aiv_pictures", "mq_pictures"):
                assert stats[k] == 32, k
            for k in ("umv_codes", "long_vectors", "umv_outside",
                      "inter4v_mbs", "obmc_mbs", "aic_blocks",
                      "deblocked_edges", "slice_headers", "alt_vlc_blocks",
                      "mq_chroma_mbs", "no_rounding_pictures"):
                assert stats[k] > 0, k


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
