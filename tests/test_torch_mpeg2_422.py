"""The port's MPEG-2 4:2:2 video (io/mpeg12.py over native/mpeg12.cpp,
chroma_format 2: broadcast contribution, XDCAM HD422 and other 4:2:2
Profile material) on the CPU, against OpenCV's default FFmpeg backend and
libavcodec's own decode.  Every stream is coded here by the
``mpeg2video`` encoder of the libavcodec cv2's wheel carries
(``lavc_encode(..., pix_fmt="yuv422p")``) over a pan of a blurred-noise
texture: each encoder tool, progressive frames held to cv2 bit for bit in
RGB (swscale's unscaled 4:2:2 converter) and in Y (its
``CAP_PROP_CONVERT_RGB=0`` read); the chroma quantiser matrices of a quant
matrix extension written into the stream; interlaced frame pictures
(field DCT, field prediction: chroma at full height) held to
``lavc_decode``'s planes, and with ``progressive_frame`` set by hand (which
changes no pixel) to cv2; the transport stream, program stream and
QuickTime (``m2v1`` and XDCAM HD422's ``xd5c``) containers; damaged
pictures; an odd height refused by name; the committed fixtures against
their recorded sha256.  cv2 returns uninitialised memory for frames
FFmpeg flags interlaced (tests/test_torch_mpeg2.py's docstring).

Rewrite the fixtures with ``PYTHONPATH=.:tests python
tests/test_torch_mpeg2_422.py --write-fixtures`` (~10 s)."""

import json
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, mpeg12
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg, mpegmux
from test_torch_mp4 import _box, _damage, cv2_rgb, lavc_encode
from test_torch_mpeg2 import (DIGESTS, FIXTURES, _sha, cv2_luma,
                              lavc_decode, progressive, write_es)
from test_torch_vp9 import pan

torch.set_num_threads(1)

SMALL_FIXTURE = "mpeg2_422.ts"
FHD_FIXTURE = "mpeg2_422_fhd.m2v"
TOOLS = {
    "bf0": {"bf": "0"},
    "bf2": {"bf": "2"},
    "alternate_scan": {"bf": "1", "alternate_scan": "1", "intra_vlc": "1"},
    "non_linear_quant": {"bf": "2", "non_linear_quant": "1", "qmax": "28",
                         "b": "60k"},
    "dc10": {"bf": "1", "dc": "10"},
    "fine_quant": {"bf": "2", "qmin": "1", "qmax": "1"},
    "all": {"bf": "3", "g": "7", "alternate_scan": "1", "intra_vlc": "1",
            "non_linear_quant": "1", "qmax": "28", "dc": "11"},
}
INTERLACED = {"bf": "2", "flags": "+ildct+ilme"}


def encode(frames, options: dict, matrices=None) -> list:
    """``frames`` coded by libavcodec's mpeg2video as 4:2:2, one packet
    per picture."""
    return lavc_encode("mpeg2video", frames, options, matrices=matrices,
                       pix_fmt="yuv422p")[0]


def port_planes(path) -> tuple:
    """The (Y, U, V) planes the port gives for ``path`` in display order,
    and the decoder's stats."""
    video = avi.open_video(str(path))
    dec = mpeg12.Decoder(video.extradata, video.width, video.height)
    out = []
    for i, f in enumerate(video.frames):
        planes = dec.decode_yuv(video.read(f), i)
        if dec.failed:
            break
        if planes is not None and video.frames[dec.tag][2]:
            out.append(planes)
    else:
        planes = dec.flush_yuv()
        if planes is not None and video.frames[dec.tag][2]:
            out.append(planes)
    stats = dec.stats()
    dec.close()
    video.close()
    return out, stats


def packets_planes(packets, w: int, h: int) -> tuple:
    """The port's planes for ``packets`` (one picture each), flushed."""
    dec = mpeg12.Decoder(b"", w, h)
    out = [p for p in (dec.decode_yuv(x) for x in packets) if p is not None]
    last = dec.flush_yuv()
    if last is not None:
        out.append(last)
    return out, dec.stats()


def check_equal_cv2(path, n=None) -> dict:
    """Every frame through MediaSource equals cv2's RGB, every Y plane
    cv2's Y read, in cv2's count (``n`` if given); the decoder's stats."""
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           prefetch=3))
    assert len(got) == len(want) > 0
    if n is not None:
        assert len(got) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    planes, stats = port_planes(path)
    luma = cv2_luma(path)
    assert len(planes) == len(luma) == len(got)
    for p, y in zip(planes, luma):
        assert p[1].shape == (p[0].shape[0], (p[0].shape[1] + 1) // 2)
        np.testing.assert_array_equal(p[0], y)
    assert stats["chroma_422_frames"] > 0
    return stats


def quant_matrix_extension(intra, non_intra) -> bytes:
    """A quant matrix extension loading only the chroma matrices (zigzag
    order, 8 bits a value), byte-aligned with zeros."""
    bits = "0011" + "0" + "0"
    for m in (intra, non_intra):
        bits += "1" + "".join(f"{int(m[k]):08b}" for k in mjpeg.ZIGZAG)
    bits += "0" * (-len(bits) % 8)
    return b"\x00\x00\x01\xb5" + int(bits, 2).to_bytes(len(bits) // 8, "big")


def with_chroma_matrices(es: bytes, intra, non_intra) -> bytes:
    """``es`` with a quant matrix extension after every sequence
    extension."""
    ext = quant_matrix_extension(intra, non_intra)
    out, at = bytearray(), 0
    while True:
        k = es.find(b"\x00\x00\x01\xb5", at)
        if k < 0:
            break
        nxt = es.find(b"\x00\x00\x01", k + 4)
        out += es[at:nxt]
        if es[k + 4] >> 4 == 1:          # the sequence extension
            out += ext
        at = nxt
    return bytes(out + es[at:])


def write_mov(path, packets, w: int, h: int, entry: bytes) -> None:
    """A QuickTime file holding ``packets`` (no B pictures) under sample
    entry ``entry``, one chunk, every sample a sync sample."""
    def full(kind, body, flags=0):
        return _box(kind, struct.pack(">I", flags) + body)

    n = len(packets)
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                         0x40000000)
    ftyp = _box(b"ftyp", b"qt  " + struct.pack(">I", 512) + b"qt  ")
    mdat_off = len(ftyp) + 8
    mdat = _box(b"mdat", b"".join(packets))
    sample = (bytes(6) + struct.pack(">H", 1) + bytes(16)
              + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1)
              + bytes(32) + struct.pack(">Hh", 0x18, -1))
    stbl = _box(b"stbl", b"".join([
        full(b"stsd", struct.pack(">I", 1) + _box(entry, sample)),
        full(b"stts", struct.pack(">III", 1, n, 1000)),
        full(b"stsc", struct.pack(">IIII", 1, 1, n, 1)),
        full(b"stsz", struct.pack(">II", 0, n) + b"".join(
            struct.pack(">I", len(p)) for p in packets)),
        full(b"stco", struct.pack(">II", 1, mdat_off))]))
    minf = _box(b"minf", full(b"vmhd", bytes(8), flags=1) + _box(
        b"dinf", full(b"dref", struct.pack(">I", 1) + full(
            b"url ", b"", flags=1))) + stbl)
    mdia = _box(b"mdia", full(b"mdhd", struct.pack(">IIIIHH", 0, 0, 25000,
                                                   n * 1000, 0x55C4, 0))
                + full(b"hdlr", bytes(4) + b"vide" + bytes(12)
                       + b"VideoHandler\0") + minf)
    ms = n * 40
    trak = _box(b"trak", full(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, ms)
                              + bytes(8) + struct.pack(">hhhH", 0, 0, 0, 0)
                              + matrix + struct.pack(">II", w << 16, h << 16),
                              flags=3) + mdia)
    mvhd = full(b"mvhd", struct.pack(">IIIIIH", 0, 0, 1000, ms, 0x10000,
                                     0x100) + bytes(10) + matrix + bytes(24)
                + struct.pack(">I", 2))
    pathlib.Path(path).write_bytes(ftyp + mdat + _box(b"moov", mvhd + trak))


# ---------------------------------------------------------- progressive

@pytest.mark.parametrize("tool", list(TOOLS))
def test_progressive_422_tools_equal_cv2(tmp_path, tool):
    """Each encoder tool in 4:2:2: eight blocks a macroblock (the
    coded_block_pattern's two more bits), RGB and Y equal to cv2's."""
    frames = pan(8, 96, 128, dy=2, dx=3, noise=2.0)
    stats = check_equal_cv2(write_es(tmp_path / "p.m2v",
                                     encode(frames, TOOLS[tool])), 8)
    assert stats["chroma_422_frames"] == 8


@pytest.mark.parametrize("hw", [(38, 54), (240, 320)])
def test_all_tools_at_other_sizes_equal_cv2(tmp_path, hw):
    """Every tool together at a size that is not whole macroblocks and at
    240x320."""
    frames = pan(6, *hw, dy=2, dx=3, noise=2.0)
    check_equal_cv2(write_es(tmp_path / "a.m2v",
                             encode(frames, TOOLS["all"])), 6)


def test_loaded_luma_and_chroma_matrices_equal_cv2(tmp_path):
    """Luma matrices loaded by the encoder and chroma ones by a quant
    matrix extension written in here: the chroma blocks dequantised by
    theirs (the frames differ from the stream without the extension),
    every frame equal to cv2's."""
    frames = pan(6, 96, 128, dy=2, dx=3, noise=2.0)
    rng = np.random.default_rng(3)
    intra = [8] + list(rng.integers(10, 60, 63))
    inter = list(rng.integers(12, 50, 64))
    es = b"".join(encode(frames, {"bf": "2"}, matrices=(intra, inter)))
    ci = [8] + list(rng.integers(20, 90, 63))
    cn = list(rng.integers(20, 90, 64))
    plain = write_es(tmp_path / "plain.m2v", [es])
    loaded = write_es(tmp_path / "chroma.m2v",
                      [with_chroma_matrices(es, ci, cn)])
    stats = check_equal_cv2(loaded, 6)
    assert stats["loaded_matrices"] > check_equal_cv2(plain, 6)[
        "loaded_matrices"]
    a = list(MediaSource(video_path=str(plain), use_photos=False))
    b = list(MediaSource(video_path=str(loaded), use_photos=False))
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------- interlaced

@pytest.mark.parametrize("hw,options", [
    ((96, 128), INTERLACED),
    ((80, 144), {**INTERLACED, "alternate_scan": "1", "bf": "3"}),
    ((96, 128), {**INTERLACED, "bf": "0", "non_linear_quant": "1",
                 "qmax": "28"}),
])
def test_interlaced_422_equals_libavcodec(tmp_path, hw, options):
    """Field DCT and field prediction in 4:2:2 (chroma laid out as luma,
    at full height): the planes equal libavcodec's decode of the
    unchanged stream; with progressive_frame set by hand the RGB and Y
    equal cv2's."""
    big = pan(13, *hw, dy=3, dx=4, noise=3.0)
    frames = []
    for i in range(6):          # the fields of each frame from two times
        f = big[2 * i].copy()
        f[1::2] = big[2 * i + 1][1::2]
        frames.append(f)
    packets = encode(frames, options)
    want = lavc_decode(packets)
    got, stats = packets_planes(packets, hw[1], hw[0])
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[1].shape == w[1].shape == (hw[0], hw[1] // 2)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert stats["field_dct_mbs"] > 0 and stats["field_mc_mbs"] > 0
    assert stats["interlaced_frames"] == 6
    check_equal_cv2(write_es(tmp_path / "i.m2v", packets), 6)


# ---------------------------------------------------------- containers

@pytest.mark.parametrize("ext", [".ts", ".mpg", ".mov", "xd5c.mov"])
def test_422_in_containers_equals_cv2(tmp_path, ext):
    """4:2:2 interlaced coding (progressive_frame set) in a transport
    stream, a program stream, and QuickTime under ``m2v1`` and XDCAM
    HD422's ``xd5c``: frames equal to cv2's."""
    frames = pan(8, 96, 128, dy=2, dx=3, noise=2.0)
    if ext in (".ts", ".mpg"):
        packets = [progressive(p) for p in encode(frames, INTERLACED)]
        path = tmp_path / f"v{ext}"
        if ext == ".ts":
            mpegmux.write_ts(path, packets)
        else:
            mpegmux.write_ps(path, packets)
        check_equal_cv2(path, 8)
        return
    packets = [progressive(p) for p in encode(
        frames, {**INTERLACED, "bf": "0"})]
    entry = b"m2v1" if ext == ".mov" else b"xd5c"
    path = tmp_path / "v.mov"
    write_mov(path, packets, 128, 96, entry)
    check_equal_cv2(path, 8)


# ---------------------------------------------------------- damage

@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("how", ["half", "90pct", "flip"])
def test_damaged_422_pictures(tmp_path, index, how):
    """Picture ``index`` of ten (the I picture, the first P, a B) damaged:
    cv2's frame count and the frames before the damage equal.  A damaged I
    picture (FFmpeg's DC concealment, which paints 4:2:2 chroma at 4:2:0's
    positions) or B picture: every plane equal to libavcodec's decode on
    one thread.  A damaged P picture, whose concealment FFmpeg deblocks
    with 4:2:0's chroma geometry (so chroma above the damage moves too):
    the first frame that differs equal in Y to libavcodec's above the
    damage as ``damaged_frame_holds_to_cv2`` bounds it, and within its mean
    difference in RGB."""
    frames = [np.ascontiguousarray(f) for f in pan(10, 240, 320, dx=2)]
    packets = [progressive(p) for p in encode(frames, {"bf": "2"})]
    clean = packets_planes(packets, 320, 240)[0]
    packets[index] = _damage(packets[index], how)
    path = write_es(tmp_path / "d.m2v", packets)
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want)
    planes, _ = packets_planes(packets, 320, 240)
    ref = lavc_decode(packets)
    assert len(planes) == len(ref) == len(got)
    bad = [k for k, (a, b) in enumerate(zip(got, want))
           if not np.array_equal(a, b)]
    if index != 1:
        for g, w in zip(planes, ref):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    elif bad:
        k = bad[0]
        rows = np.flatnonzero((planes[k][0] != clean[k][0]).any(axis=1))
        first = rows[0] // 16 if len(rows) else 240 // 16 + 1
        exact = 16 * max(0, first - -(-50 // (320 // 16)))
        np.testing.assert_array_equal(planes[k][0][:exact], ref[k][0][:exact])
        assert np.abs(got[k].astype(int) - want[k]).mean() < 8.0


def test_odd_height_refused_by_name(tmp_path):
    """4:2:2 at an odd height goes through swscale's scaled path, which is
    not reproduced: ValueError naming it."""
    packets = encode(pan(3, 95, 128), {"bf": "0"})
    path = write_es(tmp_path / "odd.m2v", packets)
    with pytest.raises(ValueError, match="4:2:2 chroma at an odd height"):
        list(MediaSource(video_path=str(path), use_photos=False))


# ---------------------------------------------------------- fixtures

def write_fixtures() -> None:
    """A small interlaced 4:2:2 transport stream (progressive_frame set)
    and one FHD picture pair of the headline scene, with the sha256 of
    cv2's RGB frames and Y planes beside the other fixtures'."""
    from test_torch_mp4 import FIXTURE as MP4_FIXTURE

    mpegmux.write_ts(FIXTURES / SMALL_FIXTURE, [progressive(p) for p in encode(
        pan(8, 96, 128, dy=2, dx=3, noise=2.0),
        {**INTERLACED, "alternate_scan": "1", "intra_vlc": "1"})])
    fhd = cv2_rgb(MP4_FIXTURE)[:2]
    write_es(FIXTURES / FHD_FIXTURE, encode(fhd, {
        **INTERLACED, "bf": "0", "qmin": "6", "qmax": "6"}))
    table = json.loads(DIGESTS.read_text())
    for name in (SMALL_FIXTURE, FHD_FIXTURE):
        rgb = cv2_rgb(FIXTURES / name)
        table[name] = {"frames": len(rgb), "shape": list(rgb[0].shape),
                       "rgb_sha256": [_sha(f) for f in rgb],
                       "y_sha256": [_sha(y) for y in
                                    cv2_luma(FIXTURES / name)]}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


@pytest.mark.parametrize("name", [SMALL_FIXTURE, FHD_FIXTURE])
def test_422_fixtures_hold_recorded_sha256(name):
    """The committed 4:2:2 fixtures (what chip_smoke.py's mpeg2 phase holds
    the card to): cv2's decode still gives the recorded sha256, and so does
    the port's, in RGB and Y, with field DCT and field prediction in
    use."""
    want = json.loads(DIGESTS.read_text())[name]
    path = FIXTURES / name
    assert path.stat().st_size <= 600_000
    assert [_sha(f) for f in cv2_rgb(path)] == want["rgb_sha256"]
    assert [_sha(y) for y in cv2_luma(path)] == want["y_sha256"]
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert [_sha(f) for f in got] == want["rgb_sha256"]
    planes, stats = port_planes(path)
    assert [_sha(p[0]) for p in planes] == want["y_sha256"]
    assert stats["chroma_422_frames"] == want["frames"]
    assert stats["field_dct_mbs"] > 0 and stats["field_mc_mbs"] > 0


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
