"""The port's Flash Video and Sorenson Spark reading (io/flv.py, and
io/h263.py's Sorenson mode over native/h263.cpp) against cv2's default
FFmpeg backend, bit for bit in RGB and in the Y plane
(``CAP_PROP_CONVERT_RGB=0``):

- cv2's ``FLV1`` writer into ``.flv``, ``.avi``, ``.mkv`` and ``.mov`` at
  sizes of 8-bit, 16-bit and standard size codes;
- libavcodec's ``flv`` encoder through ``lavc_encode`` at quantisers that
  give FLV's 7-bit and 11-bit escapes, muxed by ``write_flv`` with audio
  and script tags between the pictures;
- disposable P-pictures (PTYPE 2 and 3, set in the header by hand: given,
  not kept as the reference, and no frame before a reference) and the
  format-0 escape (the format field set by hand on a stream coded with no
  escape, where both formats read alike);
- cuts and flips of a ``.flv`` against cv2 on one thread (the frame count,
  FFmpeg's concealment held to ``damaged_frame_holds_to_cv2``);
- refusals by name: VP6, VP6 with alpha, Screen Video 1 and 2, H.264, an
  enhanced-FLV FourCC, a size change within the stream;
- the committed fixtures (``headline_flv1.flv``: the 32 headline FHD
  frames through libavcodec's ``flv`` encoder at quantiser 6, and the
  small ones) against their recorded sha256, which chip_smoke.py holds
  the card to (rewrite them with ``PYTHONPATH=.:tests python
  tests/test_torch_flv.py --write-fixtures``, ~30 s);
- ``slam_main`` on a 540x960 ``.flv`` against the JAX package's."""

import json
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, flv, h263
from slam_indoor_code_tpu_torch.io.media import MediaSource
from test_torch_h263 import set_bits
from test_torch_mp4 import (FIXTURE as MP4_FIXTURE, cv2_rgb,
                            cv2_rgb_one_thread, damaged_frame_holds_to_cv2,
                            lavc_encode, write_cv2_video)
from test_torch_mpeg2 import _sha, cv2_luma
from test_torch_vp9 import pan

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures"
FIXTURE = FIXTURES / "headline_flv1.flv"
DIGESTS = FIXTURES / "cv2_sha256.json"
# cv2's FLV1 writer into each container; libavcodec's flv encoder at
# quantiser 1 (11-bit escapes) with audio and script tags between the
# pictures
SMALL_FIXTURES = ("flv1_cv2.flv", "flv1_cv2.avi", "flv1_cv2.mkv",
                  "flv1_cv2.mov", "flv1_q1_audio_script.flv")
HEADLINE_Q = 6


# ------------------------------------------------------------- streams

def encode(frames, q: int = 0, g: int = 12) -> list:
    """``frames`` coded by libavcodec's ``flv`` encoder (format 1: FLV's
    escape), one packet a picture, at a fixed quantiser ``q`` (its rate
    control without)."""
    opts = {"g": str(g)}
    if q:
        opts.update(qmin=str(q), qmax=str(q))
    return lavc_encode("flv", frames, opts)[0]


def _tag(kind: int, ms: int, body: bytes) -> bytes:
    return (bytes([kind]) + len(body).to_bytes(3, "big")
            + (ms & 0xFFFFFF).to_bytes(3, "big") + bytes([ms >> 24 & 0xFF])
            + bytes(3) + body + struct.pack(">I", 11 + len(body)))


def _amf_meta(w: int, h: int) -> bytes:
    def num(name, v):
        return (struct.pack(">H", len(name)) + name.encode() + b"\x00"
                + struct.pack(">d", v))
    return (b"\x02" + struct.pack(">H", 10) + b"onMetaData" + b"\x08"
            + struct.pack(">I", 2) + num("width", w) + num("height", h)
            + b"\x00\x00\x09")


def write_flv(path, packets, w: int, h: int, audio: bool = False,
              script: bool = False, codec: int = flv.SORENSON,
              frame_types=None) -> pathlib.Path:
    """An FLV file as FFmpeg's flv muxer lays one out: the header (video,
    and audio with ``audio``), an ``onMetaData`` script tag with
    ``script``, then a video tag per packet (its first byte the frame
    type, 1 for the first and 2 after unless ``frame_types`` says, and
    ``codec``), each followed by an MP3-flagged audio tag of noise with
    ``audio``, at 10 frames/s."""
    rng = np.random.default_rng(len(packets))
    out = bytearray(b"FLV\x01" + bytes([5 if audio else 1]) + b"\0\0\0\x09"
                    + bytes(4))
    if script:
        out += _tag(18, 0, _amf_meta(w, h))
    for i, p in enumerate(packets):
        ft = frame_types[i] if frame_types else (1 if i == 0 else 2)
        out += _tag(9, 100 * i, bytes([ft << 4 | codec]) + p)
        if audio:
            out += _tag(8, 100 * i, b"\x2f" + rng.integers(
                0, 256, 200, np.uint8).tobytes())
    path = pathlib.Path(path)
    path.write_bytes(bytes(out))
    return path


def port_planes(path):
    """The (Y, U, V) planes of the frames the port's decoder gives, and its
    counts."""
    video = avi.open_video(str(path))
    dec = h263.Decoder(sorenson=True)
    out = []
    for f in video.frames:
        planes = dec.decode_yuv(video.read(f))
        if dec.failed:
            break
        if planes is not None:
            out.append(planes)
    video.close()
    return out, dec.stats()


def check_equal_cv2(path, n=None) -> dict:
    """Every frame through MediaSource equals cv2's in RGB, and every Y
    plane cv2's Y read, in cv2's count (``n`` if given); the decoder's
    counts."""
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


def _type_bit(packet: bytes) -> int:
    """The bit offset of a Sorenson picture header's picture type: after
    the 17-bit start code, format, TR, size code and the sizes it
    reads."""
    code = (int.from_bytes(packet[:8], "big") >> (64 - 33)) & 7
    return 33 + (16 if code == 0 else 32 if code == 1 else 0)


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("ext", ["flv", "avi", "mkv", "mov"])
@pytest.mark.parametrize("hw", [(96, 128), (120, 160), (144, 176),
                                (100, 148), (270, 300)])
def test_cv2_writer_each_size_and_container(tmp_path, hw, ext):
    """cv2's FLV1 writer: the standard size codes, 8-bit and 16-bit sizes
    (not whole macroblocks), into each container; the container's codec
    is "flv1" and every frame equals cv2's."""
    path = tmp_path / f"v.{ext}"
    write_cv2_video(path, pan(4, *hw, dy=2, dx=3), "FLV1")
    assert avi.open_video(str(path)).codec == "flv1"
    stats = check_equal_cv2(path, 4)
    assert stats["sorenson_pictures"] == 4


@pytest.mark.parametrize("q", [1, 2, 4, 8, 31])
def test_lavc_flv_quantisers_and_escapes(tmp_path, q):
    """libavcodec's flv encoder at fixed quantisers over a noisy pan, with
    audio and script tags between the pictures: FLV's 11-bit escapes at
    quantiser 1, 7-bit ones up to 8."""
    frames = pan(6, 96, 128, dy=2, dx=3, noise=12.0 if q < 4 else 4.0)
    path = write_flv(tmp_path / "q.flv", encode(frames, q), 128, 96,
                     audio=True, script=True)
    stats = check_equal_cv2(path, 6)
    if q == 1:
        assert stats["flv_escapes_11"] > 0
    if q <= 8:
        assert stats["flv_escapes_7"] > 0


@pytest.mark.parametrize("ptype", [2, 3])
def test_disposable_pictures_equal_cv2(tmp_path, ptype):
    """P-pictures made disposable (PTYPE 2 or 3) by hand: decoded and
    shown, but the next picture predicts from the one before; a stream
    that starts with one gives no frame for it."""
    frames = pan(7, 96, 128, dy=2, dx=2)
    packets = encode(frames, 4, g=100)
    for i in (2, 4):
        packets[i] = set_bits(packets[i], _type_bit(packets[i]), 2, ptype)
    path = write_flv(tmp_path / "d.flv", packets, 128, 96)
    stats = check_equal_cv2(path, 7)
    assert stats["disposable_pictures"] == 2
    first = set_bits(packets[1], _type_bit(packets[1]), 2, 2)
    path = write_flv(tmp_path / "e.flv", [first] + packets[1:], 128, 96)
    check_equal_cv2(path, 6)


def test_format_zero_reads_h263_escapes(tmp_path):
    """A stream coded with no escape at all (a flat pan at quantiser 31):
    its format field set to 0 by hand reads as H.263's escape would, and
    equals cv2's decode of it."""
    frames = [np.full((96, 128, 3), 40 + 10 * i, np.uint8) for i in range(4)]
    packets = encode(frames, 31)
    plain = write_flv(tmp_path / "p.flv", packets, 128, 96)
    stats = check_equal_cv2(plain, 4)
    assert stats["flv_escapes_7"] == stats["flv_escapes_11"] == 0
    zero = [set_bits(p, 17, 5, 0) for p in packets]
    path = write_flv(tmp_path / "z.flv", zero, 128, 96)
    check_equal_cv2(path, 4)
    np.testing.assert_array_equal(cv2_rgb(path)[-1], cv2_rgb(plain)[-1])


def test_cut_and_flipped_flv_equal_cv2_on_one_thread(tmp_path):
    """Cuts at every 401st byte and 150 single-bit flips past the FLV
    header, against cv2 on one thread: cv2's frame count; the frames
    before the damaged picture equal; the damaged one equal above the
    rows FFmpeg's error concealment re-estimates, and, where it has a
    reference, held to ``damaged_frame_holds_to_cv2`` (the frames after it
    drift from FFmpeg's concealment, which the port does not copy)."""
    frames = pan(5, 288, 352, dy=1, dx=2)
    path = write_flv(tmp_path / "s.flv", encode(frames, 3), 352, 288,
                     audio=True)
    data = path.read_bytes()
    ends = [o + n for o, n, _ in flv.FlvVideo(str(path)).frames]
    clean = list(MediaSource(video_path=str(path), use_photos=False))
    rng = np.random.default_rng(1)
    cases = [(n, data[:n]) for n in range(13, len(data), 401)]
    for _ in range(150):
        b = bytearray(data)
        i = int(rng.integers(13, len(b)))
        b[i] ^= 1 << int(rng.integers(0, 8))
        cases.append((i, bytes(b)))
    dropped = 0
    for at, case in cases:
        hit = sum(e <= at for e in ends)         # the first picture touched
        p = tmp_path / "c.flv"
        p.write_bytes(case)
        want = cv2_rgb_one_thread(p) or []
        try:
            got = list(MediaSource(video_path=str(p), use_photos=False))
        except IOError:
            got = []
        assert len(got) == len(want), at
        dropped += len(got) < len(frames)
        for j, (a, b) in enumerate(zip(got, want)):
            if j < hit:
                np.testing.assert_array_equal(a, b)
            elif j == hit:
                damaged_frame_holds_to_cv2(a, b, clean[j],
                                           8.0 if j else 256.0)
    assert 0 < dropped < len(cases)


@pytest.mark.parametrize("codec", [3, 4, 5, 6, 7])
def test_other_flv_codecs_refused_by_name(tmp_path, codec):
    """Every other codec id of FLV's video tags raises naming itself."""
    path = write_flv(tmp_path / "o.flv", [bytes(64)] * 2, 128, 96,
                     codec=codec)
    with pytest.raises(NotImplementedError, match=flv.CODECS[codec]):
        avi.open_video(str(path))


def test_enhanced_flv_and_size_change_refused_by_name(tmp_path):
    """An enhanced-FLV tag names its FourCC; a Sorenson stream that
    changes its picture size names the change."""
    path = write_flv(tmp_path / "x.flv", [b"hvc1" + bytes(60)], 128, 96,
                     codec=0x80 | 1)
    with pytest.raises(NotImplementedError, match="enhanced-FLV 'hvc1'"):
        avi.open_video(str(path))
    a = encode(pan(2, 96, 128), 4)
    b = encode(pan(2, 144, 176), 4)
    path = write_flv(tmp_path / "r.flv", a + b, 128, 96)
    with pytest.raises(ValueError, match="Sorenson Spark picture size"):
        list(MediaSource(video_path=str(path), use_photos=False))


def test_slam_main_on_flv_against_jax(tmp_path):
    """``slam_main`` on a 540x960 ``.flv`` (cv2's FLV1 writer): the frames
    equal the JAX package's (cv2's) bit for bit, the cameras as many, the
    ATE within 0.02 of the extent of its RANSAC seeds' median."""
    from test_torch_mp4 import slam_main_against_jax

    slam_main_against_jax(tmp_path, "FLV1", "flv")


# ---------------------------------------------------------- fixtures

def _digest(path) -> dict:
    rgb = cv2_rgb(path)
    return {"frames": len(rgb), "shape": list(rgb[0].shape),
            "rgb_sha256": [_sha(f) for f in rgb],
            "y_sha256": [_sha(y) for y in cv2_luma(path)]}


def write_fixtures() -> None:
    """The 32 headline FHD frames (as cv2 decodes headline_mp4v.mp4) coded
    at quantiser HEADLINE_Q into an FLV, and the small fixtures, with the
    sha256 of cv2's RGB frames and Y planes beside the other fixtures' in
    cv2_sha256.json."""
    frames = cv2_rgb(MP4_FIXTURE)
    write_flv(FIXTURE, encode(frames, HEADLINE_Q, g=16), 1920, 1080)
    small = pan(6, 120, 160, dy=1, dx=2)
    for ext in ("flv", "avi", "mkv", "mov"):
        write_cv2_video(FIXTURES / f"flv1_cv2.{ext}", small, "FLV1")
    write_flv(FIXTURES / "flv1_q1_audio_script.flv",
              encode(pan(4, 96, 128, dy=2, dx=3, noise=12.0), 1), 128, 96,
              audio=True, script=True)
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        table[name] = _digest(FIXTURES / name)
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256():
    """The committed fixtures: cv2's decode still gives the recorded
    sha256, and so does the port's, frame by frame, in RGB and Y; the FHD
    headline shows 7-bit escapes and the quantiser-1 one 11-bit ones."""
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        path = FIXTURES / name
        want = table[name]
        assert path.stat().st_size <= (2_500_000 if name == FIXTURE.name
                                       else 120_000), name
        assert _digest(path) == want, name
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert [_sha(f) for f in got] == want["rgb_sha256"], name
        planes, stats = port_planes(path)
        assert [_sha(p[0]) for p in planes] == want["y_sha256"], name
        if name == FIXTURE.name:
            assert want["frames"] == 32 and stats["flv_escapes_7"] > 0
        if name == "flv1_q1_audio_script.flv":
            assert stats["flv_escapes_11"] > 0


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
