"""The port's VP8 video (io/vp8.py over native/vp8.cpp, in WebM/Matroska
through io/matroska.py and in AVI through io/avi.py, read by
``MediaSource(use_photos=False)``) on the CPU, against OpenCV's default
FFmpeg backend: RGB frames bit for bit and frame for frame against
``cv2.VideoCapture(p)``, the Y plane bit for bit against its
``CAP_PROP_CONVERT_RGB=0`` read.  Streams: cv2's ``VP80`` writer at 37x53,
480x640 and FHD and a moving 30-frame sequence with key frames at 0, 12
and 24; and, coded through ctypes by the libvpx encoder in the libavcodec
cv2's wheel carries, key frames only and each encoder tool cv2's writer
does not use (2/4/8 token partitions, real-time segmentation, versions
1-3, hidden altref frames from a second pass, sharpness,
error-resilience), muxed into WebM by ``write_mkv`` here.  The committed
fixture (the 32 headline FHD frames as cv2's ``VP80`` writer makes them)
against its recorded sha256, and rewritten with unknown-size Segment and
Clusters and no Cues; Xiph, EBML and fixed lacing; ``VP80`` in AVI,
``mp4v`` and ``MJPG`` in .mkv; refusals (VP9 profile 1, FFV1, H.264, header
stripping, a key frame that changes the size); truncation and damage;
the decoder's tables against the bytes of libavcodec's; and, end to end,
``slam_main`` on a 540x960 VP8 WebM and the video calibration from a VP8
WebM against the JAX package reading the same files through cv2.

Rewrite the fixture with ``PYTHONPATH=. python tests/test_torch_webm.py
--write-fixture`` (needs cv2's FFmpeg ``VP80`` writer)."""

import hashlib
import json
import pathlib
import sys

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, matroska, native, vp8
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import make_scene, mjpeg
from test_torch_mp4 import (FIXTURE as MP4_FIXTURE, cv2_rgb, lavc_encode,
                            pass1_stats, swscale_rgb, write_cv2_video)

torch.set_num_threads(1)

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures")
FIXTURE = FIXTURES / "headline_vp8.webm"
DIGESTS = FIXTURES / "cv2_sha256.json"


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cv2_luma(path):
    """The decoded Y planes, as cv2's FFmpeg backend returns yuv420p with
    ``CAP_PROP_CONVERT_RGB=0``."""
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_CONVERT_RGB, 0])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def port_luma(path):
    video = avi.open_video(str(path))
    dec = vp8.Decoder()
    out = [dec.decode_yuv(video.read(f)) for f in video.frames]
    video.close()
    return [p[0] for p in out if p is not None]


def check_equal_cv2(path, hw, n, rgb=True):
    """Every frame through MediaSource equals cv2's in RGB (unless not
    ``rgb``), and every Y plane cv2's."""
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           prefetch=3))
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.shape == tuple(hw) + (3,)
        if rgb:
            np.testing.assert_array_equal(a, b)
    luma, want_y = port_luma(path), cv2_luma(path)
    assert len(luma) == len(want_y) == n
    for a, b in zip(luma, want_y):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def scene_frames():
    sc = make_scene(n_points=400, n_frames=30, seed=5, baseline=0.3)
    return [sc.render(i) for i in range(30)]


# ------------------------------------------------------------ bitstream

class _Bool:
    """RFC 6386's boolean decoder, to read the frame headers the tests
    look for in the encoder's output."""

    def __init__(self, data: bytes):
        self.d, self.pos = data, 2
        self.value = int.from_bytes(data[:2].ljust(2, b"\0"), "big")
        self.range, self.count = 255, 0

    def get(self, prob: int = 128) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            bit, self.range, self.value = 1, self.range - split, \
                self.value - (split << 8)
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value, self.range = self.value << 1, self.range << 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.d[self.pos] if self.pos < len(
                    self.d) else 0
                self.pos += 1
        return bit

    def lit(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get()
        return v


def vp8_header(frame: bytes) -> dict:
    """The frame tag and the first partition's header up to the reference
    updates (RFC 6386 section 9 / 19.2)."""
    tag = int.from_bytes(frame[:3], "little")
    h = dict(key=not tag & 1, version=(tag >> 1) & 7, show=bool(tag & 16))
    b = _Bool(frame[10 if h["key"] else 3:])
    if h["key"]:
        h["size"] = (int.from_bytes(frame[6:8], "little") & 0x3FFF,
                     int.from_bytes(frame[8:10], "little") & 0x3FFF)
        b.lit(2)
    h["segmentation"] = b.get()
    h["update_map"] = 0
    if h["segmentation"]:
        h["update_map"], update_data = b.get(), b.get()
        if update_data:
            b.get()
            for n in (7,) * 4 + (6,) * 4:
                if b.get():
                    b.lit(n + 1)
        if h["update_map"]:
            for _ in range(3):
                if b.get():
                    b.lit(8)
    h["simple"], h["level"], h["sharpness"] = b.get(), b.lit(6), b.lit(3)
    if b.get() and b.get():
        for _ in range(8):
            if b.get():
                b.lit(7)
    h["partitions"] = 1 << b.lit(2)
    b.lit(7)
    for _ in range(5):
        if b.get():
            b.lit(5)
    if not h["key"]:
        golden, altref = b.get(), b.get()
        h["refresh_altref"] = altref
        if not golden:
            b.lit(2)
        if not altref:
            b.lit(2)
        h["sign_bias"] = (b.get(), b.get())
    h["refresh_probs"] = b.get()
    return h


# -------------------------------------------------------------- muxing

def _id(i: int) -> bytes:
    return i.to_bytes((i.bit_length() + 7) // 8, "big")


def _el(i: int, body: bytes, unknown: bool = False) -> bytes:
    size = (b"\x01" + b"\xff" * 7 if unknown
            else (len(body) | 1 << 56).to_bytes(8, "big"))
    return _id(i) + size + body


def _uint(i: int, v: int) -> bytes:
    return _el(i, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def _lace(frames: list, kind: str) -> bytes:
    """A lacing header (after the flags byte) and the frames."""
    head = bytes([len(frames) - 1])
    if kind == "xiph":
        for f in frames[:-1]:
            head += b"\xff" * (len(f) // 255) + bytes([len(f) % 255])
    elif kind == "ebml":
        # the first size unsigned (4 bytes), then differences (3 bytes,
        # biased by 2^20 - 1); the last implied
        head += (len(frames[0]) | 1 << 28).to_bytes(4, "big")
        for a, b in zip(frames[:-2], frames[1:-1]):
            head += ((len(b) - len(a) + (1 << 20) - 1) | 1 << 21).to_bytes(
                3, "big")
    return head + b"".join(frames)


def write_mkv(path, frames: list, w: int, h: int, codec: str = "V_VP8",
              doctype: bytes = b"webm", lacing: str = "", per_cluster=8,
              private: bytes = b"") -> None:
    """A WebM/Matroska file of one video track holding ``frames``, eight
    to a Cluster of SimpleBlocks (or, with ``lacing`` "xiph", "ebml" or
    "fixed", one laced SimpleBlock per Cluster)."""
    header = _el(0x1A45DFA3, _uint(0x4286, 1) + _uint(0x42F7, 1)
                 + _uint(0x42F2, 4) + _uint(0x42F3, 8)
                 + _el(0x4282, doctype) + _uint(0x4287, 2)
                 + _uint(0x4285, 2))
    info = _el(0x1549A966, _uint(0x2AD7B1, 1_000_000)
               + _el(0x4D80, b"test") + _el(0x5741, b"test"))
    entry = (_uint(0xD7, 1) + _uint(0x73C5, 1) + _uint(0x83, 1)
             + _el(0x86, codec.encode())
             + (_el(0x63A2, private) if private else b"")
             + _el(0xE0, _uint(0xB0, w) + _uint(0xBA, h)))
    tracks = _el(0x1654AE6B, _el(0xAE, entry))
    clusters = b""
    for c in range(0, len(frames), per_cluster):
        group = frames[c:c + per_cluster]
        body = _uint(0xE7, 100 * c)
        if lacing:
            flags = {"xiph": 0x82, "fixed": 0x84, "ebml": 0x86}[lacing]
            laced = (bytes([len(group) - 1]) + b"".join(group)
                     if lacing == "fixed" else _lace(group, lacing))
            body += _el(0xA3, b"\x81\x00\x00" + bytes([flags]) + laced)
        else:
            for k, f in enumerate(group):
                key = 0x80 if f[0] & 1 == 0 else 0
                body += _el(0xA3, b"\x81" + (100 * k).to_bytes(2, "big")
                            + bytes([key]) + f)
        clusters += _el(0x1F43B675, body)
    pathlib.Path(path).write_bytes(
        header + _el(0x18538067, info + tracks + clusters))


def _elements(data: bytes, start: int, end: int):
    """(id, header start, data start, data end) of the EBML elements in
    data[start:end] (known sizes only)."""
    pos = start
    while pos < end:
        first = data[pos]
        n = 8 - first.bit_length() + 1
        eid = int.from_bytes(data[pos:pos + n], "big")
        s0 = data[pos + n]
        m = 8 - s0.bit_length() + 1
        size = int.from_bytes(data[pos + n:pos + n + m], "big") & (
            (1 << (7 * m)) - 1)
        yield eid, pos, pos + n + m, pos + n + m + size
        pos += n + m + size


def unknown_sizes_without_cues(src: pathlib.Path, dst: pathlib.Path) -> None:
    """``src`` written again as a live recorder writes it: the Segment and
    every Cluster of unknown size, and no SeekHead, Cues or Void."""
    data = src.read_bytes()
    (_, h0, _, h1), (sid, _, s0, s1) = list(_elements(data, 0, len(data)))
    assert sid == matroska.SEGMENT
    body = b""
    for eid, p, s, e in _elements(data, s0, s1):
        if eid in (0x114D9B74, 0x1C53BB6B, 0xEC):
            continue
        body += (_el(eid, data[s:e], unknown=True)
                 if eid == matroska.CLUSTER else data[p:e])
    dst.write_bytes(data[h0:h1] + _el(matroska.SEGMENT, body, unknown=True))


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("size,hw", [((37, 53), (36, 52)),
                                     ((480, 640), (480, 640)),
                                     ((1080, 1920), (1080, 1920)),
                                     ((38, 53), (38, 53))])
def test_frames_equal_cv2(tmp_path, scene_frames, size, hw):
    """Frames of ``size`` through cv2's VP80 writer into WebM (which cuts
    37x53 to 36x52, not whole macroblocks) and, at 38x53 (an odd last
    column), through libvpx by ctypes: every frame equals cv2's default
    backend's in RGB and in Y (three frames at FHD, eight below)."""
    n = 3 if hw[0] > 500 else 8
    frames = [np.ascontiguousarray(cv2.resize(f, size[::-1]))
              for f in scene_frames[:n]]
    path = tmp_path / "seq.webm"
    if size[1] % 2 and size[0] % 2 == 0:
        write_mkv(path, lavc_encode("libvpx", frames, {})[0], hw[1], hw[0])
    else:
        write_cv2_video(path, frames, "VP80")
    check_equal_cv2(path, hw, n)
    video = avi.open_video(str(path))
    assert isinstance(video, matroska.MkvVideo)
    assert (video.codec, video.width, video.height) == ("vp8", hw[1], hw[0])
    video.close()


@pytest.mark.parametrize("hw", [(37, 53), (95, 161), (201, 36), (37, 54),
                                (1079, 1920)])
def test_odd_height_luma_equal_cv2(tmp_path, scene_frames, hw):
    """An odd frame height (libvpx by ctypes; cv2's writers make none):
    the Y planes equal cv2's bit for bit, and so do the RGB frames, which
    swscale makes on its scaling path (bicubic chroma; at an odd width
    full horizontal chroma too), not with its unscaled converter: they
    equal sws_scale's on the port's own planes as well."""
    n = 2 if hw[0] > 500 else 6
    frames = [np.ascontiguousarray(cv2.resize(f, hw[::-1]))
              for f in scene_frames[:n]]
    packets = lavc_encode("libvpx", frames, {})[0]
    path = tmp_path / "odd.webm"
    write_mkv(path, packets, hw[1], hw[0])
    check_equal_cv2(path, hw, n)
    rgb, yuv = vp8.Decoder(), vp8.Decoder()
    for p in packets:
        np.testing.assert_array_equal(rgb.decode(p),
                                      swscale_rgb(*yuv.decode_yuv(p)))


def test_moving_sequence_two_gops(tmp_path, scene_frames):
    """30 moving frames at 240x320 from cv2's writer: key frames at 0, 12
    and 24, the inter frames between, every frame as cv2 decodes it."""
    frames = [np.ascontiguousarray(cv2.resize(f, (320, 240)))
              for f in scene_frames]
    path = tmp_path / "move.webm"
    write_cv2_video(path, frames, "VP80")
    video = matroska.MkvVideo(str(path))
    heads = [vp8_header(video.read(f)) for f in video.frames]
    video.close()
    assert [i for i, h in enumerate(heads) if h["key"]] == [0, 12, 24]
    check_equal_cv2(path, (240, 320), 30)


def _tool_frames(n=40, baseline=0.3):
    sc = make_scene(n_points=400, n_frames=n, seed=5, baseline=baseline)
    return [np.ascontiguousarray(cv2.resize(sc.render(i), (160, 96)))
            for i in range(n)]


def _encode_tool(options: dict, frames) -> list:
    if options.pop("two_pass", False):
        _, ctx = lavc_encode("libvpx", frames, {**options,
                                                "flags": "+pass1"})
        return lavc_encode("libvpx", frames, {**options, "flags": "+pass2"},
                           stats_in=pass1_stats(ctx))[0]
    return lavc_encode("libvpx", frames, options)[0]


# (libvpx options, what the stream must show)
_TOOLS = {
    "key_frames_only": ({"g": "1"}, lambda hs: all(h["key"] for h in hs)),
    "partitions_2": ({"slices": "2"},
                     lambda hs: {h["partitions"] for h in hs} == {2}),
    "partitions_4": ({"slices": "4"},
                     lambda hs: {h["partitions"] for h in hs} == {4}),
    "partitions_8": ({"slices": "8"},
                     lambda hs: {h["partitions"] for h in hs} == {8}),
    "realtime_segmentation": (
        {"deadline": "realtime", "cpu-used": "8", "error-resilient": "1",
         "b": "100k"},
        lambda hs: all(h["segmentation"] and h["update_map"] for h in hs)),
    "version_1": ({"profile": "1"},
                  lambda hs: all(h["version"] == 1 and h["simple"]
                                 for h in hs)),
    "version_2": ({"profile": "2"},
                  lambda hs: all(h["version"] == 2 for h in hs)),
    "version_3": ({"profile": "3"},
                  lambda hs: all(h["version"] == 3 for h in hs)),
    "sharpness": ({"sharpness": "7"},
                  lambda hs: sum(h["sharpness"] == 7 for h in hs) > 20),
    "error_resilient": (
        {"error-resilient": "1"},
        lambda hs: not any(h["refresh_probs"] for h in hs)),
}


@pytest.mark.parametrize("tool", sorted(_TOOLS))
def test_encoder_tools_equal_cv2(tmp_path, tool):
    """Each tool of libvpx's encoder that cv2's writer leaves off, coded
    through ctypes at 96x160 and muxed into WebM: the headers show the
    tool, and every frame equals cv2's in RGB and in Y."""
    options, shows = _TOOLS[tool]
    packets = _encode_tool(dict(options), _tool_frames())
    assert shows([vp8_header(p) for p in packets])
    path = tmp_path / "tool.webm"
    write_mkv(path, packets, 160, 96)
    check_equal_cv2(path, (96, 160), 40)


def test_hidden_altref_frames(tmp_path):
    """A second libvpx pass with ``auto-alt-ref`` on a slow pan: hidden
    altref frames (``show_frame`` 0, sign bias 1) between the shown ones;
    they update the references and give no frame, in WebM and in AVI, as
    in cv2."""
    frames = _tool_frames(60, baseline=0.02)
    packets = _encode_tool({"two_pass": True, "auto-alt-ref": "1",
                            "lag-in-frames": "25", "g": "200",
                            "b": "300k"}, frames)
    heads = [vp8_header(p) for p in packets]
    hidden = [i for i, h in enumerate(heads) if not h["show"]]
    assert len(hidden) >= 2 and len(packets) == 60 + len(hidden)
    assert all(heads[i]["refresh_altref"] for i in hidden)
    assert any(h.get("sign_bias") == (0, 1) for h in heads)
    write_mkv(tmp_path / "arf.webm", packets, 160, 96)
    check_equal_cv2(tmp_path / "arf.webm", (96, 160), 60)
    mjpeg.write_avi(str(tmp_path / "arf.avi"), packets, 160, 96,
                    fourcc=b"VP80")
    check_equal_cv2(tmp_path / "arf.avi", (96, 160), 60)


def write_fixture() -> None:
    """The 32 headline FHD frames (as cv2 decodes headline_mp4v.mp4)
    through cv2's VP80 writer into WebM, and the sha256 of cv2's RGB frames
    and Y planes, beside the other fixtures' in cv2_sha256.json."""
    write_cv2_video(FIXTURE, cv2_rgb(MP4_FIXTURE), "VP80")
    rgb = cv2_rgb(FIXTURE)
    table = json.loads(DIGESTS.read_text())
    table[FIXTURE.name] = {"frames": len(rgb), "shape": list(rgb[0].shape),
                           "rgb_sha256": [_sha(f) for f in rgb],
                           "y_sha256": [_sha(f) for f in cv2_luma(FIXTURE)]}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixture_cv2_and_port_equal_recorded_sha256():
    """The committed fixture (what chip_smoke.py holds the port to on the
    card): cv2's decode still gives the recorded sha256, and so does the
    port's, frame by frame, in RGB and Y; and its stream is cv2's default
    encode (key frames at 0, 12 and 24, version 0, one partition, every
    frame shown)."""
    table = json.loads(DIGESTS.read_text())[FIXTURE.name]
    assert FIXTURE.stat().st_size <= 4_000_000
    assert [_sha(f) for f in cv2_rgb(FIXTURE)] == table["rgb_sha256"]
    assert [_sha(y) for y in cv2_luma(FIXTURE)] == table["y_sha256"]
    got = list(MediaSource(video_path=str(FIXTURE), use_photos=False))
    assert len(got) == table["frames"] == 32
    assert [_sha(f) for f in got] == table["rgb_sha256"]
    assert [_sha(y) for y in port_luma(FIXTURE)] == table["y_sha256"]
    video = matroska.MkvVideo(str(FIXTURE))
    heads = [vp8_header(video.read(f)) for f in video.frames]
    video.close()
    assert [i for i, h in enumerate(heads) if h["key"]] == [0, 12, 24]
    assert all(h["show"] and h["version"] == 0 and h["partitions"] == 1
               for h in heads)


def test_unknown_sizes_without_cues_equal_the_fixture(tmp_path):
    """The fixture as a live recorder writes it (Segment and Clusters of
    unknown size, no SeekHead, Cues or Void): the same frames through the
    port and through cv2."""
    path = tmp_path / "live.webm"
    unknown_sizes_without_cues(FIXTURE, path)
    data = path.read_bytes()
    assert b"\x01\xff\xff\xff\xff\xff\xff\xff" in data
    assert b"\x1c\x53\xbb\x6b" not in data
    table = json.loads(DIGESTS.read_text())[FIXTURE.name]
    video = matroska.MkvVideo(str(path))
    assert len(video.frames) == 32
    video.close()
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert [_sha(f) for f in got] == table["rgb_sha256"]
    assert [_sha(f) for f in cv2_rgb(path)] == table["rgb_sha256"]


@pytest.mark.parametrize("lacing", ["xiph", "ebml", "fixed"])
def test_laced_blocks(tmp_path, lacing):
    """Eight frames to a laced SimpleBlock: the port splits Xiph, EBML and
    fixed-size lacing as cv2's demuxer does (for fixed, each frame padded
    with zeros to the largest, which the decoder never reads)."""
    packets = _encode_tool({}, _tool_frames(24))
    if lacing == "fixed":
        n = max(len(p) for p in packets)
        packets = [p + bytes(n - len(p)) for p in packets]
    path = tmp_path / "laced.webm"
    write_mkv(path, packets, 160, 96, lacing=lacing)
    video = matroska.MkvVideo(str(path))
    assert [video.read(f) for f in video.frames] == packets
    video.close()
    check_equal_cv2(path, (96, 160), 24)


def test_lacing_in_a_track_without_lacing_raises(tmp_path):
    packets = _encode_tool({}, _tool_frames(8))
    path = tmp_path / "laced.webm"
    write_mkv(path, packets, 160, 96, lacing="xiph")
    data = path.read_bytes()
    i = data.index(b"\x86\x01" + bytes(6) + b"\x05V_VP8")
    path.write_bytes(data[:i] + b"\x9c\x81\x00" + data[i:])  # FlagLacing 0
    fixed = path.read_bytes()
    # the TrackEntry and Tracks grew by three bytes
    for eid in (b"\xae", b"\x16\x54\xae\x6b", b"\x18\x53\x80\x67"):
        j = fixed.index(eid + b"\x01")
        n = int.from_bytes(fixed[j + len(eid):j + len(eid) + 8], "big")
        fixed = (fixed[:j + len(eid)] + (n + 3).to_bytes(8, "big")
                 + fixed[j + len(eid) + 8:])
    path.write_bytes(fixed)
    with pytest.raises(ValueError, match="Xiph lacing"):
        matroska.MkvVideo(str(path))


def test_vp80_avi_equals_the_webm(tmp_path, scene_frames):
    """cv2's VP80 writer into AVI, and chip_smoke.py's mux (the fixture's
    frames in a VP80 AVI by testing/mjpeg.py): each equals cv2's decode,
    and the mux equals the WebM frame for frame."""
    frames = [np.ascontiguousarray(cv2.resize(f, (160, 96)))
              for f in scene_frames[:10]]
    path = tmp_path / "cv2.avi"
    write_cv2_video(path, frames, "VP80")
    video = avi.open_video(str(path))
    assert (video.codec, video.fourcc) == ("vp8", b"VP80")
    video.close()
    check_equal_cv2(path, (96, 160), 10)
    video = matroska.MkvVideo(str(FIXTURE))
    data = [video.read(f) for f in video.frames]
    video.close()
    mjpeg.write_avi(str(tmp_path / "fix.avi"), data, 1920, 1080,
                    fourcc=b"VP80")
    table = json.loads(DIGESTS.read_text())[FIXTURE.name]
    got = list(MediaSource(video_path=str(tmp_path / "fix.avi"),
                           use_photos=False))
    assert [_sha(f) for f in got] == table["rgb_sha256"]


def test_mp4v_in_mkv_equals_cv2(tmp_path, scene_frames):
    """cv2's mp4v writer into .mkv (CodecID ``V_MPEG4/ISO/ASP``, the VOL in
    CodecPrivate): the frames equal cv2's."""
    frames = [np.ascontiguousarray(cv2.resize(f, (160, 96)))
              for f in scene_frames[:10]]
    path = tmp_path / "m.mkv"
    write_cv2_video(path, frames, "mp4v")
    video = avi.open_video(str(path))
    assert video.codec == "mpeg4" and video.codec_id == "V_MPEG4/ISO/ASP"
    assert b"\0\0\1\x20" in video.extradata
    video.close()
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mjpeg_in_mkv_equals_cv2_imdecode(tmp_path, scene_frames):
    """cv2's MJPG writer into .mkv (``V_MJPEG``): as many frames as
    cv2.VideoCapture gives, each equal to cv2.imdecode of its block (the
    libjpeg decode io/jpeg.py equals; OpenCV's FFmpeg MJPEG decoder
    differs from libjpeg by a few grey levels)."""
    frames = [np.ascontiguousarray(cv2.resize(f, (160, 96)))
              for f in scene_frames[:6]]
    path = tmp_path / "j.mkv"
    write_cv2_video(path, frames, "MJPG")
    video = avi.open_video(str(path))
    assert video.codec == "mjpeg"
    blocks = [video.read(f) for f in video.frames]
    video.close()
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(cv2_rgb(path)) == 6
    for a, blk in zip(got, blocks):
        want = cv2.imdecode(np.frombuffer(blk, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(a, want[..., ::-1])


# ----------------------------------------------------------- refusals

@pytest.mark.parametrize("fourcc,codec", [("VP90", "VP9"),
                                          ("FFV1", "FFV1")])
def test_other_codecs_raise(tmp_path, scene_frames, fourcc, codec):
    """cv2's FFV1 (.mkv) writer is read now (tests/test_torch_ffv1.py):
    its frames equal cv2's and the frames written (FFV1 in RGB is
    lossless).  cv2's VP90 (WebM) writer is read too
    (tests/test_torch_vp9.py), and the same file with its first frame
    marked VP9 profile 1 (4:4:4, which the decoder does not read) raises
    ValueError naming the profile."""
    path = tmp_path / ("v.webm" if fourcc == "VP90" else "v.mkv")
    write_cv2_video(path, [cv2.resize(f, (64, 48)) for f in scene_frames[:2]],
                    fourcc)
    want = cv2_rgb(path)
    assert len(want) == 2
    if fourcc == "VP90":
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert len(got) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        video = matroska.MkvVideo(str(path))
        offset = video.frames[0][0]
        video.close()
        data = bytearray(path.read_bytes())
        assert data[offset] >> 6 == 2                # VP9's frame marker
        data[offset] |= 0x20                         # profile_low_bit
        path.write_bytes(bytes(data))
        with pytest.raises(ValueError, match=f"{codec} profile 1"):
            list(MediaSource(video_path=str(path), use_photos=False))
        return
    written = [cv2.resize(f, (64, 48)) for f in scene_frames[:2]]
    video = matroska.MkvVideo(str(path))
    assert (video.codec, video.codec_id) == ("ffv1", "V_FFV1")
    video.close()
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == 2
    for a, b, c in zip(got, want, written):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("codec_id,name", [("V_MPEG4/ISO/AVC", "H.264"),
                                           ("V_MPEGH/ISO/HEVC", "HEVC"),
                                           ("V_AV1", "AV1")])
def test_codec_ids_raise(tmp_path, codec_id, name):
    path = tmp_path / "v.mkv"
    write_mkv(path, [b"\0" * 16], 64, 48, codec=codec_id,
              doctype=b"matroska")
    with pytest.raises(NotImplementedError, match=name):
        avi.open_video(str(path))


def test_content_encoding_raises(tmp_path):
    """A track with header stripping (ContentCompAlgo 3):
    NotImplementedError naming it; another DocType does not open."""
    packets = _encode_tool({}, _tool_frames(4))
    path = tmp_path / "v.mkv"
    write_mkv(path, packets, 160, 96)
    data = path.read_bytes()
    enc = _el(0x6D80, _el(0x6240, _el(0x5034, _uint(0x4254, 3)
                                      + _el(0x4255, b"\x9d"))))
    i = data.index(b"\xe0\x01")            # the Video element
    data = data[:i] + enc + data[i:]
    for eid in (b"\xae", b"\x16\x54\xae\x6b", b"\x18\x53\x80\x67"):
        j = data.index(eid + b"\x01")
        n = int.from_bytes(data[j + len(eid):j + len(eid) + 8], "big")
        data = (data[:j + len(eid)] + (n + len(enc)).to_bytes(8, "big")
                + data[j + len(eid) + 8:])
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match="header stripping"):
        MediaSource(video_path=str(path), use_photos=False)
    write_mkv(tmp_path / "x.mkv", packets, 160, 96, doctype=b"other")
    with pytest.raises(IOError, match="Video wasn't opened"):
        avi.open_video(str(tmp_path / "x.mkv"))


def test_size_change_and_leading_inter_frame(tmp_path):
    """A key frame of another size raises ValueError naming it.  An inter
    frame before the first key frame fails to decode: cv2 stops there and
    gives no frame at all, and so does the port; the stream without it
    gives cv2's frames."""
    small = _encode_tool({}, _tool_frames(4))
    big = lavc_encode("libvpx", [np.zeros((64, 96, 3), np.uint8)] * 2,
                      {})[0]
    dec = vp8.Decoder()
    assert dec.decode(small[0]) is not None
    with pytest.raises(ValueError, match="changes the frame size"):
        dec.decode(big[0])
    write_mkv(tmp_path / "late.webm", small[1:2] + small, 160, 96)
    write_mkv(tmp_path / "ok.webm", small, 160, 96)
    assert cv2_rgb(tmp_path / "late.webm") == []
    assert list(MediaSource(video_path=str(tmp_path / "late.webm"),
                            use_photos=False)) == []
    want = cv2_rgb(tmp_path / "ok.webm")
    got = list(MediaSource(video_path=str(tmp_path / "ok.webm"),
                           use_photos=False))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- a hand-made stream

class _BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, bit: int, prob: int = 128) -> None:
        split = 1 + (((self.range - 1) * int(prob)) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def literal(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put((v >> k) & 1)

    def _carry(self) -> None:
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def flush(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) << (8 * (c >> 3)) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


_BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]


def _dc_block(e: _BoolEncoder, coef, kind: int, ctx: int, first: int,
              dc: int) -> int:
    """One block's tokens: ``dc`` (67..2114, as DCT_CAT6) at position
    ``first`` and EOB, or EOB alone for 0 → the block's context flag."""
    p = coef[kind][_BANDS[first]][ctx]
    if not dc:
        e.put(0, p[0])
        return 0
    for bit, k in ((1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 8), (1, 10)):
        e.put(bit, p[k])
    for k, q in enumerate(vp8.table("cat6_probs")):
        e.put(((dc - 67) >> (10 - k)) & 1, int(q))
    e.put(0)                                          # positive
    e.put(0, coef[kind][_BANDS[first + 1]][2][0])      # EOB
    return 1


def saturated_key_frame(y_dc: int, u_dc: int) -> bytes:
    """A 16x16 key frame written by hand (quantiser index 0, no loop
    filter, DC_PRED everywhere): the Y2 DC ``y_dc`` and every U block's
    DC ``u_dc`` as DCT_CAT6 tokens, V empty."""
    coef = vp8.table("coeff_default_probs").reshape(4, 8, 3, 11)
    upd = vp8.table("coeff_update_probs")
    e = _BoolEncoder()
    for bit in (0, 0, 0, 0):     # colour space, clamping, segmentation, type
        e.put(bit)
    e.literal(0, 6)              # filter level
    e.literal(0, 3)              # sharpness
    e.put(0)                     # no mode/ref filter deltas
    e.literal(0, 2)              # one token partition
    e.literal(0, 7)              # quantiser index
    for _ in range(5):
        e.put(0)                 # no quantiser deltas
    e.put(1)                     # refresh_entropy_probs
    for q in upd:
        e.put(0, int(q))         # no coefficient update
    e.put(0)                     # mb_no_coeff_skip 0
    for bit, q in ((1, 145), (0, 156), (0, 163), (0, 142)):
        e.put(bit, q)            # DC_PRED luma and chroma
    first = e.flush()
    t = _BoolEncoder()
    _dc_block(t, coef, 1, 0, 0, y_dc)                 # Y2
    for _ in range(16):
        _dc_block(t, coef, 0, 0, 1, 0)                # Y: DC from Y2
    flags = []
    for k in range(4):                                # U, 2x2
        ctx = (flags[k - 2] if k > 1 else 0) + (flags[k - 1] if k % 2 else 0)
        flags.append(_dc_block(t, coef, 2, ctx, 0, u_dc))
    for k in range(4):                                # V
        _dc_block(t, coef, 2, 0, 0, 0)
    tokens = t.flush()
    tag = (len(first) << 5) | 0x10                    # key, version 0, shown
    return (tag.to_bytes(3, "little") + b"\x9d\x01\x2a"
            + (16).to_bytes(2, "little") * 2 + first + tokens)


@pytest.mark.parametrize("y_dc,u_dc", [(2000, 2000), (67, 2000), (2000, 67)])
def test_hand_made_saturated_frame_equals_cv2(tmp_path, y_dc, u_dc):
    """A key frame written here bit by bit (RFC 6386's boolean encoder)
    whose decode is Y 255 and U 255 where both DCs are large: the sums of
    swscale's converter reach 534 there, past a table of +-512, and must
    saturate to 255 as swscale's packuswb does; the frame equals cv2's."""
    frame = saturated_key_frame(y_dc, u_dc)
    y, u, v = vp8.Decoder().decode_yuv(frame)
    if y_dc > 1000:
        assert (y == 255).all()
    if u_dc > 1000:
        assert (u == 255).all()
    path = tmp_path / "hand.avi"
    mjpeg.write_avi(str(path), [frame], 16, 16, fourcc=b"VP80")
    want = cv2_rgb(path)
    assert len(want) == 1
    np.testing.assert_array_equal(vp8.Decoder().decode(frame), want[0])
    np.testing.assert_array_equal(y, cv2_luma(path)[0])


# ------------------------------------------------------ damage, close

@pytest.mark.parametrize("where", ["last_block", "cluster_header"])
def test_truncated_webm(tmp_path, where):
    """A WebM cut inside its last block, or two bytes into the header of
    its last Cluster: the demuxer drops what the cut reaches, as FFmpeg's
    does; the frames before it equal cv2's."""
    data = FIXTURE.read_bytes()
    video = matroska.MkvVideo(str(FIXTURE))
    off, n, _ = video.frames[-1]
    video.close()
    cut = off + n // 2
    keep = 31
    if where == "cluster_header":
        cut = data.rindex(b"\x1f\x43\xb6\x75") + 2
        keep = 24                           # clusters start at key frames
    path = tmp_path / "cut.webm"
    path.write_bytes(data[:cut])
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == keep
    table = json.loads(DIGESTS.read_text())[FIXTURE.name]
    assert [_sha(f) for f in got] == table["rgb_sha256"][:keep]


@pytest.mark.parametrize("keep", [0.5, 0.98])
def test_truncated_frame(tmp_path, keep):
    """The next-to-last frame of a VP80 AVI cut to a part of its bytes.
    Cut by 2 %, the token partition runs out in the last few macroblocks
    (FFmpeg's test passes them, reading zeros): the port gives the frame
    cv2 gives.  Cut by half, FFmpeg stops at the row where the data ends
    and still gives a frame, whose rows from there on are undefined; the
    port gives it too (the rows from there on are the last frame's), and
    it equals cv2's above the macroblock row where the port's frame departs
    from its decode of the uncut frame (FFmpeg's filter has then left that
    row's top edge unfiltered, as the port does)."""
    packets = _encode_tool({"g": "100"}, _tool_frames(10))
    cut = packets[-2][:int(len(packets[-2]) * keep)]
    path = tmp_path / "cut.avi"
    mjpeg.write_avi(str(path), packets[:-2] + [cut], 160, 96,
                    fourcc=b"VP80")
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(want) == len(got) == 9
    for a, b in zip(got[:8], want):
        np.testing.assert_array_equal(a, b)
    if keep > 0.9:
        np.testing.assert_array_equal(got[8], want[8])
        return
    dec = vp8.Decoder()
    for p in packets[:-2]:
        dec.decode(p)
    clean = dec.decode(packets[-2])
    rows = np.flatnonzero((got[8] != clean).any(axis=(1, 2)))
    assert len(rows)
    exact = 16 * (rows[0] // 16 + 1)
    np.testing.assert_array_equal(got[8][:exact], want[8][:exact])


@pytest.mark.parametrize("how", ["half", "90pct", "2bytes", "flip"])
def test_damaged_frame_mid_stream_gives_cv2s_frame_count(tmp_path, how):
    """The fifth frame of ten (VP80 AVI, 96x160) damaged: cv2 reads 4
    frames where the damage breaks the frame header (FFmpeg fails it and
    its reader stops), else 10; the port gives the same count, the frames
    before equal; a frame with bytes flipped equals cv2's (the range coder
    reads the damage as FFmpeg does), a cut one in the rows above where
    the port's frame departs from its decode of the whole one."""
    from test_torch_mp4 import _damage

    packets = _encode_tool({"g": "100"}, _tool_frames(10))
    damaged = list(packets)
    damaged[4] = _damage(packets[4], how)
    path = tmp_path / "damaged.avi"
    mjpeg.write_avi(str(path), damaged, 160, 96, fourcc=b"VP80")
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == (4 if how == "2bytes" else 10)
    for a, b in zip(got[:4], want):
        np.testing.assert_array_equal(a, b)
    if how == "flip":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    elif how != "2bytes":
        dec = vp8.Decoder()
        clean = [dec.decode(p) for p in packets[:5]][4]
        rows = np.flatnonzero((got[4] != clean).any(axis=(1, 2)))
        exact = 16 * (rows[0] // 16 + 1) if len(rows) else 96
        np.testing.assert_array_equal(got[4][:exact], want[4][:exact])


def test_close_mid_stream_stops_the_decoding_thread():
    src = MediaSource(video_path=str(FIXTURE), use_photos=False, prefetch=2)
    assert src.next_frame() is not None
    src.close()
    src._reader._thread.join(timeout=10)
    assert not src._reader._thread.is_alive()
    assert src.next_frame() is None


def test_damaged_input_raises_only_the_documented_errors(tmp_path):
    """Bytes changed at random (seeded) in the frames of a small stream,
    and in the headers of a WebM: the decoder gives frames or None (or
    ValueError naming a feature) and never crashes; the demuxer opens the
    file or raises IOError, ValueError or NotImplementedError."""
    rng = np.random.default_rng(15)
    packets = _encode_tool({"slices": "4"}, _tool_frames(12))
    for _ in range(40):
        dec = vp8.Decoder()
        for p in packets:
            p = bytearray(p)
            for _ in range(int(rng.integers(0, 4))):
                p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
            try:
                img = dec.decode(bytes(p[:int(rng.integers(1, len(p) + 1))]))
            except ValueError:
                continue
            assert img is None or (img.dtype == np.uint8
                                   and img.shape == (96, 160, 3))
    write_mkv(tmp_path / "ok.webm", packets, 160, 96)
    data = (tmp_path / "ok.webm").read_bytes()
    path = tmp_path / "damaged.webm"
    for _ in range(200):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            d[int(rng.integers(0, 400))] = int(rng.integers(0, 256))
        path.write_bytes(bytes(d))
        try:
            video = avi.open_video(str(path))
        except (IOError, ValueError, NotImplementedError):
            continue
        for f in video.frames[:2]:
            video.read(f)
        video.close()


# ------------------------------------------------------------- tables

def _libavcodec() -> bytes:
    import glob

    libs = pathlib.Path(cv2.__file__).resolve().parent.parent / \
        "opencv_python.libs"
    return pathlib.Path(glob.glob(str(libs / "libavcodec*"))[0]).read_bytes()


# FFmpeg numbers the subblock modes as H.264 does (vertical, horizontal,
# DC, down-left, down-right, vertical-right, horizontal-down, vertical-left,
# horizontal-up, TM); RFC 6386's index of each
_FFMPEG_BMODES = [2, 3, 0, 4, 5, 6, 8, 7, 9, 1]


@pytest.mark.parametrize("name,dtype", [
    ("dc_qlookup", "u1"), ("ac_qlookup", "<u2"),
    ("coeff_default_probs", "u1"), ("coeff_update_probs", "u1"),
    ("kf_bmode_probs", "u1"), ("mv_default_probs", "u1"),
    ("mv_update_probs", "u1"), ("mode_contexts", "<i4"),
    ("sub_mv_ref_probs", "u1"), ("bmode_probs", "u1"),
    ("subpel_filters", "u1"), ("zigzag", "u1"), ("cat6_probs", "u1"),
])
def test_table_equals_libavcodec(name, dtype):
    """Each constant table of native/vp8.cpp (RFC 6386's) is in the
    libavcodec that cv2's wheel carries, entry for entry in the same
    order (the key-frame B_PRED probabilities in FFmpeg's order of the
    subblock modes).  Where it is not, the longest prefix that is names
    the first entry that differs."""
    table = vp8.table(name)
    if name == "kf_bmode_probs":
        t = table.reshape(10, 10, 9)
        table = t[_FFMPEG_BMODES][:, _FFMPEG_BMODES].ravel()
    want = table.astype(dtype).tobytes()
    lib = _libavcodec()
    if lib.find(want) < 0:
        size = np.dtype(dtype).itemsize
        n = max(k for k in range(1, len(table) + 1)
                if lib.find(want[:k * size]) >= 0)
        pytest.fail(f"{name}: entry {n} ({table[n]}) differs from every "
                    "copy of the entries before it")


def test_a_newer_header_rebuilds(tmp_path):
    """``load_shared`` rebuilds a library older than one of its headers,
    and not one newer than all of them."""
    import os
    import threading

    src, hdr = tmp_path / "t.cpp", tmp_path / "t.h"
    hdr.write_text("inline int value() { return 1; }\n")
    src.write_text('#include "t.h"\nextern "C" int f() { return value(); }\n')
    lib = tmp_path / "libt.so"

    def load():
        state = {"lib": None, "error": None}
        return native.load_shared(state, threading.Lock(), src, lib, [],
                                  lambda _: None, (hdr,))
    assert load().f() == 1
    built = lib.stat().st_mtime_ns
    assert load() and lib.stat().st_mtime_ns == built
    hdr.write_text("inline int value() { return 2; }\n")
    os.utime(hdr, ns=(built + 10**9, built + 10**9))
    load()
    assert lib.stat().st_mtime_ns != built


# -------------------------------------------------------- end to end

def test_slam_main_on_vp8_webm_against_jax(tmp_path):
    """test_torch_mp4.py's end-to-end test on a 540x960 VP8 WebM: the same
    frames as the JAX package's (cv2), as many cameras, ATE within 0.02 of
    the extent of the median of the JAX package's RANSAC seeds 0-2."""
    from test_torch_mp4 import slam_main_against_jax

    slam_main_against_jax(tmp_path, "VP80", "webm")


def test_calibrate_from_vp8_webm_against_jax(tmp_path, monkeypatch):
    """test_torch_mp4.py's video calibration on a VP8 WebM of the same
    board renders: K within 2 % of the truth for both packages and within
    1e-3 (relative) of the JAX package's."""
    from test_torch_mp4 import calibrate_against_jax

    calibrate_against_jax(tmp_path, monkeypatch, "VP80", "webm")


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    write_fixture()
