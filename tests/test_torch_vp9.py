"""The port's VP9 video (io/vp9.py over native/vp9.cpp, in WebM/Matroska
through io/matroska.py, in AVI through io/avi.py and in MP4 through
io/mp4.py, read by ``MediaSource(use_photos=False)``) on the CPU, against
OpenCV's default FFmpeg backend: RGB frames bit for bit and frame for
frame against ``cv2.VideoCapture(p)``, the Y plane bit for bit against its
``CAP_PROP_CONVERT_RGB=0`` read, in cv2's frame count.  Streams: cv2's
``VP90`` writer into .webm, .mkv, .avi and (``vp09``) .mp4; and, coded
through ctypes by the libvpx-vp9 encoder in the libavcodec cv2's wheel
carries (``lavc_encode``) over a pan of a dense texture, each encoder tool
with a header check that shows it (one pass; two passes with hidden
alt-ref frames in superframes and compound prediction; tile columns and
rows; frame-parallel and error-resilient modes; lossless; aq-mode 1-3;
real-time and cpu-used speeds; sharpness and show_existing_frame written
into the headers by hand), odd sizes, truncation and damage (cv2's frame
count), the features the decoder refuses by name (profiles 1 and 2,
intra-only frames, a size change, a scaled reference, colour other than
BT.601 limited range), the committed fixtures in
``testing/video_fixtures/`` against their recorded sha256, the decoder's
tables against libvpx's symbols, and, end to end, ``slam_main`` on a
540x960 VP9 WebM against the JAX package reading it through cv2.

Rewrite the fixtures with ``PYTHONPATH=.:tests python
tests/test_torch_vp9.py --write-fixtures`` (needs cv2's FFmpeg ``VP90``
writer and its libvpx-vp9 encoder; ~40 s, most of it the FHD two-pass
encode)."""

import glob
import hashlib
import json
import pathlib
import sys

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, matroska, mp4, vp9
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg
from test_torch_mp4 import (FIXTURE as MP4_FIXTURE, cv2_rgb, lavc_encode,
                            pass1_stats, write_cv2_video)
from test_torch_webm import cv2_luma, write_mkv

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures"
FIXTURE = FIXTURES / "headline_vp9.webm"
DIGESTS = FIXTURES / "cv2_sha256.json"
# cv2's VP90 writer in three containers; lossless; segmentation (aq-mode
# 3); error-resilient and frame-parallel; an odd size
SMALL_FIXTURES = ("vp9_cv2.webm", "vp9_cv2.avi", "vp9_cv2.mp4",
                  "vp9_lossless.webm", "vp9_aq.webm", "vp9_er_fp.webm",
                  "vp9_odd.webm")
# libvpx's settings for the FHD fixture: a two-pass VOD encode
HEADLINE_OPTIONS = {"crf": "32", "b": "0", "auto-alt-ref": "1",
                    "lag-in-frames": "25", "tile-columns": "2",
                    "row-mt": "1", "frame-parallel": "0", "g": "9999"}


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# ------------------------------------------------------------- streams

def texture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Blurred RGB noise: a picture in which a wrong motion vector shows."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                           (0, 0), 2.0)
    return cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX)


def pan(n: int, h: int = 96, w: int = 160, dy: int = 1, dx: int = 1,
        seed: int = 0, noise: float = 0.0) -> list:
    """``n`` frames of a pan over ``texture`` (``noise``: the standard
    deviation of Gaussian noise added to each frame, from the seed)."""
    big = texture(h + dy * n + 8, w + dx * n + 8, seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(n):
        f = big[4 + dy * i:4 + dy * i + h, 4 + dx * i:4 + dx * i + w]
        if noise:
            f = np.clip(f + rng.normal(0, noise, f.shape), 0, 255)
        out.append(np.ascontiguousarray(f.astype(np.uint8)))
    return out


def encode(frames, options: dict, two_pass: bool = False) -> list:
    """``frames`` through libvpx-vp9 (two passes with ``two_pass``)."""
    if two_pass:
        _, ctx = lavc_encode("libvpx-vp9", frames,
                             {**options, "flags": "+pass1"})
        return lavc_encode("libvpx-vp9", frames,
                           {**options, "flags": "+pass2"},
                           stats_in=pass1_stats(ctx))[0]
    return lavc_encode("libvpx-vp9", frames, options)[0]


def write_webm(path, packets, h: int, w: int) -> None:
    write_mkv(path, packets, w, h, codec="V_VP9")


def port_luma(path):
    """The Y planes the port's decoder gives, in order, up to a packet
    that fails (where the video ends)."""
    video = avi.open_video(str(path))
    dec = vp9.Decoder()
    out = []
    for f in video.frames:
        planes = dec.decode_yuv(video.read(f))
        if dec.failed:
            break
        if planes is not None:
            out.append(planes[0])
    video.close()
    return out


def check_equal_cv2(path, n=None, rgb=True):
    """Every frame through MediaSource equals cv2's in RGB (unless not
    ``rgb``), every Y plane cv2's, in cv2's count (``n`` if given)."""
    want_y = cv2_luma(path)
    got_y = port_luma(path)
    assert len(got_y) == len(want_y)
    if n is not None:
        assert len(got_y) == n
    for a, b in zip(got_y, want_y):
        np.testing.assert_array_equal(a, b)
    if rgb:
        want = cv2_rgb(path)
        got = list(MediaSource(video_path=str(path), use_photos=False,
                               prefetch=3))
        assert len(got) == len(want) == len(want_y)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def decoder_stats(path) -> dict:
    video = avi.open_video(str(path))
    dec = vp9.Decoder()
    for f in video.frames:
        dec.decode(video.read(f))
    video.close()
    return dec.stats()


# ------------------------------------------------------------- headers

def superframe(packet: bytes) -> list:
    """The frames of a packet: split at a superframe index, or itself."""
    c = packet[-1]
    if c & 0xE0 == 0xC0:
        n, mag = (c & 7) + 1, ((c >> 3) & 3) + 1
        index = 2 + mag * n
        if len(packet) >= index and packet[-index] == c:
            sizes = [int.from_bytes(packet[len(packet) - index + 1 + i * mag:
                                           len(packet) - index + 1
                                           + (i + 1) * mag], "little")
                     for i in range(n)]
            starts = np.cumsum([0] + sizes)
            return [packet[a:b] for a, b in zip(starts[:-1], starts[1:])]
    return [packet]


class _Bits:
    def __init__(self, data: bytes):
        self.bits = "".join(f"{b:08b}" for b in data) + "0" * 64
        self.pos = 0

    def get(self, n: int = 1) -> int:
        v = int(self.bits[self.pos:self.pos + n], 2) if n else 0
        self.pos += n
        return v


def header(frame: bytes, size=None) -> dict:
    """The uncompressed header of one VP9 frame (the fields the tests
    check), with the bit positions of the fields they rewrite; ``size``
    (w, h) stands for the size an inter frame takes from a reference."""
    b, h = _Bits(frame), {}
    assert b.get(2) == 2
    h["profile"] = b.get() | b.get() << 1
    if h["profile"] == 3:
        h["profile"] += b.get()
    if b.get():
        h["show_existing"] = b.get(3)
        return h
    h["key"], h["show"], h["error_resilient"] = not b.get(), b.get(), b.get()
    if h["key"]:
        assert b.get(24) == 0x498342
        if h["profile"] >= 2:
            b.get()
        h["colour_space"] = b.get(3)
        h["full_range"] = b.get() if h["colour_space"] != 7 else 1
        if h["profile"] in (1, 3):
            b.get(3 if h["colour_space"] != 7 else 1)
        h["w"], h["h"] = b.get(16) + 1, b.get(16) + 1
        if b.get():
            b.get(32)
    else:
        h["intra_only"] = 0 if h["show"] else b.get()
        h["reset_context"] = 0 if h["error_resilient"] else b.get(2)
        assert not h["intra_only"]
        h["refresh"] = b.get(8)
        h["refs"], h["sign_bias"] = [], []
        for _ in range(3):
            h["refs"].append(b.get(3))
            h["sign_bias"].append(b.get())
        h["pos_found"] = b.pos
        found = False
        for _ in range(3):      # found_ref: the size of reference k
            if b.get():
                found = True
                break
        h["n_found"] = b.pos - h["pos_found"]
        if found:
            h["w"], h["h"] = size if size else (0, 0)
        else:
            h["w"], h["h"] = b.get(16) + 1, b.get(16) + 1
        if b.get():
            b.get(32)
        h["high_precision_mv"] = b.get()
        h["filter"] = 4 if b.get() else b.get(2)
    if h["error_resilient"]:
        h["refresh_context"], h["frame_parallel"] = 0, 1
    else:
        h["refresh_context"], h["frame_parallel"] = b.get(), b.get()
    h["context"] = b.get(2)
    h["filter_level"] = b.get(6)
    h["pos_sharpness"] = b.pos
    h["sharpness"] = b.get(3)
    if b.get() and b.get():
        for _ in range(6):
            if b.get():
                b.get(7)
    h["q"] = b.get(8)
    deltas = [b.get(5) if b.get() else 0 for _ in range(3)]
    h["lossless"] = h["q"] == 0 and not any(deltas)
    h["segmentation"] = b.get()
    if h["segmentation"]:
        if b.get():
            for _ in range(7):
                if b.get():
                    b.get(8)
            if b.get():
                for _ in range(3):
                    if b.get():
                        b.get(8)
        if b.get():
            b.get()
            for _ in range(8):
                for bits in (9, 7, 2, 0):
                    if b.get():
                        b.get(bits)
    sb_cols = (h.get("w", 0) + 63) // 64
    min_log2 = 0
    while (64 << min_log2) < sb_cols:
        min_log2 += 1
    max_log2 = 1
    while (sb_cols >> max_log2) >= 4:
        max_log2 += 1
    h["tile_cols_log2"] = min_log2
    while h["tile_cols_log2"] < max_log2 - 1 and b.get():
        h["tile_cols_log2"] += 1
    h["tile_rows_log2"] = b.get()
    if h["tile_rows_log2"]:
        h["tile_rows_log2"] += b.get()
    b.get(16)
    h["end"] = b.pos
    return h


def headers(packets, size=None) -> list:
    """The headers of every frame of ``packets`` (``size``: the frame size,
    which an inter frame's header may take from its reference)."""
    return [header(f, size) for p in packets for f in superframe(p)]


def packets_of(path) -> list:
    video = avi.open_video(str(path))
    out = [video.read(f) for f in video.frames]
    video.close()
    return out


def _packed(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def with_bits(frame: bytes, pos: int, value: str) -> bytes:
    """``frame`` with the bits at ``pos`` replaced by ``value``."""
    bits = "".join(f"{b:08b}" for b in frame)
    return _packed(bits[:pos] + value + bits[pos + len(value):])


def with_explicit_size(frame: bytes, w: int, h: int) -> bytes:
    """An inter frame that takes its size from a reference, rewritten to
    state ``w``x``h`` itself (the compressed data after the header, which
    starts at a byte boundary, unchanged)."""
    hd = header(frame)
    bits = "".join(f"{b:08b}" for b in frame)
    new = (bits[:hd["pos_found"]] + "000" + f"{w - 1:016b}{h - 1:016b}"
           + bits[hd["pos_found"] + hd["n_found"]:hd["end"]])
    return _packed(new) + frame[(hd["end"] + 7) // 8:]


# ------------------------------------------------------------ containers

@pytest.mark.parametrize("ext", ["webm", "mkv", "avi", "mp4"])
def test_cv2_writer_in_each_container(tmp_path, ext):
    """cv2's VP90 writer (``vp09`` into .mp4) at 96x160: every frame
    equals cv2's in RGB and Y, and the container names the codec."""
    frames = pan(8)
    path = tmp_path / f"v.{ext}"
    write_cv2_video(path, frames, "vp09" if ext == "mp4" else "VP90")
    check_equal_cv2(path, 8)
    video = avi.open_video(str(path))
    assert (video.codec, video.width, video.height) == ("vp9", 160, 96)
    video.close()


def test_vfw_fourcc_in_mkv(tmp_path):
    """A Matroska track ``V_MS/VFW/FOURCC`` whose bitmap header names
    ``VP90``: the codec is VP9 and every frame equals cv2's."""
    import struct

    packets = encode(pan(6), {"deadline": "realtime", "cpu-used": "8"})
    bih = struct.pack("<IiiHH4sIiiII", 40, 160, 96, 1, 24, b"VP90",
                      160 * 96 * 3, 0, 0, 0, 0)
    path = tmp_path / "vfw.mkv"
    write_mkv(path, packets, 160, 96, codec="V_MS/VFW/FOURCC",
              doctype=b"matroska", private=bih)
    video = avi.open_video(str(path))
    assert video.codec == "vp9"
    video.close()
    check_equal_cv2(path, 6)


def test_vp90_avi_equals_the_webm(tmp_path):
    """The packets of a two-pass stream (superframes with hidden alt-ref
    frames) muxed into a ``VP90`` AVI by testing/mjpeg.py: the same frames
    as the WebM's, and as cv2's."""
    packets = encode(pan(16), {"auto-alt-ref": "1", "lag-in-frames": "8"},
                     two_pass=True)
    assert any(len(superframe(p)) > 1 for p in packets)
    write_webm(tmp_path / "v.webm", packets, 96, 160)
    mjpeg.write_avi(str(tmp_path / "v.avi"), packets, 160, 96,
                    fourcc=b"VP90")
    check_equal_cv2(tmp_path / "v.avi", 16)
    a = list(MediaSource(video_path=str(tmp_path / "v.avi"), use_photos=False))
    b = list(MediaSource(video_path=str(tmp_path / "v.webm"),
                         use_photos=False))
    assert len(a) == len(b) == 16
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------- tools

def _has(key, value=None):
    return lambda hs, st: all(h.get(key) == (value if value is not None
                                             else h.get(key)) for h in hs)


# (encoder options, two passes, noise, what the headers and the decoder's
# counters must show)
_TOOLS = {
    "one_pass": ({"frame-parallel": "0", "g": "12"}, False, 0,
                 lambda hs, st: st["adapted"] == st["frames"] == 24
                 and [i for i, h in enumerate(hs) if h.get("key")]
                 == [0, 12]),
    "two_pass_altref": ({"auto-alt-ref": "1", "lag-in-frames": "16",
                         "g": "100", "frame-parallel": "0", "crf": "20"},
                        True, 4,
                        lambda hs, st: st["hidden"] >= 2
                        and st["compound_blocks"] > 100
                        and any(h.get("sign_bias") == [0, 0, 1]
                                for h in hs)),
    "frame_parallel": ({"frame-parallel": "1"}, False, 0,
                       lambda hs, st: all(h["frame_parallel"] for h in hs)
                       and st["adapted"] == 0),
    "error_resilient": ({"error-resilient": "1"}, False, 0,
                        lambda hs, st: all(h["error_resilient"] for h in hs)),
    "lossless": ({"lossless": "1"}, False, 0,
                 lambda hs, st: all(h["lossless"] and h["filter_level"] == 0
                                    for h in hs)),
    "aq_mode_1": ({"aq-mode": "1", "frame-parallel": "0"}, False, 0,
                  lambda hs, st: sum(h["segmentation"] for h in hs) > 20),
    "aq_mode_2": ({"aq-mode": "2"}, False, 0,
                  lambda hs, st: sum(h["segmentation"] for h in hs) > 20),
    "aq_mode_3": ({"aq-mode": "3", "deadline": "realtime",
                   "cpu-used": "6", "frame-parallel": "0"}, False, 0,
                  lambda hs, st: sum(h["segmentation"] for h in hs) > 20),
    "realtime": ({"deadline": "realtime", "cpu-used": "8"}, False, 0,
                 lambda hs, st: st["switchable"] > 0),
    "cpu_used_0": ({"cpu-used": "0", "frame-parallel": "0"}, False, 2,
                   lambda hs, st: st["subblock_inter"] > 0),
    "cpu_used_4": ({"cpu-used": "4"}, False, 0,
                   lambda hs, st: st["frames"] == 24),
}


@pytest.mark.parametrize("tool", sorted(_TOOLS))
def test_encoder_tools_equal_cv2(tmp_path, tool):
    """Each libvpx-vp9 tool, coded through ctypes over a 96x160 pan of a
    texture and muxed into WebM: the headers (and the decoder's counters)
    show the tool, and every frame equals cv2's in RGB and Y."""
    options, two_pass, noise, shows = _TOOLS[tool]
    packets = encode(pan(24, noise=noise), dict(options), two_pass)
    path = tmp_path / "tool.webm"
    write_webm(path, packets, 96, 160)
    assert shows(headers(packets, (160, 96)), decoder_stats(path))
    check_equal_cv2(path, 24, rgb=tool in ("two_pass_altref", "realtime"))


def test_tile_columns_and_rows(tmp_path):
    """``tile-columns 2`` and ``tile-rows 2`` at 128x640 (10 superblock
    columns: two tile columns at most), in one pass and in two."""
    frames = pan(8, h=128, w=640)
    for k, two_pass in enumerate((False, True)):
        packets = encode(frames, {"tile-columns": "2", "tile-rows": "2",
                                  "auto-alt-ref": str(int(two_pass))},
                         two_pass)
        hs = headers(packets, (640, 128))
        assert {h["tile_cols_log2"] for h in hs} == {1}
        assert {h["tile_rows_log2"] for h in hs} == {2}
        path = tmp_path / f"tiles{k}.webm"
        write_webm(path, packets, 128, 640)
        assert decoder_stats(path)["tile_cols"] == 2
        check_equal_cv2(path, 8, rgb=k == 0)


def test_sharpness_written_into_the_headers(tmp_path):
    """libvpx's encoder writes sharpness 0; each frame's 3 sharpness bits
    set to 1, 4, 5 and 7 by hand (the loop filter's interior limit): the
    stream stays valid, and every frame equals cv2's."""
    packets = encode(pan(12), {"deadline": "realtime", "cpu-used": "8"})
    for sharp in (1, 4, 5, 7):
        edited = []
        for p in packets:
            (f,) = superframe(p)
            edited.append(with_bits(f, header(f)["pos_sharpness"],
                                    f"{sharp:03b}"))
        assert {h["sharpness"] for h in headers(edited, (160, 96))} == {sharp}
        path = tmp_path / f"sharp{sharp}.webm"
        write_webm(path, edited, 96, 160)
        check_equal_cv2(path, 12, rgb=False)


def test_show_existing_frame(tmp_path):
    """One-byte show_existing_frame packets written in by hand (slots 0
    and 1 shown again): each gives the frame in its slot, as cv2 gives
    it."""
    packets = encode(pan(8), {"deadline": "realtime", "cpu-used": "8"})
    packets = packets[:3] + [bytes([0x88])] + packets[3:5] + [
        bytes([0x89])] + packets[5:]
    assert header(packets[3]) == {"profile": 0, "show_existing": 0}
    path = tmp_path / "sx.webm"
    write_webm(path, packets, 96, 160)
    check_equal_cv2(path, 10)
    assert decoder_stats(path)["show_existing"] == 2


@pytest.mark.parametrize("hw", [(131, 97), (97, 131), (53, 37), (9, 17),
                                (66, 66), (12, 10), (100, 200)])
def test_odd_sizes(tmp_path, hw):
    """Sizes that are not whole blocks or superblocks (odd heights from 9
    rows up): motion reads past the right and bottom edges, one pass and
    real time; RGB and Y equal cv2's."""
    h, w = hw
    frames = pan(6, h=h, w=w, dy=1, dx=2)
    for k, options in enumerate(({}, {"deadline": "realtime",
                                      "cpu-used": "8"})):
        path = tmp_path / f"odd{k}.webm"
        write_webm(path, encode(frames, options), h, w)
        check_equal_cv2(path, 6)


# ---------------------------------------------------------------- damage

@pytest.mark.parametrize("how", ["half", "90pct", "2bytes", "flip",
                                 "flip_header", "zero_tail", "no_index"])
@pytest.mark.parametrize("stream", ["realtime", "altref"])
def test_truncated_and_damaged(tmp_path, stream, how):
    """Packet 5 cut, corrupted or stripped of its superframe index: the
    frames cv2 gives, in cv2's count (a frame that fails ends the video;
    one whose tile data ends early is given)."""
    frames = pan(12)
    if stream == "realtime":
        packets = encode(frames, {"deadline": "realtime", "cpu-used": "8"})
    else:
        packets = encode(frames, {"auto-alt-ref": "1", "lag-in-frames": "8"},
                         two_pass=True)
    f = bytearray(packets[5])
    if how == "half":
        f = f[:len(f) // 2]
    elif how == "90pct":
        f = f[:len(f) * 9 // 10]
    elif how == "2bytes":
        f = f[:2]
    elif how == "flip":
        f[len(f) // 2] ^= 0x55
    elif how == "flip_header":
        f[1] ^= 0x10
    elif how == "zero_tail":
        f[len(f) // 2:] = bytes(len(f) - len(f) // 2)
    else:
        f = f[:-3]
    packets[5] = bytes(f)
    path = tmp_path / "damaged.webm"
    write_webm(path, packets, 96, 160)
    check_equal_cv2(path, rgb=False)


def test_truncated_file(tmp_path):
    """A WebM file cut in its last Cluster: the frames before the cut."""
    path = tmp_path / "v.webm"
    write_webm(path, encode(pan(10), {}), 96, 160)
    data = path.read_bytes()
    path.write_bytes(data[:len(data) - 200])
    check_equal_cv2(path, rgb=False)


# -------------------------------------------------------------- refusals

def _two_sizes(tmp_path):
    a = encode(pan(4), {"deadline": "realtime", "cpu-used": "8"})
    b = encode(pan(4, h=64, w=96, seed=3), {"deadline": "realtime",
                                           "cpu-used": "8"})
    return a, b


@pytest.mark.parametrize("feature", ["profile_1", "profile_2",
                                     "intra_only", "size_change",
                                     "scaled_reference", "smpte240m",
                                     "bt2020", "srgb", "full_range"])
def test_refusals_name_the_feature(tmp_path, feature):
    """What the decoder does not read raises ValueError naming it: a key
    frame marked profile 1 or 2, an intra-only frame (a hidden inter frame
    with intra_only set), a key frame of another size, an inter frame of
    another size than its references, the SMPTE 240M, BT.2020 and sRGB
    colour spaces (written into a key frame's header by hand) and
    full-range colour (OpenCV converts them with coefficients
    swscale_rgb.h does not carry)."""
    a, b = _two_sizes(tmp_path)
    spaces = {"smpte240m": ("100", "SMPTE 240M"), "bt2020": ("101",
                                                             "BT.2020"),
              "srgb": ("111", "sRGB")}
    if feature in ("profile_1", "profile_2"):
        k = int(feature[-1])
        packets = [with_bits(a[0], 2, f"{k & 1}{k >> 1}")] + a[1:]
        match = f"VP9 profile {k}"
    elif feature == "intra_only":
        # frame marker, profile 0, not show_existing, inter, hidden, not
        # error-resilient, intra_only
        packets = a[:2] + [_packed("10" "00" "0" "1" "0" "0" "1" "00")]
        match = "VP9 intra-only frame"
    elif feature == "size_change":
        packets = a[:2] + b[:2]
        match = "VP9 frame size change"
    elif feature == "scaled_reference":
        packets = a[:2] + [with_explicit_size(a[2], 96, 64)]
        match = "VP9 scaled reference"
    elif feature in spaces:
        # colour_space: the three bits after the key frame's sync code
        bits, name = spaces[feature]
        packets = [with_bits(a[0], 32, bits)] + a[1:]
        match = f"VP9 {name} colour space"
    else:
        packets = encode(pan(2), {"color_range": "pc"})
        match = "VP9 full-range colour"
    path = tmp_path / "refused.webm"
    write_webm(path, packets, 96, 160)
    with pytest.raises(ValueError, match=match):
        list(MediaSource(video_path=str(path), use_photos=False))


def test_bt709_read_with_its_matrix(tmp_path):
    """libvpx-vp9 with ``colorspace bt709`` (colour space 2 in the key
    frame): every frame equals cv2's in RGB, converted with BT.709's
    coefficients, and cv2's Y read equals the port's Y plane as OpenCV's
    swscale call turns it (through RGB, ``swscale_y_read``); the RGB
    differs from the same stream untagged."""
    from test_torch_mpeg2 import swscale_y_read

    packets = encode(pan(6), {"colorspace": "bt709"})
    assert header(packets[0])["colour_space"] == 2
    path = tmp_path / "bt709.webm"
    write_webm(path, packets, 96, 160)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    want_rgb = cv2_rgb(path)
    assert len(got) == len(want_rgb) == 6
    for a, b in zip(got, want_rgb):
        np.testing.assert_array_equal(a, b)
    dec = vp9.Decoder()
    planes = [dec.decode_yuv(p) for p in packets_of(path)]
    want = cv2_luma(path)
    assert len(want) == len(planes) == 6
    for p, y in zip(planes, want):
        np.testing.assert_array_equal(swscale_y_read(*p, 1), y)
    plain = tmp_path / "plain.webm"
    write_webm(plain, encode(pan(6), {}), 96, 160)
    assert np.abs(cv2_rgb(path)[0].astype(int) - cv2_rgb(plain)[0]).max() > 2


def test_bt601_colour_spaces_are_read(tmp_path):
    """Colour space BT.601 and SMPTE 170M (and unknown, the default) are
    the ones OpenCV converts as for VP8: equal to cv2 in RGB."""
    for k, cs in enumerate(("bt470bg", "smpte170m")):
        packets = encode(pan(3), {"colorspace": cs})
        assert header(packets[0])["colour_space"] == (1 if k == 0 else 3)
        path = tmp_path / f"cs{k}.webm"
        write_webm(path, packets, 96, 160)
        check_equal_cv2(path, 3)


def test_mp4_vpcc_profile_refused(tmp_path):
    """A ``vp09`` MP4 whose vpcC names profile 1: ValueError naming it when
    the file opens."""
    path = tmp_path / "v.mp4"
    write_cv2_video(path, pan(2), "vp09")
    data = bytearray(path.read_bytes())
    i = data.index(b"vpcC") + 8      # version and flags, then the profile
    assert data[i] == 0
    data[i] = 1
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="VP9 profile 1"):
        mp4.Mp4Video(str(path))


# -------------------------------------------------------------- fixtures

def _digest(path) -> dict:
    rgb = cv2_rgb(path)
    return {"frames": len(rgb), "shape": list(rgb[0].shape),
            "rgb_sha256": [_sha(f) for f in rgb],
            "y_sha256": [_sha(y) for y in cv2_luma(path)]}


def write_fixtures() -> None:
    """The 32 headline FHD frames (as cv2 decodes headline_mp4v.mp4) coded
    by libvpx-vp9 as a two-pass VOD encode (HEADLINE_OPTIONS) into WebM,
    and the small fixtures, with the sha256 of cv2's RGB frames and Y
    planes beside the other fixtures' in cv2_sha256.json."""
    frames = cv2_rgb(MP4_FIXTURE)
    write_webm(FIXTURE, encode(frames, dict(HEADLINE_OPTIONS), True),
               *frames[0].shape[:2])
    small = pan(8)
    for ext in ("webm", "avi", "mp4"):
        write_cv2_video(FIXTURES / f"vp9_cv2.{ext}", small,
                        "vp09" if ext == "mp4" else "VP90")
    write_webm(FIXTURES / "vp9_lossless.webm",
               encode(pan(4, h=32, w=48), {"lossless": "1"}), 32, 48)
    write_webm(FIXTURES / "vp9_aq.webm",
               encode(pan(12), {"aq-mode": "3", "deadline": "realtime",
                                "cpu-used": "6", "frame-parallel": "0"}),
               96, 160)
    write_webm(FIXTURES / "vp9_er_fp.webm",
               encode(pan(10), {"error-resilient": "1",
                                "frame-parallel": "1"}), 96, 160)
    write_webm(FIXTURES / "vp9_odd.webm",
               encode(pan(6, h=97, w=131, dx=2), {}), 97, 131)
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        table[name] = _digest(FIXTURES / name)
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256():
    """The committed fixtures (what chip_smoke.py holds the port to on the
    card): cv2's decode still gives the recorded sha256, and so does the
    port's, frame by frame, in RGB and Y; the FHD one holds hidden alt-ref
    frames in superframes, compound prediction, 4 tile columns and
    backward adaptation, and the small ones their tools."""
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        path = FIXTURES / name
        want = table[name]
        assert path.stat().st_size <= (1_000_000 if name == FIXTURE.name
                                       else 40_000)
        assert [_sha(f) for f in cv2_rgb(path)] == want["rgb_sha256"], name
        assert [_sha(y) for y in cv2_luma(path)] == want["y_sha256"], name
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert len(got) == want["frames"]
        assert [_sha(f) for f in got] == want["rgb_sha256"], name
        assert [_sha(y) for y in port_luma(path)] == want["y_sha256"], name
    video = matroska.MkvVideo(str(FIXTURE))
    packets = [video.read(f) for f in video.frames]
    video.close()
    assert len(packets) == table[FIXTURE.name]["frames"] == 32
    hs = headers(packets, (1920, 1080))
    assert sum(len(superframe(p)) > 1 for p in packets) >= 4
    assert sum(not h.get("show", 1) for h in hs) >= 4
    assert {h["tile_cols_log2"] for h in hs} == {2}
    assert not any(h["frame_parallel"] or h["error_resilient"] for h in hs)
    stats = decoder_stats(FIXTURE)
    assert stats["compound_blocks"] > 0 and stats["tile_cols"] == 4
    assert stats["adapted"] == stats["frames"] == len(hs)
    assert all(h["lossless"] for h in headers(
        packets_of(FIXTURES / "vp9_lossless.webm"), (48, 32)))
    assert all(h["error_resilient"] and h["frame_parallel"] for h in headers(
        packets_of(FIXTURES / "vp9_er_fp.webm"), (160, 96)))
    assert decoder_stats(FIXTURES / "vp9_aq.webm")["segmented"] > 8


# ---------------------------------------------------------------- tables

def test_tables_equal_libvpx_symbols():
    """vp9.table(name) for every table of native/vp9_tables.h equals the
    symbol of that name in the libvpx cv2's wheel carries (read from its
    ELF symbol table by scripts/vp9_tables.py, which rewrites the header
    to the same bytes), and the header carries libvpx's BSD notice; the
    defaults kept in code are byte runs of libvpx's read-only data."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import vp9_tables

    lib = vp9_tables.default_library()
    syms = vp9_tables.symbols(lib)
    for name, unit, ctype, dims in vp9_tables.TABLES:
        want = vp9_tables.values(syms, name, unit, ctype, dims)
        np.testing.assert_array_equal(vp9.table(name.split(".")[0]), want,
                                      err_msg=name)
    header_text = (ROOT / "slam_indoor_code_tpu_torch" / "native"
                   / "vp9_tables.h").read_text()
    assert header_text == vp9_tables.render(lib)
    assert "Redistribution and use in source and binary forms" in header_text
    # libvpx folds some of them into its code; FFmpeg's VP9 decoder keeps
    # them all in one table of its read-only data
    data = (pathlib.Path(lib).read_bytes(),
            pathlib.Path(glob.glob(str(pathlib.Path(lib).parent
                                       / "libavcodec*"))[0]).read_bytes())
    runs = [vp9.table(name) for name in (
        "default_skip_probs", "default_intra_inter_p",
        "default_comp_inter_p", "default_comp_ref_p", "default_mv_joints",
        "default_mv_bits")]
    classes = vp9.table("default_mv_classes")
    runs += [classes[:10], classes[10:], np.concatenate(
        [vp9.table(f"default_tx_probs_{s}") for s in ("32x32", "16x16",
                                                      "8x8")])]
    for run in runs:
        assert any(bytes(run.astype(np.uint8)) in d for d in data), run
    with pytest.raises(KeyError):
        vp9.table("no_such_table")


# ------------------------------------------------------------ end to end

def test_slam_main_on_vp9_webm_against_jax(tmp_path):
    """test_torch_mp4.py's end-to-end test on a 540x960 VP9 WebM (cv2's
    VP90 writer): the same frames as the JAX package's (cv2), as many
    cameras, ATE within 0.02 of the extent of the median of the JAX
    package's RANSAC seeds 0-2."""
    from test_torch_mp4 import slam_main_against_jax

    slam_main_against_jax(tmp_path, "VP90", "webm")


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
