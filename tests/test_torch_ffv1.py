"""The port's FFV1 video (io/ffv1.py over native/ffv1.cpp, and the FFV1
entries of io/avi.py, io/matroska.py and io/mp4.py) on the CPU, against
OpenCV's default FFmpeg backend: RGB frames bit for bit and frame for
frame against ``cv2.VideoCapture(p)``, in cv2's frame count.

Every stream is coded here: by cv2's ``FFV1`` writer (version 3, Golomb-
Rice, four slices with CRCs, BGRA) into AVI, Matroska and QuickTime at
even and odd sizes (the writer crops odd ones), each frame also equal to
the frame written; and by the ``ffv1`` encoder of the libavcodec cv2's
wheel carries (``lavc_encode``, with the pixel format given) at levels 0,
1 and 3, coders 0, 1 and 2, both context models, 4, 16 and 30 slices with
and without slice CRCs, in gray, 4:2:0, 4:2:2 and BGRA, key frames every
fourth frame.  Damage: bytes flipped in a key and a non-key frame with
and without slice CRCs (FFmpeg's concealment, bit for bit), packets cut
short, files cut, a stream that starts after its key frame, a
configuration record whose CRC fails, and random damage.  Refusals by
name: the layouts whose swscale conversion the port does not reproduce,
10-bit video, and colour spaces and versions written into configuration
records here by a small range coder (``record``).  Against the JAX
package: ``MediaSource`` and ``slam_main`` on a cv2-written 540x960 FFV1
``.mkv``.  The committed fixtures in ``testing/video_fixtures/`` (the FHD
headline ``headline_ffv1.mkv`` and the small ones) against their recorded
cv2 sha256, which chip_smoke.py holds the card to.

Rewrite the fixtures with ``PYTHONPATH=.:tests python
tests/test_torch_ffv1.py --write-fixtures`` (~20 s; it writes
test_torch_huffyuv.py's too)."""

import json
import pathlib
import sys

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, ffv1
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg
from test_torch_mp4 import (cv2_rgb, cv2_rgb_one_thread, lavc_encode,
                            lavc_extradata, write_cv2_video)
from test_torch_mpeg2 import _sha
from test_torch_vp9 import pan
from test_torch_webm import write_mkv

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures"
FIXTURE = FIXTURES / "headline_ffv1.mkv"
DIGESTS = FIXTURES / "cv2_sha256.json"
# cv2's FFV1 writer into AVI and QuickTime; libavcodec's level 3 at 4:2:0
# with 4 slices, slice CRCs and a custom state table (coder 2); a
# Golomb-Rice level 1 stream with the large context model
SMALL_FIXTURES = ("ffv1_cv2.avi", "ffv1_cv2.mov", "ffv1_l3_crc_coder2.avi",
                  "ffv1_golomb.avi")
# option sets: levels, coders, context models, slices, slice CRCs.  The
# encoder's coder 1 writes a custom state table (coder 2, as 2 does); -2
# ("range_def") keeps the default one
OPTIONS = {
    "level0": {"level": "0"},
    "level1_range": {"level": "1", "coder": "-2"},
    "level1_custom_large": {"level": "1", "coder": "2", "context": "1"},
    "level1_golomb_large": {"level": "1", "coder": "0", "context": "1"},
    "level3_4_crc_custom": {"level": "3", "slices": "4", "slicecrc": "1",
                            "coder": "2"},
    "level3_16_nocrc_range": {"level": "3", "slices": "16",
                              "slicecrc": "0", "coder": "-2"},
    "level3_30_crc_golomb": {"level": "3", "slices": "30", "slicecrc": "1",
                             "coder": "0", "context": "1"},
}


# ------------------------------------------------------------- streams

def encode(frames, options: dict, pix_fmt: str = "yuv420p"):
    """``frames`` through libavcodec's ``ffv1`` as ``pix_fmt``, a key frame
    every fourth → (packets, configuration record)."""
    packets, ctx = lavc_encode("ffv1", frames, {"g": "4", **options},
                               pix_fmt=pix_fmt)
    return packets, lavc_extradata(ctx)


def write_stream(path, packets, extradata: bytes, w: int, h: int):
    """An AVI (``FFV1``, the record after the bitmap header) or a Matroska
    file (``V_FFV1``, the record as CodecPrivate) by the suffix."""
    path = pathlib.Path(path)
    if path.suffix == ".mkv":
        write_mkv(path, packets, w, h, codec="V_FFV1", doctype=b"matroska",
                  private=extradata)
    else:
        mjpeg.write_avi(str(path), packets, w, h, fourcc=b"FFV1",
                        extradata=extradata)
    return path


def port_stats(path) -> dict:
    """The decoder's statistics after every packet of ``path``."""
    video = avi.open_video(str(path))
    dec = ffv1.Decoder(video.extradata, video.width, video.height)
    for f in video.frames:
        dec.decode_planes(video.read(f))
        if dec.failed:
            break
    video.close()
    return dec.stats()


def port_defined(path) -> list:
    """The ``Decoder.defined`` mask of each frame the port gives for
    ``path``, in order."""
    video = avi.open_video(str(path))
    dec = ffv1.Decoder(video.extradata, video.width, video.height)
    out = []
    for f in video.frames:
        if dec.decode_planes(video.read(f)) is not None:
            out.append(dec.defined())
        if dec.failed:
            break
    video.close()
    return out


def check_equal_cv2(path, n=None, frames=None, read=cv2_rgb,
                    defined_only=False) -> dict:
    """Every frame through MediaSource equals cv2's (``read``: cv2's
    default read, or ``cv2_rgb_one_thread``), in cv2's count (``n`` if
    given), and ``frames`` (the RGB written, for a lossless RGB stream)
    where given; the decoder's stats.  With ``defined_only`` only the
    pixels FFmpeg writes are compared (``port_defined``): the others hold
    whatever FFmpeg's buffer held before."""
    want = read(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           prefetch=3))
    assert len(got) == len(want)
    if n is not None:
        assert len(got) == n
    masks = port_defined(path) if defined_only else [None] * len(got)
    assert len(masks) == len(got)
    for a, b, m in zip(got, want, masks):
        if m is not None:
            a, b = a[m], b[m]
        np.testing.assert_array_equal(a, b)
    if frames is not None:
        for a, f in zip(got, frames):
            np.testing.assert_array_equal(a, f[:a.shape[0], :a.shape[1]])
    return port_stats(path)


# ------------------------------------------------------- range encoder

def _default_states():
    """ff_build_rac_states(0.05, 248): (one_state, zero_state)."""
    one, factor, max_p = 1 << 32, int(0.05 * (1 << 32)), 248
    one_state, zero_state = [0] * 256, [0] * 256
    last_p8, p = 0, one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = min(max((256 * p + one // 2) >> 32, i + 1), max_p)
        one_state[i] = p8
    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]
    return one_state, zero_state


class _RangeEncoder:
    """FFmpeg's range encoder (rangecoder.h): put_rac, put_symbol,
    ff_rac_terminate."""

    def __init__(self):
        self.one, self.zero = _default_states()
        self.low, self.range, self.count, self.byte = 0, 0xFF00, 0, -1
        self.out = bytearray()

    def _renorm(self):
        while self.range < 0x100:
            if self.byte < 0:
                self.byte = self.low >> 8
            elif self.low <= 0xFF00:
                self.out.append(self.byte)
                self.out += b"\xff" * self.count
                self.count, self.byte = 0, self.low >> 8
            elif self.low >= 0x10000:
                self.out.append(self.byte + 1)
                self.out += b"\0" * self.count
                self.count, self.byte = 0, (self.low >> 8) - 0x100
            else:
                self.count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put(self, state: list, i: int, bit: int):
        r1 = (self.range * state[i]) >> 8
        if not bit:
            self.range -= r1
            state[i] = self.zero[state[i]]
        else:
            self.low += self.range - r1
            self.range = r1
            state[i] = self.one[state[i]]
        self._renorm()

    def symbol(self, state: list, v: int, signed: bool = False):
        if not v:
            self.put(state, 0, 1)
            return
        a = abs(v) if signed else v
        e = a.bit_length() - 1
        self.put(state, 0, 0)
        for i in range(e):
            self.put(state, 1 + min(i, 9), 1)
        self.put(state, 1 + min(e, 9), 0)
        for i in range(e - 1, -1, -1):
            self.put(state, 22 + min(i, 9), (a >> i) & 1)
        if signed:
            self.put(state, 11 + min(e, 10), int(v < 0))

    def terminate(self) -> bytes:
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        return bytes(self.out)


def _crc(data: bytes, crc: int = 0) -> int:
    """av_crc(AV_CRC_32_IEEE): MSB-first 0x04C11DB7, the register kept
    byte-swapped."""
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ (0x04C11DB7 if c & 0x80000000 else 0)) \
                & 0xFFFFFFFF
        table.append(int.from_bytes(c.to_bytes(4, "big"), "little"))
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def record(version: int = 3, colorspace: int = 1, bits: int = 8,
           chroma: int = 1, shifts=(0, 0), alpha: int = 0) -> bytes:
    """A configuration record (RFC 9043 4.2) with the given fields, coder
    1, one slice, one quantisation table of one context, its CRC-32."""
    enc, st = _RangeEncoder(), [128] * 32
    enc.symbol(st, version)
    if version > 2:
        enc.symbol(st, 4)                       # micro_version
    for v in (1, colorspace, bits):             # coder, colorspace, bits
        enc.symbol(st, v)
    enc.put(st, 0, chroma)
    for v in shifts:
        enc.symbol(st, v)
    enc.put(st, 0, alpha)
    for v in (0, 0, 1):                         # slices h, v; one table
        enc.symbol(st, v)
    for _ in range(5):                          # all-zero tables: 1 context
        enc.symbol([128] * 32, 127)
    enc.put(st, 0, 0)                           # no initial states
    if version > 2:
        enc.symbol(st, 0)                       # ec
        enc.symbol(st, 0)                       # intra
    data = enc.terminate()
    if version > 2:
        data += _crc(data).to_bytes(4, "little")
    return data


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("ext", ["avi", "mkv", "mov"])
@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (96, 160)])
def test_cv2_writer_each_container_and_size(tmp_path, hw, ext):
    """cv2's FFV1 writer: version 3, Golomb-Rice, slices with CRCs, RGB
    with alpha; equal to cv2's decode and to the frames written (cropped
    to even sizes, as the writer crops them)."""
    frames = pan(5, *hw, dy=1, dx=2)
    path = tmp_path / f"v.{ext}"
    write_cv2_video(path, frames, "FFV1")
    stats = check_equal_cv2(path, 5, frames)
    assert (stats["version"], stats["colorspace"], stats["transparency"],
            stats["ec"]) == (3, 1, 1, 1)
    assert stats["crc_slices"] == stats["slices"] > 5


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv422p", "gray", "bgra"])
@pytest.mark.parametrize("name", list(OPTIONS))
def test_lavc_levels_coders_contexts_slices(tmp_path, name, pix_fmt):
    """libavcodec's ffv1 at each level, coder, context model and slice
    layout, in each layout OpenCV's conversion is reproduced for: equal to
    cv2's decode; the stream's parameters as asked."""
    options = OPTIONS[name]
    frames = pan(6, 96, 128, dy=2, dx=3, noise=3.0)
    packets, extra = encode(frames, options, pix_fmt)
    stats = check_equal_cv2(write_stream(tmp_path / "v.avi", packets, extra,
                                         128, 96), 6)
    assert stats["version"] == int(options["level"])
    coder = options.get("coder", "0")
    assert stats["coder"] == {"0": 0, "-2": 1, "1": 2, "2": 2}[coder]
    assert stats["large_context"] == int(options.get("context", "0"))
    assert stats["key_frames"] == 2
    slices = int(options.get("slices", "1"))
    assert stats["slices"] == 6 * slices
    assert stats["crc_slices"] == (6 * slices
                                   if options.get("slicecrc") == "1" else 0)
    assert stats["colorspace"] == (pix_fmt == "bgra")


@pytest.mark.parametrize("pix_fmt,hw", [("yuv420p", (37, 53)),
                                        ("gray", (37, 53)),
                                        ("bgra", (37, 53)),
                                        ("yuv422p", (38, 54)),
                                        ("yuv420p", (1080, 1920))])
def test_odd_and_fhd_sizes(tmp_path, pix_fmt, hw):
    """Odd sizes (swscale's scaled 4:2:0 path) and FHD, each in a Matroska
    file: equal to cv2's decode."""
    frames = pan(3, *hw, dy=1, dx=1, noise=2.0)
    packets, extra = encode(frames, {"level": "3", "slices": "4"}, pix_fmt)
    check_equal_cv2(write_stream(tmp_path / "v.mkv", packets, extra,
                                 hw[1], hw[0]), 3)


@pytest.mark.parametrize("pix_fmt,hw,what", [
    ("yuv444p", (48, 64), "yuv444p"), ("yuv411p", (48, 64), "yuv411p"),
    ("yuv410p", (48, 64), "yuv410p"), ("yuv440p", (48, 64), "yuv440p"),
    ("yuv422p", (37, 64), "yuv422p layout at an odd height"),
    ("yuv420p", (7, 64), "yuv420p layout at an odd height below 9"),
    ("yuv420p10le", (48, 64), "10-bit")])
def test_refused_layouts_and_depths(tmp_path, pix_fmt, hw, what):
    """Layouts whose swscale conversion the port does not reproduce, and
    more than 8 bits a sample, raise NotImplementedError naming them."""
    packets, extra = encode(pan(2, *hw), {"level": "3"}, pix_fmt)
    path = write_stream(tmp_path / "v.avi", packets, extra, hw[1], hw[0])
    assert len(cv2_rgb(path)) == 2
    with pytest.raises(NotImplementedError, match=f"FFV1.*{what}"):
        list(MediaSource(video_path=str(path), use_photos=False))


@pytest.mark.parametrize("fields,what", [
    ({"colorspace": 2}, "colorspace_type 2.*Bayer"),
    ({"version": 4}, "version 4"),
    ({"colorspace": 1, "shifts": (1, 1)}, "RGB with chroma subsampling"),
    ({"colorspace": 0, "shifts": (3, 0)}, "chroma subsampling 3,0"),
    ({"colorspace": 0, "bits": 12}, "12-bit")])
def test_refused_records(fields, what):
    """Configuration records written here: Bayer and reserved colour
    spaces, version 4, subsampled RGB, a subsampling FFmpeg has no pixel
    format for and 12 bits raise NotImplementedError naming them; the
    same encoder's plain record opens."""
    ffv1.Decoder(record(), 64, 48).close()
    ffv1.Decoder(record(version=2, colorspace=0, shifts=(1, 1)), 64,
                 48).close()
    with pytest.raises(NotImplementedError, match=f"FFV1 {what}"):
        ffv1.Decoder(record(**fields), 64, 48)


def test_record_crc_mismatch_fails_as_ffmpeg(tmp_path):
    """A configuration record with a byte flipped fails its CRC-32: cv2
    reads no frame, the port raises ValueError naming the CRC."""
    packets, extra = encode(pan(2, 48, 64), {"level": "3"})
    bad = bytearray(extra)
    bad[len(bad) // 2] ^= 0x10
    path = write_stream(tmp_path / "v.avi", packets, bytes(bad), 64, 48)
    assert not cv2_rgb(path)
    with pytest.raises(ValueError, match="CRC"):
        list(MediaSource(video_path=str(path), use_photos=False))


@pytest.mark.parametrize("options", [
    {"slicecrc": "1", "coder": "0"}, {"slicecrc": "0", "coder": "0"},
    {"slicecrc": "1", "coder": "1"}, {"slicecrc": "0", "coder": "1"}])
@pytest.mark.parametrize("packet,where", [(3, 0.5), (3, 0.1), (4, 0.6)])
def test_damaged_slice_as_ffmpeg(tmp_path, options, packet, where):
    """A byte flipped in a key frame (3) or the frame after it (4): a slice
    whose CRC or end does not check is replaced by the previous frame's
    pixels, and stays so until the next key frame; without a check the
    damage decodes as FFmpeg decodes it; every frame equal to cv2's."""
    frames = pan(8, 96, 128, dy=2, dx=3, noise=2.0)
    packets, extra = encode(frames, {"level": "3", "slices": "4",
                                     "g": "3", **options})
    bad = bytearray(packets[packet])
    bad[int(len(bad) * where)] ^= 0x55
    packets[packet] = bytes(bad)
    stats = check_equal_cv2(write_stream(tmp_path / "v.avi", packets, extra,
                                         128, 96), 8)
    if options["slicecrc"] == "1":
        assert stats["damaged_slices"] > 0
        assert stats["concealed_slices"] == stats["damaged_slices"]


@pytest.mark.parametrize("level", ["1", "3"])
def test_truncated_and_cut_files_give_cv2s_count(tmp_path, level):
    """A packet cut short (to half and to a few bytes), a file cut inside
    a packet, and a stream that starts after its key frame: cv2's frame
    count, every frame equal to cv2's."""
    frames = pan(6, 96, 128, dy=2, dx=3)
    packets, extra = encode(frames, {"level": level, "g": "3",
                                     "slices": "4" if level == "3" else "1"})
    for keep in (0.5, 0.02):
        cut = packets[:3] + [packets[3][:max(1, int(len(packets[3]) * keep))]
                             ] + packets[4:]
        check_equal_cv2(write_stream(tmp_path / f"s{keep}.avi", cut, extra,
                                     128, 96))
    path = write_stream(tmp_path / "full.avi", packets, extra, 128, 96)
    data = path.read_bytes()
    at = data.index(packets[3][:32]) + len(packets[3]) // 2
    path.write_bytes(data[:at])
    check_equal_cv2(path)
    check_equal_cv2(write_stream(tmp_path / "late.avi", packets[1:], extra,
                                 128, 96), 0)


def test_random_damage_matches_cv2_or_raises_documented_errors(tmp_path):
    """Thirty streams with random bytes of their packets flipped or cut:
    the port gives cv2's frames and count and raises nothing (a record
    that does not parse, the one documented error, is
    test_record_crc_mismatch_fails_as_ffmpeg's).  The frames are held to
    cv2 on one thread (``cv2_rgb_one_thread``), which equals cv2's default
    read on each stream before its damage: on streams with a packet cut
    short the default read's threads give whole slices that differ from
    one read to the next.  Only the pixels FFmpeg writes are compared
    (``port_defined``): where a slice's data runs out FFmpeg leaves its
    buffer's earlier contents, which other decodes in the process set.
    The count is the default read's too."""
    rng = np.random.default_rng(7)
    for case in range(30):
        options = [{"level": "1", "coder": "0"}, {"level": "3",
                                                  "slices": "4"},
                   {"level": "3", "slices": "6", "coder": "2",
                    "slicecrc": "0"}][case % 3]
        packets, extra = encode(pan(4, 48, 64, seed=case), options)
        clean = write_stream(tmp_path / f"c{case}.avi", packets, extra, 64,
                             48)
        one, default = cv2_rgb_one_thread(clean), cv2_rgb(clean)
        assert len(one) == len(default) == 4
        for a, b in zip(one, default):
            np.testing.assert_array_equal(a, b)
        for _ in range(int(rng.integers(1, 6))):
            k = int(rng.integers(0, len(packets)))
            p = bytearray(packets[k])
            p[int(rng.integers(0, len(p)))] ^= int(rng.integers(1, 256))
            packets[k] = bytes(p)
        if case % 4 == 0:
            k = int(rng.integers(0, len(packets)))
            packets[k] = packets[k][:int(rng.integers(1, len(packets[k])))]
        path = write_stream(tmp_path / f"r{case}.avi", packets, extra, 64,
                            48)
        check_equal_cv2(path, len(cv2_rgb(path)), read=cv2_rgb_one_thread,
                        defined_only=True)


def test_vfw_matroska_and_mov_entries(tmp_path):
    """An FFV1 stream in Matroska's VfW mode (a bitmap header and the
    record as CodecPrivate) and cv2's QuickTime ``FFV1`` entry with its
    ``glbl`` box: the demuxers give the record, and the frames equal
    cv2's."""
    frames = pan(4, 48, 64)
    packets, extra = encode(frames, {"level": "3", "slices": "4"}, "bgra")
    bih = (40 + len(extra)).to_bytes(4, "little") + \
        (64).to_bytes(4, "little") + (48).to_bytes(4, "little") + \
        b"\1\0\x20\0FFV1" + bytes(20)
    path = tmp_path / "vfw.mkv"
    write_mkv(path, packets, 64, 48, codec="V_MS/VFW/FOURCC",
              doctype=b"matroska", private=bih + extra)
    video = avi.open_video(str(path))
    assert (video.codec, video.extradata) == ("ffv1", extra)
    video.close()
    check_equal_cv2(path, 4, frames)
    mov = tmp_path / "v.mov"
    write_cv2_video(mov, frames, "FFV1")
    video = avi.open_video(str(mov))
    assert video.codec == "ffv1" and len(video.extradata) > 20
    video.close()


def test_slam_main_on_ffv1_mkv_against_jax(tmp_path):
    """``slam_main`` on 14 frames at 540x960 written by cv2's FFV1 writer
    into a .mkv: the port's MediaSource gives the frames the JAX package's
    (cv2's) gives, bit for bit; the cameras as many as the JAX package's,
    the ATE within 0.02 of the extent of the median of its RANSAC seeds
    0-2."""
    from test_torch_mp4 import slam_main_against_jax

    slam_main_against_jax(tmp_path, "FFV1", "mkv")


# ---------------------------------------------------------- fixtures

def _digest(path) -> dict:
    rgb = cv2_rgb(path)
    return {"frames": len(rgb), "shape": list(rgb[0].shape),
            "rgb_sha256": [_sha(f) for f in rgb]}


def headline_frames():
    """The 32 headline FHD frames chip_smoke.py renders (seed 7)."""
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=1500, n_frames=32, image_size=(1080, 1920),
                       seed=7, baseline=0.25, kind="hallway")
    return [scene.render(i) for i in range(32)]


def write_fixtures(frames=None) -> None:
    """The 32 headline FHD frames through cv2's FFV1 writer into a .mkv,
    and the small fixtures, with the sha256 of cv2's RGB frames beside the
    other fixtures' in cv2_sha256.json."""
    frames = headline_frames() if frames is None else frames
    write_cv2_video(FIXTURE, frames, "FFV1")
    small = pan(5, 72, 96, dy=1, dx=2, noise=2.0)
    for ext in ("avi", "mov"):
        write_cv2_video(FIXTURES / f"ffv1_cv2.{ext}", small, "FFV1")
    packets, extra = encode(small, {"level": "3", "slices": "4",
                                    "slicecrc": "1", "coder": "2"})
    write_stream(FIXTURES / "ffv1_l3_crc_coder2.avi", packets, extra, 96, 72)
    packets, extra = encode(small, {"level": "1", "coder": "0",
                                    "context": "1"}, "yuv422p")
    write_stream(FIXTURES / "ffv1_golomb.avi", packets, extra, 96, 72)
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        table[name] = _digest(FIXTURES / name)
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256():
    """The committed fixtures (what chip_smoke.py holds the port to on the
    card): cv2's decode still gives the recorded sha256, and so does the
    port's, frame by frame; the FHD headline's first frames equal the
    rendered ones (FFV1 in RGB is lossless), and it uses what cv2's writer
    uses (version 3, slices with CRCs, Golomb-Rice, RGB with alpha)."""
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        path = FIXTURES / name
        want = table[name]
        assert path.stat().st_size <= (7_000_000 if name == FIXTURE.name
                                       else 120_000), name
        assert [_sha(f) for f in cv2_rgb(path)] == want["rgb_sha256"], name
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert len(got) == want["frames"], name
        assert [_sha(f) for f in got] == want["rgb_sha256"], name
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=1500, n_frames=32, image_size=(1080, 1920),
                       seed=7, baseline=0.25, kind="hallway")
    for i in (0, 31):
        assert _sha(scene.render(i)) == table[FIXTURE.name]["rgb_sha256"][i]
    stats = port_stats(FIXTURE)
    assert (stats["version"], stats["coder"], stats["colorspace"],
            stats["transparency"], stats["frames"]) == (3, 0, 1, 1, 32)
    assert stats["crc_slices"] == stats["slices"] >= 4 * 32
    assert port_stats(FIXTURES / "ffv1_l3_crc_coder2.avi")["coder"] == 2
    assert port_stats(FIXTURES / "ffv1_golomb.avi")["golomb_slices"] == 5


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    import test_torch_huffyuv

    frames = headline_frames()
    write_fixtures(frames)
    test_torch_huffyuv.write_fixtures(frames)
