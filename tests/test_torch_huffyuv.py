"""The port's HuffYUV and FFVHuff video (io/huffyuv.py over
native/huffyuv.cpp, and the ``HFYU``/``FFVH`` entries of io/avi.py,
io/matroska.py and io/mp4.py) on the CPU, against OpenCV's default FFmpeg
backend: RGB frames bit for bit and frame for frame against
``cv2.VideoCapture(p)``, in cv2's frame count.

Every stream is coded here: by cv2's ``HFYU`` (RGB24, left prediction
with decorrelation) and ``FFVH`` (4:2:0) writers into AVI, Matroska and
QuickTime at even and odd sizes, the RGB ones also equal to the frames
written; by the ``huffyuv`` encoder of the libavcodec cv2's wheel carries
(``lavc_encode``) with each predictor in 4:2:2, RGB24 and BGRA, and by
its ``ffvhuff`` encoder with each predictor and both table modes (tables
in the extradata, or in every frame: context 1) in 4:2:0, 4:2:2, gray,
RGB24 and BGRA; interlaced streams (``+ilme``) at 300 rows.  Damage: cut
packets and files (cv2's count; a frame whose data runs out equals cv2's
above the row where it does, since beyond it FFmpeg reads its own stale
buffers), random damage, code-length tables that ask for more codes than
fit (in the extradata and in a packet).  Refusals by name: HuffYUV 1.x's classic tables,
10-bit video, planar RGB, median prediction of RGB, and the layouts whose
swscale conversion the port does not reproduce.  The committed fixtures
in ``testing/video_fixtures/`` against their recorded cv2 sha256, which
chip_smoke.py holds the card to.

Rewrite the fixtures with ``PYTHONPATH=.:tests python
tests/test_torch_ffv1.py --write-fixtures``."""

import json
import pathlib

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, huffyuv
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg
from test_torch_mp4 import (cv2_rgb, lavc_encode, lavc_extradata,
                            write_cv2_video)
from test_torch_mpeg2 import _sha
from test_torch_vp9 import pan

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures"
DIGESTS = FIXTURES / "cv2_sha256.json"
# the headline's first frame through cv2's FFVH writer (FHD 4:2:0, the
# decode timed on the card); cv2's HFYU writer into AVI and Matroska, its
# FFVH writer into AVI; huffyuv 4:2:2 with median prediction; FFVHuff
# with tables in every frame
FHD_FIXTURE = FIXTURES / "ffvh_fhd_cv2.avi"
SMALL_FIXTURES = ("hfyu_cv2.avi", "hfyu_cv2.mkv", "ffvh_cv2.avi",
                  "huffyuv_422_median.avi", "ffvh_context.avi")


def encode(frames, options: dict, pix_fmt: str, codec: str = "ffvhuff"):
    """``frames`` through libavcodec's ``ffvhuff`` (or ``huffyuv``) as
    ``pix_fmt`` → (packets, extradata)."""
    packets, ctx = lavc_encode(codec, frames, dict(options),
                               pix_fmt=pix_fmt)
    return packets, lavc_extradata(ctx)


def write_stream(path, packets, extradata: bytes, w: int, h: int,
                 fourcc: bytes = b"FFVH", bit_count: int = 24):
    mjpeg.write_avi(str(path), packets, w, h, fourcc=fourcc,
                    extradata=extradata, bit_count=bit_count)
    return pathlib.Path(path)


def port_stats(path) -> dict:
    video = avi.open_video(str(path))
    dec = huffyuv.Decoder(video.extradata, video.width, video.height,
                          video.bits_per_coded_sample)
    for f in video.frames:
        dec.decode_planes(video.read(f))
    video.close()
    return dec.stats()


def check_equal_cv2(path, n=None, frames=None) -> dict:
    """MediaSource's frames equal cv2's in cv2's count (``n`` if given)
    and ``frames`` (the RGB written, for an RGB stream) where given; the
    decoder's stats."""
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           prefetch=3))
    assert len(got) == len(want)
    if n is not None:
        assert len(got) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if frames is not None:
        for a, f in zip(got, frames):
            np.testing.assert_array_equal(a, f[:a.shape[0], :a.shape[1]])
    return port_stats(path)


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("ext", ["avi", "mkv", "mov"])
@pytest.mark.parametrize("fourcc", ["HFYU", "FFVH"])
@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_cv2_writers_each_container(tmp_path, hw, fourcc, ext):
    """cv2's HFYU (RGB24, equal to the frames written) and FFVH (4:2:0)
    writers in each container, at an even and an odd size (the writer
    crops it): equal to cv2's decode."""
    frames = pan(4, *hw, dy=1, dx=2)
    path = tmp_path / f"v.{ext}"
    write_cv2_video(path, frames, fourcc)
    stats = check_equal_cv2(path, 4, frames if fourcc == "HFYU" else None)
    assert stats["version"] == 2
    assert stats["bitstream_bpp"] == (24 if fourcc == "HFYU" else 12)


@pytest.mark.parametrize("context", ["0", "1"])
@pytest.mark.parametrize("pred,pix_fmt", [
    (pred, pix_fmt) for pred in ("left", "plane", "median")
    for pix_fmt in ("yuv420p", "yuv422p", "gray", "rgb24", "bgra")
    if not (pred == "median" and pix_fmt in ("rgb24", "bgra"))])
def test_ffvhuff_predictors_tables_layouts(tmp_path, pred, context,
                                           pix_fmt):
    """FFVHuff with each predictor, with its tables once or in every frame,
    in each layout (median not for RGB, which the encoder refuses): equal
    to cv2's decode, RGB also to the frames written."""
    frames = pan(4, 48, 64, dy=2, dx=3, noise=3.0)
    packets, extra = encode(frames, {"pred": pred, "context": context},
                            pix_fmt)
    rgb = pix_fmt in ("rgb24", "bgra")
    stats = check_equal_cv2(write_stream(tmp_path / "v.avi", packets, extra,
                                         64, 48), 4, frames if rgb else None)
    assert stats["predictor"] == ["left", "plane", "median"].index(pred)
    assert stats["table_frames"] == (4 if context == "1" else 0)
    assert stats["version"] == (3 if pix_fmt == "gray" else 2)


@pytest.mark.parametrize("pix_fmt,pred", [
    ("yuv422p", "left"), ("yuv422p", "plane"), ("yuv422p", "median"),
    ("rgb24", "left"), ("rgb24", "plane"), ("bgra", "left"),
    ("bgra", "plane")])
def test_huffyuv_predictors(tmp_path, pix_fmt, pred):
    """libavcodec's huffyuv (HuffYUV 2.x) in its three layouts with each
    predictor it takes: equal to cv2's decode, RGB to the frames
    written."""
    frames = pan(4, 48, 64, dy=2, dx=3, noise=3.0)
    packets, extra = encode(frames, {"pred": pred}, pix_fmt, "huffyuv")
    stats = check_equal_cv2(
        write_stream(tmp_path / "v.avi", packets, extra, 64, 48, b"HFYU"), 4,
        None if pix_fmt == "yuv422p" else frames)
    assert stats["decorrelate"] == (pix_fmt != "yuv422p")


@pytest.mark.parametrize("codec,pix_fmt", [("ffvhuff", "yuv420p"),
                                           ("huffyuv", "yuv422p"),
                                           ("ffvhuff", "gray")])
@pytest.mark.parametrize("pred", ["left", "plane", "median"])
def test_interlaced(tmp_path, codec, pix_fmt, pred):
    """``+ilme`` writes the interlaced flag: each predictor reaches two rows
    up; equal to cv2's decode."""
    frames = pan(3, 300, 64, dy=2, dx=1, noise=2.0)
    packets, extra = encode(frames, {"pred": pred, "flags": "+ilme"},
                            pix_fmt, codec)
    stats = check_equal_cv2(write_stream(tmp_path / "v.avi", packets, extra,
                                         64, 300), 3)
    assert stats["interlaced"] == 1


@pytest.mark.parametrize("pix_fmt,hw", [("gray", (37, 53)),
                                        ("rgb24", (37, 53)),
                                        ("yuv420p", (37, 54)),
                                        ("yuv420p", (1080, 1920))])
def test_odd_and_fhd_sizes(tmp_path, pix_fmt, hw):
    """Odd widths (gray, RGB), an odd height in 4:2:0 and FHD: equal to
    cv2's decode."""
    frames = pan(2, *hw, dy=1, dx=1, noise=2.0)
    packets, extra = encode(frames, {"pred": "median" if pix_fmt != "rgb24"
                                     else "plane"}, pix_fmt)
    check_equal_cv2(write_stream(tmp_path / "v.avi", packets, extra, hw[1],
                                 hw[0]), 2)


def test_refusals_name_what(tmp_path):
    """HuffYUV 1.x's classic tables (no extradata), 10-bit video, planar
    RGB, median prediction of RGB (the byte written in by hand), a 4:4:4
    stream and 4:2:2 at an odd height raise NotImplementedError naming
    them."""
    frames = pan(2, 48, 64)
    cases = []
    packets, extra = encode(frames, {}, "rgb24", "huffyuv")
    cases.append((packets, b"", b"HFYU", 24, "1.x with its classic tables"))
    cases.append((packets, bytes([0x42]) + extra[1:], b"HFYU", 24,
                  "median prediction of RGB"))
    packets, extra = encode(frames, {}, "yuv420p10le")
    cases.append((packets, extra, b"FFVH", 24, "10-bit"))
    packets, extra = encode(frames, {}, "gbrp")
    cases.append((packets, extra, b"FFVH", 24, "planar RGB"))
    packets, extra = encode(frames, {}, "yuv444p")
    cases.append((packets, extra, b"FFVH", 24, "yuv444p layout"))
    odd = pan(2, 37, 64)
    packets, extra = encode(odd, {}, "yuv422p", "huffyuv")
    for k, (pk, ex, fourcc, bits, what) in enumerate(cases + [
            (packets, extra, b"HFYU", 16,
             "yuv422p layout at an odd height")]):
        h = 37 if k == len(cases) else 48
        path = write_stream(tmp_path / f"r{k}.avi", pk, ex, 64, h, fourcc,
                            bits)
        with pytest.raises(NotImplementedError, match=f"HuffYUV.*{what}"):
            list(MediaSource(video_path=str(path), use_photos=False))


@pytest.mark.parametrize("codec,pix_fmt,context", [
    ("huffyuv", "yuv422p", "0"), ("huffyuv", "rgb24", "0"),
    ("ffvhuff", "yuv420p", "1")])
def test_cut_packets_and_files(tmp_path, codec, pix_fmt, context):
    """A packet cut to half and to a few bytes (fewer than FFmpeg's minimum:
    cv2 stops there) and a file cut inside a packet: cv2's count, every
    whole frame equal to cv2's, a frame whose data runs out equal to cv2's
    in the rows above the one where the port's decode departs from the
    undamaged stream's."""
    frames = pan(6, 96, 128, dy=2, dx=3, noise=3.0)
    options = {"context": context} if codec == "ffvhuff" else {}
    packets, extra = encode(frames, options, pix_fmt, codec)
    fourcc = b"HFYU" if codec == "huffyuv" else b"FFVH"
    clean = list(MediaSource(video_path=str(write_stream(
        tmp_path / "c.avi", packets, extra, 128, 96, fourcc)),
        use_photos=False))
    for keep in (0.5, 0.01):
        cut = packets[:3] + [packets[3][:int(len(packets[3]) * keep) & ~3]
                             ] + packets[4:]
        path = write_stream(tmp_path / f"s{keep}.avi", cut, extra, 128, 96,
                            fourcc)
        want = cv2_rgb(path)
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert len(got) == len(want) == (6 if keep == 0.5 else 3)
        for i, (a, b) in enumerate(zip(got, want)):
            if i != 3:
                np.testing.assert_array_equal(a, b)
                continue
            diff = np.flatnonzero((a != clean[3]).any(axis=(1, 2)))
            if pix_fmt == "rgb24":      # coded from the bottom row up
                whole = slice(diff[-1] + 1 if len(diff) else 0, None)
            else:                       # a chroma row serves two rows
                whole = slice(0, max(diff[0] - 1, 0) if len(diff) else None)
            np.testing.assert_array_equal(a[whole], b[whole])
    path = write_stream(tmp_path / "full.avi", packets, extra, 128, 96,
                        fourcc)
    data = path.read_bytes()
    at = data.index(packets[3][:64]) + len(packets[3]) // 2
    path.write_bytes(data[:at])
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)


def test_random_damage_raises_only_documented_errors(tmp_path):
    """Thirty streams with random bytes flipped or cut: the port gives no
    more frames than packets, cv2's count, and raises nothing (a Huffman
    table that no longer makes a code ends the stream, as in FFmpeg)."""
    rng = np.random.default_rng(11)
    for case in range(30):
        codec, pix_fmt, fourcc = [("huffyuv", "yuv422p", b"HFYU"),
                                  ("ffvhuff", "yuv420p", b"FFVH"),
                                  ("huffyuv", "rgb24", b"HFYU")][case % 3]
        options = {"context": "1"} if case % 2 and codec == "ffvhuff" else {}
        packets, extra = encode(pan(4, 48, 64, seed=case), options, pix_fmt,
                                codec)
        for _ in range(int(rng.integers(1, 6))):
            k = int(rng.integers(0, len(packets)))
            p = bytearray(packets[k])
            p[int(rng.integers(0, len(p)))] ^= int(rng.integers(1, 256))
            packets[k] = bytes(p)
        path = write_stream(tmp_path / f"r{case}.avi", packets, extra, 64, 48,
                            fourcc)
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert len(got) == len(cv2_rgb(path)) <= 4



def len_tables(lengths) -> bytes:
    """Code-length tables (256 lengths each) in read_len_table's run-length
    code: 3 bits of repeat and 5 of length, a repeat of 0 followed by 8
    bits of it; padded to a byte."""
    bits = []
    for table in lengths:
        i = 0
        while i < 256:
            n = 1
            while i + n < 256 and table[i + n] == table[i] and n < 255:
                n += 1
            head = (n if n < 8 else 0, 3), (table[i], 5)
            bits += [(v, w) for v, w in head] + ([(n, 8)] if n >= 8 else [])
            i += n
    word = "".join(format(v, f"0{w}b") for v, w in bits)
    word += "0" * (-len(word) % 8)
    return int(word, 2).to_bytes(len(word) // 8, "big")


def len_tables_size(swapped: bytes, count: int) -> int:
    """The bytes ``count`` run-length coded tables take at the start of
    ``swapped``."""
    word = "".join(format(b, "08b") for b in swapped)
    pos = 0
    for _ in range(count):
        i = 0
        while i < 256:
            repeat, pos = int(word[pos:pos + 3], 2), pos + 8
            if repeat == 0:
                repeat, pos = int(word[pos:pos + 8], 2), pos + 8
            i += repeat
    return (pos + 7) // 8


def swap32(data: bytes) -> bytes:
    return np.frombuffer(data, "<u4").byteswap().tobytes()


@pytest.mark.parametrize("where", ["extradata", "packet"])
@pytest.mark.parametrize("lengths", [[1] * 4 + [0] * 252, [1] * 256],
                         ids=["four_of_length_1", "all_of_length_1"])
def test_overfull_tables_refused_as_ffmpeg(tmp_path, where, lengths):
    """Code-length tables that ask for more codes than fit (four codes of
    length 1, or all 256; each count is even, so FFmpeg's
    generate_bits_table passes them, and its vlc_init refuses the codes
    that do not fit): in the extradata cv2 opens no frame and the port
    raises ValueError naming the table; in a context-1 packet cv2 stops
    there and so does the port, whose decoder reports the table."""
    frames = pan(4, 48, 64, seed=3)
    tables = len_tables([lengths] * 3)
    if where == "extradata":
        packets, extra = encode(frames, {}, "rgb24", "huffyuv")
        path = write_stream(tmp_path / "e.avi", packets, extra[:4] + tables,
                            64, 48, b"HFYU")
        assert cv2_rgb(path) is None     # the codec does not open
        with pytest.raises(ValueError, match="HuffYUV: Huffman table"):
            list(MediaSource(video_path=str(path), use_photos=False))
        return
    packets, extra = encode(frames, {"context": "1"}, "yuv420p")
    swapped = swap32(packets[2])
    body = tables + swapped[len_tables_size(swapped, 3):]
    packets[2] = swap32(body + bytes(-len(body) % 4))
    path = write_stream(tmp_path / "p.avi", packets, extra, 64, 48)
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    dec = huffyuv.Decoder(extra, 64, 48, 24)
    assert dec.decode(packets[0]) is not None
    assert dec.decode(packets[2]) is None and dec.failed
    assert "Huffman table" in dec.reason
    assert dec.decode(packets[3]) is not None
    dec.close()

# ---------------------------------------------------------- fixtures

def _digest(path) -> dict:
    rgb = cv2_rgb(path)
    return {"frames": len(rgb), "shape": list(rgb[0].shape),
            "rgb_sha256": [_sha(f) for f in rgb]}


def write_fixtures(frames) -> None:
    """The headline's first frame through cv2's FFVH writer (FHD), the
    small fixtures, and the sha256 of cv2's RGB frames of each beside the
    other fixtures' in cv2_sha256.json."""
    write_cv2_video(FHD_FIXTURE, frames[:1], "FFVH")
    small = pan(5, 72, 96, dy=1, dx=2, noise=2.0)
    write_cv2_video(FIXTURES / "hfyu_cv2.avi", small, "HFYU")
    write_cv2_video(FIXTURES / "hfyu_cv2.mkv", small, "HFYU")
    write_cv2_video(FIXTURES / "ffvh_cv2.avi", small, "FFVH")
    packets, extra = encode(small, {"pred": "median"}, "yuv422p", "huffyuv")
    write_stream(FIXTURES / "huffyuv_422_median.avi", packets, extra, 96, 72,
                 b"HFYU", 16)
    packets, extra = encode(small, {"pred": "plane", "context": "1"},
                            "yuv420p")
    write_stream(FIXTURES / "ffvh_context.avi", packets, extra, 96, 72)
    table = json.loads(DIGESTS.read_text())
    for name in (FHD_FIXTURE.name,) + SMALL_FIXTURES:
        table[name] = _digest(FIXTURES / name)
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256():
    """The committed fixtures (what chip_smoke.py holds the port to on the
    card): cv2's decode still gives the recorded sha256, and so does the
    port's; each uses what it was written with."""
    table = json.loads(DIGESTS.read_text())
    for name in (FHD_FIXTURE.name,) + SMALL_FIXTURES:
        path = FIXTURES / name
        want = table[name]
        assert path.stat().st_size <= (1_000_000 if path == FHD_FIXTURE
                                       else 200_000), name
        assert [_sha(f) for f in cv2_rgb(path)] == want["rgb_sha256"], name
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert [_sha(f) for f in got] == want["rgb_sha256"], name
    assert port_stats(FIXTURES / "huffyuv_422_median.avi")[
        "median_rows"] > 0
    assert port_stats(FIXTURES / "ffvh_context.avi")["table_frames"] == 5
    assert port_stats(FHD_FIXTURE)["bitstream_bpp"] == 12
