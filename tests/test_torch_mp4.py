"""The port's MPEG-4 Part 2 video (io/mpeg4.py over native/mpeg4.cpp, in
MP4 through io/mp4.py and in AVI through io/avi.py, read by
``MediaSource(use_photos=False)``) on the CPU, against OpenCV's default
FFmpeg backend: RGB frames bit for bit and frame for frame against
``cv2.VideoCapture(p)``, the Y plane bit for bit against its
``CAP_PROP_CONVERT_RGB=0`` read, on files cv2's ``mp4v`` and ``XVID``
writers make (38x54, not whole macroblocks; 480x640; FHD; a moving
sequence with three I-VOPs and both rounding types); the committed
fixtures (the FHD headline as cv2 writes mp4v; a small XVID AVI coded with
AC prediction and DQUANT, which cv2's writer does not use), whose cv2
decode must still equal its recorded sha256 (the card holds the port to
them); refusals (an ``avc1`` sample entry, a VP9 WebM, VOL
headers asking for B-VOPs, quarter-pel, interlace and MPEG quantisation, a
B-VOP); truncated files and a not-coded VOP as cv2 reads them; and, end to
end, ``slam_main`` on a 540x960 ``mp4v`` file and the video calibration on
an ``mp4v`` file of board renders against the JAX package reading the same
files through cv2.

Rewrite the fixtures with ``PYTHONPATH=. python tests/test_torch_mp4.py
--write-fixture`` (needs cv2's FFmpeg ``mp4v`` writer and the libavcodec
its wheel carries)."""

import hashlib
import json
import pathlib
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, mp4, mpeg4
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import make_scene, mjpeg

torch.set_num_threads(1)

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures")
FIXTURE = FIXTURES / "headline_mp4v.mp4"
FIXTURE_AQ = FIXTURES / "acpred_dquant_xvid.avi"
DIGESTS = FIXTURES / "cv2_sha256.json"


def write_cv2_video(path, frames, fourcc, fps=10.0):
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                         (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def cv2_rgb(path):
    """RGB frames of cv2's default backend; None if it does not open."""
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        return None
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(np.ascontiguousarray(f[..., ::-1]))


def cv2_luma(path, hw):
    """The decoded Y planes, as cv2's FFmpeg backend returns yuv420p with
    ``CAP_PROP_CONVERT_RGB=0``."""
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_CONVERT_RGB, 0])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f.reshape(hw))


def port_luma(video):
    dec = mpeg4.Decoder(video.extradata)
    out = [dec.decode_yuv(video.read(f)) for f in video.frames]
    return [p[0] for p in out if p is not None]


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def scene_frames():
    sc = make_scene(n_points=400, n_frames=30, seed=5, baseline=0.3)
    return [sc.render(i) for i in range(30)]


def _check_equal_cv2(path, hw, n):
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           prefetch=3))
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.shape == hw + (3,)
        np.testing.assert_array_equal(a, b)
    video = avi.open_video(str(path))
    luma = port_luma(video)
    video.close()
    want_y = cv2_luma(path, hw)
    assert len(luma) == len(want_y) == n
    for a, b in zip(luma, want_y):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fourcc,ext", [("mp4v", "mp4"), ("XVID", "avi")])
@pytest.mark.parametrize("hw", [(38, 54), (480, 640), (1080, 1920)])
def test_frames_equal_cv2(tmp_path, scene_frames, hw, fourcc, ext):
    """cv2's mp4v (MP4) and XVID (AVI) writers: every frame equals cv2's
    default backend's in RGB and in Y (three frames at FHD, eight below)."""
    n = 3 if hw[0] > 500 else 8
    frames = [np.ascontiguousarray(cv2.resize(f, hw[::-1]))
              for f in scene_frames[:n]]
    path = tmp_path / f"seq.{ext}"
    write_cv2_video(path, frames, fourcc)
    _check_equal_cv2(path, hw, n)
    video = avi.open_video(str(path))
    assert (video.codec, video.width, video.height) == ("mpeg4", hw[1],
                                                         hw[0])
    video.close()


class _Bits:
    def __init__(self, data: bytes):
        self.v, self.n, self.pos = int.from_bytes(data, "big"), 8 * len(
            data), 0

    def get(self, k: int) -> int:
        self.pos += k
        return (self.v >> (self.n - self.pos)) & ((1 << k) - 1)


def _vol_time_bits(extradata: bytes) -> int:
    """vop_time_increment's width from a VOL written as cv2 writes it."""
    b = _Bits(extradata[extradata.index(b"\0\0\1\x20") + 4:])
    b.get(9)
    if b.get(1):
        b.get(7)
    if b.get(4) == 15:
        b.get(16)
    if b.get(1):
        b.get(3)
        assert b.get(1) == 0          # no vbv_parameters
    b.get(3)
    res = b.get(16)
    return max(1, (res - 1).bit_length())


def _vop_kinds(samples, time_bits):
    """(vop_coding_type, vop_rounding_type) of each sample's VOP."""
    out = []
    for s in samples:
        b = _Bits(s[s.index(b"\0\0\1\xb6") + 4:][:16])
        kind = b.get(2)
        while b.get(1):
            pass
        b.get(1 + time_bits + 1)
        assert b.get(1) == 1           # vop_coded
        out.append((kind, b.get(1) if kind == 1 else None))
    return out


def test_moving_sequence_two_gops_both_roundings(tmp_path, scene_frames):
    """30 moving frames at 240x320: I-VOPs at 0, 12 and 24, P-VOPs with
    vop_rounding_type 0 and 1 (FFmpeg's encoder flips it every P-VOP),
    every frame as cv2 decodes it."""
    frames = [np.ascontiguousarray(cv2.resize(f, (320, 240)))
              for f in scene_frames]
    path = tmp_path / "move.mp4"
    write_cv2_video(path, frames, "mp4v")
    video = mp4.Mp4Video(str(path))
    kinds = _vop_kinds([video.read(f) for f in video.frames],
                       _vol_time_bits(video.extradata))
    video.close()
    assert [i for i, k in enumerate(kinds) if k[0] == 0] == [0, 12, 24]
    assert {k[1] for k in kinds if k[0] == 1} == {0, 1}
    _check_equal_cv2(path, (240, 320), 30)


def lavc_encode(codec_name: str, frames, options: dict,
                stats_in: bytes = None, pts: bool = True):
    """``frames`` (RGB) coded by encoder ``codec_name`` of the
    libavcodec that cv2's wheel carries, through ctypes, with encoder
    ``options`` (AVOptions) that cv2's writer does not pass: (the coded
    packets, the codec context).  ``stats_in`` is a first pass's
    statistics (``pass1_stats``) for a second pass.  With ``pts`` the
    frames are stamped 0, 1, 2, ..."""
    import ctypes
    import glob

    libs = pathlib.Path(cv2.__file__).resolve().parent.parent / \
        "opencv_python.libs"
    avu = ctypes.CDLL(glob.glob(str(libs / "libavutil*"))[0],
                      mode=ctypes.RTLD_GLOBAL)
    avc = ctypes.CDLL(glob.glob(str(libs / "libavcodec*"))[0],
                      mode=ctypes.RTLD_GLOBAL)
    vp = ctypes.c_void_p
    for lib, fn, res, args in (
            (avc, "avcodec_find_encoder_by_name", vp, [ctypes.c_char_p]),
            (avc, "avcodec_alloc_context3", vp, [vp]),
            (avu, "av_opt_set", ctypes.c_int,
             [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
            (avu, "av_opt_find", vp,
             [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
              ctypes.c_int]),
            (avc, "avcodec_open2", ctypes.c_int, [vp, vp, vp]),
            (avu, "av_frame_alloc", vp, []),
            (avu, "av_frame_get_buffer", ctypes.c_int, [vp, ctypes.c_int]),
            (avu, "av_frame_make_writable", ctypes.c_int, [vp]),
            (avc, "av_packet_alloc", vp, []),
            (avc, "avcodec_send_frame", ctypes.c_int, [vp, vp]),
            (avc, "avcodec_receive_packet", ctypes.c_int, [vp, vp]),
            (avc, "av_packet_unref", None, [vp])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    h, w = frames[0].shape[:2]
    codec = avc.avcodec_find_encoder_by_name(codec_name.encode())
    ctx = avc.avcodec_alloc_context3(codec)
    for k, v in {"video_size": f"{w}x{h}", "pixel_format": "yuv420p",
                 "time_base": "1/10", "g": "12", **options}.items():
        assert avu.av_opt_set(ctx, k.encode(), v.encode(), 1) >= 0, k
    if stats_in is not None:
        # AVCodecContext's stats_in: the pointer after stats_out, which
        # lies just before workaround_bugs (AVOption "bug"; an AVOption's
        # offset is the int after its name and help pointers)
        keep = ctypes.create_string_buffer(stats_in)
        off = _stats_out_offset(avu, ctx) + 8
        ctypes.c_void_p.from_address(ctx + off).value = \
            ctypes.addressof(keep)
    assert avc.avcodec_open2(ctx, codec, None) == 0
    frame = avu.av_frame_alloc()
    # AVFrame: data[8], linesize[8], extended_data, width, height,
    # nb_samples, format, ..., pts at 136
    dims = (ctypes.c_int * 4).from_address(frame + 104)
    dims[0], dims[1], dims[3] = w, h, 0                  # yuv420p
    assert avu.av_frame_get_buffer(frame, 0) == 0
    data = (ctypes.c_void_p * 8).from_address(frame)
    stride = (ctypes.c_int * 8).from_address(frame + 64)
    stamp = ctypes.c_int64.from_address(frame + 136)
    pkt, out = avc.av_packet_alloc(), []

    def drain():
        # AVPacket: buf, pts, dts, data, size
        while avc.avcodec_receive_packet(ctx, pkt) == 0:
            out.append(ctypes.string_at(
                ctypes.c_void_p.from_address(pkt + 24).value,
                ctypes.c_int.from_address(pkt + 32).value))
            avc.av_packet_unref(pkt)
    H, W = h + (h & 1), w + (w & 1)     # odd sizes: chroma rounded up
    for i, f in enumerate(frames):
        f = np.pad(f, ((0, H - h), (0, W - w), (0, 0)), mode="edge")
        i420 = cv2.cvtColor(np.ascontiguousarray(f),
                            cv2.COLOR_RGB2YUV_I420).ravel()
        n = H * W // 4
        planes = (i420[:H * W].reshape(H, W)[:h, :w],
                  i420[H * W:H * W + n].reshape(H // 2, W // 2),
                  i420[H * W + n:].reshape(H // 2, W // 2))
        avu.av_frame_make_writable(frame)
        for k, plane in enumerate(planes):
            plane = np.ascontiguousarray(plane)
            for r in range(plane.shape[0]):
                ctypes.memmove(data[k] + r * stride[k],
                               plane[r].ctypes.data, plane.shape[1])
        if pts:
            stamp.value = i
        assert avc.avcodec_send_frame(ctx, frame) == 0
        drain()
    avc.avcodec_send_frame(ctx, None)
    drain()
    return out, (avu, ctx)


def _stats_out_offset(avu, ctx) -> int:
    import ctypes

    opt = avu.av_opt_find(ctx, b"bug", None, 0, 0)
    return ctypes.c_int.from_address(opt + 16).value - 16


def pass1_stats(lib_ctx) -> bytes:
    """The first-pass statistics a ``lavc_encode`` with ``flags=+pass1``
    left in its context's stats_out."""
    import ctypes

    avu, ctx = lib_ctx
    p = ctypes.c_void_p.from_address(ctx + _stats_out_offset(avu, ctx))
    assert p.value
    return ctypes.string_at(p.value)


def _lavc_mpeg4(frames, options: dict) -> list:
    """``frames`` coded by libavcodec's ``mpeg4`` encoder with ``options``
    (no B-frames): the coded packets."""
    return lavc_encode("mpeg4", frames, {"bf": "0", **options},
                       pts=False)[0]


def write_fixture() -> None:
    """The 32 headline FHD frames as cv2 writes mp4v; 14 frames at 96x128
    coded with AC prediction and adaptive quantisation (DQUANT in I- and
    P-VOPs, the AC predictor rescaled across quantisers), which cv2's
    writer does not use, in an XVID AVI; and the sha256 of cv2's RGB frames
    and Y planes of each."""
    from slam_indoor_code_tpu_torch.testing import make_scene as scene_of

    sc = scene_of(n_points=1500, n_frames=32, image_size=(1080, 1920),
                  seed=7, baseline=0.25, kind="hallway")
    FIXTURES.mkdir(exist_ok=True)
    write_cv2_video(FIXTURE, [sc.render(i) for i in range(32)], "mp4v")
    sc = scene_of(n_points=400, n_frames=14, seed=5, baseline=0.3)
    frames = [cv2.resize(sc.render(i), (128, 96)) for i in range(14)]
    mjpeg.write_avi(str(FIXTURE_AQ), _lavc_mpeg4(frames, {
        "flags": "+aic", "lumi_mask": "0.3", "scplx_mask": "0.3"}),
        128, 96, fourcc=b"XVID")
    table = {}
    for path in (FIXTURE, FIXTURE_AQ):
        rgb = cv2_rgb(path)
        luma = cv2_luma(path, rgb[0].shape[:2])
        table[path.name] = {"frames": len(rgb), "shape": list(rgb[0].shape),
                            "rgb_sha256": [_sha(f) for f in rgb],
                            "y_sha256": [_sha(f) for f in luma]}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


@pytest.mark.parametrize("name", ["headline_mp4v.mp4",
                                  "acpred_dquant_xvid.avi"])
def test_fixture_cv2_and_port_equal_recorded_sha256(name):
    """The committed fixtures: cv2's decode still gives the recorded
    sha256 (the yardstick chip_smoke.py holds the port to on the card), and
    so does the port's, frame by frame, in RGB and Y."""
    table = json.loads(DIGESTS.read_text())[name]
    path = FIXTURES / name
    assert path.stat().st_size <= 4_000_000
    rgb = cv2_rgb(path)
    assert [_sha(f) for f in rgb] == table["rgb_sha256"]
    assert [_sha(f) for f in cv2_luma(path, tuple(table["shape"][:2]))
            ] == table["y_sha256"]
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == table["frames"]
    assert [_sha(f) for f in got] == table["rgb_sha256"]
    video = avi.open_video(str(path))
    assert [_sha(y) for y in port_luma(video)] == table["y_sha256"]
    video.close()


def test_close_mid_stream_stops_the_decoding_thread():
    """MediaSource closed after one frame of an MPEG-4 stream: its
    producer thread ends (it waits on a full queue of prefetch 2) and the
    source gives no more frames."""
    src = MediaSource(video_path=str(FIXTURE_AQ), use_photos=False,
                      prefetch=2)
    assert src.next_frame() is not None
    src.close()
    src._reader._thread.join(timeout=10)
    assert not src._reader._thread.is_alive()
    assert src.next_frame() is None


def xvid_avi_from_mp4(src, dst):
    """The MP4's samples muxed into an XVID AVI (testing/mjpeg.py), the
    esds headers in front of the first, as an AVI carries them."""
    video = mp4.Mp4Video(str(src))
    samples = [video.read(f) for f in video.frames]
    samples[0] = video.extradata + samples[0]
    mjpeg.write_avi(str(dst), samples, video.width, video.height,
                    fourcc=b"XVID")
    video.close()
    return samples


def test_xvid_avi_of_the_fixture_samples_equals_the_mp4(tmp_path):
    """chip_smoke.py's mux: the fixture's samples in an XVID AVI give the
    MP4's frames, through the port and through cv2."""
    path = tmp_path / "fix.avi"
    xvid_avi_from_mp4(FIXTURE, path)
    table = json.loads(DIGESTS.read_text())[FIXTURE.name]
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert [_sha(f) for f in got] == table["rgb_sha256"]
    assert [_sha(f) for f in cv2_rgb(path)] == table["rgb_sha256"]


# ----------------------------------------------------------------- refusals

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _rebuild(data: bytes, start: int, end: int, entry_fn) -> bytes:
    """The boxes of data[start:end] written again, each video sample entry
    through ``entry_fn(kind, fields, child boxes) -> bytes`` (sizes
    recomputed; moov is the last box cv2 writes, so offsets hold)."""
    out = b""
    for kind, s, e in mp4._boxes(data, start, end):
        if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
            body = _rebuild(data, s, e, entry_fn)
        elif kind == b"stsd":
            es = s + 8
            ek, = struct.unpack(">4s", data[es + 4:es + 8])
            ee = es + struct.unpack(">I", data[es:es + 4])[0]
            body = data[s:s + 8] + entry_fn(ek, data[es + 8:es + 86],
                                            data[es + 86:ee])
        else:
            body = data[s:e]
        out += _box(kind, body)
    return out


def _with_entry(src, dst, entry_fn):
    data = src.read_bytes()
    moov = mp4._find(data, 0, len(data), b"moov")
    dst.write_bytes(data[:moov[0] - 8] + _rebuild(data, moov[0] - 8,
                                                  moov[1], entry_fn))


def _esds(extradata: bytes) -> bytes:
    """An esds box as FFmpeg's mov muxer writes one (4-byte lengths)."""
    def desc(tag, body):
        n = len(body)
        return bytes([tag, 0x80 | (n >> 21) & 127, 0x80 | (n >> 14) & 127,
                      0x80 | (n >> 7) & 127, n & 127]) + body
    dcd = desc(4, bytes([0x20, 0x11]) + bytes(11) + desc(5, extradata))
    return _box(b"esds", bytes(4) + desc(3, bytes(3) + dcd + desc(6, b"\2")))


def vol(w=1920, h=1080, verid=1, low_delay=1, interlaced=0, quant_type=0,
        quarter=0, resync_disable=1, res=10) -> bytes:
    """A VOL header in the layout cv2's writer uses (Simple object type,
    vol_control_parameters, rectangular, progressive), fields settable."""
    bits = "0" + "00000001" + "1" + f"{verid:04b}" + "001" + "0001"
    bits += "1" + "01" + str(low_delay) + "0"
    bits += "00" + "1" + f"{res:016b}" + "1" + "0"
    bits += "1" + f"{w:013b}" + "1" + f"{h:013b}" + "1"
    bits += str(interlaced) + "1" + ("0" if verid == 1 else "00") + "0"
    bits += str(quant_type) + ("00" if quant_type else "")
    bits += str(quarter) if verid != 1 else ""
    bits += "1" + str(resync_disable) + "0" + ("00" if verid != 1 else "")
    bits += "0"
    bits += "0" + "1" * (-(len(bits) + 1) % 8)
    return b"\0\0\1\x20" + int(bits, 2).to_bytes(len(bits) // 8, "big")


def _swap_vol(extradata: bytes, new: bytes) -> bytes:
    i = extradata.index(b"\0\0\1\x20")
    j = extradata.index(b"\0\0\1", i + 4)
    return extradata[:i] + new + extradata[j:]


def test_vol_writer_reproduces_the_fixture_vol():
    video = mp4.Mp4Video(str(FIXTURE))
    assert _swap_vol(video.extradata, vol()) == video.extradata
    video.close()


@pytest.mark.parametrize("fields,tool", [
    (dict(low_delay=0), "B-VOPs"),
    (dict(verid=2, quarter=1), "quarter-pel"),
    (dict(interlaced=1), "interlace"),
    (dict(quant_type=1), "MPEG quantisation"),
])
def test_vol_tools_not_decoded_raise(tmp_path, fields, tool):
    """The fixture's VOL with one tool switched on, in the MP4's esds and
    in band in an XVID AVI: ValueError naming the tool."""
    video = mp4.Mp4Video(str(FIXTURE))
    extra = _swap_vol(video.extradata, vol(**fields))
    first = video.read(video.frames[0])
    video.close()
    path = tmp_path / "tool.mp4"
    _with_entry(FIXTURE, path,
                lambda k, f, kids: _box(k, f + _esds(extra)))
    with pytest.raises(ValueError, match=tool):
        MediaSource(video_path=str(path), use_photos=False)
    path = tmp_path / "tool.avi"
    mjpeg.write_avi(str(path), [extra + first], 1920, 1080, fourcc=b"XVID")
    src = MediaSource(video_path=str(path), use_photos=False)
    with pytest.raises(ValueError, match=tool):
        src.next_frame()


def test_resync_enabled_vol_without_markers_decodes(tmp_path, scene_frames):
    """resync_marker_disable 0 with no marker in the stream: the same
    frames (the per-macroblock marker check finds none)."""
    frames = [np.ascontiguousarray(cv2.resize(f, (160, 96)))
              for f in scene_frames[:6]]
    path = tmp_path / "a.mp4"
    write_cv2_video(path, frames, "mp4v")
    video = mp4.Mp4Video(str(path))
    extra = _swap_vol(video.extradata, vol(160, 96, resync_disable=0))
    samples = [video.read(f) for f in video.frames]
    video.close()
    dec = mpeg4.Decoder(extra)
    got = [dec.decode(s) for s in samples]
    for a, b in zip(got, cv2_rgb(path)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("duration,media_time", [
    (3000, 2048), (1000, 4096), (1550, 1500), (0, 0)])
def test_edit_list_applied_as_ffmpeg(tmp_path, scene_frames, duration,
                                     media_time):
    """The elst entry rewritten (segment duration in ms, media time in
    1/10240 s; frames last 1024): the port shows the frames cv2 shows,
    those before the media time decoded as references only, none past the
    segment's end, none for a zero duration."""
    frames = [np.ascontiguousarray(cv2.resize(f, (80, 64)))
              for f in scene_frames]
    path = tmp_path / "a.mp4"
    write_cv2_video(path, frames, "mp4v")
    data = bytearray(path.read_bytes())
    i = data.index(b"elst")
    assert struct.unpack(">IIIi", data[i + 4:i + 20]) == (0, 1, 3000, 0)
    struct.pack_into(">Ii", data, i + 12, duration, media_time)
    path.write_bytes(bytes(data))
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_b_vop_raises(tmp_path, scene_frames):
    frames = [np.ascontiguousarray(cv2.resize(f, (64, 48)))
              for f in scene_frames[:3]]
    path = tmp_path / "b.mp4"
    write_cv2_video(path, frames, "mp4v")
    video = mp4.Mp4Video(str(path))
    samples = [video.read(f) for f in video.frames]
    dec = mpeg4.Decoder(video.extradata)
    video.close()
    assert dec.decode(samples[0]) is not None
    p = samples[1]
    i = p.index(b"\0\0\1\xb6") + 4
    assert p[i] >> 6 == 1                         # a P-VOP
    b_vop = p[:i] + bytes([p[i] ^ 0xC0]) + p[i + 1:]
    with pytest.raises(ValueError, match="B-VOPs"):
        dec.decode(b_vop)


@pytest.mark.parametrize("kind,codec", [(b"avc1", "H.264"),
                                        (b"hvc1", "HEVC")])
def test_other_mp4_codecs_raise(tmp_path, kind, codec):
    """A sample entry other than mp4v (built by hand on the fixture's
    boxes): NotImplementedError naming the codec."""
    path = tmp_path / "h.mp4"
    _with_entry(FIXTURE, path,
                lambda k, f, kids: _box(kind, f + _box(b"avcC", bytes(7))))
    with pytest.raises(NotImplementedError, match=codec):
        MediaSource(video_path=str(path), use_photos=False)


def test_webm_raises(tmp_path, scene_frames):
    """A WebM file in a codec the port does not decode (cv2's ``VP90``
    writer; VP8 WebM is read, tests/test_torch_webm.py):
    NotImplementedError naming the codec."""
    path = tmp_path / "v.webm"
    write_cv2_video(path, [cv2.resize(f, (64, 48)) for f in scene_frames[:2]],
                    "VP90")
    assert len(cv2_rgb(path)) == 2
    with pytest.raises(NotImplementedError, match="VP9"):
        MediaSource(video_path=str(path), use_photos=False)


# ------------------------------------------------------ damage, not coded

@pytest.mark.parametrize("where", ["vop_header", "mid_vop"])
def test_truncated_avi(tmp_path, scene_frames, where):
    """An XVID AVI cut inside its next-to-last chunk ends without an error
    after the frames before the cut, equal to cv2's.  Cut in the VOP
    header, cv2 gives no frame for it either; cut deeper, FFmpeg conceals
    the lost macroblocks and gives one frame more, which the port does not
    (it has no error concealment: a damaged VOP is dropped)."""
    frames = [np.ascontiguousarray(cv2.resize(f, (128, 96)))
              for f in scene_frames[:10]]
    path = tmp_path / "full.avi"
    write_cv2_video(path, frames, "XVID")
    video = avi.AviVideo(str(path))
    off, n, _ = video.frames[-2]
    video.close()
    cut = off + (2 if where == "vop_header" else n // 2)
    cut_path = tmp_path / "cut.avi"
    cut_path.write_bytes(path.read_bytes()[:cut])
    want = cv2_rgb(cut_path)
    got = list(MediaSource(video_path=str(cut_path), use_photos=False))
    assert len(got) == 8
    assert len(want) == (8 if where == "vop_header" else 9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_truncated_mp4_does_not_open(tmp_path, scene_frames):
    """cv2's MP4 keeps its moov after the samples: cut mid-sample, neither
    cv2 nor the port opens it (IOError, as a missing file)."""
    path = tmp_path / "full.mp4"
    write_cv2_video(path, [cv2.resize(f, (128, 96))
                           for f in scene_frames[:6]], "mp4v")
    video = mp4.Mp4Video(str(path))
    off, n, _ = video.frames[3]
    video.close()
    cut = tmp_path / "cut.mp4"
    cut.write_bytes(path.read_bytes()[:off + n // 2])
    assert cv2_rgb(cut) is None
    with pytest.raises(IOError, match="Video wasn't opened"):
        MediaSource(video_path=str(cut), use_photos=False)


def test_not_coded_vop_gives_no_frame(tmp_path, scene_frames):
    """A VOP with vop_coded 0 (written by hand into an XVID AVI between
    the fifth and sixth samples): cv2 gives no frame for it, nor does the
    port; every other frame is as cv2 decodes it."""
    frames = [np.ascontiguousarray(cv2.resize(f, (54, 38)))
              for f in scene_frames[:10]]
    src = tmp_path / "a.mp4"
    write_cv2_video(src, frames, "mp4v")
    samples = xvid_avi_from_mp4(src, tmp_path / "plain.avi")
    bits = "01" + "0" + "1" + "0011" + "1" + "0"       # P, vop_coded 0
    bits += "0" + "1" * (-(len(bits) + 1) % 8)
    skip = b"\0\0\1\xb6" + int(bits, 2).to_bytes(len(bits) // 8, "big")
    path = tmp_path / "nc.avi"
    mjpeg.write_avi(str(path), samples[:5] + [skip] + samples[5:], 54, 38,
                    fourcc=b"XVID")
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_damaged_input_raises_only_the_documented_errors(tmp_path):
    """Bytes changed at random (seeded) in the samples of the small
    fixture, and in the moov box of an MP4: the decoder gives frames or
    None (or ValueError naming a tool the damage asks for) and never
    crashes; the demuxer opens the file or raises IOError or
    NotImplementedError."""
    rng = np.random.default_rng(14)
    video = avi.AviVideo(str(FIXTURE_AQ))
    samples = [video.read(f) for f in video.frames]
    video.close()
    for _ in range(40):
        dec = mpeg4.Decoder()
        for s in samples:
            s = bytearray(s)
            for _ in range(int(rng.integers(0, 4))):
                s[int(rng.integers(0, len(s)))] = int(rng.integers(0, 256))
            try:
                img = dec.decode(bytes(s[:int(rng.integers(1, len(s) + 1))]))
            except ValueError:
                continue
            assert img is None or (img.dtype == np.uint8
                                   and img.shape[2] == 3)
    data = FIXTURE.read_bytes()
    moov = data.index(b"moov") - 4
    path = tmp_path / "damaged.mp4"
    for _ in range(200):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            d[int(rng.integers(moov, len(d)))] = int(rng.integers(0, 256))
        path.write_bytes(bytes(d))
        try:
            video = mp4.Mp4Video(str(path))
        except (IOError, NotImplementedError):
            continue
        for f in video.frames[:2]:
            video.read(f)
        video.close()


# --------------------------------------------------------------- end to end

# The JAX package's runs on a video, in a process of its own: its frames
# read by its MediaSource (cv2), then slam_main on them with RANSAC seeds 0,
# 1 and 2; each trajectory to an npz.
_JAX_VIDEO_RUNS = r"""
import sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
from slam_indoor_code_tpu import app, config
from slam_indoor_code_tpu.io.media import MediaSource
from test_torch_video import _cfg
video, out = sys.argv[1], sys.argv[2]
frames = list(MediaSource(video_path=video, use_photos=False))
for seed in range(3):
    gd = app.slam_main(_cfg(config, video, out), np.load(out + "/K.npy"),
                       frames=frames, seed=seed)
    np.savez(f"{out}/gd{seed}.npz", rotations=np.asarray(gd.rotations),
             positions=np.asarray(gd.positions),
             frame_ids=np.asarray(gd.frame_ids))
"""


def test_slam_main_on_mp4v_against_jax_video_run(tmp_path):
    """tests/test_torch_video.py's end-to-end test on a 540x960 mp4v file:
    the JAX package reads it through its MediaSource (cv2), the port's
    ``slam_main`` through io/mp4.py; the frames are equal bit for bit, the
    cameras as many, ATE within 0.02 of the extent of the JAX package's.
    On this file the JAX package's ATE is not a function of its inputs: it
    moves with Python's string hash seed, with what the process did
    before, and with the machine's load (at RANSAC seed 0, 0.18 % or
    3.06 % of the extent: ``scripts/mp4_cpu.py ate jax``, six at once; the
    port's, 0.30 %, moves with none of them).  So the reference is the
    median of the JAX package's seeds 0-2, run in a process of its own
    with ``PYTHONHASHSEED=0``."""
    slam_main_against_jax(tmp_path, "mp4v", "mp4")


def slam_main_against_jax(tmp_path, fourcc: str, ext: str) -> None:
    """``slam_main`` on 14 frames at 540x960 written by cv2's ``fourcc``
    writer into a .``ext`` file: the port's frames equal the JAX package's
    (cv2's) bit for bit, the cameras as many as each of the JAX package's
    RANSAC seeds 0-2 give, the ATE within 0.02 of the extent of their
    median (run in a process of its own with ``PYTHONHASHSEED=0``)."""
    import os
    import subprocess
    import types

    from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
    from slam_indoor_code_tpu_torch import app as tapp
    from slam_indoor_code_tpu_torch import config as tconfig
    from test_torch_video import _cfg, _rel_ate

    scene = make_scene(n_points=700, n_frames=14, image_size=(540, 960),
                       seed=5, baseline=0.3)
    path = tmp_path / f"seq.{ext}"
    write_cv2_video(path, [scene.render(i) for i in range(14)], fourcc)
    f_j = list(JMediaSource(video_path=str(path), use_photos=False))
    f_t = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(f_t) == len(f_j) == 14
    for a, b in zip(f_t, f_j):
        np.testing.assert_array_equal(a, b)
    for d in ("jax", "torch"):
        (tmp_path / d).mkdir()
    np.save(tmp_path / "jax" / "K.npy", scene.K)
    here = pathlib.Path(__file__).resolve().parent
    res = subprocess.run(
        [sys.executable, "-c", _JAX_VIDEO_RUNS, str(path),
         str(tmp_path / "jax")], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONHASHSEED="0",
                 PYTHONPATH=os.pathsep.join([str(here.parent), str(here)])))
    assert res.returncode == 0, res.stderr[-3000:]
    runs = [types.SimpleNamespace(**np.load(tmp_path / "jax" / f"gd{k}.npz"))
            for k in range(3)]
    gd_t = tapp.slam_main(_cfg(tconfig, path, tmp_path / "torch"), scene.K,
                          device="cpu")
    assert {len(g.rotations) for g in runs} == {len(gd_t.rotations)}
    assert len(gd_t.rotations) >= 10
    rel_t = _rel_ate(scene, gd_t)
    rel_j = float(np.median([_rel_ate(scene, g) for g in runs]))
    assert rel_t < 0.08 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)


def test_calibrate_from_mp4v_against_jax(tmp_path, monkeypatch):
    """tests/test_torch_chessboard.py's video calibration on an mp4v file
    of the same eight board renders, each ten times: both packages recover
    K within 2 % of the truth, and within 1e-3 (relative) of each other."""
    calibrate_against_jax(tmp_path, monkeypatch, "mp4v", "mp4")


def calibrate_against_jax(tmp_path, monkeypatch, fourcc: str,
                          ext: str) -> None:
    """The video calibration on eight board renders, each ten times, in a
    .``ext`` file of cv2's ``fourcc`` writer: the port's and the JAX
    package's K within 2 % of the truth and within 1e-3 (relative) of
    each other."""
    from slam_indoor_code_tpu.calibration.chessboard import \
        main_calibration_entry_point as jentry
    from slam_indoor_code_tpu.config import Config as JConfig
    from slam_indoor_code_tpu.config import TpuConfig
    from slam_indoor_code_tpu_torch import app as tapp
    from slam_indoor_code_tpu_torch import config as tconfig
    from slam_indoor_code_tpu_torch.calibration import chessboard as tcb
    from test_torch_chessboard import _spy_calibrate, _video_views

    K_gt, views = _video_views()
    path = str(tmp_path / f"calib.{ext}")
    write_cv2_video(path, [np.repeat(v[..., None], 3, axis=2)
                           for v in views for _ in range(10)], fourcc)
    cfg = tconfig.Config(usePhotosCycle=False, calibrate=True,
                         videoSourcePath=path,
                         calibrationPath=str(tmp_path / "cam.xml"),
                         outputDataDir=str(tmp_path))
    got = _spy_calibrate(monkeypatch, tcb)
    tapp.run_from_config(cfg, device="cpu")
    K = got[0][0]
    jK, _, _ = jentry(JConfig(
        usePhotosCycle=False, videoSourcePath=path,
        calibrationPath=str(tmp_path / "jcam.xml"), calibrate=True,
        outputDataDir=str(tmp_path), tpu=TpuConfig()))
    for k in (K, jK):
        np.testing.assert_allclose(np.diag(k)[:2], np.diag(K_gt)[:2],
                                   rtol=0.02)
        np.testing.assert_allclose(k[:2, 2], K_gt[:2, 2], rtol=0.02)
    np.testing.assert_allclose(K, jK, rtol=1e-3, atol=0)


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    write_fixture()
