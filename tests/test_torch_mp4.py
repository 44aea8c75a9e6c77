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
them); refusals (an ``avc1`` sample entry, a VP9 WebM, a VOL header
asking for interlace) and the Advanced Simple tools a VOL or VOP header
switches on (low_delay 0, quarter-pel, MPEG quantisation, a B-VOP) held
to cv2 (tests/test_torch_mpeg4_asp.py holds each ASP tool to it);
truncated files and a not-coded VOP as cv2 reads them; and, end to
end, ``slam_main`` on a 540x960 ``mp4v`` file and the video calibration on
an ``mp4v`` file of board renders against the JAX package reading the same
files through cv2.

Rewrite the fixtures with ``PYTHONPATH=. python tests/test_torch_mp4.py
--write-fixture`` (needs cv2's FFmpeg ``mp4v`` writer and the libavcodec
its wheel carries), and the small ones the card also holds (video
packets, an Xvid-tagged stream, odd heights, uncompressed AVIs, MJPEG in
MOV) with ``--write-small-fixtures``; each also rewrites its MPEG-4 ASP
counterparts (tests/test_torch_mpeg4_asp.py)."""

import hashlib
import json
import pathlib
import re
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


def cv2_rgb_one_thread(path):
    """``cv2_rgb`` with FFmpeg's decoder on one thread
    (``CAP_PROP_N_THREADS`` 1): the reference for damaged streams, whose
    frames FFmpeg's threads make vary from one read to the next (the
    damaged slices of FFV1, the concealed VOPs of MPEG-4); undamaged, it
    gives what the default read gives."""
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_N_THREADS, 1])
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
    """The Y planes of the frames the port shows, in display order (as
    ``MediaSource`` gives their RGB)."""
    dec = mpeg4.Decoder(video.extradata, video.fourcc)
    out = []
    for i, f in enumerate(video.frames):
        planes = dec.decode_yuv(video.read(f), i)
        if dec.failed:
            return out
        if planes is not None and video.frames[dec.tag][2]:
            out.append(planes[0])
    planes = dec.flush_yuv()
    if planes is not None and video.frames[dec.tag][2]:
        out.append(planes[0])
    return out


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
    """vop_time_increment's width from a VOL."""
    return mjpeg.vop_time_bits(extradata)


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


# the pixel formats lavc_encode gives an encoder besides yuv420p:
# (chroma shifts) of the planar YCbCr ones
LAVC_YUV = {"yuv422p": (1, 0), "yuv444p": (0, 0), "yuv411p": (2, 0),
            "yuv410p": (2, 2), "yuv440p": (0, 1)}
LAVC_PIX_FMTS = ("yuv420p", *LAVC_YUV, "gray", "rgb24", "bgra", "gbrp",
                 "yuv420p10le", "bayer_rggb8")


def lavc_planes(rgb: np.ndarray, pix_fmt: str) -> list:
    """The planes (2-D uint8 arrays: each row the bytes of a row) an
    AVFrame of ``pix_fmt`` holds for ``rgb``: YCbCr from cv2's full-range
    YCrCb subsampled by taking every n-th sample (the content of a
    lossless test), gray, packed RGB24 or BGRA (alpha a gradient), planar
    G, B, R, 10-bit 4:2:0 (each 8-bit sample times 4, little-endian) or an
    RGGB Bayer mosaic."""
    h, w = rgb.shape[:2]
    if pix_fmt == "gray":
        return [cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)]
    if pix_fmt == "rgb24":
        return [rgb.reshape(h, w * 3)]
    if pix_fmt == "bgra":
        alpha = (np.arange(w * h) % 251).astype(np.uint8).reshape(h, w, 1)
        return [np.concatenate([rgb[..., ::-1], alpha], -1).reshape(h, w * 4)]
    if pix_fmt == "gbrp":
        return [rgb[..., 1], rgb[..., 2], rgb[..., 0]]
    if pix_fmt == "bayer_rggb8":
        out = rgb[..., 1].copy()
        out[0::2, 0::2] = rgb[0::2, 0::2, 0]
        out[1::2, 1::2] = rgb[1::2, 1::2, 2]
        return [out]
    ycc = cv2.cvtColor(rgb, cv2.COLOR_RGB2YCrCb)
    y, cr, cb = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    if pix_fmt == "yuv420p10le":
        return [(p.astype("<u2") * 4).view(np.uint8).reshape(p.shape[0], -1)
                for p in (y, cb[::2, ::2], cr[::2, ::2])]
    hs, vs = LAVC_YUV[pix_fmt]
    return [y, cb[::1 << vs, ::1 << hs], cr[::1 << vs, ::1 << hs]]


def lavc_encode(codec_name: str, frames, options: dict,
                stats_in: bytes = None, pts: bool = True,
                matrices: tuple = None, pix_fmt: str = "yuv420p"):
    """``frames`` (RGB) coded by encoder ``codec_name`` of the
    libavcodec that cv2's wheel carries, through ctypes, with encoder
    ``options`` (AVOptions) that cv2's writer does not pass: (the coded
    packets, the codec context).  The frames reach the encoder as
    ``pix_fmt``: yuv420p (cv2's I420), or one of ``LAVC_PIX_FMTS`` through
    ``lavc_planes``.  ``stats_in`` is a first pass's
    statistics (``pass1_stats``) for a second pass.  With ``pts`` the
    frames are stamped 0, 1, 2, ...  ``matrices`` (intra, inter: 64
    values each in raster order, or None) are the quantisation matrices
    of an MPEG-quantised stream (``mpeg_quant``), which the encoder sends
    in its VOL."""
    import ctypes
    import glob

    assert pix_fmt in LAVC_PIX_FMTS, pix_fmt
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
            (avu, "av_get_pix_fmt", ctypes.c_int, [ctypes.c_char_p]),
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
    for k, v in {"video_size": f"{w}x{h}", "pixel_format": pix_fmt,
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
    if matrices is not None:
        # AVCodecContext's intra_matrix and inter_matrix: the pointers
        # after mb_decision (AVOption "mbd"); the context keeps them
        keep_m = [None if m is None else (ctypes.c_uint16 * 64)(*m)
                  for m in matrices]
        opt = avu.av_opt_find(ctx, b"mbd", None, 0, 0)
        off = (ctypes.c_int.from_address(opt + 16).value + 4 + 7) & ~7
        for k, m in enumerate(keep_m):
            if m is not None:
                ctypes.c_void_p.from_address(ctx + off + 8 * k).value = \
                    ctypes.addressof(m)
    assert avc.avcodec_open2(ctx, codec, None) == 0
    frame = avu.av_frame_alloc()
    # AVFrame: data[8], linesize[8], extended_data, width, height,
    # nb_samples, format, ..., pts at 136
    dims = (ctypes.c_int * 4).from_address(frame + 104)
    dims[0], dims[1] = w, h
    dims[3] = avu.av_get_pix_fmt(pix_fmt.encode())
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
        if pix_fmt == "yuv420p":
            f = np.pad(f, ((0, H - h), (0, W - w), (0, 0)), mode="edge")
            i420 = cv2.cvtColor(np.ascontiguousarray(f),
                                cv2.COLOR_RGB2YUV_I420).ravel()
            n = H * W // 4
            planes = (i420[:H * W].reshape(H, W)[:h, :w],
                      i420[H * W:H * W + n].reshape(H // 2, W // 2),
                      i420[H * W + n:].reshape(H // 2, W // 2))
        else:
            planes = lavc_planes(np.ascontiguousarray(f), pix_fmt)
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


def swscale_rgb(y, u, v, chroma_left=False):
    """RGB of I420 planes through sws_scale yuv420p -> bgr24 at the same
    size with SWS_BICUBIC, the libswscale cv2's wheel carries, called
    through ctypes: what OpenCV's FFmpeg backend returns for a frame whose
    decoder reports these planes (``chroma_left``: chroma sited left, as
    FFmpeg's MPEG-4 decoder reports it)."""
    import ctypes
    import glob

    libs = pathlib.Path(cv2.__file__).resolve().parent.parent / \
        "opencv_python.libs"
    avu = ctypes.CDLL(glob.glob(str(libs / "libavutil*"))[0],
                      mode=ctypes.RTLD_GLOBAL)
    sws = ctypes.CDLL(glob.glob(str(libs / "libswscale*"))[0],
                      mode=ctypes.RTLD_GLOBAL)
    vp = ctypes.c_void_p
    sws.sws_alloc_context.restype = vp
    sws.sws_init_context.argtypes = [vp, vp, vp]
    sws.sws_scale.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
    sws.sws_freeContext.argtypes = [vp]
    avu.av_opt_set_int.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int]
    h, w = y.shape
    ctx = sws.sws_alloc_context()
    for k, val in (("srcw", w), ("srch", h), ("src_format", 0),  # yuv420p
                   ("dstw", w), ("dsth", h), ("dst_format", 3),  # bgr24
                   ("sws_flags", 4),                             # bicubic
                   ("src_h_chr_pos", 0 if chroma_left else -513)):
        assert avu.av_opt_set_int(ctx, k.encode(), val, 0) >= 0, k
    assert sws.sws_init_context(ctx, None, None) >= 0
    planes = [np.ascontiguousarray(p) for p in (y, u, v)]
    src = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes], 0)
    stride = (ctypes.c_int * 4)(*[p.strides[0] for p in planes], 0)
    out = np.zeros((h, w * 3 + 32), np.uint8)      # room to write past w
    dst = (ctypes.c_void_p * 4)(out.ctypes.data, 0, 0, 0)
    dstride = (ctypes.c_int * 4)(out.strides[0], 0, 0, 0)
    assert sws.sws_scale(ctx, src, stride, 0, h, dst, dstride) == h
    sws.sws_freeContext(ctx)
    return np.ascontiguousarray(out[:, :w * 3].reshape(h, w, 3)[..., ::-1])


def lavc_extradata(lib_ctx) -> bytes:
    """The extradata a ``lavc_encode`` left in its codec context (an FFV1
    configuration record, HuffYUV's tables): AVCodecContext's extradata
    pointer and size, the fields after flags2 (AVOption "flags2")."""
    import ctypes

    avu, ctx = lib_ctx
    opt = avu.av_opt_find(ctx, b"flags2", None, 0, 0)
    off = (ctypes.c_int.from_address(opt + 16).value + 4 + 7) & ~7
    ptr = ctypes.c_void_p.from_address(ctx + off).value
    size = ctypes.c_int.from_address(ctx + off + 8).value
    return ctypes.string_at(ptr, size) if ptr and size > 0 else b""


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
    table = json.loads(DIGESTS.read_text()) if DIGESTS.exists() else {}
    for path in (FIXTURE, FIXTURE_AQ):
        rgb = cv2_rgb(path)
        luma = cv2_luma(path, rgb[0].shape[:2])
        table[path.name] = {"frames": len(rgb), "shape": list(rgb[0].shape),
                            "rgb_sha256": [_sha(f) for f in rgb],
                            "y_sha256": [_sha(f) for f in luma]}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")
    import test_torch_mpeg4_asp

    test_torch_mpeg4_asp.write_headline()   # the ASP one


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


# ------------------------------------------------------------ video packets
@pytest.mark.parametrize("hw", [(96, 128), (240, 320)])
@pytest.mark.parametrize("ps", [200, 600])
def test_resync_marker_streams_equal_cv2(tmp_path, scene_frames, hw, ps):
    """libavcodec's ``mpeg4`` with ``ps`` (a video packet, led by a resync
    marker, every ``ps`` bytes or so), 12 frames with I-VOPs at 0 and 12
    (``g`` 12) in an FMP4 AVI: cv2's frame count and pixels bit for bit in
    RGB and Y, never a run of zero frames; the stream holds markers in
    both I- and P-VOPs."""
    frames = [np.ascontiguousarray(cv2.resize(f, hw[::-1]))
              for f in scene_frames[:12]]
    samples = _lavc_mpeg4(frames, {"ps": str(ps)})
    path = tmp_path / "packets.avi"
    mjpeg.write_avi(str(path), samples, hw[1], hw[0], fourcc=b"FMP4")
    kinds = _vop_kinds(samples, _vol_time_bits(samples[0]))
    assert kinds[0][0] == 0 and {k[0] for k in kinds[1:]} == {1}
    # a resync marker: byte-aligned zeros (16 in an I-VOP, 15 + fcode in
    # a P-VOP), then a one
    vop = samples[0].index(b"\x00\x00\x01\xb6")
    assert len(re.findall(b"\x00\x00[\x80-\xff]", samples[0][vop:])) >= 2
    assert sum(len(re.findall(b"\x00\x00[\x02-\xff]", s))
               for s in samples[1:]) >= 10
    _check_equal_cv2(path, hw, 12)


def _with_header_extension(sample: bytes, time_bits: int,
                           mb_count: int) -> bytes:
    """The VOP in ``sample`` with each video packet header's
    header_extension_code set and the fields it repeats written after it
    (modulo_time_base, vop_time_increment, vop_coding_type,
    intra_dc_vlc_thr, vop_fcode_forward), the stuffing before each
    resync marker and at the end recomputed."""
    bits = "".join(f"{b:08b}" for b in sample)
    vop = bits.index("0" * 23 + "1" + "10110110")
    q = vop + 32
    vtype = int(bits[q:q + 2], 2)
    q += 2
    while bits[q] == "1":                       # modulo_time_base
        q += 1
    q += 1 + 1 + time_bits + 1                  # 0, marker, time, marker
    assert bits[q] == "1"                       # vop_coded
    q += 1 + (vtype == 1)                       # rounding type
    dc_thr = bits[q:q + 3]
    q += 3 + 5                                  # quant
    fcode = int(bits[q:q + 3], 2) if vtype == 1 else 1
    prefix = 16 if vtype == 0 else 15 + fcode
    mb_bits = (mb_count - 1).bit_length()
    marks = [p for p in range(-(-q // 8) * 8, len(bits) - prefix, 8)
             if bits[p:p + prefix + 1] == "0" * prefix + "1"]
    ext = ("1" + "0" + "1" + "0" * time_bits + "1" + f"{vtype:02b}" + dc_thr
           + (f"{fcode:03b}" if vtype == 1 else ""))

    def aligned(b):
        return b + "0" + "1" * (7 - len(b) % 8)

    out, start = "", 0
    for p in marks + [len(bits)]:
        body = bits[start:p]
        body = body[:body.rindex("0")]          # drop the stuffing
        out = aligned(out + body)
        if p == len(bits):
            break
        h = p + prefix + 1 + mb_bits + 5       # the header's HEC bit
        assert bits[h] == "0"
        out += bits[p:h] + ext
        start = h + 1
    return int(out, 2).to_bytes(len(out) // 8, "big")


def test_resync_marker_packet_header_extension(tmp_path, scene_frames):
    """Video packets whose headers repeat the VOP header
    (header_extension_code 1: libavcodec never writes it, so it is written
    here into a ``ps`` 200 stream, in I- and P-VOPs): the repeated fields
    are read past, as FFmpeg reads past them, and the frames equal cv2's."""
    frames = [np.ascontiguousarray(cv2.resize(f, (160, 96)))
              for f in scene_frames[:6]]
    samples = _lavc_mpeg4(frames, {"ps": "200"})
    time_bits = _vol_time_bits(samples[0])
    edited = [_with_header_extension(s, time_bits, 10 * 6) for s in samples]
    assert all(len(e) > len(s) for e, s in zip(edited, samples))
    path = tmp_path / "hec.avi"
    mjpeg.write_avi(str(path), edited, 160, 96, fourcc=b"FMP4")
    _check_equal_cv2(path, (96, 160), 6)


def test_data_partitioned_packets_raise_naming_the_tool(tmp_path,
                                                        scene_frames):
    """Video packets with data partitioning (libavcodec's
    ``data_partitioning``), which the port now decodes: every frame equal
    to cv2's, each VOP's packets read in their partitions
    (tests/test_torch_mpeg4_dp.py holds the tool in full)."""
    frames = [np.ascontiguousarray(cv2.resize(f, (128, 96)))
              for f in scene_frames[:3]]
    samples = _lavc_mpeg4(frames, {"ps": "200", "data_partitioning": "1"})
    path = tmp_path / "dp.avi"
    mjpeg.write_avi(str(path), samples, 128, 96, fourcc=b"FMP4")
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    dec = mpeg4.Decoder(b"", b"FMP4")
    for sample in samples:
        dec.decode(sample)
    assert dec.stats()["partitioned_packets"] >= 3


# ----------------------------------------------------------------- Xvid IDCT
def _with_user_data(sample: bytes, user: bytes) -> bytes:
    """The first sample with its user data (``Lavc...``), if any, replaced
    by ``user`` (a whole user-data start code and text, or nothing)."""
    if b"\x00\x00\x01\xb2" not in sample:
        return sample
    i = sample.index(b"\x00\x00\x01\xb2")
    j = sample.index(b"\x00\x00\x01", i + 4)
    return sample[:i] + user + sample[j:]


@pytest.mark.parametrize("user,fourcc,xvid", [
    (b"", b"XVID", True),                           # Xvid fourcc, no user data
    (b"\x00\x00\x01\xb2XviD0050", b"XVID", True),   # Xvid's own user data
    (b"\x00\x00\x01\xb2XviD0050", b"FMP4", True),
    (b"\x00\x00\x01\xb2DivX503b1393p", b"XVID", False),
    (b"", b"DIVX", False),
    (b"", b"FMP4", False),
    (None, b"XVID", False),                         # cv2's own Lavc user data
])
def test_xvid_streams_take_the_xvid_idct(tmp_path, scene_frames, user,
                                         fourcc, xvid):
    """FFmpeg's rule: a stream with ``XviD`` user data, or an Xvid fourcc
    and no encoder's user data, is decoded with the Xvid IDCT, any other
    with the simple IDCT.  An XVID AVI from cv2's writer (176x144, 8
    frames) with its ``Lavc`` user data removed or replaced: every frame
    equals cv2's bit for bit (the simple IDCT left them 3-5 grey levels
    off in the Xvid cases), in RGB and Y."""
    frames = [np.ascontiguousarray(cv2.resize(f, (176, 144)))
              for f in scene_frames[:8]]
    src = tmp_path / "src.avi"
    write_cv2_video(src, frames, "XVID")
    video = avi.AviVideo(str(src))
    samples = [video.read(f) for f in video.frames]
    video.close()
    assert b"Lavc" in samples[0]
    if user is not None:
        samples[0] = _with_user_data(samples[0], user)
    path = tmp_path / "tagged.avi"
    mjpeg.write_avi(str(path), samples, 176, 144, fourcc=fourcc)
    _check_equal_cv2(path, (144, 176), 8)
    if xvid:       # the simple IDCT's frames are not cv2's
        simple = tmp_path / "simple.avi"
        mjpeg.write_avi(str(simple), [_with_user_data(samples[0], b"")]
                        + samples[1:], 176, 144, fourcc=b"FMP4")
        want = cv2_rgb(path)
        got = list(MediaSource(video_path=str(simple), use_photos=False))
        assert max(np.abs(a.astype(int) - b).max()
                   for a, b in zip(got, want)) >= 2


# ---------------------------------------------------------- odd frame height
@pytest.mark.parametrize("hw", [(37, 54), (95, 161), (201, 36), (37, 53),
                                (1079, 1920)])
def test_odd_height_rgb_equals_cv2_and_swscale(tmp_path, scene_frames, hw):
    """An odd frame height (libavcodec's ``mpeg4`` by ctypes; cv2's writers
    make none): swscale takes its scaling path (bicubic chroma, sited left
    as FFmpeg reports MPEG-4's; at an odd width also full horizontal
    chroma), and every frame equals cv2's RGB bit for bit, and sws_scale's
    on the port's own planes."""
    n = 2 if hw[0] > 500 else 4
    frames = [np.ascontiguousarray(cv2.resize(f, hw[::-1]))
              for f in scene_frames[:n]]
    samples = _lavc_mpeg4(frames, {})
    path = tmp_path / "odd.avi"
    mjpeg.write_avi(str(path), samples, hw[1], hw[0], fourcc=b"FMP4")
    _check_equal_cv2(path, hw, n)
    rgb, yuv = mpeg4.Decoder(b"", b"FMP4"), mpeg4.Decoder(b"", b"FMP4")
    for s in samples:
        np.testing.assert_array_equal(
            rgb.decode(s), swscale_rgb(*yuv.decode_yuv(s), chroma_left=True))


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
    in band in an XVID AVI (its first four samples), each read into
    samples coded without it: low_delay 0 (the one-frame delay of a stream
    with B-VOPs), quarter-pel and MPEG quantisation: every frame equals
    cv2's.  Interlace, which the port now decodes: each VOP header is read
    with top_field_first and alternate_vertical_scan_flag, which these
    samples lack, so every VOP decodes as damage, which libavcodec
    conceals its own way (and cv2 returns uninitialised memory for frames
    FFmpeg flags interlaced): the port gives libavcodec's own decode's
    (``lavc_decode``) frame count, concealing each VOP
    (tests/test_torch_mpeg4_interlace.py holds interlaced coding in
    full)."""
    video = mp4.Mp4Video(str(FIXTURE))
    extra = _swap_vol(video.extradata, vol(**fields))
    samples = [video.read(f) for f in video.frames[:4]]
    video.close()
    path = tmp_path / "tool.mp4"
    _with_entry(FIXTURE, path,
                lambda k, f, kids: _box(k, f + _esds(extra)))
    avi_path = tmp_path / "tool.avi"
    mjpeg.write_avi(str(avi_path), [extra + samples[0]] + samples[1:], 1920,
                    1080, fourcc=b"XVID")
    if tool == "interlace":
        from test_torch_mpeg2 import lavc_decode

        for p, data in ((path, [extra + samples[0]] + samples[1:]),
                        (avi_path, [extra + samples[0]] + samples[1:4])):
            if p == path:
                video = mp4.Mp4Video(str(FIXTURE))
                data = [extra + video.read(video.frames[0])] + [
                    video.read(f) for f in video.frames[1:]]
                video.close()
            want = lavc_decode(data, codec="mpeg4")
            got = list(MediaSource(video_path=str(p), use_photos=False))
            assert len(got) == len(want) == len(data)
            assert all(f.shape == (1080, 1920, 3) for f in got)
            dec = mpeg4.Decoder(b"", b"XVID")
            for sample in data:
                dec.decode(sample)
            assert dec.stats()["concealed_vops"] == len(data)
            assert dec.stats()["interlaced_vops"] == len(data)
        return
    for p, n in ((path, 32), (avi_path, 4)):
        want = cv2_rgb(p)
        got = list(MediaSource(video_path=str(p), use_photos=False))
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


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
    """B-VOPs, which the port now decodes: a P-VOP of cv2's mp4v stream
    turned into a B-VOP by its coding type, whose time does not lie
    between its references' (FFmpeg skips such a B-VOP: five frames), and
    libavcodec's ``bf`` 1 stream (display order, one frame late): every
    frame equals cv2's, in RGB and Y."""
    frames = [np.ascontiguousarray(cv2.resize(f, (64, 48)))
              for f in scene_frames[:6]]
    path = tmp_path / "b.mp4"
    write_cv2_video(path, frames, "mp4v")
    samples = xvid_avi_from_mp4(path, tmp_path / "p.avi")
    heads = [s.index(b"\0\0\1\xb6") + 4 for s in samples]
    k = next(k for k in range(2, 6) if samples[k][heads[k]] >> 6 == 1)
    p, i = samples[k], heads[k]                   # a P-VOP after two VOPs
    samples[k] = p[:i] + bytes([p[i] ^ 0xC0]) + p[i + 1:]
    flipped = tmp_path / "flipped.avi"
    mjpeg.write_avi(str(flipped), samples, 64, 48, fourcc=b"XVID")
    _check_equal_cv2(flipped, (48, 64), 5)
    bf = tmp_path / "bf.avi"
    mjpeg.write_avi(str(bf), lavc_encode("mpeg4", frames, {"bf": "1"})[0],
                    64, 48, fourcc=b"XVID")
    _check_equal_cv2(bf, (48, 64), 6)


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
    """A WebM file in a codec the port does not decode: cv2's ``VP90``
    writer's file (read now, tests/test_torch_vp9.py) with its track's
    CodecID turned to ``V_AV1``: NotImplementedError naming the codec."""
    path = tmp_path / "v.webm"
    write_cv2_video(path, [cv2.resize(f, (64, 48)) for f in scene_frames[:2]],
                    "VP90")
    assert len(cv2_rgb(path)) == 2
    data = path.read_bytes()
    assert data.count(b"V_VP9") == 1
    path.write_bytes(data.replace(b"V_VP9", b"V_AV1"))
    with pytest.raises(NotImplementedError, match="AV1"):
        MediaSource(video_path=str(path), use_photos=False)


# ------------------------------------------------------ damage, not coded

def damaged_frame_holds_to_cv2(got, want, clean, tol_mean=8.0):
    """A frame FFmpeg conceals against cv2's: equal in the macroblock rows
    more than ceil(50 / macroblocks per row) rows above the first one
    damaged (the first row where ``got`` departs from ``clean``, the port's
    decode of the undamaged stream), since FFmpeg's error concealment
    re-estimates up to 50 coded macroblocks before the damage; over the
    whole frame a mean |difference| below ``tol_mean`` grey levels."""
    h, w = got.shape[:2]
    rows = np.flatnonzero((got != clean).any(axis=(1, 2)))
    first = rows[0] // 16 if len(rows) else h // 16 + 1
    exact = 16 * max(0, first - -(-50 // -(-w // 16)))
    np.testing.assert_array_equal(got[:exact], want[:exact])
    assert np.abs(got.astype(int) - want).mean() < tol_mean


@pytest.mark.parametrize("where", ["vop_header", "mid_vop"])
def test_truncated_avi(tmp_path, scene_frames, where):
    """An XVID AVI cut inside its next-to-last chunk ends without an error
    after cv2's frame count.  Cut in the VOP header (two bytes: no VOP),
    FFmpeg fails the sample and cv2 stops at 8 frames; so does the port.
    Cut deeper, FFmpeg conceals the lost macroblocks and gives a ninth
    frame; so does the port (its lost macroblocks are the reference's), as
    ``damaged_frame_holds_to_cv2`` states.  The frames before the cut equal
    cv2's."""
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
    assert len(got) == len(want) == (8 if where == "vop_header" else 9)
    for a, b in zip(got[:8], want):
        np.testing.assert_array_equal(a, b)
    if where == "mid_vop":
        clean = list(MediaSource(video_path=str(path), use_photos=False))
        damaged_frame_holds_to_cv2(got[8], want[8], clean[8])


def _damage(data: bytes, how: str) -> bytes:
    """A frame's bytes cut to half, to 90 %, to its first two bytes, or
    with eight bytes flipped a third of the way in."""
    if how == "half":
        return data[:len(data) // 2]
    if how == "90pct":
        return data[:len(data) * 9 // 10]
    if how == "2bytes":
        return data[:2]
    d = bytearray(data)
    for i in range(len(d) // 3, len(d) // 3 + 8):
        d[i] ^= 0x55
    return bytes(d)


@pytest.mark.parametrize("how", ["half", "90pct", "2bytes", "flip"])
def test_damaged_vop_mid_stream_gives_cv2s_frame_count(tmp_path,
                                                       scene_frames, how):
    """The fifth VOP of ten in an XVID AVI at 240x320 damaged: cv2 reads
    4 frames where the damage leaves no VOP (FFmpeg fails the sample and
    its reader stops), else 10 (FFmpeg conceals); the port gives the same
    count, the frames before the damage equal, the damaged one as
    ``damaged_frame_holds_to_cv2`` states (the frames after it predict
    from it, so they are not compared).  The reference is cv2 on one
    thread (``cv2_rgb_one_thread``): with FFmpeg's frame threads the
    concealed frame varies from one read to the next; the count is the
    default read's too."""
    frames = [np.ascontiguousarray(cv2.resize(f, (320, 240)))
              for f in scene_frames[:10]]
    src = tmp_path / "full.avi"
    write_cv2_video(src, frames, "XVID")
    video = avi.AviVideo(str(src))
    samples = [video.read(f) for f in video.frames]
    video.close()
    samples[4] = _damage(samples[4], how)
    path = tmp_path / "damaged.avi"
    mjpeg.write_avi(str(path), samples, 320, 240, fourcc=b"XVID")
    want = cv2_rgb_one_thread(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == len(cv2_rgb(path)) == (
        4 if how == "2bytes" else 10)
    for a, b in zip(got[:4], want):
        np.testing.assert_array_equal(a, b)
    if how != "2bytes":
        clean = list(MediaSource(video_path=str(src), use_photos=False))
        damaged_frame_holds_to_cv2(got[4], want[4], clean[4])


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


def slam_main_against_jax(tmp_path, fourcc: str, ext: str,
                          write=None) -> None:
    """``slam_main`` on 14 frames at 540x960 written by cv2's ``fourcc``
    writer into a .``ext`` file (or by ``write(path, frames)``): the
    port's frames equal the JAX package's (cv2's) bit for bit, the cameras
    as many as each of the JAX package's RANSAC seeds 0-2 give, the ATE
    within 0.02 of the extent of their median (run in a process of its own
    with ``PYTHONHASHSEED=0``)."""
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
    frames = [scene.render(i) for i in range(14)]
    if write is None:
        write_cv2_video(path, frames, fourcc)
    else:
        write(path, frames)
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


# --------------------------------------------- small fixtures for the card
# The inputs this suite holds to cv2 that the card must decode the same
# way (it has no cv2): each file with the sha256 of cv2's RGB frames in
# cv2_sha256.json.
SMALL_FIXTURES = ("resync_fmp4.avi", "xvid_tagged.avi", "odd_vp8.webm",
                  "odd_i420.avi", "y800.avi", "mjpeg.mov")


def _small_fixture_bytes(name: str, path) -> None:
    from test_torch_webm import write_mkv

    sc = make_scene(n_points=400, n_frames=6, seed=5, baseline=0.3)
    frames = [sc.render(i) for i in range(6)]

    def sized(h, w, n):
        return [np.ascontiguousarray(cv2.resize(f, (w, h)))
                for f in frames[:n]]

    if name == "resync_fmp4.avi":          # video packets, I- and P-VOPs
        mjpeg.write_avi(str(path), _lavc_mpeg4(sized(96, 128, 6), {
            "ps": "200", "g": "3"}), 128, 96, fourcc=b"FMP4")
    elif name == "xvid_tagged.avi":        # Xvid's user data: its IDCT
        tmp = path.with_suffix(".src.avi")
        write_cv2_video(tmp, sized(144, 176, 4), "XVID")
        video = avi.AviVideo(str(tmp))
        samples = [video.read(f) for f in video.frames]
        video.close()
        tmp.unlink()
        i = samples[0].index(b"\x00\x00\x01\xb2")
        j = samples[0].index(b"\x00\x00\x01", i + 4)
        samples[0] = (samples[0][:i] + b"\x00\x00\x01\xb2XviD0050"
                      + samples[0][j:])
        mjpeg.write_avi(str(path), samples, 176, 144, fourcc=b"XVID")
    elif name == "odd_vp8.webm":           # swscale's scaling path
        write_mkv(path, lavc_encode("libvpx", sized(37, 53, 4), {})[0],
                  53, 37)
    elif name == "odd_i420.avi":           # the same, uncompressed
        rng = np.random.default_rng(16)
        raw = []
        for f in sized(37, 54, 2):
            y = cv2.cvtColor(f, cv2.COLOR_RGB2GRAY)
            c = rng.integers(64, 192, (2, 19, 27), np.uint8)
            raw.append(y.tobytes() + c.tobytes())
        mjpeg.write_avi(str(path), raw, 54, 37, fourcc=b"I420")
    elif name == "y800.avi":               # gray rows read 4-byte aligned
        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"Y800"),
                             10.0, (54, 36))
        for f in sized(36, 54, 2):
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
    elif name == "mjpeg.mov":              # Motion-JPEG in QuickTime
        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"),
                             10.0, (128, 96))
        for f in sized(96, 128, 3):
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()


def _small_fixture_cv2_rgb(path):
    """cv2's frames of a small fixture: its default backend, save the
    Motion-JPEG ones, which are libjpeg's decode of each sample."""
    if path.suffix != ".mov":
        return cv2_rgb(path)
    video = mp4.Mp4Video(str(path))
    out = [cv2.imdecode(np.frombuffer(video.read(f), np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1] for f in video.frames]
    video.close()
    return [np.ascontiguousarray(f) for f in out]


def write_small_fixtures() -> None:
    table = json.loads(DIGESTS.read_text())
    for name in SMALL_FIXTURES:
        path = FIXTURES / name
        _small_fixture_bytes(name, path)
        rgb = _small_fixture_cv2_rgb(path)
        table[name] = {"frames": len(rgb), "shape": list(rgb[0].shape),
                       "rgb_sha256": [_sha(f) for f in rgb]}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")
    import test_torch_mpeg4_asp

    test_torch_mpeg4_asp.write_small()      # the ASP ones


@pytest.mark.parametrize("name", SMALL_FIXTURES)
def test_small_fixtures_hold_cv2s_decode_and_the_port_equals_it(name):
    """The committed small fixtures (video packets, an Xvid-tagged stream,
    odd heights in VP8 and I420, Y800, Motion-JPEG in MOV): cv2's decode
    still gives the recorded sha256, and so does the port's through
    MediaSource, frame by frame (what chip_smoke.py holds the card to)."""
    table = json.loads(DIGESTS.read_text())[name]
    path = FIXTURES / name
    assert [_sha(f) for f in _small_fixture_cv2_rgb(path)
            ] == table["rgb_sha256"]
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert [_sha(f) for f in got] == table["rgb_sha256"]
    assert sum((FIXTURES / n).stat().st_size for n in SMALL_FIXTURES
               ) < 250_000


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    write_fixture()
if __name__ == "__main__" and "--write-small-fixtures" in sys.argv:
    write_small_fixtures()
