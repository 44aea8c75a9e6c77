"""The port's MPEG-1 and MPEG-2 video (io/mpeg12.py over native/mpeg12.cpp)
on the CPU, against OpenCV's default FFmpeg backend: RGB frames bit for
bit and frame for frame against ``cv2.VideoCapture(p)``, the Y plane bit
for bit against its ``CAP_PROP_CONVERT_RGB=0`` read, in cv2's frame count.
Every stream is coded here, by cv2's writers or by the ``mpeg2video`` and
``mpeg1video`` encoders of the libavcodec cv2's wheel carries through
``lavc_encode``, over a pan of a blurred-noise texture (a wrong vector
shows), mostly as raw elementary streams (``.m2v``/``.m1v``; the
containers are tests/test_torch_mpegts.py's): each encoder tool alone and
all together at 38x54, 96x128 and 480x640 (B pictures 0-3, interlaced
frame pictures with field DCT and field prediction, alternate scan, B-15
intra VLCs, non-linear quantiser scale, intra DC precision 8-11, loaded
matrices, closed and open GOPs, MPEG-1 with and without B pictures); the
colour matrices (BT.709 against SMPTE 170M, BT.470BG and untagged: cv2's
RGB uses the frame's matrix, and its Y read of a BT.709 frame goes
through RGB, ``swscale_y_read``); ``repeat_first_field``,
``top_field_first`` and ``progressive_frame`` written into the headers by
hand; odd sizes (swscale's scaling path, chroma sited at the centre for
MPEG-1 and left for MPEG-2); a stream joined mid-way; damaged and cut
pictures (cv2's count, ``damaged_frame_holds_to_cv2``); the tools refused
by name; the committed fixtures against their recorded sha256
(``slam_main`` on an MPEG-2 ``.ts`` against the JAX package's is
tests/test_torch_mpegts.py's).

cv2 (OpenCV 5.0.0, FFmpeg 8) returns uninitialised memory for every frame
FFmpeg flags interlaced (``progressive_frame`` 0 in an interlaced
sequence, what ``flags=+ildct+ilme`` writes): its swscale call fails for
them.  Interlaced coding is therefore held to cv2 with
``progressive_frame`` set to 1 by hand, which changes nothing in the
decoding, and the unchanged stream to libavcodec's own decode through
ctypes (``lavc_decode``).

Rewrite the fixtures with ``PYTHONPATH=.:tests python
tests/test_torch_mpeg2.py --write-fixtures`` (~15 s)."""

import ctypes
import glob
import hashlib
import json
import pathlib
import sys

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, mpeg12
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg, mpegmux
from test_torch_mp4 import (FIXTURE as MP4_FIXTURE, _damage, cv2_rgb,
                            damaged_frame_holds_to_cv2, lavc_encode,
                            write_cv2_video)
from test_torch_vp9 import pan

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures"
FIXTURE = FIXTURES / "headline_mpeg2.ts"
DIGESTS = FIXTURES / "cv2_sha256.json"
# cv2's mpg1 and MPEG writers in each container; an M2TS; a VOB-like
# interlaced PAL program stream; a transport stream cut mid-GOP
SMALL_FIXTURES = ("mpeg1_cv2.mpg", "mpeg2_cv2.mpg", "mpeg2_cv2.avi",
                  "mpeg2_cv2.mkv", "mpeg2_cv2.mp4", "mpeg1_cv2.mov",
                  "mpeg2_bt709.m2ts", "mpeg2_pal.vob", "mpeg2_cut.ts")
# the headline: a broadcast/HDV-like interlaced encode
HEADLINE_OPTIONS = {"bf": "2", "g": "12", "flags": "+ildct+ilme",
                    "qmin": "8", "qmax": "8", "alternate_scan": "1",
                    "intra_vlc": "1", "non_linear_quant": "1",
                    "dc": "10", "colorspace": "bt709",
                    "color_primaries": "bt709", "color_trc": "bt709",
                    "seq_disp_ext": "always", "time_base": "1/25"}
LIBS = pathlib.Path(cv2.__file__).resolve().parent.parent / \
    "opencv_python.libs"


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# ------------------------------------------------------------- streams

def encode(frames, options: dict, mpeg1: bool = False,
           matrices=None) -> list:
    """``frames`` coded by libavcodec's mpeg2video (``mpeg1``:
    mpeg1video, which needs one of MPEG-1's frame rates: 25 fps), one
    packet per picture."""
    base = {"time_base": "1/25"} if mpeg1 else {}
    return lavc_encode("mpeg1video" if mpeg1 else "mpeg2video", frames,
                       {**base, **options}, matrices=matrices)[0]


def progressive(es: bytes) -> bytes:
    """``es`` with progressive_frame set to 1 in every picture: decoded
    the same, but not flagged interlaced, so that cv2 converts it."""
    return mpegmux.set_picture_coding(es, progressive_frame=1)


def write_es(path, packets, prog: bool = True) -> pathlib.Path:
    es = b"".join(packets)
    path = pathlib.Path(path)
    path.write_bytes(progressive(es) if prog else es)
    return path


def cv2_luma(path):
    """cv2's Y read (``CAP_PROP_CONVERT_RGB=0``), whole planes."""
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_CONVERT_RGB, 0])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f.reshape(f.shape[:2]))


def port_planes(path):
    """The (Y, U, V) planes of the frames the port gives, in display order
    (as ``MediaSource`` gives their RGB), with the colour matrix of the
    stream."""
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
    matrix = dec.stats()["matrix_coefficients"]
    dec.close()
    video.close()
    return out, matrix


def decoder_stats(path) -> dict:
    video = avi.open_video(str(path))
    dec = mpeg12.Decoder(video.extradata, video.width, video.height)
    for i, f in enumerate(video.frames):
        dec.decode_yuv(video.read(f), i)
        if dec.failed:
            break
    else:
        dec.flush_yuv()
    video.close()
    return dec.stats()


def swscale_y_read(y, u, v, colorspace: int) -> np.ndarray:
    """cv2's ``CAP_PROP_CONVERT_RGB=0`` read of a frame FFmpeg tags
    ``colorspace`` (AVColorSpace): OpenCV asks libswscale (through
    ctypes, the wheel's own) for yuv420p with the frame's matrix as source
    and the default one as destination; where they differ, swscale goes
    through bgr24 (its cascaded context), which moves Y.  The Y plane."""
    ctypes.CDLL(glob.glob(str(LIBS / "libavutil*"))[0],
                mode=ctypes.RTLD_GLOBAL)
    sws = ctypes.CDLL(glob.glob(str(LIBS / "libswscale*"))[0],
                      mode=ctypes.RTLD_GLOBAL)
    vp = ctypes.c_void_p
    sws.sws_getContext.restype = vp
    sws.sws_getContext.argtypes = [ctypes.c_int] * 7 + [vp, vp, vp]
    sws.sws_getCoefficients.restype = vp
    sws.sws_getCoefficients.argtypes = [ctypes.c_int]
    sws.sws_setColorspaceDetails.argtypes = [vp, vp, ctypes.c_int, vp,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int]
    sws.sws_scale.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
    sws.sws_freeContext.argtypes = [vp]
    h, w = y.shape
    ctx = sws.sws_getContext(w, h, 0, w, h, 0, 4, None, None, None)
    sws.sws_setColorspaceDetails(ctx, sws.sws_getCoefficients(colorspace), 0,
                                 sws.sws_getCoefficients(2), 0, 0, 1 << 16,
                                 1 << 16)
    planes = [np.ascontiguousarray(p) for p in (y, u, v)]
    src = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes], 0)
    stride = (ctypes.c_int * 4)(*[p.strides[0] for p in planes], 0)
    outs = [np.zeros((h, w + 64), np.uint8),
            np.zeros(((h + 1) // 2, (w + 1) // 2 + 64), np.uint8)]
    outs.append(np.zeros_like(outs[1]))
    dst = (ctypes.c_void_p * 4)(*[o.ctypes.data for o in outs], 0)
    dstride = (ctypes.c_int * 4)(*[o.strides[0] for o in outs], 0)
    assert sws.sws_scale(ctx, src, stride, 0, h, dst, dstride) == h
    sws.sws_freeContext(ctx)
    return np.ascontiguousarray(outs[0][:, :w])


def lavc_decode(packets, codec: str = "mpeg2video") -> list:
    """libavcodec's own decode of ``packets`` (one picture each) through
    ctypes: the (Y, U, V) planes of each frame it gives (4:2:0, or 4:2:2
    with chroma at full height), flushed at the end."""
    avu = ctypes.CDLL(glob.glob(str(LIBS / "libavutil*"))[0],
                      mode=ctypes.RTLD_GLOBAL)
    avc = ctypes.CDLL(glob.glob(str(LIBS / "libavcodec*"))[0],
                      mode=ctypes.RTLD_GLOBAL)
    vp = ctypes.c_void_p
    for lib, fn, res, args in (
            (avc, "avcodec_find_decoder_by_name", vp, [ctypes.c_char_p]),
            (avc, "avcodec_alloc_context3", vp, [vp]),
            (avc, "avcodec_open2", ctypes.c_int, [vp, vp, vp]),
            (avu, "av_frame_alloc", vp, []),
            (avc, "av_packet_alloc", vp, []),
            (avc, "av_new_packet", ctypes.c_int, [vp, ctypes.c_int]),
            (avc, "avcodec_send_packet", ctypes.c_int, [vp, vp]),
            (avc, "avcodec_receive_frame", ctypes.c_int, [vp, vp]),
            (avu, "av_frame_unref", None, [vp]),
            (avc, "av_packet_unref", None, [vp])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    codec_p = avc.avcodec_find_decoder_by_name(codec.encode())
    ctx = avc.avcodec_alloc_context3(codec_p)
    assert avc.avcodec_open2(ctx, codec_p, None) == 0
    frame, pkt, out = avu.av_frame_alloc(), avc.av_packet_alloc(), []

    def drain():
        # AVFrame: data[8], linesize[8], extended_data, width, height
        while avc.avcodec_receive_frame(ctx, frame) == 0:
            data = (ctypes.c_void_p * 8).from_address(frame)
            ls = (ctypes.c_int * 8).from_address(frame + 64)
            w = ctypes.c_int.from_address(frame + 104).value
            h = ctypes.c_int.from_address(frame + 108).value
            fmt = ctypes.c_int.from_address(frame + 116).value
            ch = h if fmt == 4 else (h + 1) // 2      # AV_PIX_FMT_YUV422P
            planes = []
            for k, (pw, ph) in enumerate(((w, h), ((w + 1) // 2, ch),
                                          ((w + 1) // 2, ch))):
                raw = ctypes.string_at(data[k], ls[k] * ph)
                planes.append(np.frombuffer(raw, np.uint8).reshape(
                    ph, ls[k])[:, :pw].copy())
            out.append(tuple(planes))
            avu.av_frame_unref(frame)

    for p in packets:
        avc.av_new_packet(pkt, len(p))
        ctypes.memmove(ctypes.c_void_p.from_address(pkt + 24).value, p,
                       len(p))
        avc.avcodec_send_packet(ctx, pkt)
        avc.av_packet_unref(pkt)
        drain()
    avc.avcodec_send_packet(ctx, None)
    drain()
    return out


def check_equal_cv2(path, n=None):
    """Every frame through MediaSource equals cv2's in RGB, every Y plane
    cv2's Y read (for a BT.709 stream, which cv2 reads through RGB,
    ``swscale_y_read`` of the port's planes, and at an even height
    ``mpeg12.luma_read`` of its RGB), in cv2's count (``n`` if given)."""
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           prefetch=3))
    assert len(got) == len(want)
    if n is not None:
        assert len(got) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    planes, matrix = port_planes(path)
    want_y = cv2_luma(path)
    assert len(planes) == len(want_y) == len(got)
    for p, b, rgb in zip(planes, want_y, got):
        if matrix == 1:     # through RGB: libswscale's own, and the port's
            np.testing.assert_array_equal(swscale_y_read(*p, 1), b)
            if not b.shape[0] & 1:
                np.testing.assert_array_equal(mpeg12.luma_read(rgb), b)
        else:
            np.testing.assert_array_equal(p[0], b)


# ---------------------------------------------------------- encoder tools

_TOOLS = {
    "bf0": ({"bf": "0"}, {}),
    "bf1": ({"bf": "1"}, {"b_pictures": 1}),
    "bf2": ({"bf": "2"}, {"b_pictures": 1}),
    "bf3": ({"bf": "3", "g": "8"}, {"b_pictures": 1}),
    "interlace": ({"bf": "2", "flags": "+ildct+ilme"},
                  {"field_dct_mbs": 1, "field_mc_mbs": 1}),
    "alternate_scan": ({"bf": "1", "alternate_scan": "1"},
                       {"alternate_scan": 1}),
    "intra_vlc": ({"bf": "1", "intra_vlc": "1", "qmin": "1", "qmax": "3"},
                  {"intra_vlc": 1}),
    "non_linear_quant": ({"bf": "2", "non_linear_quant": "1", "qmax": "28",
                          "b": "60k"}, {"non_linear_quant": 1}),
    "dc8": ({"bf": "1", "dc": "8"}, {}),
    "dc9": ({"bf": "1", "dc": "9"}, {"max_dc_precision": 1}),
    "dc10": ({"bf": "1", "dc": "10"}, {"max_dc_precision": 2}),
    "dc11": ({"bf": "1", "dc": "11", "qmin": "1", "qmax": "2"},
             {"max_dc_precision": 3}),
    "matrices": ({"bf": "2"}, {"loaded_matrices": 2}),
    "closed_gop": ({"bf": "2", "g": "6", "flags": "+cgop",
                    "sc_threshold": "1000000000"}, {"closed_gops": 2}),
    "fine_quant": ({"bf": "2", "qmin": "1", "qmax": "1"}, {}),
    "all": ({"bf": "3", "g": "7", "flags": "+ildct+ilme",
             "alternate_scan": "1", "intra_vlc": "1",
             "non_linear_quant": "1", "qmax": "28", "dc": "11"},
            {"field_mc_mbs": 1, "alternate_scan": 1, "intra_vlc": 1,
             "non_linear_quant": 1, "max_dc_precision": 3}),
    "mpeg1": ({"bf": "0"}, {"mpeg1_pictures": 1}),
    "mpeg1_bf2": ({"bf": "2", "qmin": "1", "qmax": "4"},
                  {"mpeg1_pictures": 1, "b_pictures": 1}),
    "mpeg1_matrices": ({"bf": "2"}, {"mpeg1_pictures": 1,
                                     "loaded_matrices": 2}),
}


def _matrices(seed: int = 1):
    rng = np.random.default_rng(seed)
    return ([8] + rng.integers(8, 60, 63).tolist(),
            rng.integers(10, 40, 64).tolist())


@pytest.mark.parametrize("hw", [(38, 54), (96, 128), (480, 640)])
@pytest.mark.parametrize("tool", list(_TOOLS))
def test_encoder_tools_equal_cv2(tmp_path, tool, hw):
    """Each tool of libavcodec's MPEG-1/2 encoders, and all MPEG-2 ones
    together, over a pan with some vertical motion: the decoder's
    statistics show the tool, and every frame equals cv2's in RGB and Y."""
    options, shows = _TOOLS[tool]
    mpeg1 = tool.startswith("mpeg1")
    frames = pan(8 if hw[0] > 100 else 10, *hw, dy=2, dx=3)
    packets = encode(frames, options, mpeg1,
                     _matrices() if "matrices" in tool else None)
    path = write_es(tmp_path / ("s.m1v" if mpeg1 else "s.m2v"), packets)
    check_equal_cv2(path, len(frames))
    stats = decoder_stats(path)
    for key, least in shows.items():
        assert stats[key] >= least, (key, stats)


def test_interlaced_frames_as_ffmpeg_decodes_them(tmp_path):
    """An interlaced stream as ``flags=+ildct+ilme`` writes it
    (progressive_frame 0): cv2 gives as many frames, but each is
    uninitialised memory (its swscale call fails for a frame flagged
    interlaced; two reads differ); the port gives FFmpeg's planes
    (libavcodec's decode through ctypes) and their RGB as for a
    progressive frame, equal to its decode of the stream with
    progressive_frame set to 1 (which cv2 reads as the port does)."""
    packets = encode(pan(10, 96, 128, dy=2, dx=3),
                     {"bf": "2", "flags": "+ildct+ilme"})
    raw = write_es(tmp_path / "i.m2v", packets, prog=False)
    prog = write_es(tmp_path / "p.m2v", packets)
    assert len(cv2_rgb(raw)) == 10
    planes, _ = port_planes(raw)
    ref = lavc_decode(packets)
    assert len(planes) == len(ref) == 10
    for a, b in zip(planes, ref):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
    got = list(MediaSource(video_path=str(raw), use_photos=False))
    for a, b in zip(got, list(MediaSource(video_path=str(prog),
                                          use_photos=False))):
        np.testing.assert_array_equal(a, b)
    dec = mpeg12.Decoder()
    flags = []
    for i, (o, n) in enumerate(mpeg12.split_pictures(raw.read_bytes())):
        if dec.decode(raw.read_bytes()[o:o + n], i) is not None:
            flags.append(dec.interlaced)
    assert flags and all(flags)
    assert decoder_stats(raw)["interlaced_frames"] == 10
    assert decoder_stats(prog)["interlaced_frames"] == 0
    check_equal_cv2(prog, 10)


@pytest.mark.parametrize("colorspace,matrix", [
    ("bt709", 1), ("smpte170m", 6), ("bt470bg", 5), (None, 2)])
def test_colour_matrices(tmp_path, colorspace, matrix):
    """sequence_display_extension's matrix_coefficients: BT.709 frames
    convert with BT.709's coefficients (cv2's RGB moves by up to ~8 grey
    levels from the untagged stream's; its Y read goes through RGB), and
    SMPTE 170M and BT.470BG as untagged (BT.601); each equals cv2."""
    options = {"bf": "2", "seq_disp_ext": "always"}
    if colorspace:
        options["colorspace"] = colorspace
    packets = encode(pan(6, 96, 128), options)
    path = write_es(tmp_path / "c.m2v", packets)
    check_equal_cv2(path, 6)
    assert decoder_stats(path)["matrix_coefficients"] == matrix
    plain = write_es(tmp_path / "u.m2v", encode(pan(6, 96, 128),
                                                {"bf": "2"}))
    a, b = cv2_rgb(path)[0], cv2_rgb(plain)[0]
    diff = np.abs(a.astype(int) - b).max()
    assert (diff > 2) == (matrix == 1), diff


def test_repeat_first_field_and_top_field_first_by_hand(tmp_path):
    """repeat_first_field (3:2 pulldown) and top_field_first set by hand
    in some pictures' coding extensions: each coded frame is given once,
    as cv2 gives it, and equals cv2's."""
    packets = encode(pan(12, 96, 128, dy=2), {"bf": "2"})
    es = progressive(b"".join(packets))
    es = mpegmux.set_picture_coding(es, which={1, 2, 5, 9},
                                    repeat_first_field=1, top_field_first=1)
    es = mpegmux.set_picture_coding(es, which={3, 4}, top_field_first=1)
    path = tmp_path / "rff.m2v"
    path.write_bytes(es)
    check_equal_cv2(path, 12)
    stats = decoder_stats(path)
    assert stats["repeat_first_field"] == 4
    assert stats["top_field_first"] == 6


@pytest.mark.parametrize("hw", [(37, 53), (99, 130), (51, 64), (97, 131)])
@pytest.mark.parametrize("mpeg1", [False, True])
def test_odd_sizes(tmp_path, hw, mpeg1):
    """Sizes that are not whole macroblocks, odd heights and widths
    (swscale's scaling path: chroma sited at the centre for MPEG-1 and
    left for MPEG-2, as FFmpeg reports it): equal to cv2."""
    packets = encode(pan(6, *hw, dy=1, dx=2), {"bf": "2"}, mpeg1)
    check_equal_cv2(write_es(tmp_path / "o.m2v", packets), 6)


@pytest.mark.parametrize("cut", [0.25, 0.5, 0.8])
def test_stream_joined_mid_way(tmp_path, cut):
    """An elementary stream whose start is cut off at 25/50/80 %: the
    pictures before the next sequence header give nothing, the open GOP's
    B pictures without their older reference are skipped, as FFmpeg skips
    them; the frames and their count equal cv2's."""
    packets = encode(pan(30, 96, 128, dy=1, dx=2), {"bf": "2", "g": "6"})
    es = progressive(b"".join(packets))
    path = tmp_path / "j.m2v"
    path.write_bytes(es[int(len(es) * cut):])
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert 0 < len(got) == len(want) < 30
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("how", ["half", "90pct", "2bytes", "flip"])
def test_damaged_pictures_give_cv2s_frame_count(tmp_path, index, how):
    """Picture ``index`` of ten (the I picture, the first P, a B) in an
    MPEG AVI at 240x320 damaged (cut to half, to 90 %, to its first two
    bytes, or eight bytes flipped): the port gives cv2's frame count (a
    packet FFmpeg fails gives no frame and the video goes on), the frames
    before the damage equal, and the first one that differs as
    ``damaged_frame_holds_to_cv2`` states (FFmpeg conceals the slices
    from the damage its own way; the frames after it predict from it)."""
    frames = [np.ascontiguousarray(f) for f in pan(10, 240, 320, dx=2)]
    packets = encode(frames, {"bf": "2"})
    clean_path = tmp_path / "clean.avi"
    mjpeg.write_avi(str(clean_path), packets, 320, 240, fourcc=b"MPEG")
    clean = list(MediaSource(video_path=str(clean_path), use_photos=False))
    packets[index] = _damage(packets[index], how)
    path = tmp_path / "damaged.avi"
    mjpeg.write_avi(str(path), packets, 320, 240, fourcc=b"MPEG")
    want = cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want)
    bad = [k for k, (a, b) in enumerate(zip(got, want))
           if not np.array_equal(a, b)]
    if bad:
        k = bad[0]
        damaged_frame_holds_to_cv2(got[k], want[k], clean[k])


def test_damaged_input_raises_only_the_documented_errors(tmp_path):
    """Bytes changed at random (seeded) in the pictures of an MPEG-2 and
    an MPEG-1 stream, each picture cut at random: the decoder gives
    frames or None (or ValueError naming a tool the damage asks for) and
    never crashes; transport and program streams damaged at random and
    cut at the front demux to something the decoder takes the same way,
    or raise IOError or NotImplementedError."""
    from slam_indoor_code_tpu_torch.io import mpegps, mpegts

    rng = np.random.default_rng(20)
    frames = pan(6, 96, 128, dy=2, dx=3)
    streams = ([progressive(p) for p in encode(
        frames, {"bf": "2", "flags": "+ildct+ilme"})],
        encode(frames, {"bf": "2"}, mpeg1=True))

    def decode_all(packets):
        dec = mpeg12.Decoder(b"", 128, 96)
        for p in packets:
            try:
                img = dec.decode(p)
            except ValueError:
                continue
            assert img is None or (img.dtype == np.uint8
                                   and img.shape == (96, 128, 3))
        dec.flush()

    for _ in range(60):
        packets = []
        for p in streams[int(rng.integers(0, 2))]:
            p = bytearray(p)
            for _ in range(int(rng.integers(0, 6))):
                p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
            packets.append(bytes(p[:int(rng.integers(1, len(p) + 1))]))
        decode_all(packets)
    ts, ps = tmp_path / "d.ts", tmp_path / "d.mpg"
    mpegmux.write_ts(ts, streams[0])
    mpegmux.write_ps(ps, streams[1], mpeg1=True)
    for _ in range(40):
        for path, mod in ((ts, mpegts), (ps, mpegps)):
            d = bytearray(path.read_bytes())
            for _ in range(int(rng.integers(1, 20))):
                d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
            damaged = tmp_path / f"damaged{path.suffix}"
            damaged.write_bytes(bytes(d[int(rng.integers(0, 200)):]))
            try:
                video = mod.open_video(str(damaged))
            except (IOError, NotImplementedError):
                continue
            decode_all([video.read(f) for f in video.frames])


# ------------------------------------------------------------- refusals

def _crafted_dual_prime() -> bytes:
    """A P picture whose first macroblock asks for dual-prime prediction
    (frame_motion_type 3; no encoder here writes it): picture header,
    coding extension (frame picture, frame_pred_frame_dct 0), a slice
    whose one macroblock is "MC, not coded" with motion type 11 and which
    then ends cleanly."""
    bits = "0000000001" + "010" + "1" * 16 + "0" + "001" + "0"   # P, f 1
    bits += "0" * (-len(bits) % 8)
    pic = b"\x00\x00\x01\x00" + int(bits, 2).to_bytes(len(bits) // 8, "big")
    ext = ("1000" + "0001" * 4 + "00" + "11" + "0" + "0" + "0" + "0" + "0"
           + "0" + "0" + "1" + "0" + "0000000")
    ext += "0" * (-len(ext) % 8)
    pic += b"\x00\x00\x01\xb5" + int(ext, 2).to_bytes(len(ext) // 8, "big")
    # quantiser 4, no extra information, address increment 1, "MC, not
    # coded", motion type 11, the vectors (each its predictor, dmv 0)
    sl = "00100" + "0" + "1" + "001" + "11" + "1" + "0" + "1" + "0"
    sl += "0" * (-len(sl) % 8)
    return pic + b"\x00\x00\x01\x01" + int(sl, 2).to_bytes(
        len(sl) // 8, "big") + bytes(3)


@pytest.mark.parametrize("tool", [
    "field_picture", "dual_prime", "chroma_422", "chroma_444",
    "scalable", "d_picture", "smpte240m", "fcc", "bt2020nc"])
def test_refusals_name_the_tool(tmp_path, tool):
    """What the decoder does not read raises ValueError naming it: a field
    picture (picture_structure set to 1 by hand), dual-prime prediction
    (a crafted macroblock), 4:2:2 at an odd height (its conversion goes
    through swscale's scaled path) and 4:4:4 (chroma_format set by hand),
    a sequence scalable extension (inserted), an MPEG-1 D-picture
    (picture_coding_type 4 by hand), and the colour matrices OpenCV
    converts with coefficients swscale_rgb.h does not carry."""
    frames = pan(4, 96, 128)
    packets = encode(frames, {"bf": "0"} if tool == "d_picture" else
                     {"bf": "0", "flags": "+ildct+ilme"},
                     mpeg1=tool == "d_picture")
    es = b"".join(packets)
    match = {"field_picture": "field pictures", "dual_prime": "dual-prime",
             "chroma_422": "4:2:2 chroma at an odd height",
             "chroma_444": "4:4:4",
             "scalable": "scalable extension", "d_picture": "D-pictures",
             "smpte240m": "SMPTE 240M", "fcc": "FCC",
             "bt2020nc": "BT.2020"}[tool]
    if tool == "field_picture":
        es = mpegmux.set_picture_coding(es, which={1}, picture_structure=1)
    elif tool == "dual_prime":
        es = es + _crafted_dual_prime()
    elif tool == "chroma_422":
        es = b"".join(lavc_encode("mpeg2video", pan(4, 95, 128), {"bf": "0"},
                                  pix_fmt="yuv422p")[0])
    elif tool == "chroma_444":
        k = es.index(b"\x00\x00\x01\xb5")
        b = bytearray(es)
        assert b[k + 4] >> 4 == 1                       # sequence extension
        b[k + 5] = b[k + 5] & ~0x06 | 6
        es = bytes(b)
    elif tool == "scalable":
        k = es.index(b"\x00\x00\x01\xb5") + 10
        es = es[:k] + b"\x00\x00\x01\xb5\x50\x00\x00\x00" + es[k:]
    elif tool == "d_picture":
        k = es.index(b"\x00\x00\x01\x00", es.index(b"\x00\x00\x01\x00") + 4)
        b = bytearray(es)
        b[k + 5] = b[k + 5] & ~0x38 | 4 << 3
        es = bytes(b)
    else:
        es = b"".join(encode(frames, {"bf": "0", "colorspace": tool,
                                      "seq_disp_ext": "always"}))
    path = tmp_path / "refused.m2v"
    path.write_bytes(es)
    with pytest.raises(ValueError, match=match):
        list(MediaSource(video_path=str(path), use_photos=False))


# -------------------------------------------------------------- fixtures

def _digest(path) -> dict:
    rgb = cv2_rgb(path)
    return {"frames": len(rgb), "shape": list(rgb[0].shape),
            "rgb_sha256": [_sha(f) for f in rgb],
            "y_sha256": [_sha(y) for y in cv2_luma(path)]}


def headline_pictures(frames) -> list:
    """The headline frames coded as a broadcast or HDV encoder would:
    HEADLINE_OPTIONS (25 fps, B pictures, 12-picture open GOPs, field DCT
    and field prediction, alternate scan, B-15, non-linear quantiser
    scale at quantiser 8, 10-bit intra DC, BT.709), top_field_first and
    progressive_frame set to 1 by hand (cv2 returns uninitialised memory
    for frames flagged interlaced; neither flag changes the decoding)."""
    packets = encode(frames, dict(HEADLINE_OPTIONS))
    return [mpegmux.set_picture_coding(p, progressive_frame=1,
                                       top_field_first=1) for p in packets]


def write_fixtures() -> None:
    """The 32 headline FHD frames (as cv2 decodes headline_mp4v.mp4) in a
    transport stream with an audio PID, and the small fixtures, with the
    sha256 of cv2's RGB frames and Y planes (cv2's Y read: through RGB for
    the BT.709 ones) beside the other fixtures' in cv2_sha256.json."""
    frames = cv2_rgb(MP4_FIXTURE)
    mpegmux.write_ts(FIXTURE, headline_pictures(frames))
    small = pan(8, 96, 128, dy=1, dx=2)
    write_cv2_video(FIXTURES / "mpeg1_cv2.mpg", small, "mpg1", fps=25.0)
    for ext in ("mpg", "avi", "mkv", "mp4"):
        write_cv2_video(FIXTURES / f"mpeg2_cv2.{ext}", small, "MPEG")
    write_cv2_video(FIXTURES / "mpeg1_cv2.mov", small, "MPEG", fps=25.0)
    mpegmux.write_ts(FIXTURES / "mpeg2_bt709.m2ts", [progressive(p) for p in
                     encode(pan(8, 90, 160), {
                         "bf": "2", "colorspace": "bt709",
                         "seq_disp_ext": "always",
                         "flags": "+ildct+ilme"})], packet_size=192)
    pal = pan(4, 576, 720, dy=2, dx=3)
    mpegmux.write_ps(FIXTURES / "mpeg2_pal.vob", [progressive(p) for p in
                     encode(pal, {"bf": "2", "g": "6", "qmin": "24",
                                  "qmax": "24", "flags": "+ildct+ilme"})],
                     nav=True, pack_stuffing=2)
    mpegmux.write_ts(FIXTURES / "mpeg2_cut.ts", encode(
        pan(24, 96, 128, dx=2), {"bf": "2", "g": "8"}))
    data = (FIXTURES / "mpeg2_cut.ts").read_bytes()
    (FIXTURES / "mpeg2_cut.ts").write_bytes(data[len(data) * 2 // 5 + 57:])
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        table[name] = _digest(FIXTURES / name)
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256():
    """The committed fixtures (what chip_smoke.py holds the port to on the
    card): cv2's decode still gives the recorded sha256, and so does the
    port's, frame by frame, in RGB and Y; the FHD headline uses its
    tools (B pictures, field DCT and prediction, alternate scan, B-15,
    non-linear quantiser scale, 10-bit DC, BT.709)."""
    table = json.loads(DIGESTS.read_text())
    for name in (FIXTURE.name,) + SMALL_FIXTURES:
        path = FIXTURES / name
        want = table[name]
        assert path.stat().st_size <= (4_000_000 if name == FIXTURE.name
                                       else 60_000), name
        assert [_sha(f) for f in cv2_rgb(path)] == want["rgb_sha256"], name
        assert [_sha(y) for y in cv2_luma(path)] == want["y_sha256"], name
        got = list(MediaSource(video_path=str(path), use_photos=False))
        assert len(got) == want["frames"], name
        assert [_sha(f) for f in got] == want["rgb_sha256"], name
        planes, matrix = port_planes(path)
        assert [_sha(p[0] if matrix != 1 else mpeg12.luma_read(f))
                for p, f in zip(planes, got)] == want["y_sha256"], name
    assert table[FIXTURE.name]["frames"] == 32
    stats = decoder_stats(FIXTURE)
    assert stats["b_pictures"] >= 16 and stats["field_dct_mbs"] > 0
    assert stats["field_mc_mbs"] > 0 and stats["alternate_scan"] == 32
    assert stats["intra_vlc"] == 32 and stats["non_linear_quant"] == 32
    assert stats["max_dc_precision"] == 2 and stats["top_field_first"] == 32
    assert stats["matrix_coefficients"] == 1
    assert decoder_stats(FIXTURES / "mpeg1_cv2.mpg")["mpeg1_pictures"] == 8
    assert decoder_stats(FIXTURES / "mpeg2_cut.ts")["skipped_pictures"] >= 1


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
