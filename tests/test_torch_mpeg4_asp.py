"""MPEG-4 Part 2 Advanced Simple Profile in the port (native/mpeg4.cpp
through io/mpeg4.py and ``MediaSource``) on the CPU, against OpenCV's
default FFmpeg backend: RGB frames bit for bit and frame for frame
against ``cv2.VideoCapture(p)``, the Y plane bit for bit against its
``CAP_PROP_CONVERT_RGB=0`` read.  The streams are coded by the libavcodec
cv2's wheel carries (``lavc_encode``): B-VOPs (``bf`` 1-3, both rounding
types in the P-VOPs), INTER4V, quarter-pel, MPEG quantisation with the
default and with loaded matrices, all of them together, at 38x54 (not
whole macroblocks), 96x128 and 480x640; video packets in B-VOPs; DivX's
packed bitstream with and without its ``p`` user data and with Xvid's;
the per-build workarounds FFmpeg applies by the user data an encoder
writes (FF_BUG_EDGE, QPEL_CHROMA, QPEL_CHROMA2; the old quarter-pel
filter is refused by name); an MP4 with ``ctts`` and an edit list as
FFmpeg's mov muxer writes them for B-frames; truncated and damaged B
streams keeping cv2's frame count; the committed ASP fixtures whose cv2
sha256 the card checks; and, end to end, ``slam_main`` on a 540x960 ASP
AVI against the JAX package reading it through cv2.

Rewrite the fixtures with ``PYTHONPATH=.:tests python
tests/test_torch_mpeg4_asp.py --write-fixtures`` (needs the libavcodec
cv2's wheel carries)."""

import json
import pathlib
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

import test_torch_mp4 as mp4t
from slam_indoor_code_tpu_torch.io import avi
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import make_scene, mjpeg

torch.set_num_threads(1)

FIXTURES = mp4t.FIXTURES
DIGESTS = mp4t.DIGESTS
HEADLINE = FIXTURES / "headline_asp_packed.avi"

# libavcodec's mpeg4 encoder options for each tool
TOOLS = {
    "bf1": {"bf": "1"},
    "bf2": {"bf": "2"},
    "bf3": {"bf": "3"},
    "mv4": {"flags": "+mv4", "mbd": "rd"},
    "qpel": {"flags": "+qpel"},
    "mpeg_quant": {"mpeg_quant": "1", "bf": "1"},
    "qpel_mv4_b": {"bf": "2", "flags": "+mv4+qpel", "mbd": "rd"},
    "all": {"bf": "2", "flags": "+mv4+qpel", "mpeg_quant": "1",
            "mbd": "rd"},
}
# the headline fixture's coding: every ASP tool, DivX's packing
HEADLINE_OPTS = {**TOOLS["all"], "flags": "+mv4+qpel+qscale",
                 "qmin": "4", "qmax": "4"}
DIVX = b"DivX503b2000p"     # DivX 5.03 build 2000, packed: no workaround


@pytest.fixture(scope="module")
def slow_frames():
    """40 renders of a moving scene: consecutive ones move little, so the
    encoder codes P- and B-VOPs with every tool, not intra frames."""
    sc = make_scene(n_points=400, n_frames=40, seed=5, baseline=0.3)
    return [sc.render(i) for i in range(12)]


def sized(frames, hw, n=12):
    return [np.ascontiguousarray(cv2.resize(f, hw[::-1])) for f in frames[:n]]


def vop_kinds(samples):
    """The coding type (I, P, B, S) of each sample's first VOP."""
    return "".join("IPBS"[s[s.index(b"\0\0\1\xb6") + 4] >> 6]
                   for s in samples)


def encode_avi(path, frames, opts, fourcc=b"XVID", **kw):
    h, w = frames[0].shape[:2]
    samples = mp4t.lavc_encode("mpeg4", frames, opts, **kw)[0]
    mjpeg.write_avi(str(path), samples, w, h, fourcc=fourcc)
    return samples


@pytest.mark.parametrize("hw,tool", [
    (hw, tool) for hw in ((38, 54), (96, 128)) for tool in TOOLS] + [
    ((480, 640), tool) for tool in ("bf2", "mv4", "all")])
def test_tools_equal_cv2(tmp_path, slow_frames, hw, tool):
    """Each ASP tool alone, then together: every frame, in display order,
    equals cv2's in RGB and Y; B-VOP streams hold B-VOPs (480x640: the B,
    4MV and all-tools streams)."""
    path = tmp_path / "asp.avi"
    samples = encode_avi(path, sized(slow_frames, hw), TOOLS[tool])
    kinds = vop_kinds(samples)
    assert kinds[0] == "I" and "P" in kinds
    assert ("B" in kinds) == ("bf" in TOOLS[tool])
    mp4t._check_equal_cv2(path, hw, 12)


def test_both_roundings_in_b_streams(slow_frames):
    """FFmpeg's encoder flips vop_rounding_type at each P-VOP: a B stream
    holds both (the B-VOPs themselves always round)."""
    samples = mp4t.lavc_encode("mpeg4", sized(slow_frames, (96, 128)),
                               TOOLS["bf1"])[0]
    tb = mp4t._vol_time_bits(samples[0])
    kinds = mp4t._vop_kinds([s for s, k in zip(samples, vop_kinds(samples))
                             if k != "B"], tb)
    assert {r for k, r in kinds if k == 1} == {0, 1}


INTRA = [8 + (i % 8) * 3 + (i // 8) * 2 for i in range(64)]
INTER = [16 + (i * 7) % 23 for i in range(64)]


@pytest.mark.parametrize("which", ["both", "intra", "inter"])
def test_loaded_quant_matrices_equal_cv2(tmp_path, slow_frames, which):
    """MPEG quantisation with matrices the VOL loads (load_intra_quant_mat
    / load_nonintra_quant_mat, zigzag order): the frames equal cv2's.
    Its unquantisers: FFmpeg's dct_unquantize_mpeg2_intra without
    mismatch control and _inter with it (either other choice leaves
    3-5 grey levels in every frame)."""
    mats = (INTRA if which != "inter" else None,
            INTER if which != "intra" else None)
    path = tmp_path / "mq.avi"
    samples = encode_avi(path, sized(slow_frames, (96, 128)),
                         TOOLS["mpeg_quant"], matrices=mats)
    vol = samples[0][samples[0].index(b"\0\0\1\x20"):]
    assert len(vol) > 64       # the VOL carries its matrices
    mp4t._check_equal_cv2(path, (96, 128), 12)


def test_xvid_idct_as_its_sse2_build(tmp_path, slow_frames):
    """An Xvid-tagged stream (its IDCT) under MPEG quantisation with a flat
    inter matrix of 11 at quantiser 2, where inter blocks whose first row
    is {-4, 0, ...} occur: FFmpeg's C ff_xvid_idct leaves such a row as it
    was, its x86 SSE2 build (what cv2 runs) zeroes it, and the port, which
    followed the C version, parted from cv2 by a grey level from frame 10
    on.  The frames equal cv2's."""
    samples = mp4t.lavc_encode(
        "mpeg4", sized(slow_frames, (96, 128)),
        {"mpeg_quant": "1", "qmin": "2", "qmax": "2"},
        matrices=(None, [11] * 64))[0]
    samples[0] = mjpeg.with_user_data(samples[0], b"XviD0050")
    path = tmp_path / "xvid.avi"
    mjpeg.write_avi(str(path), samples, 128, 96, fourcc=b"XVID")
    mp4t._check_equal_cv2(path, (96, 128), 12)


def zero_pixel_frames(n=12, hw=(96, 128)):
    """I420 frames (Y, U, V stacked as the channels) of a texture where
    most pixels are 0, moving by half pixels: predictions without
    rounding read 0 next to odd values."""
    rng = np.random.default_rng(3)
    h, w = hw
    yb = rng.choice(np.array([0, 0, 0, 1, 3, 5, 7, 41, 201], np.uint8),
                    size=(h + 40, w + 40))
    cb = rng.choice(np.array([0, 0, 1, 3, 129, 77], np.uint8),
                    size=(h + 40, w + 40))
    out = []
    for k in range(n):
        m = np.float32([[1, 0, -20 + 0.5 * k], [0, 1, -20 + 0.5 * k]])

        def sh(a):
            return cv2.warpAffine(a, m, (w, h), flags=cv2.INTER_NEAREST)
        out.append(np.ascontiguousarray(
            np.stack([sh(yb), sh(cb), sh(cb[::-1].copy())], -1)))
    return out


def encode_i420(frames, opts):
    """``lavc_encode`` of frames given as I420 planes (Y, U, V in the
    three channels; U and V taken at even positions), not RGB: Y down to
    0, which cv2's RGB->I420 (video range) never gives."""
    class I420:
        COLOR_RGB2YUV_I420 = cv2.COLOR_RGB2YUV_I420

        def cvtColor(self, f, code):
            return np.concatenate([f[..., 0].ravel(), f[::2, ::2, 1].ravel(),
                                   f[::2, ::2, 2].ravel()])

        def __getattr__(self, k):
            return getattr(cv2, k)

    real, mp4t.cv2 = mp4t.cv2, I420()
    try:
        return mp4t.lavc_encode("mpeg4", frames, opts)[0]
    finally:
        mp4t.cv2 = real


@pytest.mark.parametrize("opts", [{"bf": "0"}, {"flags": "+mv4"}])
def test_no_rounding_8_wide_as_ffmpeg_x86(tmp_path, opts):
    """FFmpeg's x86 build predicts 8-wide blocks without rounding (every
    chroma block of a P-VOP with vop_rounding_type 1, INTER4V luma) by
    put_no_rnd_pixels8_x2/_y2, which round up where the pixel they take one
    from is 0; the exact average left 1-3 grey levels in hundreds of
    pixels of every P frame here, in Simple Profile too (chroma).  The
    frames equal cv2's."""
    frames = zero_pixel_frames()
    samples = encode_i420(frames, {**opts, "sc_threshold": "1000000000"})
    assert vop_kinds(samples) == "I" + "P" * 11
    path = tmp_path / "z.avi"
    mjpeg.write_avi(str(path), samples, 128, 96, fourcc=b"XVID")
    mp4t._check_equal_cv2(path, (96, 128), 12)


# ------------------------------------------------------ packed bitstream
@pytest.mark.parametrize("bf", ["1", "2", "3"])
@pytest.mark.parametrize("user,fourcc,nvop,all_frames", [
    (b"DivX503b1393p", b"DX50", True, True),     # DivX 5's packing
    (b"DivX503b1393", b"DX50", True, False),     # no 'p': B-VOPs dropped
    (b"XviD0050", b"XVID", True, False),         # Xvid's user data
    (b"DivX503b1393p", b"DX50", False, False),   # N-VOPs left out
])
def test_packed_bitstream_equal_cv2(tmp_path, slow_frames, bf, user, fourcc,
                                    nvop, all_frames):
    """Decode-order samples packed as DivX packs them (testing/mjpeg.py's
    ``pack_divx``: a P-VOP and the next B-VOP in one chunk, N-VOPs in the
    slots left over).  FFmpeg holds the B-VOP for the next chunk only
    under DivX's ``p`` user data: then every frame comes out, equal to the
    unpacked stream's; without it (or with Xvid's) the B-VOPs packed
    behind P-VOPs are dropped.  The port gives cv2's frames in each case."""
    frames = sized(slow_frames, (96, 128), 10)
    samples = mp4t.lavc_encode("mpeg4", frames, {"bf": bf})[0]
    plain = tmp_path / "plain.avi"
    mjpeg.write_avi(str(plain), samples, 128, 96, fourcc=b"XVID")
    packed = mjpeg.pack_divx(samples, user, nvop)
    assert any(s.count(b"\0\0\1\xb6") == 2 for s in packed)
    path = tmp_path / "packed.avi"
    mjpeg.write_avi(str(path), packed, 128, 96, fourcc=fourcc)
    want = mp4t.cv2_rgb(path)
    assert (len(want) == 10) == all_frames
    mp4t._check_equal_cv2(path, (96, 128), len(want))
    if all_frames:
        for a, b in zip(want, mp4t.cv2_rgb(plain)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ workarounds
@pytest.mark.parametrize("user,hw", [
    (b"XviD0001", (38, 54)),     # QPEL_CHROMA, EDGE, DC_CLIP; Xvid's IDCT
    (b"XviD0005", (38, 54)),     # EDGE, DC_CLIP
    (b"XviD0020", (38, 54)),     # DC_CLIP
    (b"DivX400b1000", (38, 54)),     # EDGE (DivX 4)
    (b"DivX501b1000", (38, 54)),     # QPEL_CHROMA
    (b"DivX503b1000", (96, 128)),    # QPEL_CHROMA2
    (b"FFmpeg v0.4.9 / libavcodec build: 4654", (38, 54)),   # EDGE, DC_CLIP
])
def test_workarounds_by_user_data_equal_cv2(tmp_path, slow_frames, user, hw):
    """A B/4MV/quarter-pel stream (at 38x54, not whole macroblocks, where
    FF_BUG_EDGE's edge at the VOL's size shows) with its ``Lavc`` user data
    replaced by an older encoder's: FFmpeg applies that build's
    workarounds and cv2's frames move (FF_BUG_EDGE, QPEL_CHROMA(2), Xvid's
    IDCT); the port's equal them.  FF_BUG_DC_CLIP, which keeps DC
    predictors above 2047, shows only where a DC level exceeds 2047 +
    half its scale, which an encoder of 8-bit pixels never writes."""
    frames = sized(slow_frames, hw)
    samples = mp4t.lavc_encode("mpeg4", frames, TOOLS["qpel_mv4_b"])[0]
    clean = tmp_path / "clean.avi"
    mjpeg.write_avi(str(clean), samples, hw[1], hw[0], fourcc=b"FMP4")
    samples[0] = mjpeg.with_user_data(samples[0], user)
    path = tmp_path / "old.avi"
    mjpeg.write_avi(str(path), samples, hw[1], hw[0], fourcc=b"FMP4")
    want = mp4t.cv2_rgb(path)
    assert sum(not np.array_equal(a, b)
               for a, b in zip(want, mp4t.cv2_rgb(clean))) > 0
    mp4t._check_equal_cv2(path, hw, 12)


@pytest.mark.parametrize("user", [b"DivX400b1000", b"XviD0005"])
def test_edge_workaround_on_not_coded_macroblocks(tmp_path, user):
    """FF_BUG_EDGE at an odd height (17x30: the edge at row 17, chroma's at
    row 8 of 9 shown): FFmpeg predicts a not-coded P macroblock with a zero
    vector through its edge test, so its rows past the edge repeat the last
    row inside it (the port copied the reference and left chroma row 8
    off by up to 6).  Repeated frames, whose P-VOPs are all not coded: the
    frames equal cv2's."""
    sc = make_scene(n_points=400, n_frames=40, seed=5, baseline=0.3)
    a, b = (np.ascontiguousarray(cv2.resize(sc.render(i), (30, 17)))
            for i in (0, 1))
    samples = mp4t.lavc_encode("mpeg4", [a] * 3 + [b] * 3, {"bf": "1"})[0]
    samples[0] = mjpeg.with_user_data(samples[0], user)
    path = tmp_path / "still.avi"
    mjpeg.write_avi(str(path), samples, 30, 17, fourcc=b"FMP4")
    mp4t._check_equal_cv2(path, (17, 30), 6)


def test_old_libavcodec_quarter_pel_raises(tmp_path, slow_frames):
    """libavcodec before build 4653 coded quarter-pel with an older filter
    (FFmpeg's FF_BUG_STD_QPEL): ValueError naming it."""
    samples = mp4t.lavc_encode("mpeg4", sized(slow_frames, (48, 64), 4),
                               TOOLS["qpel"])[0]
    samples[0] = mjpeg.with_user_data(
        samples[0], b"FFmpeg v0.4.8 / libavcodec build: 4600")
    path = tmp_path / "old.avi"
    mjpeg.write_avi(str(path), samples, 64, 48, fourcc=b"FMP4")
    with pytest.raises(ValueError, match="FF_BUG_STD_QPEL"):
        list(MediaSource(video_path=str(path), use_photos=False))


# -------------------------------------------------- video packets, damage
def test_resync_markers_in_b_vops_equal_cv2(tmp_path, slow_frames):
    """Video packets (``ps`` 200) in a stream with B-VOPs: markers of
    15 + max(fcode, bcode, 2) zeros in B-VOPs, packets that start after
    skipped B macroblocks; the frames equal cv2's."""
    path = tmp_path / "ps.avi"
    samples = encode_avi(path, sized(slow_frames, (96, 128)),
                         {"bf": "2", "ps": "200"}, fourcc=b"FMP4")
    b_vops = [s for s, k in zip(samples, vop_kinds(samples)) if k == "B"]
    assert sum(s.count(b"\0\0") for s in b_vops) > len(b_vops)
    mp4t._check_equal_cv2(path, (96, 128), 12)


@pytest.mark.parametrize("how", ["2bytes", "half", "flip"])
@pytest.mark.parametrize("which", ["B", "P"])
def test_damaged_b_stream_keeps_cv2s_frame_count(tmp_path, slow_frames, how,
                                                 which):
    """A B- or P-VOP in the middle of a ``bf`` 2 stream damaged: cv2's frame
    count (a sample with no VOP ends the stream and loses the reference
    held back; a damaged VOP gives a concealed frame), the frames before
    the damaged one equal cv2's.  The reference is cv2 on one thread
    (``cv2_rgb_one_thread``: FFmpeg's frame threads make the concealed
    frames vary between reads); the count is the default read's too."""
    frames = sized(slow_frames, (96, 128))
    samples = mp4t.lavc_encode("mpeg4", frames, TOOLS["bf2"])[0]
    kinds = vop_kinds(samples)
    k = kinds.index(which, 4)
    samples[k] = mp4t._damage(samples[k], how)
    path = tmp_path / "d.avi"
    mjpeg.write_avi(str(path), samples, 128, 96, fourcc=b"XVID")
    want = mp4t.cv2_rgb_one_thread(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == len(mp4t.cv2_rgb(path))
    first = sum(1 for j in range(k) if kinds[j] == "B") + max(
        0, sum(1 for j in range(k) if kinds[j] != "B") - 1)
    for a, b in zip(got[:first], want):
        np.testing.assert_array_equal(a, b)


def test_truncated_b_stream_keeps_cv2s_frame_count(tmp_path, slow_frames):
    """A ``bf`` 3 AVI cut inside one of its last three chunks, two bytes in
    (no VOP: the stream ends there and the reference held back is lost)
    and halfway (a concealed frame): cv2's frame count; each frame equal
    to cv2's, the concealed one as ``damaged_frame_holds_to_cv2`` states."""
    path = tmp_path / "full.avi"
    encode_avi(path, sized(slow_frames, (96, 128), 10), TOOLS["bf3"])
    video = avi.AviVideo(str(path))
    offsets = [f[0] for f in video.frames]
    sizes = [f[1] for f in video.frames]
    video.close()
    data = path.read_bytes()
    full = mp4t.cv2_rgb(path)
    clean = list(MediaSource(video_path=str(path), use_photos=False))
    for c in (-1, -2, -3):
        for cut in (offsets[c] + 2, offsets[c] + sizes[c] // 2):
            p = tmp_path / "cut.avi"
            p.write_bytes(data[:cut])
            want = mp4t.cv2_rgb(p)
            got = list(MediaSource(video_path=str(p), use_photos=False))
            assert len(got) == len(want), (c, cut)
            for k, (a, b) in enumerate(zip(got, want)):
                if np.array_equal(b, full[k]):
                    np.testing.assert_array_equal(a, b)
                else:
                    mp4t.damaged_frame_holds_to_cv2(a, b, clean[k])


def test_stream_ending_on_an_n_vop(tmp_path, slow_frames):
    """Six frames and a not-coded VOP: a low-delay stream gives its last
    frame again at the end (FFmpeg's flush gives the reference it holds
    after a skipped VOP: 7 frames), and so does the port; a B stream gives
    its 6."""
    for opts, n in (({"bf": "0"}, 7), (TOOLS["bf2"], 6)):
        samples = mp4t.lavc_encode("mpeg4", sized(slow_frames, (64, 80), 6),
                                   opts)[0]
        tb = mjpeg.vop_time_bits(samples[0])
        samples.append(mjpeg.n_vop(samples[-1], tb))
        path = tmp_path / "n.avi"
        mjpeg.write_avi(str(path), samples, 80, 64, fourcc=b"XVID")
        mp4t._check_equal_cv2(path, (64, 80), n)


# --------------------------------------------------------- MP4 with ctts
def write_mp4(path, samples, extradata, w, h, delay=1, media_time=None,
              sync=True):
    """An MP4 as FFmpeg's mov muxer writes MPEG-4 Part 2 with B-frames:
    one chunk, frames of 1024 in a 10240 time scale, a ``ctts`` offset per
    sample (its display slot + ``delay`` - its decode index), the I-VOPs
    as sync samples (``stss``; none with ``sync`` False: every sample is
    one), and an edit list from ``media_time`` (default ``delay`` frames)
    on, the VOL in an ``esds``."""
    box = mp4t._box

    def full(kind, body, version=0, flags=0):
        return box(kind, struct.pack(">I", version << 24 | flags) + body)

    n = len(samples)
    kinds = vop_kinds(samples)
    # display order: a reference after the B-VOPs that follow it
    order = sorted(range(n), key=lambda i: (
        i if kinds[i] == "B" else
        next((j for j in range(i + 1, n) if kinds[j] != "B"), n) - 0.5))
    slot = {i: s for s, i in enumerate(order)}
    ctts = [(slot[i] + delay - i) * 1024 for i in range(n)]
    assert min(ctts) >= 0
    mt = delay * 1024 if media_time is None else media_time
    dur = n * 1024
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                         0x40000000)
    ftyp = box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    mdat_off = len(ftyp) + 8
    mdat = box(b"mdat", b"".join(samples))
    entry = (bytes(6) + struct.pack(">H", 1) + bytes(16)
             + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1)
             + bytes(32) + struct.pack(">Hh", 0x18, -1))
    stbl = box(b"stbl", b"".join([
        full(b"stsd", struct.pack(">I", 1)
             + box(b"mp4v", entry + mp4t._esds(extradata))),
        full(b"stts", struct.pack(">III", 1, n, 1024)),
        full(b"stss", struct.pack(">I", kinds.count("I")) + b"".join(
            struct.pack(">I", i + 1) for i in range(n) if kinds[i] == "I"))
        if sync else b"",
        full(b"ctts", struct.pack(">I", n) + b"".join(
            struct.pack(">II", 1, c) for c in ctts)),
        full(b"stsc", struct.pack(">IIII", 1, 1, n, 1)),
        full(b"stsz", struct.pack(">II", 0, n) + b"".join(
            struct.pack(">I", len(s)) for s in samples)),
        full(b"stco", struct.pack(">II", 1, mdat_off))]))
    minf = box(b"minf", full(b"vmhd", bytes(8), flags=1) + box(
        b"dinf", full(b"dref", struct.pack(">I", 1) + full(
            b"url ", b"", flags=1))) + stbl)
    mdia = box(b"mdia", full(b"mdhd", struct.pack(">IIIIHH", 0, 0, 10240,
                                                  dur, 0x55C4, 0))
               + full(b"hdlr", bytes(4) + b"vide" + bytes(12)
                      + b"VideoHandler\0") + minf)
    ms = n * 100
    trak = box(b"trak", full(b"tkhd", struct.pack(">IIIII", 0, 0, 1, 0, ms)
                             + bytes(8) + struct.pack(">hhhH", 0, 0, 0, 0)
                             + matrix + struct.pack(">II", w << 16, h << 16),
                             flags=3)
               + box(b"edts", full(b"elst", struct.pack(">IIiI", 1, ms, mt,
                                                       0x10000)))
               + mdia)
    mvhd = full(b"mvhd", struct.pack(">IIIIIH", 0, 0, 1000, ms, 0x10000,
                                     0x100) + bytes(10) + matrix + bytes(24)
                + struct.pack(">I", 2))
    pathlib.Path(path).write_bytes(ftyp + mdat + box(b"moov", mvhd + trak))


def split_headers(samples):
    """The VOS/VOL headers of the first sample (an MP4 keeps them in its
    esds) and the samples with them taken out."""
    first = samples[0]
    vop = first.index(b"\0\0\1\xb6")
    ud = first.find(b"\0\0\1\xb2")
    cut = ud if 0 <= ud < vop else vop
    return first[:cut], [first[cut:]] + samples[1:]


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("media_time", [None, 2048, 3072, 5120])
def test_mp4_with_ctts_and_edit_list_equals_cv2(tmp_path, slow_frames,
                                               media_time, sync):
    """An all-tools ``bf`` 2 stream in an MP4 with ``ctts`` and an edit
    list (as FFmpeg's mov muxer writes them, and with the edit starting a
    frame or more later): the port shows cv2's frames.  With the I-VOPs as
    sync samples reading starts at the I-VOP before the edit and the
    frames before it are hidden in display order, not decode order
    (10 - k frames for an edit k frames in); with every sample a sync
    sample FFmpeg starts at the B-VOP there and skips the B-VOPs that lack
    two references."""
    samples = mp4t.lavc_encode("mpeg4", sized(slow_frames, (64, 96), 10),
                               TOOLS["all"])[0]
    assert vop_kinds(samples).count("B") >= 4
    extra, body = split_headers(samples)
    path = tmp_path / "b.mp4"
    write_mp4(path, body, extra, 96, 64, media_time=media_time, sync=sync)
    want = mp4t.cv2_rgb(path)
    if sync:
        assert len(want) == 11 - (media_time or 1024) // 1024
    mp4t._check_equal_cv2(path, (64, 96), len(want))


# --------------------------------------------------------------- fixtures
# Small fixtures the card holds to cv2's decode (it has neither cv2 nor an
# encoder): each file with the sha256 of cv2's RGB frames and Y planes.
SMALL = ("asp_b_resync.avi", "asp_qpel_mv4_odd.avi",
         "asp_mpeg_matrices.avi", "asp_packed_divx.avi", "asp_xvid_edge.avi",
         "asp_divx_qpel_chroma.avi", "asp_zero_no_rnd.avi", "asp_ctts.mp4")


def _small_fixture(name: str, path) -> None:
    sc = make_scene(n_points=400, n_frames=40, seed=5, baseline=0.3)
    frames = [sc.render(i) for i in range(10)]
    f96, f38 = sized(frames, (96, 128), 10), sized(frames, (38, 54), 10)
    q = {"qmin": "6", "qmax": "6"}

    def opts(tool, **kw):
        o = {**TOOLS[tool], **q, **kw}
        o["flags"] = TOOLS[tool].get("flags", "") + "+qscale"
        return o

    def lavc(frames, o, **kw):
        return mp4t.lavc_encode("mpeg4", frames, o, **kw)[0]

    if name == "asp_b_resync.avi":         # B-VOPs with video packets
        mjpeg.write_avi(str(path), lavc(f96, opts("bf3", ps="300")), 128,
                        96, fourcc=b"FMP4")
    elif name == "asp_qpel_mv4_odd.avi":   # 4MV, quarter-pel, B, odd size
        mjpeg.write_avi(str(path), lavc(f38, opts("qpel_mv4_b")), 54, 38,
                        fourcc=b"XVID")
    elif name == "asp_mpeg_matrices.avi":  # MPEG quantisation, loaded
        mjpeg.write_avi(str(path), lavc(f96, opts("mpeg_quant"),
                                        matrices=(INTRA, INTER)),
                        128, 96, fourcc=b"XVID")
    elif name == "asp_packed_divx.avi":    # DivX's packed bitstream
        mjpeg.write_avi(str(path), mjpeg.pack_divx(
            lavc(f96, opts("bf2")), b"DivX503b1393p"), 128, 96,
            fourcc=b"DX50")
    elif name == "asp_xvid_edge.avi":      # Xvid 5: EDGE, DC_CLIP, IDCT
        s = lavc(f38, opts("qpel_mv4_b"))
        s[0] = mjpeg.with_user_data(s[0], b"XviD0005")
        mjpeg.write_avi(str(path), s, 54, 38, fourcc=b"XVID")
    elif name == "asp_divx_qpel_chroma.avi":   # DivX 5.01: QPEL_CHROMA
        mjpeg.write_avi(str(path), mjpeg.pack_divx(
            lavc(f96, opts("qpel_mv4_b")), b"DivX501b1000p"), 128, 96,
            fourcc=b"DX50")
    elif name == "asp_zero_no_rnd.avi":    # FFmpeg's inexact 8-wide no_rnd
        samples = encode_i420(zero_pixel_frames(6, (48, 64)), {
            "flags": "+mv4+qscale", "qmin": "6", "qmax": "6",
            "sc_threshold": "1000000000"})
        mjpeg.write_avi(str(path), samples, 64, 48, fourcc=b"XVID")
    elif name == "asp_ctts.mp4":           # B-frames in MP4: ctts, edit
        extra, body = split_headers(lavc(sized(frames, (64, 96), 10),
                                         opts("all")))
        write_mp4(path, body, extra, 96, 64)


def record_cv2(names) -> None:
    """The sha256 of cv2's RGB frames and Y planes of each fixture, into
    cv2_sha256.json."""
    table = json.loads(DIGESTS.read_text())
    for name in names:
        path = FIXTURES / name
        rgb = mp4t.cv2_rgb(path)
        luma = mp4t.cv2_luma(path, rgb[0].shape[:2])
        table[name] = {"frames": len(rgb), "shape": list(rgb[0].shape),
                       "rgb_sha256": [mp4t._sha(f) for f in rgb],
                       "y_sha256": [mp4t._sha(f) for f in luma]}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def write_headline() -> None:
    """The headline's 32 FHD frames coded with every ASP tool and packed
    as DivX packs them (``bf`` 2, 4MV, quarter-pel, MPEG quantisation at a
    fixed quantiser of 4, RD macroblock decision, DX50), and its cv2
    sha256."""
    sc = make_scene(n_points=1500, n_frames=32, image_size=(1080, 1920),
                    seed=7, baseline=0.25, kind="hallway")
    samples = mp4t.lavc_encode("mpeg4", [sc.render(i) for i in range(32)],
                               HEADLINE_OPTS)[0]
    mjpeg.write_avi(str(HEADLINE), mjpeg.pack_divx(samples, DIVX), 1920,
                    1080, fourcc=b"DX50")
    record_cv2([HEADLINE.name])


def write_small() -> None:
    """The small ASP fixtures and their cv2 sha256."""
    for name in SMALL:
        _small_fixture(name, FIXTURES / name)
    record_cv2(SMALL)


@pytest.mark.parametrize("name", (HEADLINE.name,) + SMALL)
def test_asp_fixtures_hold_cv2s_decode_and_the_port_equals_it(name):
    """The committed ASP fixtures: cv2's decode still gives the recorded
    sha256 (what chip_smoke.py holds the card to), and so does the port's
    through MediaSource and its Y planes, frame by frame; the headline
    fixture is 4 MB or less and each small one 100 KB or less."""
    table = json.loads(DIGESTS.read_text())[name]
    path = FIXTURES / name
    assert path.stat().st_size <= (4_000_000 if name == HEADLINE.name
                                   else 100_000)
    if name != HEADLINE.name:       # its cv2 decode takes ~3 s
        rgb = mp4t.cv2_rgb(path)
        assert [mp4t._sha(f) for f in rgb] == table["rgb_sha256"]
        assert [mp4t._sha(f) for f in mp4t.cv2_luma(
            path, tuple(table["shape"][:2]))] == table["y_sha256"]
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert [mp4t._sha(f) for f in got] == table["rgb_sha256"]
    video = avi.open_video(str(path))
    assert [mp4t._sha(y) for y in mp4t.port_luma(video)] == table["y_sha256"]
    video.close()


def test_headline_fixture_uses_every_tool():
    """The headline fixture: DivX's packed user data, a VOL with
    quarter-pel and MPEG quantisation, B-VOPs packed behind P-VOPs."""
    video = avi.AviVideo(str(HEADLINE))
    samples = [video.read(f) for f in video.frames]
    video.close()
    assert video.fourcc == b"DX50" and len(samples) == 32
    assert DIVX in samples[0]
    assert sum(s.count(b"\0\0\1\xb6") == 2 for s in samples) >= 8
    assert "B" in vop_kinds([s[s.index(b"\0\0\1\xb6") + 4:] for s in
                             samples if s.count(b"\0\0\1\xb6") == 2])


# ------------------------------------------------------------ end to end
def test_slam_main_on_asp_avi_against_jax_video_run(tmp_path):
    """``slam_main`` on 14 frames at 540x960 coded with every ASP tool as
    the headline fixture is (quantiser 4) and packed as DivX packs them:
    the port's frames equal the JAX package's (cv2's) bit for bit, the
    cameras as many as each of its RANSAC seeds 0-2 give, the ATE within
    0.02 of the extent of their median."""
    def write(path, frames):
        samples = mp4t.lavc_encode("mpeg4", frames, HEADLINE_OPTS)[0]
        mjpeg.write_avi(str(path), mjpeg.pack_divx(samples, DIVX), 960, 540,
                        fourcc=b"DX50")
    mp4t.slam_main_against_jax(tmp_path, "DX50", "avi", write=write)


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    write_headline()
    write_small()
