"""The port's MPEG containers (io/mpegps.py, io/mpegts.py and the MPEG-1/2
entries of io/avi.py, io/mp4.py and io/matroska.py) on the CPU, against
OpenCV's default FFmpeg backend: every frame bit for bit in RGB and Y,
in cv2's frame count.  Files: cv2's ``MPEG``, ``mpg1``, ``mpg2`` and
``PIM1`` writers into each container they write (AVI, program stream,
transport stream, M2TS, Matroska, MP4, QuickTime); program streams from
``testing/mpegmux.py`` with MPEG-1 and MPEG-2 pack syntax, small PES
packets, audio, padding, pack stuffing and DVD navigation packs, and two
video streams (the first to appear is read); transport streams with the
PAT and PMT at other PIDs, a second program, M2TS packets, MPEG-1's
stream_type; files cut at 30 %, 55 % and 80 % at either end (FFmpeg
drops a transport stream's short last packet, so a picture that starts in
it is lost); a lost transport packet; and what is refused (a program
stream whose video is not MPEG-1/2, H.264, HEVC or MPEG-4 in a
transport stream); and, end to end, ``slam_main`` on a 540x960
interlaced B-picture BT.709 MPEG-2 ``.ts`` against the JAX package
reading it through cv2.  The decoder itself is tests/test_torch_mpeg2.py's."""

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, mpeg12, mpegps, mpegts
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mpegmux
from test_torch_mp4 import cv2_rgb, damaged_frame_holds_to_cv2, \
    swscale_rgb, write_cv2_video
from test_torch_mpeg2 import check_equal_cv2, encode, lavc_decode, \
    progressive
from test_torch_vp9 import pan

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    return pan(20, 96, 128, dy=1, dx=2)


@pytest.fixture(scope="module")
def pictures(frames):
    """Twelve interlaced B-picture MPEG-2 pictures (progressive_frame set
    to 1, so that cv2 converts them) and twelve MPEG-1 ones."""
    return ([progressive(p) for p in encode(
        frames[:12], {"bf": "2", "flags": "+ildct+ilme"})],
            encode(frames[:12], {"bf": "2"}, mpeg1=True))


@pytest.mark.parametrize("fourcc,ext,fps", [
    ("MPEG", "avi", 10), ("MPEG", "mpg", 10), ("MPEG", "ts", 10),
    ("MPEG", "m2ts", 10), ("MPEG", "mkv", 10), ("MPEG", "mp4", 10),
    ("MPEG", "mov", 25), ("mpg2", "mov", 25), ("mpg1", "mpg", 25),
    ("mpg2", "mpg", 10), ("PIM1", "avi", 25), ("mpg1", "avi", 25),
    ("mpg2", "avi", 10), ("mpg2", "ts", 10), ("mpg1", "ts", 25),
    ("mpg2", "mkv", 10), ("mpg1", "mkv", 25), ("mpg1", "mp4", 25)])
def test_cv2_writer_in_each_container(tmp_path, frames, fourcc, ext, fps):
    """cv2's MPEG-1/2 writers (MPEG-1 only at its frame rates) into every
    container they write: the port reads the codec ("mpeg12") and every
    frame equals cv2's."""
    path = tmp_path / f"v.{ext}"
    write_cv2_video(path, frames, fourcc, fps=float(fps))
    video = avi.open_video(str(path))
    assert video.codec == "mpeg12"
    video.close()
    check_equal_cv2(path, len(frames))


@pytest.mark.parametrize("variant", ["mpeg2", "mpeg1", "small_pes",
                                     "vob", "bare"])
def test_program_streams(tmp_path, pictures, variant):
    """Program streams as DVDs, camcorders and MPEG-1 muxers write them:
    MPEG-2 or MPEG-1 pack headers and PES syntax, PES packets of 300
    bytes, a VOB's navigation packs, pack stuffing and PES of 2 kB, or
    the video alone; the audio and padding streams passed over."""
    mpeg2, mpeg1 = pictures
    path = tmp_path / "v.mpg"
    if variant == "mpeg1":
        mpegmux.write_ps(path, mpeg1, mpeg1=True)
    elif variant == "small_pes":
        mpegmux.write_ps(path, mpeg2, pes_size=300)
    elif variant == "vob":
        mpegmux.write_ps(path, mpeg2, nav=True, pack_stuffing=3)
    elif variant == "bare":
        mpegmux.write_ps(path, mpeg2, audio=False, padding=False)
    else:
        mpegmux.write_ps(path, mpeg2)
    assert avi.mpeg_container(path.read_bytes()[:4096]) == \
        "MPEG program stream"
    check_equal_cv2(path, 12)


def test_program_stream_two_video_streams(tmp_path, frames, pictures):
    """A program stream with video streams 0xE1 and 0xE0, 0xE1's packets
    first: the first to appear is read, as FFmpeg orders its streams and
    OpenCV takes the first video one."""
    other = encode(pan(12, 96, 128, seed=3), {"bf": "0"})
    out = bytearray()
    for a, b in zip(other, pictures[0]):
        for sid, pic in ((0xE1, a), (0xE0, b)):
            out += mpegmux._pack_header(0, False) + mpegmux.pes(sid, pic, 0)
    path = tmp_path / "two.mpg"
    path.write_bytes(bytes(out))
    check_equal_cv2(path, 12)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    solo = tmp_path / "solo.m2v"
    solo.write_bytes(b"".join(other))
    for a, b in zip(got, MediaSource(video_path=str(solo),
                                     use_photos=False)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", ["plain", "m2ts", "pids", "programs",
                                     "mpeg1", "psi_once", "no_audio"])
def test_transport_streams(tmp_path, pictures, variant):
    """Transport streams as broadcast and camcorders write them: the PAT,
    PMT and video at other PIDs (program 7, PMT 0x1FF0, video 0x44), a
    second program listed first, 192-byte M2TS packets, MPEG-1 video
    (stream_type 0x01), the PSI only once, no audio; adaptation fields
    (PCR, stuffing) throughout."""
    mpeg2, mpeg1 = pictures
    path = tmp_path / "v.ts"
    kwargs = {"m2ts": {"packet_size": 192},
              "pids": {"video_pid": 0x44, "pmt_pid": 0x1FF0, "program": 7,
                       "psi_every": 3},
              "programs": {"extra_programs": ((3, 0x20, [(0x03, 0x21)]),)},
              "psi_once": {"psi_every": 100},
              "no_audio": {"audio": False}}.get(variant, {})
    if variant == "mpeg1":
        mpegmux.write_ts(path, mpeg1, stream_type=0x01)
    else:
        mpegmux.write_ts(path, mpeg2, **kwargs)
    assert mpegts.packet_layout(path.read_bytes())[0] == (
        192 if variant == "m2ts" else 188)
    check_equal_cv2(path, 12)


@pytest.mark.parametrize("ext", ["ts", "m2ts", "mpg"])
@pytest.mark.parametrize("end", ["head", "tail"])
@pytest.mark.parametrize("cut", [0.3, 0.55, 0.8])
def test_cut_files(tmp_path, ext, end, cut):
    """cv2's MPEG writer's 40-frame .ts, .m2ts and .mpg keeping only their
    first (``head``) or last (``tail``) 30/55/80 %: the port gives cv2's
    frame count (a transport stream's short last packet dropped as FFmpeg
    drops it; a stream joined mid-way decoded from its next sequence
    header, without the open GOP's first B pictures); every frame equals
    cv2's but a cut last picture, which FFmpeg conceals its own way
    (``damaged_frame_holds_to_cv2``)."""
    path = tmp_path / f"full.{ext}"
    frames = pan(40, 96, 128, dy=1, dx=2)
    write_cv2_video(path, frames, "MPEG")
    data = path.read_bytes()
    n = int(len(data) * cut)
    cut_path = tmp_path / f"cut.{ext}"
    cut_path.write_bytes(data[:n] if end == "head" else data[-n:])
    want = cv2_rgb(cut_path)
    got = list(MediaSource(video_path=str(cut_path), use_photos=False))
    assert 0 < len(got) == len(want) < 40
    exact = len(got) - 1 if end == "head" else len(got)
    for a, b in zip(got[:exact], want):
        np.testing.assert_array_equal(a, b)
    if end == "head" and not np.array_equal(got[-1], want[-1]):
        clean = list(MediaSource(video_path=str(path), use_photos=False))
        k = [i for i, f in enumerate(clean)
             if np.array_equal(f, got[-2])][0] + 1
        damaged_frame_holds_to_cv2(got[-1], want[-1], clean[k])


@pytest.mark.parametrize("which", [5, 40, 90])
def test_lost_transport_packet(tmp_path, pictures, which):
    """One transport packet of the video PID dropped (the ``which``-th of
    them): the continuity counter's gap leaves its bytes out of the
    stream, as FFmpeg passes the packet on marked corrupt; cv2's frame
    count, and the frames before the damage equal cv2's.  The damaged
    frames are held to libavcodec's own decode of the same pictures on one
    thread (``lavc_decode``), as ``damaged_frame_holds_to_cv2`` states:
    cv2 runs FFmpeg's decoder with slice threads, one per core, and where
    the loss joins the slices of two pictures (the 40th) the threads
    decode a different subset of them than one thread does, so its
    concealment there depends on the machine's core count."""
    path = tmp_path / "full.ts"
    mpegmux.write_ts(path, pictures[0])
    data = path.read_bytes()
    packets = [data[i:i + 188] for i in range(0, len(data), 188)]
    video = [i for i, p in enumerate(packets)
             if (p[1] & 0x1F) << 8 | p[2] == 0x1011]
    drop = video[min(which, len(video) - 1)]
    lost = tmp_path / "lost.ts"
    lost.write_bytes(b"".join(packets[:drop] + packets[drop + 1:]))
    want = cv2_rgb(lost)
    got = list(MediaSource(video_path=str(lost), use_photos=False))
    assert len(got) == len(want)
    clean = list(MediaSource(video_path=str(path), use_photos=False))
    bad = [k for k, (a, b) in enumerate(zip(got, want))
           if not np.array_equal(a, b)]
    if not bad:
        return
    es = mpegts.demux(lost.read_bytes())
    ref = lavc_decode([es[o:o + n] for o, n in mpeg12.split_pictures(es)])
    assert len(ref) == len(got)
    k = bad[0]
    damaged_frame_holds_to_cv2(got[k], swscale_rgb(*ref[k], chroma_left=True),
                               clean[k])


def test_program_stream_of_other_video_refused(tmp_path):
    """A program stream whose video stream holds no MPEG-1/2 sequence
    header (here MPEG-4 Part 2 VOPs): NotImplementedError naming what is
    decoded; a file with no video stream: IOError."""
    from test_torch_mp4 import _lavc_mpeg4

    path = tmp_path / "m4.mpg"
    mpegmux.write_ps(path, _lavc_mpeg4(pan(3, 96, 128), {}))
    with pytest.raises(NotImplementedError, match="not MPEG-1/2 video"):
        MediaSource(video_path=str(path), use_photos=False)
    empty = tmp_path / "audio.mpg"
    empty.write_bytes(mpegmux._pack_header(0, False)
                      + mpegmux.pes(0xC0, mpegmux.mp2_silence(2), 0))
    with pytest.raises(IOError, match="Video wasn't opened"):
        mpegps.open_video(str(empty))


# ------------------------------------------------------------ end to end

def _write_interlaced_ts(path, frames) -> None:
    """The 540x960 frames as an interlaced, B-picture, BT.709 MPEG-2
    transport stream (progressive_frame set to 1: see the module's
    docstring)."""
    packets = encode(frames, {"bf": "2", "flags": "+ildct+ilme",
                              "qmin": "3", "qmax": "3",
                              "colorspace": "bt709",
                              "seq_disp_ext": "always",
                              "alternate_scan": "1", "time_base": "1/25"})
    mpegmux.write_ts(path, [progressive(p) for p in packets])


def test_slam_main_on_mpeg2_ts_against_jax(tmp_path):
    """test_torch_mp4.py's end-to-end test on a 540x960 interlaced,
    B-picture, BT.709 MPEG-2 transport stream: the same frames as the JAX
    package's (cv2), as many cameras, ATE within 0.02 of the extent of the
    median of the JAX package's RANSAC seeds 0-2."""
    from test_torch_mp4 import slam_main_against_jax

    slam_main_against_jax(tmp_path, "", "ts", write=_write_interlaced_ts)


def test_transport_stream_video_types_refused(tmp_path):
    """A transport stream whose video is H.264 or HEVC (stream_type 0x1B,
    0x24): NotImplementedError naming the codec."""
    packets = encode(pan(3, 96, 128), {"bf": "0"})
    for kind, name in ((0x1B, "H.264"), (0x24, "HEVC"), (0x10, "MPEG-4")):
        path = tmp_path / f"v{kind}.ts"
        mpegmux.write_ts(path, packets, stream_type=kind)
        with pytest.raises(NotImplementedError, match=name):
            MediaSource(video_path=str(path), use_photos=False)
        assert mpegts.OTHER_VIDEO[kind].startswith(name)
