"""The port's MPEG-4 Part 2 interlace (io/mpeg4.py over native/mpeg4.cpp:
the VOL's interlaced bit, top_field_first and alternate_vertical_scan_flag
per VOP) on the CPU, against libavcodec's own decode of the same samples
(``lavc_decode``, one thread, through ctypes; RGB through ``swscale_rgb``,
libswscale's own conversion as OpenCV's backend calls it).  cv2 (OpenCV
5.0.0, FFmpeg 8) cannot be the reference: FFmpeg flags every VOP of an
interlaced VOL interlaced, and cv2 returns uninitialised memory for such
frames (shown here).  Every stream is coded by the ``mpeg4`` encoder of
the libavcodec cv2's wheel carries, ``flags=+ildct+ilme`` (a VOL's
interlaced bit, field DCT and field motion estimation), over frames whose
two fields come from two moments of a pan (so that the encoder picks field
DCT and field vectors): field DCT in I-, P- and B-VOPs, field vectors in
P-VOPs, forward, backward and interpolated field prediction and field
direct mode in B-VOPs, the alternate vertical scan, each with and without
quarter-pel, INTER4V, MPEG quantisation, B-VOPs, video packets and DivX's
packed bitstream, at 38x54 (odd size), 80x144 (an odd number of
macroblocks a row) and 96x128; top_field_first set by hand; damaged
streams; the committed FHD fixture ``headline_asp_interlaced.avi``.

Rewrite the fixture with ``PYTHONPATH=.:tests python
tests/test_torch_mpeg4_interlace.py --write-fixtures`` (~2 min: 32 FHD
renders and their encode)."""

import json
import sys

import numpy as np
import pytest
import torch

import test_torch_mp4 as mp4t
from slam_indoor_code_tpu_torch.io import avi, mpeg4
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import make_scene, mjpeg
from test_torch_mpeg2 import lavc_decode
from test_torch_vp9 import pan

torch.set_num_threads(1)

FIXTURES = mp4t.FIXTURES
DIGESTS = mp4t.DIGESTS
HEADLINE = FIXTURES / "headline_asp_interlaced.avi"
IL = "+ildct+ilme"
TOOLS = {
    "field_dct": {"flags": "+ildct", "bf": "0"},
    "field_mv": {"flags": IL, "bf": "0"},
    "b_vops": {"flags": IL, "bf": "2"},
    "alternate_scan": {"flags": IL, "bf": "2", "alternate_scan": "1"},
    "qpel": {"flags": IL + "+qpel", "bf": "0"},
    "qpel_b": {"flags": IL + "+qpel", "bf": "2"},
    "mv4_b": {"flags": IL + "+mv4", "bf": "1", "mbd": "rd"},
    "mpeg_quant_b": {"flags": IL, "bf": "2", "mpeg_quant": "1"},
    "packets_b": {"flags": IL, "bf": "2", "ps": "300"},
    "all": {"flags": IL + "+qpel+mv4", "bf": "3", "mpeg_quant": "1",
            "alternate_scan": "1", "ps": "400"},
}
# the headline fixture's coding: interlace with B-VOPs, the alternate
# scan and INTER4V at a fixed quantiser, Xvid's fourcc
HEADLINE_OPTS = {"flags": IL + "+mv4+qscale", "bf": "2", "mbd": "rd",
                 "alternate_scan": "1", "qmin": "5", "qmax": "5"}


def combed(n: int, h: int, w: int, seed: int = 0, dy: int = 3,
           dx: int = 4, noise: float = 3.0) -> list:
    """``n`` frames whose top field is one moment of a noisy pan and whose
    bottom field the next: interlaced video as a camera records it."""
    big = pan(2 * n + 1, h, w, dy=dy, dx=dx, noise=noise, seed=seed)
    out = []
    for i in range(n):
        f = big[2 * i].copy()
        f[1::2] = big[2 * i + 1][1::2]
        out.append(f)
    return out


def lavc_rgb(samples) -> list:
    """libavcodec's decode of ``samples`` as OpenCV would convert it, had
    it a defined frame: RGB through libswscale, chroma sited left."""
    return [mp4t.swscale_rgb(*p, chroma_left=True)
            for p in lavc_decode(samples, codec="mpeg4")]


def port_decode(samples, fourcc: bytes = b"XVID"):
    """The port's (Y, U, V) planes and RGB for ``samples`` in display
    order, and its stats."""
    dec = mpeg4.Decoder(b"", fourcc)
    planes, rgb = [], []
    for s in samples:
        p = dec.decode_yuv(s)
        if p is not None:
            planes.append(p)
            rgb.append(dec.rgb())
    p = dec.flush_yuv()
    if p is not None:
        planes.append(p)
        rgb.append(dec.rgb())
    stats = dec.stats()
    dec.close()
    return planes, rgb, stats


def check_equal_lavc(samples, n=None, fourcc: bytes = b"XVID") -> dict:
    """The port's planes and RGB equal libavcodec's decode's, frame for
    frame, in its count (``n`` if given) → the port's stats."""
    want = lavc_decode(samples, codec="mpeg4")
    planes, rgb, stats = port_decode(samples, fourcc)
    assert len(planes) == len(want) > 0
    if n is not None:
        assert len(planes) == n
    for g, w in zip(planes, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(rgb, lavc_rgb(samples)):
        np.testing.assert_array_equal(a, b)
    return stats


@pytest.mark.parametrize("hw", [(80, 144), (96, 128)])
@pytest.mark.parametrize("tool", list(TOOLS))
def test_interlaced_tools_equal_libavcodec(tool, hw):
    """Each tool with interlace: every plane and RGB frame equal to
    libavcodec's, and the decoder's counts show the interlaced tools in
    use."""
    samples = mp4t.lavc_encode("mpeg4", combed(8, *hw), TOOLS[tool])[0]
    stats = check_equal_lavc(samples, 8)
    assert stats["interlaced_vops"] == stats["vops"] == 8
    assert stats["field_dct_mbs"] > 0
    if tool != "field_dct":
        assert stats["field_mc_mbs"] > 0
    if "bf" in TOOLS[tool] and TOOLS[tool]["bf"] != "0":
        assert stats["b_vops"] > 0
    if "alternate_scan" in TOOLS[tool]:
        assert stats["alternate_scan_vops"] == 8


@pytest.mark.parametrize("tool", ["b_vops", "qpel_b", "all"])
def test_odd_size_equals_libavcodec(tool):
    """38x54: a partial macroblock row and column, swscale's scaled path."""
    samples = mp4t.lavc_encode("mpeg4", combed(6, 38, 54, seed=2),
                               TOOLS[tool])[0]
    check_equal_lavc(samples, 6)


@pytest.mark.parametrize("opts", [
    TOOLS["qpel_b"], {**TOOLS["qpel_b"], "mpeg_quant": "1", "bf": "3"}])
def test_field_direct_mode_equals_libavcodec(opts):
    """B-VOP macroblocks in direct mode whose co-located macroblock was
    field-predicted: the co-located field vectors scaled by FFmpeg's field
    distances (pp/pb_field_time, t_frame); a pan of progressive frames,
    on which the encoder picks field vectors in some P-VOP macroblocks and
    direct mode in many B-VOP ones."""
    samples = mp4t.lavc_encode("mpeg4", pan(12, 96, 128, dy=2, dx=3,
                                            noise=3.0), opts)[0]
    stats = check_equal_lavc(samples, 12)
    assert stats["field_direct_mbs"] > 0


def _set_top_field_first(sample: bytes, time_bits: int) -> bytes:
    """``sample``'s VOP with top_field_first set to 1 (read after
    intra_dc_vlc_thr, as decode_vop_header reads it)."""
    i = sample.index(b"\0\0\1\xb6") + 4
    bits = "".join(f"{b:08b}" for b in sample[i:i + 16])
    kind = int(bits[:2], 2)
    p = 2
    while bits[p] == "1":          # modulo_time_base
        p += 1
    p += 1 + 1 + time_bits + 1     # its 0, marker, increment, marker
    if bits[p] != "1":             # vop_coded 0
        return sample
    p += 1 + (kind == 1) + 3       # vop_coded, rounding, dc threshold
    bits = bits[:p] + "1" + bits[p + 1:]
    return sample[:i] + int(bits, 2).to_bytes(16, "big") + sample[i + 16:]


def test_top_field_first_set_by_hand_equals_libavcodec():
    """top_field_first 1 in every VOP (libavcodec writes 0 from frames
    without the flag): field direct mode scales by other field distances;
    every frame equal to libavcodec's."""
    samples = mp4t.lavc_encode("mpeg4", pan(12, 96, 128, dy=2, dx=3,
                                            noise=3.0), TOOLS["qpel_b"])[0]
    tb = mjpeg.vop_time_bits(samples[0])
    tff = [_set_top_field_first(s, tb) for s in samples]
    assert tff != samples
    stats = check_equal_lavc(tff, 12)
    assert stats["field_direct_mbs"] > 0


@pytest.mark.parametrize("user", [b"DivX503b1393p", b"DivX503b1393"])
def test_divx_packed_interlaced_equals_libavcodec(tmp_path, user):
    """DivX's packed bitstream (the B-VOP behind the P-VOP in one sample,
    an N-VOP after it) with interlace, through an AVI: the port's frames
    equal libavcodec's decode of the same samples."""
    samples = mp4t.lavc_encode("mpeg4", combed(8, 96, 128, seed=3),
                               TOOLS["b_vops"])[0]
    packed = mjpeg.pack_divx(samples, user)
    path = tmp_path / "packed.avi"
    mjpeg.write_avi(str(path), packed, 128, 96, fourcc=b"DX50")
    want = lavc_rgb(packed)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cv2_is_no_reference_for_interlaced_frames(tmp_path):
    """Why these tests hold the port to libavcodec: cv2's frames of an
    interlaced stream are not the decode (its swscale call fails for frames
    FFmpeg flags interlaced and it returns its buffer as it was), while the
    port's equal libavcodec's; the same stream with the VOL's interlaced
    bit clear cannot be written, so the progressive coding of the same
    frames is held to cv2 instead."""
    frames = combed(6, 96, 128)
    samples = mp4t.lavc_encode("mpeg4", frames, TOOLS["field_dct"])[0]
    path = tmp_path / "il.avi"
    mjpeg.write_avi(str(path), samples, 128, 96, fourcc=b"XVID")
    want = lavc_rgb(samples)
    reads = [mp4t.cv2_rgb(path) for _ in range(3)]
    assert all(len(r) == len(want) for r in reads)
    assert any(not np.array_equal(a, b) for r in reads
               for a, b in zip(r, want))
    got = list(MediaSource(video_path=str(path), use_photos=False))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    prog = mp4t.lavc_encode("mpeg4", frames, {"bf": "2"})[0]
    ppath = tmp_path / "p.avi"
    mjpeg.write_avi(str(ppath), prog, 128, 96, fourcc=b"XVID")
    for a, b in zip(MediaSource(video_path=str(ppath), use_photos=False),
                    mp4t.cv2_rgb(ppath)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("how", ["half", "90pct", "flip"])
@pytest.mark.parametrize("which", ["P", "B"])
def test_damaged_interlaced_stream(how, which):
    """A P- or B-VOP of an interlaced ``bf`` 2 stream at 240x320 damaged
    (renders of a moving scene, each frame's fields from two of them):
    libavcodec's frame count, and every frame the damage does not reach
    equal to libavcodec's; of a damaged P-VOP the first frame it reaches
    as ``damaged_frame_holds_to_cv2`` states against libavcodec's (FFmpeg
    re-estimates up to 50 macroblocks before the damage; a damaged B-VOP's
    concealment is FFmpeg's own, as in tests/test_torch_mpeg4_asp.py)."""
    sc = make_scene(n_points=400, n_frames=40, seed=5, baseline=0.3)
    renders = [sc.render(i)[::2, ::2] for i in range(21)]
    frames = []
    for i in range(10):
        f = renders[2 * i].copy()
        f[1::2] = renders[2 * i + 1][1::2]
        frames.append(np.ascontiguousarray(f))
    samples = mp4t.lavc_encode("mpeg4", frames, TOOLS["b_vops"])[0]
    kinds = "".join("IPBS"[s[s.index(b"\0\0\1\xb6") + 4] >> 6]
                    for s in samples)
    k = kinds.index(which, 3)
    clean = port_decode(samples)[1]
    samples[k] = mp4t._damage(samples[k], how)
    want = lavc_rgb(samples)
    _, got, _ = port_decode(samples)
    assert len(got) == len(want) == len(clean)
    reached = [j for j, (a, b) in enumerate(zip(got, clean))
               if not np.array_equal(a, b)]
    first = reached[0] if reached else len(got)
    for j in [j for j in range(len(got)) if j not in reached]:
        np.testing.assert_array_equal(got[j], want[j])
    if which == "P" and reached:
        mp4t.damaged_frame_holds_to_cv2(got[first], want[first],
                                        clean[first])


def test_xvix_interlace_refused_by_name():
    """Interlace in a stream tagged XVIX, where FFmpeg reads dct_type on
    uncoded macroblocks too (FF_BUG_XVID_ILACE): the decoder raises
    ValueError naming it (the AVI reader names no XVIX decoder)."""
    samples = mp4t.lavc_encode("mpeg4", combed(3, 96, 128),
                               TOOLS["field_mv"])[0]
    dec = mpeg4.Decoder(b"", b"XVIX")
    with pytest.raises(ValueError, match="XVIX"):
        dec.decode(samples[0])


# ---------------------------------------------------------- fixture

def headline_samples() -> list:
    """The headline scene's 32 FHD renders (headline_asp_packed.avi's)
    coded with HEADLINE_OPTS."""
    sc = make_scene(n_points=1500, n_frames=32, image_size=(1080, 1920),
                    seed=7, baseline=0.25, kind="hallway")
    return mp4t.lavc_encode("mpeg4", [sc.render(i) for i in range(32)],
                            HEADLINE_OPTS)[0]


def fixture_digest(samples) -> dict:
    """The sha256 of libavcodec's decode of ``samples``: RGB through
    swscale and the Y planes."""
    planes = lavc_decode(samples, codec="mpeg4")
    rgb = [mp4t.swscale_rgb(*p, chroma_left=True) for p in planes]
    return {"frames": len(rgb), "shape": list(rgb[0].shape),
            "reference": "libavcodec's mpeg4 decode on one thread "
                         "(lavc_decode), RGB through libswscale "
                         "(swscale_rgb): cv2 returns uninitialised memory "
                         "for interlaced frames",
            "rgb_sha256": [mp4t._sha(f) for f in rgb],
            "y_sha256": [mp4t._sha(p[0]) for p in planes]}


def write_fixtures() -> None:
    samples = headline_samples()
    mjpeg.write_avi(str(HEADLINE), samples, 1920, 1080, fourcc=b"XVID")
    table = json.loads(DIGESTS.read_text())
    table[HEADLINE.name] = fixture_digest(samples)
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_headline_fixture_holds_recorded_sha256():
    """The committed FHD fixture (what chip_smoke.py's asp phase holds the
    card to): Xvid-tagged, interlaced, with B-VOPs and the alternate scan,
    under 4 MB; libavcodec's decode still gives the recorded sha256, and so
    does the port's through MediaSource (RGB) and its decoder (Y); the
    decoder's counts show field DCT, field prediction and field direct
    mode."""
    table = json.loads(DIGESTS.read_text())[HEADLINE.name]
    assert HEADLINE.stat().st_size <= 4_000_000
    video = avi.open_video(str(HEADLINE))
    assert video.fourcc == b"XVID"
    samples = [video.read(f) for f in video.frames]
    video.close()
    assert table["frames"] == 32 and "libavcodec" in table["reference"]
    assert fixture_digest(samples)["rgb_sha256"] == table["rgb_sha256"]
    got = list(MediaSource(video_path=str(HEADLINE), use_photos=False))
    assert [mp4t._sha(f) for f in got] == table["rgb_sha256"]
    planes, _, stats = port_decode(samples)
    assert [mp4t._sha(p[0]) for p in planes] == table["y_sha256"]
    assert stats["interlaced_vops"] == stats["alternate_scan_vops"] == 32
    assert stats["b_vops"] >= 16
    assert stats["field_dct_mbs"] > 0 and stats["field_mc_mbs"] > 0
    assert stats["field_direct_mbs"] > 0


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
