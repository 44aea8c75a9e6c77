"""The port's MPEG-4 Part 2 data partitioning (io/mpeg4.py over
native/mpeg4.cpp: the VOL's data_partitioned bit; each video packet of an
I- or P-VOP in three partitions: the macroblocks' modes with their DCs or
motion vectors, a DC or motion marker, ac_pred/CBPY/DQUANT, then the
texture) on the CPU, against OpenCV's default FFmpeg backend bit for bit
in RGB and Y.  Every stream is coded by the ``mpeg4`` encoder of the
libavcodec cv2's wheel carries with ``data_partitioning=1`` (the option as
the encoder spells it; the VOL's bit is read back here): I- and P-VOPs
with many video packets (``ps``), INTER4V, quarter-pel, MPEG quantisation,
B-VOPs (which are not partitioned), low quantisers, at 38x54, 96x128 and
240x320; damaged partitions (cv2 on one thread: its threads make a
concealed frame vary between reads); RVLC and data partitioning with
interlace refused by name; the committed FHD fixture ``asp_dp_fhd.avi``;
``slam_main`` on a 540x960 data-partitioned Xvid AVI against the JAX
package's.

Rewrite the fixture with ``PYTHONPATH=.:tests python
tests/test_torch_mpeg4_dp.py --write-fixtures`` (~20 s)."""

import json
import sys

import numpy as np
import pytest
import torch

import test_torch_mp4 as mp4t
from slam_indoor_code_tpu_torch.io import avi, mpeg4
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import make_scene, mjpeg
from test_torch_vp9 import pan

torch.set_num_threads(1)

FIXTURES = mp4t.FIXTURES
DIGESTS = mp4t.DIGESTS
FIXTURE = FIXTURES / "asp_dp_fhd.avi"
DP = {"data_partitioning": "1"}
TOOLS = {
    "ip": {"bf": "0"},
    "packets": {"bf": "0", "ps": "200"},
    "b_vops": {"bf": "2", "ps": "300"},
    "mv4": {"bf": "1", "flags": "+mv4", "mbd": "rd", "ps": "300"},
    "qpel": {"bf": "2", "flags": "+qpel", "ps": "300"},
    "mpeg_quant": {"bf": "1", "mpeg_quant": "1", "ps": "300"},
    "low_quant": {"bf": "0", "qmin": "1", "qmax": "3", "ps": "500"},
    "all": {"bf": "3", "flags": "+mv4+qpel", "mpeg_quant": "1", "ps": "250",
            "mbd": "rd"},
}


def encode(frames, options: dict) -> list:
    return mp4t.lavc_encode("mpeg4", frames, {**DP, **options})[0]


def write(path, samples, hw, fourcc: bytes = b"XVID"):
    mjpeg.write_avi(str(path), samples, hw[1], hw[0], fourcc=fourcc)
    return path


def port_planes(samples, fourcc: bytes = b"XVID"):
    """The port's planes for ``samples`` in display order, and its
    stats."""
    dec = mpeg4.Decoder(b"", fourcc)
    out = [p for p in (dec.decode_yuv(s) for s in samples) if p is not None]
    last = dec.flush_yuv()
    if last is not None:
        out.append(last)
    stats = dec.stats()
    dec.close()
    return out, stats


def vol_bits(sample: bytes) -> dict:
    """The VOL fields up to reversible_vlc (a VOL as libavcodec writes it:
    no loaded matrices), and the bit position of data_partitioned."""
    i = sample.index(b"\0\0\1\x20") + 4
    bits = "".join(f"{b:08b}" for b in sample[i:i + 40])
    p = 1 + 8
    verid = 1
    if bits[p] == "1":
        verid = int(bits[p + 1:p + 5], 2)
        p += 7
    p += 1
    if int(bits[p:p + 4], 2) == 15:
        p += 16
    p += 4
    control = bits[p] == "1"        # vol_control_parameters
    p += 1
    if control:
        p += 3                      # chroma_format, low_delay
        p += 1 + (79 if bits[p] == "1" else 0)  # vbv_parameters
    p += 2 + 1                      # shape, marker
    res = int(bits[p:p + 16], 2)
    p += 16 + 1
    tb = max(1, (res - 1).bit_length())
    p += 1 + (tb if bits[p] == "1" else 0)      # fixed_vop_rate
    p += 1 + 13 + 1 + 13 + 1
    out = {"interlaced": int(bits[p])}
    p += 1 + 1 + (1 if verid == 1 else 2) + 1
    out["quant_type"] = int(bits[p])
    if out["quant_type"]:
        assert bits[p + 1:p + 3] == "00"        # default matrices
    p += 1 + (2 if out["quant_type"] else 0)
    if verid != 1:
        p += 1
    p += 1 + 1                      # complexity disable, resync disable
    out["data_partitioned"] = int(bits[p])
    out["at"] = (i * 8) + p
    out["reversible_vlc"] = int(bits[p + 1]) if out["data_partitioned"] \
        else 0
    return out


def set_bit(data: bytes, at: int) -> bytes:
    b = bytearray(data)
    b[at >> 3] |= 0x80 >> (at & 7)
    return bytes(b)


def check_equal_cv2(path, n=None) -> dict:
    """Every frame through MediaSource equals cv2's RGB, every Y plane
    cv2's Y read, in cv2's count; the decoder's stats."""
    want = mp4t.cv2_rgb(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) > 0
    if n is not None:
        assert len(got) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    video = avi.open_video(str(path))
    luma = mp4t.port_luma(video)
    samples = [video.read(f) for f in video.frames]
    video.close()
    for a, b in zip(luma, mp4t.cv2_luma(path, got[0].shape[:2])):
        np.testing.assert_array_equal(a, b)
    return port_planes(samples)[1]


@pytest.mark.parametrize("hw", [(96, 128), (240, 320)])
@pytest.mark.parametrize("tool", list(TOOLS))
def test_partitioned_tools_equal_cv2(tmp_path, tool, hw):
    """Each tool with data partitioning, the VOL's bit set: every frame
    equal to cv2's in RGB and Y; every I- and P-VOP read in partitions."""
    frames = pan(8, *hw, dy=2, dx=3, noise=2.0)
    samples = encode(frames, TOOLS[tool])
    vol = vol_bits(samples[0])
    assert vol["data_partitioned"] == 1 and vol["reversible_vlc"] == 0
    stats = check_equal_cv2(write(tmp_path / "dp.avi", samples, hw), 8)
    refs = stats["vops"] - stats["b_vops"]
    assert stats["partitioned_packets"] >= refs > 0
    if "ps" in TOOLS[tool] and hw == (240, 320):
        assert stats["partitioned_packets"] > refs


@pytest.mark.parametrize("tool", ["packets", "all"])
def test_odd_size_equals_cv2(tmp_path, tool):
    """38x54: a partial macroblock row and column."""
    frames = pan(6, 38, 54, dy=1, dx=2, noise=2.0, seed=4)
    check_equal_cv2(write(tmp_path / "odd.avi", encode(frames, TOOLS[tool]),
                          (38, 54)), 6)


def partitioned_frame_holds(got, want, clean, intra: bool,
                            tol_mean=8.0):
    """A concealed frame of a partitioned VOP against the reference's: of
    an I-VOP, equal in the macroblock rows more than ceil(100 / macroblocks
    per row) rows above the first one damaged (FFmpeg's error resilience
    marks up to 100 coded macroblocks before the damage in a partitioned
    frame, 50 in others: ``damaged_frame_holds_to_cv2``; in a P-VOP the
    skipped macroblocks it passes over do not count, so the rows it
    re-renders reach further up); over the frame a mean |difference| below
    ``tol_mean`` grey levels."""
    h, w = got.shape[:2]
    if intra:
        rows = np.flatnonzero((got != clean).any(axis=(1, 2)))
        first = rows[0] // 16 if len(rows) else h // 16 + 1
        exact = 16 * max(0, first - -(-100 // -(-w // 16)))
        np.testing.assert_array_equal(got[:exact], want[:exact])
    assert np.abs(got.astype(int) - want).mean() < tol_mean


@pytest.mark.parametrize("how", ["half", "90pct", "2bytes", "flip"])
@pytest.mark.parametrize("which", ["I", "P"])
def test_damaged_partitions(tmp_path, how, which):
    """An I- or P-VOP of a packetised stream at 240x320 damaged (cut, cut
    to its first bytes, or bytes flipped a third of the way in, where they
    hit a partition of a packet): cv2's frame count; the frames before the
    damage equal; the first the damage reaches as
    ``partitioned_frame_holds`` states; the port resumes at the next packet
    whose header parses, as FFmpeg resumes.  cv2 on one thread is the
    reference (``cv2_rgb_one_thread``)."""
    sc = make_scene(n_points=400, n_frames=40, seed=5, baseline=0.3)
    frames = [np.ascontiguousarray(sc.render(i)[::2, ::2]) for i in range(10)]
    samples = encode(frames, {"bf": "0", "ps": "300", "g": "6"})
    k = 6 if which == "I" else 4
    clean_path = write(tmp_path / "clean.avi", samples, (240, 320))
    clean = list(MediaSource(video_path=str(clean_path), use_photos=False))
    samples[k] = mp4t._damage(samples[k], how)
    path = tmp_path / "d.avi"
    mjpeg.write_avi(str(path), samples, 320, 240, fourcc=b"XVID")
    want = mp4t.cv2_rgb_one_thread(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == len(mp4t.cv2_rgb(path))
    for a, b in zip(got[:k], want):
        np.testing.assert_array_equal(a, b)
    if len(got) > k:
        partitioned_frame_holds(got[k], want[k], clean[k], which == "I")


def test_damage_in_one_packet_resumes_at_the_next():
    """Eight bytes cut out of an early packet of an I-VOP: the packets
    after it decode as in the undamaged stream (rows below the concealed
    packet equal the clean decode), and the VOP counts as concealed."""
    sc = make_scene(n_points=400, n_frames=40, seed=5, baseline=0.3)
    frames = [np.ascontiguousarray(sc.render(i)[::2, ::2]) for i in range(2)]
    samples = encode(frames, {"bf": "0", "ps": "400"})
    clean, st = port_planes(samples)
    assert st["partitioned_packets"] >= 4
    data = bytearray(samples[0])
    starts = [i for i in range(len(data) - 3)
              if data[i:i + 3] == b"\0\0\1"]
    vop = data.index(b"\0\0\1\xb6")
    at = vop + (len(data) - vop) // 4
    del data[at:at + 8]
    assert all(s <= vop or s > at + 8 for s in starts)
    got, st = port_planes([bytes(data)] + samples[1:])
    assert st["concealed_vops"] >= 1
    diff = np.flatnonzero((got[0][0] != clean[0][0]).any(axis=1))
    assert 0 < len(diff) and diff[-1] < 240 - 32
    np.testing.assert_array_equal(got[0][0][diff[-1] + 16:],
                                  clean[0][0][diff[-1] + 16:])


def test_rvlc_and_interlace_refused_by_name():
    """The VOL's reversible_vlc bit set (RVLC: no encoder this decoder is
    held to writes it), and data partitioning with interlace (libavcodec's
    encoder writes dct_type and field bits into the partitions, which
    FFmpeg's decoder does not read): ValueError naming each."""
    frames = pan(3, 96, 128)
    samples = encode(frames, {"bf": "0"})
    vol = vol_bits(samples[0])
    rvlc = [set_bit(samples[0], vol["at"] + 1)] + samples[1:]
    dec = mpeg4.Decoder(b"", b"XVID")
    with pytest.raises(ValueError, match="RVLC"):
        dec.decode(rvlc[0])
    il = encode(frames, {"bf": "0", "flags": "+ildct+ilme"})
    assert vol_bits(il[0])["interlaced"] == 1
    dec = mpeg4.Decoder(b"", b"XVID")
    with pytest.raises(ValueError, match="data partitioning with interlace"):
        dec.decode(il[0])


# ---------------------------------------------------------- fixture

def write_fixtures() -> None:
    """Eight of the headline scene's FHD renders coded with data
    partitioning, video packets, B-VOPs and INTER4V into an XVID AVI, and
    the sha256 of cv2's decode."""
    sc = make_scene(n_points=1500, n_frames=32, image_size=(1080, 1920),
                    seed=7, baseline=0.25, kind="hallway")
    samples = encode([sc.render(i) for i in range(8)],
                     {"bf": "2", "flags": "+mv4+qscale", "mbd": "rd",
                      "ps": "1400", "qmin": "6", "qmax": "6"})
    mjpeg.write_avi(str(FIXTURE), samples, 1920, 1080, fourcc=b"XVID")
    table = json.loads(DIGESTS.read_text())
    rgb = mp4t.cv2_rgb(FIXTURE)
    table[FIXTURE.name] = {
        "frames": len(rgb), "shape": list(rgb[0].shape),
        "rgb_sha256": [mp4t._sha(f) for f in rgb],
        "y_sha256": [mp4t._sha(y) for y in
                     mp4t.cv2_luma(FIXTURE, rgb[0].shape[:2])]}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fhd_fixture_holds_recorded_sha256():
    """The committed FHD fixture (what chip_smoke.py's asp phase holds the
    card to): data partitioning in every I- and P-VOP, many packets each;
    cv2's decode still gives the recorded sha256, and so does the port's
    in RGB and Y."""
    table = json.loads(DIGESTS.read_text())[FIXTURE.name]
    assert FIXTURE.stat().st_size <= 1_500_000
    assert [mp4t._sha(f) for f in mp4t.cv2_rgb(FIXTURE)] == \
        table["rgb_sha256"]
    got = list(MediaSource(video_path=str(FIXTURE), use_photos=False))
    assert [mp4t._sha(f) for f in got] == table["rgb_sha256"]
    video = avi.open_video(str(FIXTURE))
    samples = [video.read(f) for f in video.frames]
    assert [mp4t._sha(y) for y in mp4t.port_luma(video)] == \
        table["y_sha256"]
    video.close()
    assert vol_bits(samples[0])["data_partitioned"] == 1
    stats = port_planes(samples)[1]
    assert stats["partitioned_packets"] > 2 * (stats["vops"] -
                                               stats["b_vops"])


def test_slam_main_on_partitioned_xvid_avi_against_jax(tmp_path):
    """slam_main on a 540x960 XVID AVI coded with data partitioning and
    video packets (progressive): the same frames bit for bit as the JAX
    package's (cv2's), as many cameras, ATE within 0.02 of the extent."""
    def write_dp(path, frames):
        samples = encode(frames, {"bf": "0", "ps": "1000", "qmin": "2",
                                  "qmax": "2"})
        assert vol_bits(samples[0])["data_partitioned"] == 1
        mjpeg.write_avi(str(path), samples, 960, 540, fourcc=b"XVID")

    mp4t.slam_main_against_jax(tmp_path, "XVID", "avi", write=write_dp)


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
