"""The port's Motion-JPEG video (io/avi.py over io/jpeg.py, through
``MediaSource(use_photos=False)``) on the CPU: frames bit for bit and frame
for frame against ``cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)`` (whose
frames are libjpeg's decode of each chunk) on files from
``cv2.VideoWriter(..., 'MJPG')`` and from the numpy writer chip_smoke.py
uses; the RIFF walk through ``rec `` lists, other streams and ``AVIX``
extensions; a damaged frame, which keeps the default backend's frame
count; Motion-JPEG in MOV and MP4; and ``slam_main`` on a 540x960 MJPEG AVI against the JAX
package's video run (OpenCV's default backend, whose frames differ from
libjpeg's by a few grey levels): the same frames read, the same number of
cameras, ATE within 0.02 of the extent."""

import struct

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io import avi, jpeg
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
from slam_indoor_code_tpu_torch.testing import mjpeg

torch.set_num_threads(1)


def write_cv2_video(path, frames, fps=10.0):
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                         (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def opencv_mjpeg_frames(path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_OPENCV_MJPEG)
    assert cap.isOpened()
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(np.ascontiguousarray(f[..., ::-1]))


@pytest.fixture(scope="module")
def scene_frames():
    sc = make_scene(n_points=400, n_frames=8, seed=5, baseline=0.3)
    return [sc.render(i) for i in range(8)]


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("hw", [(38, 54), (480, 640)])
def test_frames_equal_opencv_mjpeg_backend(tmp_path, scene_frames, hw,
                                           threads):
    """cv2's MJPG writer (even sizes, not whole MCUs at 38x54): every frame
    as OpenCV's MJPEG backend decodes it, with 1 and 3 decode workers."""
    frames = [np.ascontiguousarray(cv2.resize(f, hw[::-1]))
              for f in scene_frames]
    path = tmp_path / "seq.avi"
    write_cv2_video(path, frames)
    want = opencv_mjpeg_frames(path)
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           threads=threads, prefetch=3))
    assert len(got) == len(want) == len(frames)
    for a, b in zip(got, want):
        assert a.shape == hw + (3,)
        np.testing.assert_array_equal(a, b)
    v = avi.AviVideo(str(path))
    assert (v.fourcc, v.width, v.height) == (b"MJPG", hw[1], hw[0])
    v.close()


def test_numpy_writer_avi_equals_opencv_mjpeg_backend(tmp_path,
                                                      scene_frames):
    """chip_smoke.py's AVI writer over its JPEG writer's frames, which carry
    no DHT: OpenCV's MJPEG backend reads the file, to the port's frames."""
    jpegs = [mjpeg.encode_jpeg(f, 95, dht=False) for f in scene_frames]
    path = tmp_path / "np.avi"
    mjpeg.write_avi(str(path), jpegs, 640, 480)
    want = opencv_mjpeg_frames(path)
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == len(want) == len(jpegs)
    for a, b, j in zip(got, want, jpegs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, jpeg.decode(j))


def _chunk(fcc, data):
    return fcc + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(kind, kids, outer=b"LIST"):
    body = b"".join(kids)
    return outer + struct.pack("<I", len(body) + 4) + kind + body


def test_riff_walk_rec_lists_other_streams_and_avix(tmp_path, scene_frames):
    """An OpenDML-shaped file: stream 0 audio, stream 1 MJPEG; frames in a
    ``rec `` list, beside audio and JUNK chunks, an empty (dropped) frame,
    and in a second RIFF ``AVIX``: every video frame, in file order."""
    jpegs = [mjpeg.encode_jpeg(f[:40, :56], 90) for f in scene_frames[:5]]
    strh_a = b"auds" + bytes(52)
    strh_v = b"vidsMJPG" + bytes(48)
    strf_v = struct.pack("<IiiHH4sIiiII", 40, 56, 40, 1, 24, b"MJPG",
                         0, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", [_chunk(b"avih", bytes(56)),
                           _list(b"strl", [_chunk(b"strh", strh_a),
                                           _chunk(b"strf", bytes(18))]),
                           _list(b"strl", [_chunk(b"strh", strh_v),
                                           _chunk(b"strf", strf_v)])])
    movi = _list(b"movi", [
        _chunk(b"01dc", jpegs[0]), _chunk(b"00wb", b"\1\2\3"),
        _list(b"rec ", [_chunk(b"01dc", jpegs[1]),
                        _chunk(b"00wb", b"\4" * 5)]),
        _chunk(b"01dc", b""), _chunk(b"JUNK", bytes(7)),
        _chunk(b"01dc", jpegs[2])])
    first = _list(b"AVI ", [hdrl, movi, _chunk(b"idx1", bytes(16))],
                  outer=b"RIFF")
    ext = _list(b"AVIX", [_list(b"movi", [
        _chunk(b"ix01", bytes(24)), _chunk(b"01dc", jpegs[3]),
        _chunk(b"01db", jpegs[4])])], outer=b"RIFF")
    path = tmp_path / "odml.avi"
    path.write_bytes(first + ext)
    v = avi.AviVideo(str(path))
    assert (v.fourcc, v.width, v.height, len(v.frames)) == (b"MJPG", 56, 40,
                                                            5)
    v.close()
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           threads=2))
    assert len(got) == 5
    for a, j in zip(got, jpegs):
        np.testing.assert_array_equal(a, jpeg.decode(j))


# ------------------------------------------------- damaged Motion-JPEG
@pytest.mark.parametrize("how", ["half", "90pct", "2bytes", "flip"])
def test_damaged_mjpeg_frame_gives_cv2s_frame_count(tmp_path, scene_frames,
                                                    how):
    """The fifth of eight MJPEG frames (240x320) damaged.  OpenCV's default
    backend (FFmpeg's decoder, which the JAX package reads through) gives a
    frame unless the damage leaves no frame header: 8 frames, or 4 where
    only two bytes are left; the port gives the same count.  The frames
    before equal CAP_OPENCV_MJPEG's (libjpeg's decode); the damaged one is
    libjpeg-turbo's reading of it: with bytes flipped, cv2.imdecode's
    pixels; cut short (cv2.imdecode then refuses it), the undamaged frame's
    pixels down to the cut and mid-grey in the last MCU row, as libjpeg
    leaves the MCUs its data does not reach."""
    frames = [np.ascontiguousarray(cv2.resize(f, (320, 240)))
              for f in scene_frames]
    jpegs = [mjpeg.encode_jpeg(f, 90) for f in frames]
    clean = jpeg.decode(jpegs[4])
    from test_torch_mp4 import _damage
    jpegs[4] = _damage(jpegs[4], how)
    path = tmp_path / "damaged.avi"
    mjpeg.write_avi(str(path), jpegs, 320, 240)
    cap = cv2.VideoCapture(str(path))
    n_cv2 = 0
    while cap.read()[0]:
        n_cv2 += 1
    got = list(MediaSource(video_path=str(path), use_photos=False))
    assert len(got) == n_cv2 == (4 if how == "2bytes" else 8)
    libjpeg = opencv_mjpeg_frames(path)
    for a, b in zip(got[:4], libjpeg):
        np.testing.assert_array_equal(a, b)
    if how == "2bytes":
        return
    if how == "flip":
        want = cv2.imdecode(np.frombuffer(jpegs[4], np.uint8),
                            cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(got[4], want)
        return
    assert cv2.imdecode(np.frombuffer(jpegs[4], np.uint8), 1) is None
    rows = np.flatnonzero((got[4] != clean).any(axis=(1, 2)))
    assert rows[0] >= (0.3 if how == "half" else 0.7) * 240   # cut there
    assert (got[4][-16:] == 128).all()                         # the last MCUs


# --------------------------------------------------- MJPEG in MOV and MP4
@pytest.mark.parametrize("ext", ["mov", "mp4"])
def test_mjpeg_in_mov_and_mp4_equals_cv2(tmp_path, scene_frames, ext):
    """cv2's ``MJPG`` writer into ``.mov`` (sample entry ``jpeg``) and
    ``.mp4`` (``mp4v`` with objectTypeIndication 0x6C): the port reads
    cv2's frame count, each frame libjpeg's decode of its sample
    (cv2.imdecode; FFmpeg's own MJPEG decoder differs by a few grey
    levels, as in AVI), through the same thread pool as MJPEG AVIs."""
    from slam_indoor_code_tpu_torch.io import mp4

    path = tmp_path / f"seq.{ext}"
    h, w = scene_frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                         (w, h))
    for f in scene_frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    video = mp4.Mp4Video(str(path))
    assert video.codec == "mjpeg"
    assert video.fourcc == (b"jpeg" if ext == "mov" else b"mp4v")
    samples = [video.read(f) for f in video.frames]
    video.close()
    cap = cv2.VideoCapture(str(path))
    n_cv2 = 0
    while cap.read()[0]:
        n_cv2 += 1
    got = list(MediaSource(video_path=str(path), use_photos=False,
                           threads=3))
    assert len(got) == len(samples) == n_cv2 == len(scene_frames)
    for a, s in zip(got, samples):
        want = cv2.imdecode(np.frombuffer(s, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(a, want[..., ::-1])


def _cfg(mod, video, out):
    """tests/test_runtime.py's _cfg (device runtime, BA on) over a video."""
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12)
    return mod.Config(
        usePhotosCycle=False, videoSourcePath=str(video),
        outputDataDir=str(out), requiredExtractedPointsCount=80,
        featureExtractingThreshold=20, framesBatchSize=6,
        requiredMatchedPointsCount=30, knnMatcherDistance=0.8,
        RPDistanceThreshold=500.0, useBundleAdjustment=True,
        BAMaxFramesCnt=4, BAUseHuberLossFunction=True,
        BAHuberLossFunctionParameter=2.0, tpu=tpu)


def _rel_ate(scene, gd):
    est = camera_centers(gd.rotations, gd.positions)
    gt = scene.centers()[[int(f) for f in gd.frame_ids]]
    return absolute_trajectory_error(est, gt) / np.linalg.norm(
        gt.max(0) - gt.min(0))


def test_slam_main_on_mjpeg_avi_against_jax_video_run(tmp_path):
    """tests/test_runtime.py's video test at 540x960 through both packages:
    the JAX run reads the AVI through OpenCV's default backend, the port
    through io/avi.py."""
    scene = make_scene(n_points=700, n_frames=14, image_size=(540, 960),
                       seed=5, baseline=0.3)
    path = tmp_path / "seq.avi"
    write_cv2_video(path, [scene.render(i) for i in range(14)])
    n_j = len(list(JMediaSource(video_path=str(path), use_photos=False)))
    n_t = len(list(MediaSource(video_path=str(path), use_photos=False)))
    assert n_t == n_j == 14
    for d in ("jax", "torch"):
        (tmp_path / d).mkdir()
    gd_j = japp.slam_main(_cfg(jconfig, path, tmp_path / "jax"), scene.K)
    gd_t = tapp.slam_main(_cfg(tconfig, path, tmp_path / "torch"), scene.K,
                          device="cpu")
    assert len(gd_t.rotations) == len(gd_j.rotations) >= 10
    rel_t, rel_j = _rel_ate(scene, gd_t), _rel_ate(scene, gd_j)
    assert rel_t < 0.08 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)
