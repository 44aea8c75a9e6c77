"""The port's chessboard calibration (calibration/) against the JAX
package's, on the CPU: twins of tests/test_calibration.py on the same
synthetic views (seed 9, 8 views of the 7×7 board, 0.1 px noise).

The port is held to the JAX test's own bounds against the truth, and to the
JAX package's ``calibrate_camera`` on the same views: K within 2e-3
relative, dist[0:2] within 5e-3 absolute, rms within 0.01 px.  From pixels,
the port's corner detection (calibration/corners.py) against the JAX
package's OpenCV call on a render, and ``run_from_config`` with
``calibrate`` on the same PNG photos in both packages: K within 1e-3
relative, dist within 1e-3, rms within 1e-3 px.  The twin of
tests/test_calibration.py's video test writes its MJPEG AVI with the numpy
writer (testing/mjpeg.py); the JAX package reads it with
``cv2.VideoCapture``, the port with ``MediaSource``; each K lies within 2 %
of the truth and within 1e-3 (relative) of the other.  The video branch's
gray is ``cv2.cvtColor(BGR2GRAY)``'s, bit for bit.
"""

import sys

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.calibration import chessboard as jcb
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.calibration import chessboard as tcb
from slam_indoor_code_tpu_torch.io import png, xmlio as txml

torch.set_num_threads(1)


def _project_board(K, dist, R, t, obj):
    # tests/test_calibration.py's projector
    Xc = obj @ R.T + t
    x = Xc[:, 0] / Xc[:, 2]
    y = Xc[:, 1] / Xc[:, 2]
    r2 = x * x + y * y
    k1, k2, p1, p2, k3 = dist
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], axis=1)


def _rot(rng, scale=0.35):
    aa = rng.normal(0, scale, 3)
    th = np.linalg.norm(aa)
    if th < 1e-9:
        return np.eye(3)
    k = aa / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


@pytest.fixture(scope="module")
def calib_views():
    # tests/test_calibration.py's fixture
    rng = np.random.default_rng(9)
    K_gt = np.array([[900.0, 0, 330.0], [0, 910.0, 250.0], [0, 0, 1.0]])
    dist_gt = np.array([0.08, -0.15, 0.001, -0.0005, 0.0])
    obj = tcb.make_object_points()
    views = []
    for _ in range(8):
        R = _rot(rng)
        t = np.array([rng.uniform(-40, 40), rng.uniform(-40, 40),
                      rng.uniform(320, 520)])
        uv = _project_board(K_gt, dist_gt, R, t, obj)
        uv += rng.normal(0, 0.1, uv.shape)
        views.append(uv)
    return K_gt, dist_gt, obj, views


@pytest.fixture(scope="module")
def both(calib_views):
    _, _, obj, views = calib_views
    return (tcb.calibrate_camera(obj, views, device="cpu"),
            jcb.calibrate_camera(obj, views))


def test_object_points_equal_jax():
    np.testing.assert_array_equal(tcb.make_object_points(),
                                  jcb.make_object_points())
    np.testing.assert_array_equal(tcb.make_object_points((5, 4), 3.0),
                                  jcb.make_object_points((5, 4), 3.0))


def test_calibrate_recovers_intrinsics(calib_views, both):
    """Twin of test_calibration.py::test_calibrate_recovers_intrinsics, with
    its bounds."""
    K_gt, dist_gt, _, _ = calib_views
    K, dist, rvecs, tvecs, rms = both[0]
    assert rms < 0.3, f"rms {rms}"
    assert abs(K[0, 0] - K_gt[0, 0]) / K_gt[0, 0] < 0.01
    assert abs(K[1, 1] - K_gt[1, 1]) / K_gt[1, 1] < 0.01
    assert abs(K[0, 2] - K_gt[0, 2]) < 6
    assert abs(K[1, 2] - K_gt[1, 2]) < 6
    assert abs(dist[0] - dist_gt[0]) < 0.03
    assert abs(dist[1] - dist_gt[1]) < 0.1
    assert rvecs.shape == tvecs.shape == (8, 3)


def test_calibrate_matches_jax(both):
    (K, dist, rvecs, tvecs, rms), (jK, jdist, jr, jt, jrms) = both
    np.testing.assert_allclose(K, jK, rtol=2e-3, atol=0)
    np.testing.assert_allclose(dist[:2], jdist[:2], rtol=0, atol=5e-3)
    assert abs(rms - jrms) < 0.01, (rms, jrms)


def test_closed_form_equals_jax(calib_views):
    """The numpy closed form is the JAX package's, so its homographies,
    initial K and extrinsics are equal."""
    _, _, obj, views = calib_views
    for uv in views[:3]:
        np.testing.assert_array_equal(tcb._homography_dlt(obj[:, :2], uv),
                                      jcb._homography_dlt(obj[:, :2], uv))
    Hs = [tcb._homography_dlt(obj[:, :2], uv) for uv in views]
    K0 = tcb._intrinsics_from_homographies(Hs)
    np.testing.assert_array_equal(K0, jcb._intrinsics_from_homographies(Hs))
    for H in Hs:
        for a, b in zip(tcb._extrinsics_from_homography(K0, H),
                        jcb._extrinsics_from_homography(K0, H)):
            np.testing.assert_array_equal(a, b)


def test_residual_view_equals_jax(calib_views, rng):
    import jax.numpy as jnp

    _, _, obj, views = calib_views
    params = np.array([900, 910, 330, 250, 0.08, -0.15, 1e-3, -5e-4, 0.0,
                       0.1, -0.2, 0.05, 3.0, -4.0, 400.0], np.float32)
    got = tcb._residual_view(torch.from_numpy(params),
                             torch.from_numpy(obj.astype(np.float32)),
                             torch.from_numpy(views[0].astype(np.float32)))
    want = jcb._residual_view(jnp.asarray(params),
                              jnp.asarray(obj, jnp.float32),
                              jnp.asarray(views[0], jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_calibrate_saves_reference_xml(calib_views, tmp_path):
    """Twin of test_calibration.py::test_calibrate_saves_reference_xml,
    written by the port's xmlio and read back by both packages."""
    from slam_indoor_code_tpu.io.xmlio import load_matrix_from_xml

    _, _, obj, views = calib_views
    K, dist, rvecs, tvecs, rms = tcb.calibrate_camera(obj, views[:4],
                                                      device="cpu")
    p = str(tmp_path / "cam.xml")
    txml.save_calib_parameters_to_xml(p, K, dist.reshape(1, 5), rvecs, tvecs)
    for load in (txml.load_matrix_from_xml, load_matrix_from_xml):
        np.testing.assert_allclose(load(p, "K"), K, atol=1e-8)
        assert load(p, "DC").shape == (1, 5)
        assert load(p, "R").shape == (4, 3)


def _jax_no_cv2_error(monkeypatch) -> str:
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        with pytest.raises(RuntimeError) as e:
            jcb.find_chessboard_corners(np.zeros((8, 8)))
    return str(e.value)


def _rendered_views(n, seed):
    """``n`` 480x640 renders of the board (testing/board.py) through K_gt
    with distortion and noise of one gray level, every inner corner 20 px
    inside the frame."""
    from slam_indoor_code_tpu_torch.testing import board

    H, W = size = (480, 640)
    dist = np.array([0.08, -0.15, 1e-3, -5e-4, 0.0])
    K = np.array([[800.0, 0, W / 2], [0, 810.0, H / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        R = _rot(rng, scale=0.3)
        t = np.array([rng.uniform(-40, 40), rng.uniform(-30, 30),
                      rng.uniform(420, 600)]) - R @ np.array([60, 60, 0.0])
        p = board.project_corners(K, dist, R, t)
        if p.min() < 20 or p[:, 0].max() > W - 20 or p[:, 1].max() > H - 20:
            continue
        out.append(board.render_view(K, dist, R, t, size, noise=1.0,
                                     seed=len(out)))
    return K, out


def test_find_corners_raises_jax_no_cv2_error(monkeypatch):
    """Where the JAX package raises its no-cv2 error, the port's detection
    (no OpenCV) finds the corners OpenCV finds, in OpenCV's order."""
    _, views = _rendered_views(2, seed=5)
    for img in views:
        want = jcb.find_chessboard_corners(img.astype(np.float64))
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "cv2", None)
            got = tcb.find_chessboard_corners(img.astype(np.float64))
        assert got.shape == want.shape == (49, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    assert "cv2" in _jax_no_cv2_error(monkeypatch)


def _spy_calibrate(monkeypatch, module):
    """Record what ``module.calibrate_camera`` returns."""
    seen = []
    orig = module.calibrate_camera

    def spy(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "calibrate_camera", spy)
    return seen


def test_run_from_config_calibrate_on_photos(tmp_path, monkeypatch):
    """``calibrate`` on the same PNG photos in both packages: the port's K
    within 1e-3 (relative) of the JAX package's, dist within 1e-3, rms
    within 1e-3 px, and the XML written and read back by both."""
    from slam_indoor_code_tpu import app as japp
    from slam_indoor_code_tpu import config as jconfig
    from slam_indoor_code_tpu.io.xmlio import load_matrix_from_xml

    photos = tmp_path / "photos"
    photos.mkdir()
    K_gt, views = _rendered_views(10, seed=21)
    for i, img in enumerate(views):
        png.write_png(str(photos / f"board_{i:02d}.png"),
                      np.repeat(img[..., None], 3, axis=2))
    got = _spy_calibrate(monkeypatch, tcb)
    want = _spy_calibrate(monkeypatch, jcb)
    kw = dict(usePhotosCycle=True, calibrate=True,
              photosPathPattern=str(photos / "*.png"),
              outputDataDir=str(tmp_path / "out"))
    tapp.run_from_config(tconfig.Config(
        calibrationPath=str(tmp_path / "cam.xml"), **kw), device="cpu")
    japp.run_from_config(jconfig.Config(
        calibrationPath=str(tmp_path / "jcam.xml"), **kw))
    (K, dist, rvecs, _, rms), = got
    (jK, jdist, _, _, jrms), = want
    assert rvecs.shape == (10, 3)
    np.testing.assert_allclose(K, jK, rtol=1e-3, atol=0)
    np.testing.assert_allclose(dist, jdist, rtol=0, atol=1e-3)
    assert abs(rms - jrms) < 1e-3, (rms, jrms)
    assert rms < 0.3
    np.testing.assert_allclose(K[0, 0], K_gt[0, 0], rtol=0.01)
    for load in (txml.load_matrix_from_xml, load_matrix_from_xml):
        np.testing.assert_allclose(load(str(tmp_path / "cam.xml"), "K"), K,
                                   atol=1e-6)
        assert load(str(tmp_path / "cam.xml"), "R").shape == (10, 3)


def _video_views():
    """tests/test_calibration.py::test_video_calibration_entry_point's
    eight views, rendered by testing/board.py (equal to its cv2 warps)."""
    from slam_indoor_code_tpu_torch.testing import board

    rng = np.random.default_rng(3)
    K_gt = np.array([[800.0, 0, 320.0], [0, 810.0, 240.0], [0, 0, 1.0]])
    W, H = 640, 480
    views = []
    while len(views) < 8:
        R = _rot(rng, scale=0.25)
        t = np.array([rng.uniform(-30, 30), rng.uniform(-25, 25),
                      rng.uniform(380, 560)])
        corners = _project_board(K_gt, np.zeros(5), R, t,
                                 tcb.make_object_points())
        if (corners.min() < 20 or corners[:, 0].max() > W - 20
                or corners[:, 1].max() > H - 20):
            continue
        views.append(board.render_view(K_gt, np.zeros(5), R, t, (H, W)))
    return K_gt, views


def test_calibrate_video_raises_as_media_source(tmp_path, monkeypatch):
    """Video calibration opens the video as ``MediaSource`` does (a missing
    file raises its ``IOError``); on the twin of tests/test_calibration.py's
    video (its eight views, each ten times, as q95 MJPEG from the numpy
    writer) both packages recover K within 2 % of the truth, and within
    1e-3 (relative) of each other."""
    from slam_indoor_code_tpu.calibration.chessboard import \
        main_calibration_entry_point as jentry
    from slam_indoor_code_tpu.config import Config as JConfig
    from slam_indoor_code_tpu.config import TpuConfig
    from slam_indoor_code_tpu.io.xmlio import load_matrix_from_xml
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg

    cfg = tconfig.Config(usePhotosCycle=False, calibrate=True,
                         videoSourcePath=str(tmp_path / "calib.avi"),
                         calibrationPath=str(tmp_path / "cam.xml"),
                         outputDataDir=str(tmp_path))
    with pytest.raises(IOError) as e:
        tapp.run_from_config(cfg, device="cpu")
    with pytest.raises(IOError) as want:
        MediaSource(video_path=cfg.videoSourcePath, use_photos=False)
    assert str(e.value) == str(want.value)
    K_gt, views = _video_views()
    jpegs = [mjpeg.encode_jpeg(np.repeat(v[..., None], 3, axis=2))
             for v in views for _ in range(10)]
    mjpeg.write_avi(cfg.videoSourcePath, jpegs, 640, 480)
    got = _spy_calibrate(monkeypatch, tcb)
    tapp.run_from_config(cfg, device="cpu")
    K = got[0][0]
    jK, _, jrms = jentry(JConfig(
        usePhotosCycle=False, videoSourcePath=cfg.videoSourcePath,
        calibrationPath=str(tmp_path / "jcam.xml"), calibrate=True,
        outputDataDir=str(tmp_path), tpu=TpuConfig()))
    for k in (K, jK):
        np.testing.assert_allclose(np.diag(k)[:2], np.diag(K_gt)[:2],
                                   rtol=0.02)
        np.testing.assert_allclose(k[:2, 2], K_gt[:2, 2], rtol=0.02)
    np.testing.assert_allclose(K, jK, rtol=1e-3, atol=0)
    np.testing.assert_allclose(load_matrix_from_xml(cfg.calibrationPath,
                                                    "K"), K, atol=1e-6)


def test_video_branch_gray_equals_cv2(tmp_path, monkeypatch):
    """The video branch detects on ``cv2.cvtColor(frame, BGR2GRAY)`` of the
    decoded frame, bit for bit (OpenCV's fixed point, not a truncated
    float dot product)."""
    import cv2

    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg

    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
              for _ in range(10)]
    path = str(tmp_path / "v.avi")
    mjpeg.write_avi(path, [mjpeg.encode_jpeg(f) for f in frames], 64, 48)
    seen = []
    monkeypatch.setattr(tcb, "find_chessboard_corners",
                        lambda gray, *a: seen.append(gray))
    cfg = tconfig.Config(usePhotosCycle=False, calibrate=True,
                         videoSourcePath=path,
                         calibrationPath=str(tmp_path / "cam.xml"))
    with pytest.raises(RuntimeError, match="not enough chessboard views"):
        tcb.main_calibration_entry_point(cfg, device="cpu")
    src = MediaSource(video_path=path, use_photos=False)
    decoded = list(src)
    src.close()
    want = cv2.cvtColor(decoded[9][..., ::-1].copy(), cv2.COLOR_BGR2GRAY)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], want)
    assert not np.array_equal(
        seen[0], (decoded[9] @ np.array([0.299, 0.587, 0.114])).astype(
            np.uint8))


@pytest.mark.parametrize("pil", [True, False])
def test_corner_overlay_png(tmp_path, monkeypatch, pil):
    """The overlay marks each corner red; without PIL the port's own PNG
    writer saves it (the JAX package then saves nothing)."""
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    else:
        pytest.importorskip("PIL")
    img = np.full((40, 50, 3), 200, np.uint8)
    corners = np.array([[10.2, 12.7], [30.0, 20.4]])
    path = str(tmp_path / "corners.png")
    tcb._save_corner_overlay(img, corners, path)
    got = png.read_png(path)
    assert got.shape == img.shape
    np.testing.assert_array_equal(got[13, 10], [255, 0, 0])
    np.testing.assert_array_equal(got[20, 30], [255, 0, 0])
    np.testing.assert_array_equal(got[0, 0], [200, 200, 200])


def agreement() -> dict:
    """The numbers behind the photo and video tests: the port against the
    JAX package on the same PNG photos and on the same MJPEG AVI (K's
    largest relative difference, dist's largest absolute difference, the
    rms difference), and how far cv2's default video backend decodes that
    AVI from ``MediaSource`` (gray levels, share of pixels)."""
    import glob
    import tempfile

    import cv2

    from slam_indoor_code_tpu.config import Config as JConfig
    from slam_indoor_code_tpu.config import TpuConfig
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg

    def diff(a, b):
        return dict(K_rel=float(np.max(np.abs(a[0] - b[0]) / b[0].max())),
                    dist_abs=float(np.abs(a[1] - b[1]).max()),
                    rms_px=float(abs(a[2] - b[2])))

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for i, img in enumerate(_rendered_views(10, seed=21)[1]):
            png.write_png(f"{d}/b{i:02d}.png",
                          np.repeat(img[..., None], 3, axis=2))
        paths = sorted(glob.glob(f"{d}/*.png"))
        out["photos"] = diff(
            tcb.chessboard_photos_calibration(paths, f"{d}/t.xml",
                                              device="cpu"),
            jcb.chessboard_photos_calibration(paths, f"{d}/j.xml"))
        views = _video_views()[1]
        mjpeg.write_avi(f"{d}/v.avi", [
            mjpeg.encode_jpeg(np.repeat(v[..., None], 3, axis=2))
            for v in views for _ in range(10)], 640, 480)
        kw = dict(usePhotosCycle=False, videoSourcePath=f"{d}/v.avi",
                  calibrate=True, outputDataDir=d)
        out["video"] = diff(
            tcb.main_calibration_entry_point(tconfig.Config(
                calibrationPath=f"{d}/t.xml", **kw), device="cpu"),
            jcb.main_calibration_entry_point(JConfig(
                calibrationPath=f"{d}/j.xml", tpu=TpuConfig(), **kw)))
        src = MediaSource(video_path=f"{d}/v.avi", use_photos=False)
        ours = list(src)
        src.close()
        cap = cv2.VideoCapture(f"{d}/v.avi")
        theirs = []
        while (frame := cap.read())[0]:
            theirs.append(frame[1][..., ::-1].astype(int))
        out["decode"] = dict(
            max_levels=int(max(np.abs(a - b).max()
                               for a, b in zip(ours, theirs))),
            share=float(np.mean([(a != b).mean()
                                 for a, b in zip(ours, theirs)])))
    return out


if __name__ == "__main__":
    # python tests/test_torch_chessboard.py
    print(agreement())
