"""The port's chessboard calibration (calibration/) against the JAX
package's, on the CPU: twins of tests/test_calibration.py on the same
synthetic views (seed 9, 8 views of the 7×7 board, 0.1 px noise).

The port is held to the JAX test's own bounds against the truth, and to the
JAX package's ``calibrate_camera`` on the same views: K within 2e-3
relative, dist[0:2] within 5e-3 absolute, rms within 0.01 px.  Corner
detection is OpenCV's in the JAX package, so the port's photo entry point
raises the JAX package's own no-cv2 error (on photos, and on the tenth
frame of an MJPEG AVI).  tests/test_calibration.py's video
test has no twin: it writes its video with cv2's VideoWriter and detects
the corners with cv2, neither of which the port has.
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


def test_find_corners_raises_jax_no_cv2_error(monkeypatch):
    with pytest.raises(RuntimeError) as e:
        tcb.find_chessboard_corners(np.zeros((8, 8)))
    assert str(e.value) == _jax_no_cv2_error(monkeypatch)


def test_run_from_config_calibrate_on_photos(tmp_path, monkeypatch):
    """``calibrate`` dispatches to main_calibration_entry_point, which
    decodes the photos and stops at detection with the JAX package's
    no-cv2 error; nothing is written."""
    photos = tmp_path / "photos"
    photos.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        png.write_png(str(photos / f"board_{i}.png"),
                      rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    cfg = tconfig.Config(usePhotosCycle=True, calibrate=True,
                         photosPathPattern=str(photos / "*.png"),
                         calibrationPath=str(tmp_path / "cam.xml"),
                         outputDataDir=str(tmp_path / "out"))
    with pytest.raises(RuntimeError) as e:
        tapp.run_from_config(cfg, device="cpu")
    assert str(e.value) == _jax_no_cv2_error(monkeypatch)
    assert not (tmp_path / "cam.xml").exists()


def test_calibrate_video_raises_as_media_source(tmp_path, monkeypatch):
    """Video calibration opens the video as ``MediaSource`` does (a missing
    file raises its ``IOError``), and on an MJPEG AVI stops at the tenth
    frame's corner detection with the JAX package's no-cv2 error; nothing
    is written."""
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg

    cfg = tconfig.Config(usePhotosCycle=False, calibrate=True,
                         videoSourcePath=str(tmp_path / "calib.avi"),
                         calibrationPath=str(tmp_path / "cam.xml"))
    with pytest.raises(IOError) as e:
        tapp.run_from_config(cfg, device="cpu")
    with pytest.raises(IOError) as want:
        MediaSource(video_path=cfg.videoSourcePath, use_photos=False)
    assert str(e.value) == str(want.value)
    rng = np.random.default_rng(0)
    frames = [mjpeg.encode_jpeg(rng.integers(0, 255, (24, 32, 3),
                                             dtype=np.uint8))
              for _ in range(10)]
    mjpeg.write_avi(cfg.videoSourcePath, frames, 32, 24)
    with pytest.raises(RuntimeError) as e:
        tapp.run_from_config(cfg, device="cpu")
    assert str(e.value) == _jax_no_cv2_error(monkeypatch)
    assert not (tmp_path / "cam.xml").exists()


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
