"""The port's chessboard corner detection (calibration/corners.py) against
OpenCV's, on the CPU, and the board renderer it is tested on
(testing/board.py).

- ``corner_subpix`` against ``cv2.cornerSubPix`` from the same starts
  (cv2's own corners moved by up to ±1.5 px from a seed): within 1e-3 px.
- Detection against the JAX package's call (``cv2.findChessboardCorners``
  then ``cornerSubPix`` with an 11x11 window, 30 iterations, eps 1e-3) on a
  seeded set of 64 renders at 640x480 and 4 at 1080x1920: random pose and
  in-plane angle, distortion on three in four, Gaussian blur 0/0.8/1.5 px
  and gray noise 0/2/5 levels.  At most 2 % of the boards are found by one
  and not the other; on the boards both find, the order is OpenCV's on at
  least 98 % of them, a board whose order differs differs by a rotation of
  the grid only, and every corner lies within 0.05 px of OpenCV's.
- Negatives give None in both: a blank image, noise, a 6x7 board, a board
  cut by the frame, a board with one square covered.
- Detection runs with cv2 blocked.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.calibration import chessboard as jcb
from slam_indoor_code_tpu_torch.calibration import chessboard as tcb
from slam_indoor_code_tpu_torch.calibration import corners
from slam_indoor_code_tpu_torch.testing import board, realtex

torch.set_num_threads(1)

CRIT = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)


def _rot(aa):
    th = np.linalg.norm(aa)
    if th < 1e-12:
        return np.eye(3)
    k = aa / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _camera(size):
    H, W = size
    f = 1.25 * W
    return np.array([[f, 0, W / 2], [0, 1.01 * f, H / 2], [0, 0, 1.0]])


def _views(seed, n, size):
    """``n`` views with every inner corner 20 px inside the frame: pose,
    in-plane angle, distortion (none on one in four), blur, noise."""
    H, W = size
    K = _camera(size)
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        R = _rot(rng.normal(0, 0.35, 3)) @ _rot(
            np.array([0, 0, rng.uniform(-np.pi, np.pi)]))
        t = np.array([rng.uniform(-40, 40), rng.uniform(-30, 30),
                      rng.uniform(400, 650)]) - R @ np.array([60, 60, 0.0])
        dist = np.array([rng.uniform(-0.25, 0.25), rng.uniform(-0.3, 0.3),
                         rng.uniform(-2e-3, 2e-3), rng.uniform(-2e-3, 2e-3),
                         0.0])
        if rng.random() < 0.25:
            dist[:] = 0
        p = board.project_corners(K, dist, R, t)
        if p.min() < 20 or p[:, 0].max() > W - 20 or p[:, 1].max() > H - 20:
            continue
        out.append((K, dist, R, t, rng.choice([0, 0, 0.8, 1.5]),
                    rng.choice([0, 2, 5]), int(rng.integers(1 << 30))))
    return out


def _image(view, size):
    K, dist, R, t, blur, noise, seed = view
    img = board.render_view(K, dist, R, t, size)
    if blur:
        img = cv2.GaussianBlur(img, (0, 0), blur)
    if noise:
        img = img + np.random.default_rng(seed).normal(0, noise, img.shape)
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return img


def _cv2_corners(img):
    found, c = cv2.findChessboardCorners(img, (7, 7))
    return c.reshape(-1, 2) if found else None


def _grid_rotations(c):
    g = c.reshape(7, 7, 2)
    return [np.rot90(g, k, axes=(0, 1)).reshape(-1, 2) for k in range(4)]


@pytest.fixture(scope="module")
def detections():
    """(both, one_only, n): per board found by both, the port's refined
    corners and the JAX package's; the boards only one finds."""
    both, one_only, n = [], [], 0
    for size, views in (((480, 640), _views(0, 64, (480, 640))),
                        ((1080, 1920), _views(1, 4, (1080, 1920)))):
        for k, view in enumerate(views):
            img = _image(view, size)
            got = tcb.find_chessboard_corners(img.astype(np.float64))
            want = jcb.find_chessboard_corners(img.astype(np.float64))
            n += 1
            if (got is None) != (want is None):
                one_only.append((size, k, got is not None))
            elif got is not None:
                both.append((size, k, got, want))
    return both, one_only, n


def test_detection_finds_the_boards_cv2_finds(detections):
    both, one_only, n = detections
    assert len(both) >= 0.9 * n, (len(both), n)
    assert len(one_only) <= 0.02 * n, one_only


def test_detection_order_is_cv2s(detections):
    both, _, _ = detections
    differ = [(size, k) for size, k, got, want in both
              if np.abs(got - want).max() > 0.05]
    assert len(differ) <= 0.02 * len(both), differ
    for size, k, got, want in both:
        if np.abs(got - want).max() > 0.05:
            # a differing order is a rotation of the grid, nothing else
            assert min(np.abs(r - want).max()
                       for r in _grid_rotations(got)) <= 0.05, (size, k)


def test_detection_positions_within_005px(detections):
    both, _, _ = detections
    worst = max(min(np.abs(r - want).max() for r in _grid_rotations(got))
                for _, _, got, want in both)
    assert worst <= 0.05, worst


@pytest.mark.parametrize("size,seed", [((480, 640), 3), ((480, 640), 4),
                                       ((480, 640), 5), ((1080, 1920), 6)])
def test_corner_subpix_equals_cv2(size, seed):
    """From the same starts (cv2's corners moved by up to ±1.5 px)."""
    view = _views(seed, 1, size)[0]
    img = _image(view, size)
    c = _cv2_corners(img)
    assert c is not None
    start = (c + np.random.default_rng(seed).uniform(-1.5, 1.5, c.shape)
             ).astype(np.float32)
    want = cv2.cornerSubPix(img, start.reshape(-1, 1, 2).copy(), (11, 11),
                            (-1, -1), CRIT).reshape(-1, 2)
    got = corners.corner_subpix(img, start)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_corner_subpix_window_and_zero_zone_equal_cv2():
    img = _image(_views(7, 1, (480, 640))[0], (480, 640))
    c = _cv2_corners(img)
    start = (c + np.random.default_rng(7).uniform(-1, 1, c.shape)).astype(
        np.float32)
    crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 15, 0.01)
    want = cv2.cornerSubPix(img, start.reshape(-1, 1, 2).copy(), (5, 7),
                            (1, 1), crit).reshape(-1, 2)
    got = corners.corner_subpix(img, start, (5, 7), (1, 1), 15, 0.01)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _negative(kind):
    size = (480, 640)
    K = _camera(size)
    R, t = np.eye(3), np.array([-60.0, -60.0, 560.0])
    rng = np.random.default_rng(11)
    if kind == "blank":
        return np.full(size, 200, np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, size, dtype=np.uint8)
    if kind == "6x7 board":
        return board.render_view(K, np.zeros(5), R, t, size,
                                 pattern_size=(6, 7))
    if kind == "cut by the frame":
        return board.render_view(K, np.zeros(5), R,
                                 np.array([-300.0, -60.0, 560.0]), size)
    if kind == "one square covered":
        img = board.render_view(K, np.zeros(5), R, t, size)
        # paint over the black square between inner corners (2,2)-(3,3)
        p = board.project_corners(K, np.zeros(5), R, t).reshape(7, 7, 2)
        (x0, y0), (x1, y1) = p[2, 2], p[3, 3]
        img[int(y0) - 1:int(np.ceil(y1)) + 2,
            int(x0) - 1:int(np.ceil(x1)) + 2] = 255
        return img
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["blank", "noise", "6x7 board",
                                  "cut by the frame", "one square covered"])
def test_negatives_give_none_in_both(kind):
    img = _negative(kind)
    assert jcb.find_chessboard_corners(img.astype(np.float64)) is None
    assert tcb.find_chessboard_corners(img.astype(np.float64)) is None


def test_detection_runs_with_cv2_blocked(monkeypatch):
    size = (480, 640)
    img = _image(_views(8, 1, size)[0], size).astype(np.float64)
    want = tcb.find_chessboard_corners(img)
    assert want is not None
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tcb.find_chessboard_corners(img)
    np.testing.assert_array_equal(got, want)


def test_board_render_equals_cv2_warp():
    """With no distortion the render is tests/test_calibration.py's:
    cv2.warpPerspective of the same texture, white outside."""
    size = (480, 640)
    K = np.array([[800.0, 0, 320.0], [0, 810.0, 240.0], [0, 0, 1.0]])
    R = _rot(np.array([0.2, -0.15, 0.4]))
    t = np.array([-50.0, -40.0, 470.0])
    tex, T = board.board_texture()
    Hm = K @ np.column_stack([R[:, 0], R[:, 1], t]) @ np.linalg.inv(T)
    want = cv2.warpPerspective(tex, Hm, (640, 480), flags=cv2.INTER_LINEAR,
                               borderValue=255)
    np.testing.assert_array_equal(board.render_view(K, np.zeros(5), R, t,
                                                    size), want)
    np.testing.assert_array_equal(
        realtex.warp_perspective(tex, Hm, size, border=255), want)


def test_distorted_render_puts_corners_at_the_projection():
    """The detected corners of a clean distorted render lie on the exact
    projection of the board's corners."""
    size = (480, 640)
    K = _camera(size)
    R = _rot(np.array([0.25, 0.3, 0.6]))
    t = np.array([-10.0, 0.0, 520.0]) - R @ np.array([60, 60, 0.0])
    dist = np.array([0.2, -0.25, 1e-3, -1e-3, 0.0])
    img = board.render_view(K, dist, R, t, size)
    got = tcb.find_chessboard_corners(img.astype(np.float64))
    truth = board.project_corners(K, dist, R, t)
    err = min(np.linalg.norm(r - truth, axis=1).max()
              for r in _grid_rotations(got))
    assert err < 0.1, err
    noisy = board.render_view(K, dist, R, t, size, noise=2, seed=4)
    assert np.array_equal(
        noisy, board.render_view(K, dist, R, t, size, noise=2, seed=4))
    assert 0 < np.abs(noisy.astype(int) - img).mean() < 3


def survey(seed: int, n: int, size=(480, 640)) -> dict:
    """Detection against the JAX package's OpenCV call on ``n`` renders of
    the test set's kind from ``seed``: boards found by both, by one only,
    by neither; boards whose order differs; the largest corner distance
    (grid rotations allowed); and how often cv2's first corner is the
    topmost of the four outer ones (the geometric rule the port does not
    use)."""
    out = dict(both=0, port_only=0, cv2_only=0, neither=0, order_differs=0,
               max_px=0.0, cv2_first_is_topmost=0)
    for view in _views(seed, n, size):
        img = _image(view, size).astype(np.float64)
        got = tcb.find_chessboard_corners(img)
        want = jcb.find_chessboard_corners(img)
        if got is None or want is None:
            key = ("neither" if got is None and want is None else
                   "port_only" if want is None else "cv2_only")
            out[key] += 1
            continue
        out["both"] += 1
        out["order_differs"] += int(np.abs(got - want).max() > 0.05)
        out["max_px"] = max(out["max_px"], min(
            np.abs(r - want).max() for r in _grid_rotations(got)))
        outer = want[[0, 6, 42, 48], 1]
        out["cv2_first_is_topmost"] += int(outer.argmin() == 0)
    return out


if __name__ == "__main__":
    # python tests/test_torch_corners.py SEED N: the survey at 640x480
    print(survey(int(sys.argv[1]), int(sys.argv[2])))
