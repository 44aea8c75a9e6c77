"""Rendered views of the calibration chessboard with exact corners, from a
seed: what calibration from pixels is tested on without a camera.

The board is tests/test_calibration.py's: the pattern's inner corners
(7×7 by default) at ``CELL_SIZE`` board units apart, (pattern+1) squares a
side with square (0, 0) black, inside a white border two squares wide.
A view is the board through K, the five distortion coefficients
(k1, k2, p1, p2, k3) and the pose R, t (board point (X, Y, 0) → camera
R·X + t), in gray u8:

- with no distortion, ``testing/realtex.py::warp_perspective`` of the
  board texture (20 px a square, white outside it), OpenCV 5's float32
  ``warpPerspective`` with INTER_LINEAR, equal to cv2's;
- with distortion, a per-pixel inverse map in torch on ``device``: pixel
  centres are undistorted by fixed-point iteration
  (``cv2.undistortPoints``' scheme; every fourth pixel, interpolated
  bilinearly between) and taken through the board plane's inverse
  homography; a pixel near an edge is the mean of 4×4 sub-samples through
  that map linearised at its centre, each coloured black or white exactly,
  so edges are anti-aliased.

Gray noise of ``noise`` levels (numpy, from ``seed``) is added last and
the sum rounded half to even.
"""

from __future__ import annotations

import numpy as np
import torch

from ..calibration.chessboard import CELL_SIZE, PATTERN_SIZE
from .realtex import warp_perspective

PX_PER_CELL = 20
BORDER_CELLS = 2
SUPERSAMPLE = 4
UNDISTORT_ITERS = 10
MAP_STEP = 4


def board_texture(pattern_size=PATTERN_SIZE):
    """The board as a u8 texture and the map board units → texture px."""
    nx, ny = pattern_size[0] + 1, pattern_size[1] + 1
    border = BORDER_CELLS * PX_PER_CELL
    tex = np.full((ny * PX_PER_CELL + 2 * border,
                   nx * PX_PER_CELL + 2 * border), 255, np.uint8)
    for by in range(ny):
        for bx in range(nx):
            if (bx + by) % 2 == 0:
                y0 = border + by * PX_PER_CELL
                x0 = border + bx * PX_PER_CELL
                tex[y0:y0 + PX_PER_CELL, x0:x0 + PX_PER_CELL] = 0
    s = PX_PER_CELL / CELL_SIZE
    T = np.array([[s, 0, border + PX_PER_CELL],
                  [0, s, border + PX_PER_CELL], [0, 0, 1.0]])
    return tex, T


def project_corners(K, dist, R, t, pattern_size=PATTERN_SIZE) -> np.ndarray:
    """The inner corners' exact pixels [w·h, 2], row-major from (0, 0)."""
    w, h = pattern_size
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    obj = np.stack([xs.ravel() * CELL_SIZE, ys.ravel() * CELL_SIZE,
                    np.zeros(w * h)], 1)
    Xc = obj @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    x, y = Xc[:, 0] / Xc[:, 2], Xc[:, 1] / Xc[:, 2]
    k1, k2, p1, p2, k3 = np.asarray(dist, np.float64)
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], 1)


def _board_plane(R, t) -> np.ndarray:
    """Homography board units (X, Y, 1) → normalised camera (x, y, 1)."""
    R = np.asarray(R, np.float64)
    return np.column_stack([R[:, 0], R[:, 1], np.asarray(t, np.float64)])


def _undistort(K, dist, u, v, iters: int = UNDISTORT_ITERS):
    """Normalised undistorted coordinates (x, y) seen at pixels (u, v)."""
    k1, k2, p1, p2, k3 = (float(c) for c in dist)
    xd = (u - K[0, 2]) / K[0, 0]
    yd = (v - K[1, 2]) / K[1, 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (xd - dx) * icdist, (yd - dy) * icdist
    return x, y


def _board_xy(K, dist, Hinv, size, device):
    """Board-plane point (X, Y) seen at each pixel of the [H+2, W+2] grid
    from (-1, -1), and whether it lies in front of the camera.  The
    undistortion is computed every ``MAP_STEP`` pixels and interpolated
    bilinearly (it is smooth; the homography is not interpolated)."""
    H, W = size
    nv, nu = -(-(H + 1) // MAP_STEP) + 1, -(-(W + 1) // MAP_STEP) + 1
    v = (torch.arange(nv, dtype=torch.float64, device=device) * MAP_STEP
         - 1)[:, None]
    u = (torch.arange(nu, dtype=torch.float64, device=device) * MAP_STEP
         - 1)[None, :]
    x, y = _undistort(K, dist, *torch.broadcast_tensors(u, v))
    full = torch.nn.functional.interpolate(
        torch.stack([x, y])[None], size=((nv - 1) * MAP_STEP + 1,
                                         (nu - 1) * MAP_STEP + 1),
        mode="bilinear", align_corners=True)[0, :, :H + 2, :W + 2]
    x, y = full[0], full[1]
    w = Hinv[2, 0] * x + Hinv[2, 1] * y + Hinv[2, 2]
    X = (Hinv[0, 0] * x + Hinv[0, 1] * y + Hinv[0, 2]) / w
    Y = (Hinv[1, 0] * x + Hinv[1, 1] * y + Hinv[1, 2]) / w
    return X, Y, w > 0


def _colour(X, Y, front, pattern_size):
    """0 on the board's black squares, 255 elsewhere."""
    bx = torch.floor(X / CELL_SIZE) + 1
    by = torch.floor(Y / CELL_SIZE) + 1
    black = ((bx >= 0) & (bx <= pattern_size[0]) & (by >= 0)
             & (by <= pattern_size[1]) & ((bx + by) % 2 == 0) & front)
    return (~black).to(X.dtype) * 255.0


def _distorted(K, dist, R, t, size, pattern_size, device) -> torch.Tensor:
    """Mean board colour of each pixel's 4×4 sub-samples, float64 [H,W].
    The map is computed at pixel centres (and one pixel beyond); a pixel
    whose 3×3 neighbourhood is all one colour is that colour, and the rest
    are supersampled through the map linearised at their centre."""
    H, W = size
    Hinv = torch.as_tensor(np.linalg.inv(_board_plane(R, t)),
                           dtype=torch.float64, device=device)
    X, Y, front = _board_xy(K, dist, Hinv, size, device)
    col = _colour(X, Y, front, pattern_size)
    img = col[1:-1, 1:-1].clone()
    edge = torch.zeros((H, W), dtype=torch.bool, device=device)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            edge |= col[dy:dy + H, dx:dx + W] != img
    ys, xs = torch.nonzero(edge, as_tuple=True)
    ys1, xs1 = ys + 1, xs + 1
    # d(X, Y)/du and /dv by central differences
    Xu = (X[ys1, xs1 + 1] - X[ys1, xs1 - 1]) / 2
    Yu = (Y[ys1, xs1 + 1] - Y[ys1, xs1 - 1]) / 2
    Xv = (X[ys1 + 1, xs1] - X[ys1 - 1, xs1]) / 2
    Yv = (Y[ys1 + 1, xs1] - Y[ys1 - 1, xs1]) / 2
    X0, Y0, f0 = X[ys1, xs1], Y[ys1, xs1], front[ys1, xs1]
    offs = ((np.arange(SUPERSAMPLE) + 0.5) / SUPERSAMPLE - 0.5).tolist()
    acc = torch.zeros(len(ys), dtype=torch.float64, device=device)
    for oy in offs:
        for ox in offs:
            acc += _colour(X0 + ox * Xu + oy * Xv, Y0 + ox * Yu + oy * Yv,
                           f0, pattern_size)
    img[ys, xs] = acc / SUPERSAMPLE ** 2
    return img


def render_view(K, dist, R, t, size, noise: float = 0.0, seed: int = 0,
                pattern_size=PATTERN_SIZE, device="cpu") -> np.ndarray:
    """One gray u8 view [H,W] of the board (see the module docstring)."""
    K = np.asarray(K, np.float64)
    if not np.any(np.asarray(dist, np.float64)):
        tex, T = board_texture(pattern_size)
        Hm = K @ _board_plane(R, t) @ np.linalg.inv(T)
        img = warp_perspective(tex, Hm, tuple(size), device=device,
                               border=255).astype(np.float64)
    else:
        img = _distorted(K, dist, R, t, tuple(size), pattern_size,
                         device).cpu().numpy()
    if noise:
        img = img + np.random.default_rng(seed).normal(0.0, noise, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)
