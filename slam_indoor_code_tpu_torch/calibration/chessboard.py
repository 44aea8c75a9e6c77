"""Chessboard camera calibration: Zhang's closed form and a joint
Levenberg–Marquardt refinement (counterpart of the JAX package's
calibration/chessboard.py; the reference citations are there).

The closed form (DLT homographies, Zhang's B-matrix intrinsics, extrinsics
from each homography) is numpy, copied.  The refinement over (fx, fy, cx,
cy, k1, k2, p1, p2, k3, per-view R|t) runs in float32 on the caller's
device with the Jacobian from ``torch.func.jacfwd`` (``jax.jacfwd`` in the
JAX code); accept/reject and the damping schedule are the JAX package's, and
the loop reads nothing back from the device until it ends.

Corner detection is OpenCV's ``findChessboardCorners`` then
``cornerSubPix`` in the JAX package; here it is calibration/corners.py, in
numpy, held to OpenCV on the same images.  The video branch takes the gray
``cv2.cvtColor(BGR2GRAY)`` gives the JAX package (``host_gray``, OpenCV's
fixed point); the photo branch truncates the float dot product to u8, as
the JAX package's does.
"""

from __future__ import annotations

import glob as _glob
import os

import numpy as np
import torch
from torch.func import vmap

from .. import resolve_device
from ..geometry.rotations import matrix_to_rodrigues, rodrigues_to_matrix
from ..io.xmlio import save_calib_parameters_to_xml
from ..models.frontend import host_gray
from ..utils.autodiff import jacfwd
from .corners import corner_subpix, find_corners

PATTERN_SIZE = (7, 7)  # inner corners, reference cameraCalibration.cpp:15
CELL_SIZE = 20.0       # arbitrary board units (reference uses unit cells)


def make_object_points(pattern_size=PATTERN_SIZE,
                       cell: float = CELL_SIZE) -> np.ndarray:
    """Planar board corner coordinates [N,3] (z=0)."""
    w, h = pattern_size
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([xs.ravel() * cell, ys.ravel() * cell,
                     np.zeros(w * h)], axis=1).astype(np.float64)


def find_chessboard_corners(gray: np.ndarray, pattern_size=PATTERN_SIZE):
    """Detect inner corners (host-side).  Returns [N,2] float64 in
    OpenCV's order, or None."""
    img8 = gray.astype(np.uint8)
    corners = find_corners(img8, pattern_size)
    if corners is None:
        return None
    corners = corner_subpix(img8, corners, (11, 11), (-1, -1), 30, 1e-3)
    return corners.astype(np.float64)


# ------------------------------------------------------------- Zhang closed form
def _homography_dlt(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """Normalized DLT homography board→image, [3,3]."""

    def normalize(pts):
        mu = pts.mean(0)
        scale = np.sqrt(2) / max(np.linalg.norm(pts - mu, axis=1).mean(), 1e-12)
        T = np.array([[scale, 0, -scale * mu[0]],
                      [0, scale, -scale * mu[1]],
                      [0, 0, 1.0]])
        ph = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ T.T
        return ph[:, :2], T

    src, Ts = normalize(obj_xy)
    dst, Td = normalize(img_xy)
    n = len(src)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        X, Y = src[i]
        u, v = dst[i]
        A[2 * i] = [-X, -Y, -1, 0, 0, 0, u * X, u * Y, u]
        A[2 * i + 1] = [0, 0, 0, -X, -Y, -1, v * X, v * Y, v]
    _, _, Vt = np.linalg.svd(A)
    Hn = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def _intrinsics_from_homographies(Hs: list[np.ndarray]) -> np.ndarray:
    """Closed-form K from ≥3 homographies via Zhang's B-matrix constraints
    (zero-skew parameterization recovered afterwards)."""

    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.asarray(V)
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _extrinsics_from_homography(K: np.ndarray, H: np.ndarray):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / max(np.linalg.norm(Kinv @ h1), 1e-12)
    r1 = lam * Kinv @ h1
    r2 = lam * Kinv @ h2
    t = lam * Kinv @ h3
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:  # board must be in front of the camera
        R[:, :2] *= -1
        t = -t
    return R, t


# ------------------------------------------------------ joint LM refinement
def _residual_view(params: torch.Tensor, obj: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """Reprojection residual of one view: params = [fx,fy,cx,cy,
    k1,k2,p1,p2,k3, aa(3), t(3)]."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2, k3 = params[4], params[5], params[6], params[7], params[8]
    R = rodrigues_to_matrix(params[9:12])
    t = params[12:15]
    Xc = obj @ R.T + t
    x = Xc[:, 0] / Xc[:, 2]
    y = Xc[:, 1] / Xc[:, 2]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    u = fx * xd + cx
    v = fy * yd + cy
    return torch.stack([u - uv[:, 0], v - uv[:, 1]], -1).reshape(-1)


def calibrate_camera(obj_points: np.ndarray, image_points: list[np.ndarray],
                     iters: int = 40, device=None):
    """Full calibration from V views of a planar target, refined on
    ``device`` (None = CUDA; raises without a GPU).

    Returns (K [3,3], dist [5], rvecs [V,3], tvecs [V,3], rms)."""
    V = len(image_points)
    assert V >= 3, "need ≥3 views for Zhang initialization"
    dev = resolve_device(device)
    obj_xy = obj_points[:, :2]
    Hs = [_homography_dlt(obj_xy, uv) for uv in image_points]
    K0 = _intrinsics_from_homographies(Hs)
    exts = [_extrinsics_from_homography(K0, H) for H in Hs]

    obj = torch.as_tensor(obj_points, dtype=torch.float32, device=dev)
    uvs = torch.as_tensor(np.stack(image_points), dtype=torch.float32,
                          device=dev)
    intr0 = np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2],
                      0, 0, 0, 0, 0], np.float32)
    views0 = np.zeros((V, 6), np.float32)
    views0[:, :3] = matrix_to_rodrigues(torch.from_numpy(
        np.stack([R for R, _ in exts]).astype(np.float32))).numpy()
    views0[:, 3:] = np.stack([t for _, t in exts])

    def f(flat):
        intr = flat[:9]

        def one(view, uv):
            return _residual_view(torch.cat([intr, view]), obj, uv)

        return vmap(one)(flat[9:].reshape(V, 6), uvs).reshape(-1)

    flat = torch.as_tensor(np.concatenate([intr0, views0.reshape(-1)]),
                           device=dev)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r = f(flat)
        J = jacfwd(f)(flat)
        H = J.T @ J
        g = J.T @ r
        Hd = H + lam * torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6))
        new = flat - torch.linalg.solve_ex(Hd, g)[0]
        better = (f(new) ** 2).sum() < (r ** 2).sum()
        flat = torch.where(better, new, flat)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    cost = (f(flat) ** 2).sum()

    flat = flat.cpu().numpy().astype(np.float64)
    intr, views = flat[:9], flat[9:].reshape(V, 6)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1.0]])
    rms = float(np.sqrt(float(cost) / (2 * V * len(obj_points))))
    return K, intr[4:9], views[:, :3], views[:, 3:], rms


# --------------------------------------------------------------- entry points
def _save_corner_overlay(img: np.ndarray, corners: np.ndarray, path: str):
    """Headless stand-in for the reference's visualCalibration corner display
    (drawChessboardCorners + imshow): save an overlay artifact instead,
    with the port's PNG writer."""
    from ..io.png import write_png

    out = np.array(img, copy=True)
    for u, v in corners:
        ui, vi = int(round(u)), int(round(v))
        out[max(0, vi - 2):vi + 3, max(0, ui - 2):ui + 3] = [255, 0, 0]
    write_png(path, out)


def _calibrate_and_save(obj, img_pts, save_path: str, device=None):
    K, dist, rvecs, tvecs, rms = calibrate_camera(obj, img_pts,
                                                  device=device)
    save_calib_parameters_to_xml(save_path, K, dist.reshape(1, 5), rvecs,
                                 tvecs)
    return K, dist, rms


def chessboard_photos_calibration(photo_paths, save_path,
                                  pattern_size=PATTERN_SIZE,
                                  max_views: int = 20,
                                  visual_dir: str | None = None, device=None):
    """Calibrate from photo files and persist to XML (reference:
    chessboardPhotosCalibration, cameraCalibration.cpp:142-203)."""
    from ..io.media import _imread_rgb

    obj = make_object_points(pattern_size)
    img_pts = []
    for p in photo_paths[:max_views * 3]:
        img = _imread_rgb(p)
        if img is None:
            continue
        gray = (img @ np.array([0.299, 0.587, 0.114])).astype(np.float64)
        c = find_chessboard_corners(gray, pattern_size)
        if c is not None:
            img_pts.append(c)
            if visual_dir:
                os.makedirs(visual_dir, exist_ok=True)
                _save_corner_overlay(
                    img, c, os.path.join(
                        visual_dir, f"corners_{len(img_pts):02d}.png"))
        if len(img_pts) >= max_views:
            break
    if len(img_pts) < 3:
        raise RuntimeError(
            f"found chessboard in only {len(img_pts)} photos; need ≥3")
    return _calibrate_and_save(obj, img_pts, save_path, device)


def main_calibration_entry_point(cfg, device=None):
    """Dispatch like the reference's mainCalibrationEntryPoint
    (cameraCalibration.cpp:18-32): photos glob, or every tenth frame of the
    video (Motion-JPEG, MPEG-4 Part 2 or VP8 in AVI, MP4 or Matroska/WebM,
    read by ``MediaSource``)."""
    if cfg.usePhotosCycle:
        paths = sorted(_glob.glob(cfg.photosPathPattern))
        visual_dir = cfg.outputDataDir if cfg.visualCalibration else None
        return chessboard_photos_calibration(paths, cfg.calibrationPath,
                                             visual_dir=visual_dir,
                                             device=device)
    from ..io.media import MediaSource

    src = MediaSource(video_path=cfg.videoSourcePath, use_photos=False)
    obj = make_object_points()
    img_pts = []
    try:
        for count, frame in enumerate(src, 1):
            if count % 10:
                continue
            c = find_chessboard_corners(host_gray(frame))
            if c is not None:
                img_pts.append(c)
            if len(img_pts) >= 20:
                break
    finally:
        src.close()
    if len(img_pts) < 3:
        raise RuntimeError("not enough chessboard views in video")
    return _calibrate_and_save(obj, img_pts, cfg.calibrationPath, device)
