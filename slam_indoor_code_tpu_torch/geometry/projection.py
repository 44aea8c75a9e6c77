"""Camera model: projection, normalization, undistortion (counterpart of the
JAX package's geometry/projection.py).  World→camera extrinsics:
X_cam = R X_world + t, uv ~ K [R | t] X̃."""

from __future__ import annotations

import torch


def project(K, R, t, X):
    """Project world points X [...,N,3] → pixels uv [...,N,2]."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    uvw = Xc @ K.T
    return uvw[..., :2] / torch.clamp_min(uvw[..., 2:3], 1e-12)


def camera_depths(R, t, X):
    """z-coordinate of world points X [...,N,3] in the camera frame."""
    return (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]


def homogeneous(x):
    """[...,D] → [...,D+1] with an appended 1."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def projection_matrix(K, R, t):
    """P = K [R|t], shape [...,3,4]."""
    return K @ torch.cat([R, t[..., :, None]], dim=-1)


def normalize_pixels(K, uv):
    """Pixel coords → K-normalized image coords (zero-skew K)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def denormalize(K, xy):
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], -1)


def undistort_points(K, dist, uv, iters: int = 5):
    """Iteratively undistort pixel coords with the OpenCV 5-coefficient
    model (k1,k2,p1,p2,k3); returns undistorted pixel coordinates."""
    k1, k2, p1, p2, k3 = (dist.reshape(-1)[i] for i in range(5))
    xy_d = normalize_pixels(K, uv)
    x, y = xy_d[..., 0], xy_d[..., 1]
    xu, yu = x, y
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xu * yu + p2 * (r2 + 2.0 * xu * xu)
        dy = p1 * (r2 + 2.0 * yu * yu) + 2.0 * p2 * xu * yu
        xu = (x - dx) / radial
        yu = (y - dy) / radial
    return denormalize(K, torch.stack([xu, yu], dim=-1))
