"""Trajectory accuracy harness: ATE / RPE with Sim(3) alignment.

The reference publishes no accuracy numbers (SURVEY.md §6); its verification
was visual.  We make trajectory error a first-class oracle: monocular SLAM
recovers pose up to an arbitrary similarity, so trajectories are aligned with
Umeyama's closed-form Sim(3) before RMSE.  Trajectories in the reference's
poses.txt/rotations.txt format (extrinsic translations + rotations,
src/misc/IOmisc.cpp:133-178) are converted to camera centers C = -Rᵀ t first.
"""

from __future__ import annotations

import numpy as np


def camera_centers(rotations: np.ndarray, translations: np.ndarray) -> np.ndarray:
    """World-frame camera centers from world→camera extrinsics (R, t):
    C = -Rᵀ t."""
    R = np.asarray(rotations).reshape(-1, 3, 3)
    t = np.asarray(translations).reshape(-1, 3)
    return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), t)


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[float, np.ndarray, np.ndarray]:
    """Closed-form similarity (s, R, t) minimizing ||dst - (s·R·src + t)||².

    Umeyama (1991).  Returns (scale, rotation, translation)."""
    src = np.asarray(src, np.float64).reshape(-1, 3)
    dst = np.asarray(dst, np.float64).reshape(-1, 3)
    assert src.shape == dst.shape and len(src) >= 3, "need ≥3 corresponding points"
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_trajectory_error(
    est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True
) -> float:
    """ATE RMSE after Sim(3) (or SE(3)) alignment."""
    est = np.asarray(est_centers, np.float64).reshape(-1, 3)
    gt = np.asarray(gt_centers, np.float64).reshape(-1, 3)
    s, R, t = umeyama_alignment(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(axis=1).mean()))


def relative_pose_error(
    est_centers: np.ndarray, gt_centers: np.ndarray, delta: int = 1
) -> float:
    """Translation RPE RMSE over pose pairs ``delta`` apart, after global
    scale normalization (median displacement ratio)."""
    est = np.asarray(est_centers, np.float64).reshape(-1, 3)
    gt = np.asarray(gt_centers, np.float64).reshape(-1, 3)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    ne, ng = np.linalg.norm(de, axis=1), np.linalg.norm(dg, axis=1)
    valid = ng > 1e-12
    scale = np.median(ng[valid] / np.maximum(ne[valid], 1e-12)) if valid.any() else 1.0
    err = np.linalg.norm(de * scale - dg, axis=1)
    return float(np.sqrt((err**2).mean()))
