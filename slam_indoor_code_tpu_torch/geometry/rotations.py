"""Batched rotation parameterizations, angle-axis ⇄ matrix (counterpart of
the JAX package's geometry/rotations.py; differentiable everywhere, so
``torch.func`` can take Jacobians through ``rodrigues_to_matrix``)."""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """[...,3] → [...,3,3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], dim=-2)


def rodrigues_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis [...,3] → rotation matrix [...,3,3] (Taylor-safe at 0)."""
    theta2 = (aa * aa).sum(-1, keepdim=True)[..., None]   # [...,1,1]
    K = skew(aa)
    K2 = K @ K
    small = theta2 < 1e-8
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_theta = torch.sqrt(safe_theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(safe_theta) / safe_theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_theta)) / safe_theta2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + a * K + b * K2


def matrix_to_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [...,3,3] → angle-axis [...,3], stable near 0 and π."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_theta = 0.5 * torch.linalg.norm(w, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)
    t2 = (theta * theta)[..., None]
    scale = torch.where(
        sin_theta[..., None] < 1e-6,
        0.5 + t2 / 12.0,
        theta[..., None] / torch.clamp_min(2.0 * sin_theta[..., None], 1e-24),
    )
    aa_generic = w * scale

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp_min(
        (diag - cos_theta[..., None])
        / torch.clamp_min(1.0 - cos_theta[..., None], 1e-12), 0.0)
    axis = torch.sqrt(axis2)
    offd = torch.stack([
        R[..., 0, 1] + R[..., 1, 0],
        R[..., 0, 2] + R[..., 2, 0],
        R[..., 1, 2] + R[..., 2, 1],
    ], dim=-1)
    largest = torch.argmax(axis, dim=-1)

    def sgn(x):
        return torch.sign(x) + (x == 0).to(x.dtype)

    s01, s02, s12 = sgn(offd[..., 0]), sgn(offd[..., 1]), sgn(offd[..., 2])
    n0 = torch.stack([axis[..., 0], s01 * axis[..., 1], s02 * axis[..., 2]], -1)
    n1 = torch.stack([s01 * axis[..., 0], axis[..., 1], s12 * axis[..., 2]], -1)
    n2 = torch.stack([s02 * axis[..., 0], s12 * axis[..., 1], axis[..., 2]], -1)
    stacked = torch.stack([n0, n1, n2], dim=-2)
    idx = largest[..., None, None].expand(*largest.shape, 1, 3)
    aa_pi = torch.gather(stacked, -2, idx)[..., 0, :] * theta[..., None]

    near_pi = (sin_theta.abs() < 1e-3) & (cos_theta < 0.0)
    return torch.where(near_pi[..., None], aa_pi, aa_generic)


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix to M via SVD (det-corrected)."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones(M.shape[:-2] + (2,), dtype=M.dtype,
                              device=M.device), det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vt
