"""Batched two-view triangulation (counterpart of the JAX package's
geometry/triangulate.py): DLT via the smallest eigenvector of AᵀA, the
closed-form midpoint method, and its anchored (per-row first view) form."""

from __future__ import annotations

import torch

from .nullspace import smallest_eigenvector


def triangulate_dlt(P1, P2, uv1, uv2, mask=None):
    """Linear triangulation of N correspondences; P1, P2 [3,4], uv [N,2]
    in the same scale → X [N,3] (masked rows zeroed)."""
    def rows(P, uv):
        r0 = uv[:, 0:1] * P[2][None, :] - P[0][None, :]
        r1 = uv[:, 1:2] * P[2][None, :] - P[1][None, :]
        return r0, r1

    a0, a1 = rows(P1, uv1)
    a2, a3 = rows(P2, uv2)
    A = torch.stack([a0, a1, a2, a3], dim=1)                 # [N,4,4]
    A = A / torch.clamp_min(torch.linalg.norm(A, dim=-1, keepdim=True), 1e-12)
    AtA = torch.einsum("nij,nik->njk", A, A)
    Xh = smallest_eigenvector(AtA)
    w = Xh[:, 3:4]
    tiny = torch.where(w < 0, torch.full_like(w, -1e-12),
                       torch.full_like(w, 1e-12))
    safe_w = torch.where(w.abs() < 1e-12, tiny, w)
    X = Xh[:, :3] / safe_w
    if mask is not None:
        X = torch.where(mask[:, None], X, torch.zeros_like(X))
    return X


def triangulate_midpoint(K, R1, t1, R2, t2, uv1, uv2, mask=None):
    """Closed-form midpoint triangulation of N correspondences."""
    Kinv = torch.linalg.inv(K)

    def ray(R, t, uv):
        ones = torch.ones((uv.shape[0], 1), dtype=uv.dtype, device=uv.device)
        pix = torch.cat([uv, ones], dim=-1)
        d = (pix @ Kinv.T) @ R
        C = -R.T @ t
        return d, C

    d1, C1 = ray(R1, t1, uv1)
    d2, C2 = ray(R2, t2, uv2)
    b = C2 - C1
    a11 = (d1 * d1).sum(-1)
    a12 = (d1 * d2).sum(-1)
    a22 = (d2 * d2).sum(-1)
    b1 = d1 @ b
    b2 = d2 @ b
    det = a11 * a22 - a12 * a12
    safe_det = torch.maximum(det, 1e-12 * torch.clamp_min(a11 * a22, 1e-20))
    s = (b1 * a22 - b2 * a12) / safe_det
    u = (b1 * a12 - b2 * a11) / safe_det
    X = 0.5 * ((C1[None] + s[:, None] * d1) + (C2[None] + u[:, None] * d2))
    if mask is not None:
        X = torch.where(mask[:, None], X, torch.zeros_like(X))
    return X


def triangulate_midpoint_anchored(K, R1, t1, R2, t2, uv1, uv2, mask=None):
    """Midpoint triangulation where every row has its OWN first view
    (R1 [N,3,3], t1 [N,3]) against a shared second view → (X [N,3],
    cos_parallax [N])."""
    Kinv = torch.linalg.inv(K)
    ones = torch.ones((uv1.shape[0], 1), dtype=uv1.dtype, device=uv1.device)
    pix1 = torch.cat([uv1, ones], dim=-1)
    pix2 = torch.cat([uv2, ones], dim=-1)
    R1T = R1.transpose(1, 2)
    d1 = torch.einsum("nij,nj->ni", R1T, pix1 @ Kinv.T)
    C1 = -torch.einsum("nij,nj->ni", R1T, t1)
    d2 = (pix2 @ Kinv.T) @ R2
    C2 = -R2.T @ t2
    b = C2[None, :] - C1
    a11 = (d1 * d1).sum(-1)
    a12 = (d1 * d2).sum(-1)
    a22 = (d2 * d2).sum(-1)
    b1 = (d1 * b).sum(-1)
    b2 = (d2 * b).sum(-1)
    det = a11 * a22 - a12 * a12
    safe_det = torch.maximum(det, 1e-12 * torch.clamp_min(a11 * a22, 1e-20))
    s = (b1 * a22 - b2 * a12) / safe_det
    u = (b1 * a12 - b2 * a11) / safe_det
    X = 0.5 * ((C1 + s[:, None] * d1) + (C2[None, :] + u[:, None] * d2))
    cosang = a12 / torch.sqrt(torch.clamp_min(a11 * a22, 1e-20))
    if mask is not None:
        X = torch.where(mask[:, None], X, torch.zeros_like(X))
    return X, cosang


def reconstruct(K, R1, t1, R2, t2, uv1, uv2, mask=None):
    """Triangulate matched pixels between two posed frames (midpoint)."""
    return triangulate_midpoint(K, R1, t1, R2, t2, uv1, uv2, mask)
