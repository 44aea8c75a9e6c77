"""Batched-RANSAC PnP (counterpart of the JAX package's geometry/pnp.py):
S 6-point DLT hypotheses as one batched [S,12,12] nullspace problem, every
hypothesis scored against all N correspondences at once, then masked
Gauss–Newton on the winner's inliers in two LO rounds.  The Jacobian of the
refine comes from ``torch.func.jacfwd`` (``jax.jacfwd`` in the reference),
taken under utils/autodiff.py's lock."""

from __future__ import annotations

import torch

from ..utils.autodiff import jacfwd
from .nullspace import smallest_eigenvector
from .projection import denormalize, normalize_pixels
from .ransac import sample_indices
from .rotations import matrix_to_rodrigues, rodrigues_to_matrix


def _dlt_pnp(X, x):
    """Minimal DLT pose from 6 points (batched): X [S,6,3] world, x [S,6,2]
    normalized → (R [S,3,3], t [S,3])."""
    S, m, _ = X.shape
    ones = torch.ones((S, m, 1), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones], dim=-1)
    zeros = torch.zeros_like(Xh)
    u = x[..., 0:1]
    v = x[..., 1:2]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=1)
    AtA = torch.einsum("sij,sik->sjk", A, A)
    P = smallest_eigenvector(AtA).reshape(S, 3, 4)
    centroid = torch.cat([X.mean(dim=1), torch.ones((S, 1), dtype=X.dtype,
                                                     device=X.device)], -1)
    depth = torch.einsum("sj,sj->s", P[:, 2], centroid)
    P = P * torch.where(depth < 0, -1.0, 1.0)[:, None, None]
    M = P[:, :, :3]
    U, s, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (U * D[:, None, :]) @ Vt
    sm = s.mean(dim=-1)
    scale = torch.where(sm > 1e-12, 1.0 / torch.clamp_min(sm, 1e-12),
                        torch.zeros_like(sm))
    t = P[:, :, 3] * scale[:, None]
    return R, t


def _reproj_err_px(K, R, t, X, uv):
    """R [S,3,3], t [S,3], X [N,3], uv [N,2] → (err [S,N], depth [S,N])."""
    Xc = torch.einsum("sij,nj->sni", R, X) + t[:, None, :]
    z = torch.clamp_min(Xc[..., 2], 1e-9)
    xy = Xc[..., :2] / z[..., None]
    uv_hat = denormalize(K, xy)
    return torch.linalg.norm(uv_hat - uv[None], dim=-1), Xc[..., 2]


def _gauss_newton_refine(K, R0, t0, X, uv, weights, iters: int = 8):
    """Masked Gauss–Newton on (angle-axis, t) minimizing pixel
    reprojection; a step is kept only if it lowers the cost."""
    params = torch.cat([matrix_to_rodrigues(R0), t0])
    fx, fy = K[0, 0], K[1, 1]

    def residuals(p):
        R = rodrigues_to_matrix(p[:3])
        Xc = X @ R.T + p[3:]
        z = torch.clamp_min(Xc[:, 2], 1e-9)
        u_hat = fx * Xc[:, 0] / z + K[0, 2]
        v_hat = fy * Xc[:, 1] / z + K[1, 2]
        r = torch.stack([u_hat - uv[:, 0], v_hat - uv[:, 1]], dim=-1)
        return (r * weights[:, None]).reshape(-1)

    eye6 = 1e-6 * torch.eye(6, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        r = residuals(params)
        J = jacfwd(residuals)(params)                     # [2N,6]
        H = J.T @ J + eye6
        delta = torch.linalg.solve(H, J.T @ r)
        new_params = params - delta
        better = (residuals(new_params) ** 2).sum() < (r ** 2).sum()
        params = torch.where(better, new_params, params)
    return rodrigues_to_matrix(params[:3]), params[3:]


def solve_pnp_ransac(K, X, uv, mask, reproj_threshold_px: float = 8.0,
                     num_hypotheses: int = 256, refine_iters: int = 6,
                     prior_R=None, prior_t=None, idx=None, gen=None):
    """RANSAC PnP over N fixed correspondence slots (X [N,3], uv [N,2],
    mask [N]); ``prior_R/prior_t`` join as one extra hypothesis.  ``idx``
    [S,6] overrides the draw from ``gen``.  Returns dict R, t (world→camera),
    inliers [N], num_inliers."""
    x_norm = normalize_pixels(K, uv)
    if idx is None:
        idx = sample_indices(mask, (num_hypotheses, 6), gen)
    R_c, t_c = _dlt_pnp(X[idx], x_norm[idx])
    if prior_R is not None and prior_t is not None:
        R_c = torch.cat([R_c, prior_R[None]], dim=0)
        t_c = torch.cat([t_c, prior_t[None]], dim=0)

    err, depth = _reproj_err_px(K, R_c, t_c, X, uv)
    inlier_mat = (err < reproj_threshold_px) & (depth > 0) & mask[None, :]
    best = torch.argmax(inlier_mat.sum(dim=1))
    inliers = inlier_mat[best]

    R, t = _gauss_newton_refine(K, R_c[best], t_c[best], X, uv,
                                inliers.to(X.dtype), iters=refine_iters)
    err_1, depth_1 = _reproj_err_px(K, R[None], t[None], X, uv)
    inliers_1 = (err_1[0] < reproj_threshold_px) & (depth_1[0] > 0) & mask
    R, t = _gauss_newton_refine(K, R, t, X, uv, inliers_1.to(X.dtype),
                                iters=refine_iters // 2 + 1)
    err_f, depth_f = _reproj_err_px(K, R[None], t[None], X, uv)
    inliers_f = (err_f[0] < reproj_threshold_px) & (depth_f[0] > 0) & mask
    return {"R": R, "t": t, "inliers": inliers_f,
            "num_inliers": inliers_f.sum()}
