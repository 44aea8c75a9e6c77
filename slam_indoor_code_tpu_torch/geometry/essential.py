"""Two-view relative pose: fixed-fan-out RANSAC essential matrix + pose
recovery by chirality voting (counterpart of the JAX package's
geometry/essential.py).

Each RANSAC takes an optional ``idx`` [S,8] of sampled correspondence slots;
without it the samples come from ``gen`` (a ``torch.Generator`` on the
tensors' device).  Eigen/singular vectors carry arbitrary signs, so only the
poses and points derived from them are comparable across packages.
"""

from __future__ import annotations

import torch

from .nullspace import smallest_eigenvector
from .projection import normalize_pixels
from .ransac import sample_indices
from .triangulate import triangulate_dlt


def _design(x1, x2):
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def _to_essential(E: torch.Tensor) -> torch.Tensor:
    """Project [...,3,3] onto the essential manifold: singular values
    (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    D = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * D) @ Vt


def _eight_point(x1, x2):
    """Batched 8-point essential estimate: [S,8,2] pairs → E [S,3,3]."""
    A = _design(x1, x2)
    AtA = torch.einsum("sij,sik->sjk", A, A)
    return _to_essential(smallest_eigenvector(AtA).reshape(-1, 3, 3))


def _sampson_sq(E, x1h, x2h):
    """Squared Sampson distance of N correspondences under S hypotheses."""
    Ex1 = torch.einsum("sij,nj->sni", E, x1h)
    Etx2 = torch.einsum("sji,nj->sni", E, x2h)
    x2Ex1 = torch.einsum("ni,sni->sn", x2h, Ex1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
             + Etx2[..., 1] ** 2)
    return (x2Ex1 * x2Ex1) / torch.clamp_min(denom, 1e-18)


def find_essential_ransac(K, uv1, uv2, mask, threshold_px: float = 1.0,
                          num_hypotheses: int = 1024, idx=None, gen=None):
    """Fixed-fan-out RANSAC essential-matrix estimation → dict E [3,3],
    inliers [N], num_inliers."""
    n = uv1.shape[0]
    x1 = normalize_pixels(K, uv1)
    x2 = normalize_pixels(K, uv2)
    ones = torch.ones((n, 1), dtype=x1.dtype, device=x1.device)
    x1h = torch.cat([x1, ones], dim=1)
    x2h = torch.cat([x2, ones], dim=1)
    if idx is None:
        idx = sample_indices(mask, (num_hypotheses, 8), gen)
    E = _eight_point(x1[idx], x2[idx])

    f_mean = 0.5 * (K[0, 0] + K[1, 1])
    thr = (threshold_px / f_mean) ** 2
    d2 = _sampson_sq(E, x1h, x2h)
    inlier_mat = (d2 < thr) & mask[None, :]
    counts = inlier_mat.sum(dim=1)
    best = torch.argmax(counts)
    best_inliers = inlier_mat[best]

    # refit on all inliers of the best hypothesis (weighted 8-point over N)
    Aw = _design(x1, x2) * best_inliers.to(x1.dtype)[:, None]
    e = smallest_eigenvector((Aw.T @ Aw)[None])[0]
    E_refined = _to_essential(e.reshape(3, 3))
    d2_ref = _sampson_sq(E_refined[None], x1h, x2h)[0]
    inliers_ref = (d2_ref < thr) & mask
    use_ref = inliers_ref.sum() >= counts[best]
    E_best = torch.where(use_ref, E_refined, E[best])
    inliers = torch.where(use_ref, inliers_ref, best_inliers)
    return {"E": E_best, "inliers": inliers, "num_inliers": inliers.sum()}


def recover_pose(E, K, uv1, uv2, mask, distance_threshold: float = 50.0):
    """Choose the (R, t) decomposition of E by chirality voting → dict
    R [3,3], t [3] (unit), chirality_mask [N], num_passed."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    cand_R = torch.stack([R1, R1, R2, R2])
    cand_t = torch.stack([t, -t, t, -t])

    x1 = normalize_pixels(K, uv1)
    x2 = normalize_pixels(K, uv2)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    P1 = torch.cat([eye, torch.zeros((3, 1), dtype=E.dtype,
                                     device=E.device)], dim=1)
    votes = []
    for Rc, tc in zip(cand_R, cand_t):
        P2 = torch.cat([Rc, tc[:, None]], dim=1)
        X = triangulate_dlt(P1, P2, x1, x2)
        z1 = X[:, 2]
        z2 = (X @ Rc.T + tc)[:, 2]
        votes.append((z1 > 0) & (z2 > 0) & (z1 < distance_threshold)
                     & (z2 < distance_threshold) & mask)
    votes = torch.stack(votes)
    counts = votes.sum(dim=1)
    best = torch.argmax(counts)
    return {"R": cand_R[best], "t": cand_t[best],
            "chirality_mask": votes[best], "num_passed": counts[best]}


def estimate_transformation(K, uv1, uv2, mask, *, use_ransac: bool = True,
                            threshold_px: float = 1.0,
                            distance_threshold: float = 50.0,
                            num_hypotheses: int = 1024, idx=None, gen=None):
    """E-RANSAC + recoverPose (the reference's estimateTransformation).
    ``use_ransac=False`` fits one least-squares 8-point E to all matches."""
    if use_ransac:
        est = find_essential_ransac(K, uv1, uv2, mask,
                                    threshold_px=threshold_px,
                                    num_hypotheses=num_hypotheses,
                                    idx=idx, gen=gen)
        E, support = est["E"], est["inliers"]
    else:
        A = (_design(normalize_pixels(K, uv1), normalize_pixels(K, uv2))
             * mask.to(uv1.dtype)[:, None])
        e = smallest_eigenvector((A.T @ A)[None])[0]
        E = _to_essential(e.reshape(3, 3))
        support = mask
    pose = recover_pose(E, K, uv1, uv2, support,
                        distance_threshold=distance_threshold)
    pose["E"] = E
    pose["ransac_inliers"] = support
    return pose
