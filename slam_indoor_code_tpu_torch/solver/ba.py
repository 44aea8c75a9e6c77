"""Windowed bundle adjustment: Levenberg–Marquardt with Schur-complement
reduction and robust IRLS losses (counterpart of the JAX package's
solver/ba.py — see there for the reference citations).

Observations live in a fixed [F,K] slot grid (frame × keypoint slot, with a
mask); the per-observation residual Jacobians come from ``torch.func``
(``vmap`` of ``jacfwd``, as the JAX code vmaps ``jax.jacfwd``); the normal
equations are assembled with a fixed-order segment sum (``segment_sum``
there) into dense per-point blocks, and the reduced camera system is
solved densely.
``lax.while_loop`` becomes a Python loop with the same accept/reject and
stop rules; it reads one flag per iteration from the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import jacfwd, vmap

from ..geometry.rotations import rodrigues_to_matrix


def loss_rho_and_weight(s: torch.Tensor, kind: str, a: float):
    """Ceres-compatible robust losses on squared residual s → (ρ(s), ρ'(s))."""
    a2 = a * a
    one = torch.ones_like(s)
    if kind == "trivial":
        return s, one
    if kind == "huber":
        r = torch.sqrt(torch.clamp_min(s, 1e-18))
        rho = torch.where(s <= a2, s, 2.0 * a * r - a2)
        w = torch.where(s <= a2, one, a / r)
        return rho, w
    if kind == "cauchy":
        return a2 * torch.log1p(s / a2), 1.0 / (1.0 + s / a2)
    if kind == "arctan":
        u = s / a
        return a * torch.atan2(s, torch.full_like(s, a)), 1.0 / (1.0 + u * u)
    if kind == "tukey":
        u = s / a2
        rho = torch.where(u <= 1.0, (a2 / 3.0) * (1.0 - (1.0 - u) ** 3),
                          torch.full_like(s, a2 / 3.0))
        w = torch.where(u <= 1.0, (1.0 - u) ** 2, torch.zeros_like(s))
        return rho, w
    raise ValueError(f"unknown loss {kind!r}")


def _project_residual(params13: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Reprojection residual of one observation; params13 = [fx,fy,cx,cy,
    aa(3), t(3), X(3)] (the reference's ProjectionCostFunctor)."""
    fx, fy, cx, cy = params13[0], params13[1], params13[2], params13[3]
    R = rodrigues_to_matrix(params13[4:7])
    Xc = R @ params13[10:13] + params13[7:10]
    z = Xc[2]
    safe_z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * Xc[0] / safe_z + cx
    v = fy * Xc[1] / safe_z + cy
    return torch.stack([u - uv[0], v - uv[1]])


_residuals = vmap(_project_residual)
_jacobians = vmap(jacfwd(_project_residual))


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3×3 inverse (adjugate / determinant)."""
    a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-18, torch.full_like(det, 1e-18), det)
    adj = torch.stack([
        torch.stack([A, c * h - b * i, b * f - c * e], -1),
        torch.stack([B, a * i - c * g, c * d - a * f], -1),
        torch.stack([C, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj / det[:, None, None]


@dataclass(frozen=True)
class BAConfig:
    loss: str = "trivial"
    loss_param: float = 1.0
    max_iters: int = 25
    init_lambda: float = 1e-3
    fix_intrinsics: bool = False
    obs_cap: int = 0   # >0: compact the [F,K] grid to this many observations
    function_tolerance: float = 1e-6
    gauge_frame0: bool = True  # freeze frame-0 extrinsics (reference gauge)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` summed by segment id into [n, ...], in a fixed order.
    ``index_add_`` adds with float atomics on CUDA, in an order that changes
    from run to run; an accumulating ``index_put_`` sorts the ids (stably)
    and adds each segment's rows in that order, so a run repeats bit for
    bit."""
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_put_((ids,), x, accumulate=True)


def bundle_adjust_window(cfg: BAConfig, K4, cams, points, uv, point_idx,
                         obs_mask, point_mask, point_free=None):
    """One windowed BA solve.  K4 [4], cams [F,6] (angle-axis + t),
    points [P,3], uv [F,K,2], point_idx [F,K], obs_mask [F,K], point_mask
    [P], point_free [P] (None = all real points free).  Returns (K4', cams',
    points', info dict)."""
    dev, dt = uv.device, uv.dtype
    F, Kslots = uv.shape[0], uv.shape[1]
    P = points.shape[0]
    D = 4 + 6 * F
    O = F * Kslots

    f_of_obs = torch.arange(F, device=dev).repeat_interleave(Kslots)
    uv_flat = uv.reshape(O, 2)
    pid = point_idx.reshape(O).long()
    m_obs = obs_mask.reshape(O)
    if cfg.obs_cap and cfg.obs_cap < O:
        # valid-first compaction, round-robin across frames (slot-major)
        slot_in_frame = torch.arange(O, device=dev) % Kslots
        rr = slot_in_frame * F + f_of_obs
        key_sort = torch.where(m_obs, rr, O + rr)
        order = torch.argsort(key_sort, stable=True)[: cfg.obs_cap]
        f_of_obs, uv_flat, pid, m_obs = (f_of_obs[order], uv_flat[order],
                                         pid[order], m_obs[order])
        O = cfg.obs_cap

    # compact the point table to the Pc = min(O, P) points observed
    if point_free is None:
        point_free = torch.ones_like(point_mask)
    Pc = min(O, P)
    pid_sent = torch.where(m_obs, pid, torch.full_like(pid, P))
    uniq = torch.unique(pid_sent)[:Pc]
    puids = torch.full((Pc,), P, dtype=torch.long, device=dev)
    puids[: uniq.shape[0]] = uniq
    pc_mask = puids < P
    gather_ids = torch.where(pc_mask, puids, torch.zeros_like(puids))
    points_full = points
    points = points_full[gather_ids]
    point_mask = pc_mask & point_mask[gather_ids]
    point_free = pc_mask & point_free[gather_ids]
    loc = torch.clamp(torch.searchsorted(puids, pid_sent), max=Pc - 1)
    m_obs = m_obs & (puids[loc] == pid_sent)
    P = Pc
    pid_safe = torch.where(m_obs, loc, torch.zeros_like(loc))

    def p13_of(K4, cams, points):
        return torch.cat([K4.expand(O, 4), cams[f_of_obs], points[pid_safe]],
                         dim=1)

    def cost_only(K4, cams, points):
        r = _residuals(p13_of(K4, cams, points), uv_flat)
        rho, _ = loss_rho_and_weight((r * r).sum(-1), cfg.loss,
                                     cfg.loss_param)
        return torch.where(m_obs, rho, torch.zeros_like(rho)).sum()

    eyeF = torch.eye(F, dtype=dt, device=dev)
    if cfg.gauge_frame0:
        frame0_free = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        frame0_free = (m_obs & ~point_free[pid_safe]).any()
    gauge = torch.cat([
        torch.full((4,), not cfg.fix_intrinsics, dtype=torch.bool, device=dev),
        frame0_free.expand(6),
        torch.ones(6 * (F - 1), dtype=torch.bool, device=dev),
    ])
    gf = gauge.to(dt)
    free_p = point_free[pid_safe].to(dt)[:, None, None]
    no_obs_base = ~point_mask | ~point_free
    eye3 = torch.eye(3, dtype=dt, device=dev)

    def lm_step(K4, cams, points, lam):
        p13 = p13_of(K4, cams, points)
        r = _residuals(p13, uv_flat)                      # [O,2]
        J = _jacobians(p13, uv_flat)                      # [O,2,13]
        _, w = loss_rho_and_weight((r * r).sum(-1), cfg.loss, cfg.loss_param)
        w = torch.where(m_obs, w, torch.zeros_like(w))
        J_K = J[:, :, 0:4]
        J_c = J[:, :, 4:10]
        J_p = J[:, :, 10:13] * free_p
        if cfg.fix_intrinsics:
            J_K = J_K * 0.0
        fhot = eyeF[f_of_obs]
        a = torch.cat([J_K, torch.einsum("of,oij->oifj", fhot, J_c)
                       .reshape(O, 2, 6 * F)], dim=2)    # [O,2,D]
        ws = w[:, None, None]
        Hcc = torch.einsum("oid,oie->de", a * ws, a)
        b_c = torch.einsum("oid,oi->d", a * ws, r)
        GP = _segment_sum(torch.einsum("oid,oie->ode", a * ws, J_p)
                          .reshape(O, D * 3), pid_safe, P).reshape(P, D, 3)
        V = _segment_sum(torch.einsum("oid,oie->ode", J_p * ws, J_p)
                         .reshape(O, 9), pid_safe, P).reshape(P, 3, 3)
        b_p = _segment_sum(torch.einsum("oid,oi->od", J_p * ws, r),
                           pid_safe, P)

        lamV = lam * torch.clamp_min(torch.diagonal(V, dim1=1, dim2=2), 1e-9)
        Vd = V + torch.diag_embed(lamV)
        no_obs = no_obs_base | (Vd.abs().sum((1, 2)) < 1e-12)
        Vd = torch.where(no_obs[:, None, None], eye3, Vd)
        Vinv = _inv3(Vd)
        Vinv = torch.where(no_obs[:, None, None], torch.zeros_like(Vinv), Vinv)

        GV = torch.einsum("pdi,pij->pdj", GP, Vinv)
        S = Hcc - torch.einsum("pdi,pei->de", GV, GP)
        rhs = b_c - torch.einsum("pdi,pi->d", GV, b_p)
        S = S * gf[:, None] * gf[None, :] + torch.diag(1.0 - gf)
        rhs = rhs * gf
        dead = torch.diagonal(S).abs() < 1e-8
        df = (~dead).to(dt)
        S = S * df[:, None] * df[None, :] + torch.diag(dead.to(dt))
        rhs = rhs * df
        S = S + lam * torch.diag(torch.clamp_min(torch.diagonal(S), 1e-9))

        dc = torch.linalg.solve_ex(S, rhs)[0]
        dp = torch.einsum("pij,pj->pi", Vinv,
                          b_p - torch.einsum("pdi,d->pi", GP, dc))
        return (K4 - dc[:4], cams - dc[4:].reshape(F, 6),
                torch.where(point_mask[:, None], points - dp, points))

    init_cost = cost_only(K4, cams, points)
    lam = torch.tensor(cfg.init_lambda, dtype=dt, device=dev)
    cost = init_cost
    n_iters = 0
    while n_iters < cfg.max_iters:
        K4_new, cams_new, points_new = lm_step(K4, cams, points, lam)
        new_cost = cost_only(K4_new, cams_new, points_new)
        accept = new_cost < cost
        K4 = torch.where(accept, K4_new, K4)
        cams = torch.where(accept, cams_new, cams)
        points = torch.where(accept, points_new, points)
        lam = torch.where(accept, torch.clamp_min(lam * 0.4, 1e-9),
                          torch.clamp_max(lam * 4.0, 1e6))
        cost_prev = cost
        cost = torch.where(accept, new_cost, cost_prev)
        n_iters += 1
        converged = accept & (cost_prev - cost <= cfg.function_tolerance
                              * torch.clamp_min(cost, 1e-18))
        if bool(converged):
            break

    full_idx = torch.where(pc_mask, puids, torch.zeros_like(puids))
    pointsf = points_full.clone()
    pointsf[full_idx[pc_mask]] = points[pc_mask]
    num_res = torch.clamp_min(m_obs.sum(), 1)
    info = {
        "initial_cost": init_cost,
        "final_cost": cost,
        "num_iters": n_iters,
        "num_residuals": num_res,
        "initial_rmse": torch.sqrt(init_cost / num_res),
        "final_rmse": torch.sqrt(cost / num_res),
    }
    return K4, cams, pointsf, info
