"""Global (full-trajectory) bundle adjustment via matrix-free LM + PCG
(counterpart of the JAX package's solver/global_ba.py, which documents the
design).  Each Levenberg–Marquardt step is solved inexactly with a
Jacobi-preconditioned conjugate gradient on the damped normal equations

    (JᵀWJ + λ·diag) δ = -JᵀWr,

every product built from flat per-observation [O,2,9] Jacobian slices with
gathers and segment sums: memory O(observations), never O(obs × cameras).

The LM ``while_loop`` and the CG ``fori_loop`` become Python loops.  The CG
loop reads nothing back to the host; the LM loop reads its stop flag once
per iteration, as ``bundle_adjust_window`` does.  Every segment sum is the
fixed-order ``_segment_sum`` of solver/ba.py, so a run on the card repeats
bit for bit.  Intrinsics stay fixed; camera 0 is the gauge anchor, and
points that no observation reaches are frozen.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ba import _jacobians, _residuals, _segment_sum, loss_rho_and_weight


@dataclass(frozen=True)
class GlobalBAConfig:
    loss: str = "huber"
    loss_param: float = 2.0
    max_iters: int = 30         # LM (outer) iterations
    cg_iters: int = 32          # CG (inner) iterations per LM step
    init_lambda: float = 1e-4
    function_tolerance: float = 1e-6


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < 1e-18, torch.full_like(x, 1e-18), x)


def global_bundle_adjust(cfg: GlobalBAConfig, K4, cams, points, uv, cam_idx,
                         pid, mask):
    """K4 [4] fx,fy,cx,cy (held fixed), cams [N,6] angle-axis + t
    (world→camera), points [P,3], uv [O,2] observed pixels, cam_idx [O] and
    pid [O] the camera and landmark of each observation, mask [O] bool.
    Returns (cams', points', info)."""
    N, P, O = cams.shape[0], points.shape[0], uv.shape[0]
    dt, dev = cams.dtype, cams.device
    zero = torch.zeros((), dtype=torch.long, device=dev)
    ci = torch.where(mask, cam_idx.long(), zero)
    pi = torch.where(mask, pid.long(), zero)
    K4o = K4.to(dt).expand(O, 4)

    def p13_of(cams, points):
        return torch.cat([K4o, cams[ci], points[pi]], dim=1)

    def cost_only(cams, points):
        r = _residuals(p13_of(cams, points), uv)
        rho, _ = loss_rho_and_weight((r * r).sum(-1), cfg.loss,
                                     cfg.loss_param)
        return torch.where(mask, rho, torch.zeros_like(rho)).sum()

    def linearize(cams, points):
        p13 = p13_of(cams, points)
        r = _residuals(p13, uv)                       # [O,2]
        J = _jacobians(p13, uv)                       # [O,2,13]
        _, w = loss_rho_and_weight((r * r).sum(-1), cfg.loss, cfg.loss_param)
        w = torch.where(mask, w, torch.zeros_like(w))
        return r, J[:, :, 4:10], J[:, :, 10:13], w

    cam_free = (torch.arange(N, device=dev) > 0)[:, None].to(dt)   # gauge

    def lm_step(cams, points, lam):
        r, Jc, Jp, w = linearize(cams, points)
        ws = w[:, None]
        rw = r * ws
        gc = _segment_sum(torch.einsum("oij,oi->oj", Jc, rw), ci, N) * cam_free
        gp = _segment_sum(torch.einsum("oij,oi->oj", Jp, rw), pi, P)
        # Jacobi diagonal of JᵀWJ (damping scale and preconditioner)
        dc = _segment_sum(torch.einsum("oij,oij->oj", Jc * ws[..., None], Jc),
                          ci, N).clamp_min(1e-9)
        dp = _segment_sum(torch.einsum("oij,oij->oj", Jp * ws[..., None], Jp),
                          pi, P).clamp_min(1e-9)
        damp_c = dc * lam
        damp_p = dp * lam
        free_p = (dp.amax(-1) > 1e-8)[:, None].to(dt)   # observed points
        gp = gp * free_p

        def Hv(vc, vp):
            Jv = (torch.einsum("oij,oj->oi", Jc, vc[ci])
                  + torch.einsum("oij,oj->oi", Jp, vp[pi])) * ws
            hc = _segment_sum(torch.einsum("oij,oi->oj", Jc, Jv), ci, N)
            hp = _segment_sum(torch.einsum("oij,oi->oj", Jp, Jv), pi, P)
            return ((hc + damp_c * vc) * cam_free,
                    (hp + damp_p * vp) * free_p)

        # PCG on (H+λD)δ = -g with the Jacobi preconditioner
        Mc = cam_free / (dc + damp_c)
        Mp = free_p / (dp + damp_p)
        xc = torch.zeros_like(gc)
        xp = torch.zeros_like(gp)
        rc, rp = -gc, -gp
        zc, zp = Mc * rc, Mp * rp
        pc, pp = zc, zp
        rz = _vdot(rc, zc) + _vdot(rp, zp)
        for _ in range(cfg.cg_iters):
            Ac, Ap = Hv(pc, pp)
            alpha = rz / _safe(_vdot(pc, Ac) + _vdot(pp, Ap))
            xc = xc + alpha * pc
            xp = xp + alpha * pp
            rc = rc - alpha * Ac
            rp = rp - alpha * Ap
            zc, zp = Mc * rc, Mp * rp
            rz_new = _vdot(rc, zc) + _vdot(rp, zp)
            beta = rz_new / _safe(rz)
            pc, pp, rz = zc + beta * pc, zp + beta * pp, rz_new
        return cams + xc, points + xp

    init_cost = cost_only(cams, points)
    lam = torch.tensor(cfg.init_lambda, dtype=dt, device=dev)
    cost = init_cost
    n_iters = 0
    while n_iters < cfg.max_iters:
        cams_new, points_new = lm_step(cams, points, lam)
        new_cost = cost_only(cams_new, points_new)
        accept = new_cost < cost
        cams = torch.where(accept, cams_new, cams)
        points = torch.where(accept, points_new, points)
        lam = torch.where(accept, torch.clamp_min(lam * 0.33, 1e-9),
                          torch.clamp_max(lam * 5.0, 1e7))
        cost_prev = cost
        cost = torch.where(accept, new_cost, cost_prev)
        n_iters += 1
        converged = accept & (cost_prev - cost <= cfg.function_tolerance
                              * torch.clamp_min(cost, 1e-18))
        if bool(converged):       # one host read per LM iteration
            break
    num_res = torch.clamp_min(mask.sum(), 1)
    info = {
        "initial_cost": init_cost,
        "final_cost": cost,
        "num_iters": n_iters,
        "num_residuals": num_res,
        "initial_rmse": torch.sqrt(init_cost / num_res),
        "final_rmse": torch.sqrt(cost / num_res),
    }
    return cams, points, info
