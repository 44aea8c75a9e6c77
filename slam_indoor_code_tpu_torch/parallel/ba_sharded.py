"""Distributed bundle adjustment: the Schur complement over a mesh
(counterpart of the JAX package's parallel/ba_sharded.py; its design notes
are there).

Landmarks are dealt round-robin over the shards and every observation sits
on its landmark's shard, so the per-point blocks V_p, the couplings G_p and
the back-substitution are shard-local.  Cameras are replicated: each shard
computes its partial reduced camera system S_d = Hcc_d − Σ G_p V_p⁻¹ G_pᵀ,
its partial rhs and its partial cost.  Where the JAX code ``psum``s them
inside one ``shard_map``, the port adds them on the first device in shard
order (``mesh.reduce_sum``; across processes, then ``all_reduce``), solves
the [D,D] system there (D = 4+6F) and hands the camera step back to every
shard.  The gauge, the dead-column rule, the accept rule and the λ
schedule are the JAX code's; the loop runs all ``max_iters`` iterations
without reading anything back, as ``lax.scan`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..solver.ba import (BAConfig, _inv3, _jacobians, _residuals,
                         _segment_sum, loss_rho_and_weight)
from .mesh import Mesh, reduce_sum


def _shard_cost(cfg: BAConfig, K4, cams, pts, sh):
    p13 = torch.cat([K4.expand(sh["uv"].shape[0], 4), cams[sh["fobs"]],
                     pts[sh["pid"]]], dim=1)
    r = _residuals(p13, sh["uv"])
    rho, _ = loss_rho_and_weight((r * r).sum(-1), cfg.loss, cfg.loss_param)
    return torch.where(sh["omask"], rho, torch.zeros_like(rho)).sum()


def _shard_system(cfg: BAConfig, F: int, K4, cams, pts, lam, sh):
    """One shard's partial reduced camera system: (S_d, rhs_d, and what
    its back-substitution needs: Vinv, GP, b_p)."""
    uv, fobs, pid, omask = sh["uv"], sh["fobs"], sh["pid"], sh["omask"]
    O_d, P_d = uv.shape[0], pts.shape[0]
    D = 4 + 6 * F
    p13 = torch.cat([K4.expand(O_d, 4), cams[fobs], pts[pid]], dim=1)
    r = _residuals(p13, uv)
    J = _jacobians(p13, uv)
    _, w = loss_rho_and_weight((r * r).sum(-1), cfg.loss, cfg.loss_param)
    w = torch.where(omask, w, torch.zeros_like(w))
    J_K = J[:, :, 0:4]
    if cfg.fix_intrinsics:
        J_K = J_K * 0.0
    J_c = J[:, :, 4:10]
    J_p = J[:, :, 10:13]
    fhot = torch.eye(F, dtype=uv.dtype, device=uv.device)[fobs]
    a = torch.cat([J_K, torch.einsum("of,oij->oifj", fhot, J_c)
                   .reshape(O_d, 2, 6 * F)], dim=2)
    ws = w[:, None, None]
    Hcc = torch.einsum("oid,oie->de", a * ws, a)
    b_c = torch.einsum("oid,oi->d", a * ws, r)
    GP = _segment_sum(torch.einsum("oid,oie->ode", a * ws, J_p)
                      .reshape(O_d, D * 3), pid, P_d).reshape(P_d, D, 3)
    V = _segment_sum(torch.einsum("oid,oie->ode", J_p * ws, J_p)
                     .reshape(O_d, 9), pid, P_d).reshape(P_d, 3, 3)
    b_p = _segment_sum(torch.einsum("oid,oi->od", J_p * ws, r), pid, P_d)

    lamV = lam * torch.clamp_min(torch.diagonal(V, dim1=1, dim2=2), 1e-9)
    Vd = V + torch.diag_embed(lamV)
    no_obs = ~sh["pmask"] | (Vd.abs().sum((1, 2)) < 1e-12)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vinv = _inv3(torch.where(no_obs[:, None, None], eye3, Vd))
    Vinv = torch.where(no_obs[:, None, None], torch.zeros_like(Vinv), Vinv)
    GV = torch.einsum("pdi,pij->pdj", GP, Vinv)
    S_d = Hcc - torch.einsum("pdi,pei->de", GV, GP)
    rhs_d = b_c - torch.einsum("pdi,pi->d", GV, b_p)
    return S_d, rhs_d, (Vinv, GP, b_p)


def _solve_shards(mesh: Mesh, cfg: BAConfig, F: int, K4, cams, shards):
    """The LM loop over this process's ``shards`` (dicts of one shard's
    tensors on its device, ``pts`` included).  Returns (K4, cams, the
    shards' points, [initial cost, final cost]) with K4, cams and the costs
    on the mesh's first device."""
    dev, dt = mesh.device, cams.dtype
    gauge = torch.cat([
        torch.full((4,), not cfg.fix_intrinsics, dtype=torch.bool,
                   device=dev),
        torch.zeros(6, dtype=torch.bool, device=dev),
        torch.ones(6 * (F - 1), dtype=torch.bool, device=dev)])
    gf = gauge.to(dt)

    def cost(K4, cams, pts_list):
        return reduce_sum(mesh, [
            _shard_cost(cfg, K4.to(sh["uv"].device), cams.to(sh["uv"].device),
                        p, sh) for p, sh in zip(pts_list, shards)])

    pts = [sh["pts"] for sh in shards]
    init_cost = cost(K4, cams, pts)
    lam = torch.tensor(cfg.init_lambda, dtype=dt, device=dev)
    cost_prev = init_cost
    for _ in range(cfg.max_iters):
        parts = []
        for p, sh in zip(pts, shards):
            d = sh["uv"].device
            parts.append(_shard_system(cfg, F, K4.to(d), cams.to(d), p,
                                       lam.to(d), sh))
        S = reduce_sum(mesh, [x[0] for x in parts])
        rhs = reduce_sum(mesh, [x[1] for x in parts])
        S = S * gf[:, None] * gf[None, :] + torch.diag(1.0 - gf)
        rhs = rhs * gf
        dead = torch.diagonal(S).abs() < 1e-8
        df = (~dead).to(dt)
        S = S * df[:, None] * df[None, :] + torch.diag(dead.to(dt))
        rhs = rhs * df
        S = S + lam * torch.diag(torch.clamp_min(torch.diagonal(S), 1e-9))
        dc = torch.linalg.solve_ex(S, rhs)[0]

        ptsn = []
        for p, sh, (Vinv, GP, b_p) in zip(pts, shards,
                                          (x[2] for x in parts)):
            dcd = dc.to(p.device)
            dp = torch.einsum("pij,pj->pi", Vinv,
                              b_p - torch.einsum("pdi,d->pi", GP, dcd))
            ptsn.append(torch.where(sh["pmask"][:, None], p - dp, p))
        K4n = K4 - dc[:4]
        camsn = cams - dc[4:].reshape(F, 6)
        new_cost = cost(K4n, camsn, ptsn)
        accept = new_cost < cost_prev
        K4 = torch.where(accept, K4n, K4)
        cams = torch.where(accept, camsn, cams)
        pts = [torch.where(accept.to(p.device), pn, p)
               for p, pn in zip(pts, ptsn)]
        lam = torch.where(accept, torch.clamp_min(lam * 0.4, 1e-9),
                          torch.clamp_max(lam * 4.0, 1e6))
        cost_prev = torch.where(accept, new_cost, cost_prev)
    return K4, cams, pts, torch.stack([init_cost, cost_prev])


@dataclass
class ShardedBAResult:
    K4: np.ndarray
    cams: np.ndarray
    points: np.ndarray      # [P] in the original uid order
    initial_cost: float
    final_cost: float


class ShardedBA:
    """Host adapter: partitions a BA window's landmarks over the mesh,
    co-locates observations and runs the sharded LM solve."""

    def __init__(self, mesh: Mesh, cfg: BAConfig, window: int):
        self.mesh = mesh
        self.cfg = cfg
        self.window = window
        self.ndev = mesh.size

    def pack(self, K4, cams, points, uv, local_idx, obs_mask, point_mask):
        """Partition the problem over the mesh: returns (args, owner,
        local_of), ``args`` the packed arrays as tensors on the first
        device (the sharded ones with ndev·cap rows, shard-major)."""
        np_args, owner, local_of = self._pack_np(
            K4, cams, points, uv, local_idx, obs_mask, point_mask)
        return (tuple(torch.from_numpy(a).to(self.mesh.device)
                      for a in np_args), owner, local_of)

    def _pack_np(self, K4, cams, points, uv, local_idx, obs_mask,
                 point_mask):
        """Numpy half of ``pack``: round-robin landmarks (shard d owns
        points d, d+nd, …, at local index p // nd), observations on their
        landmark's shard in a stable order."""
        F, Kslots = uv.shape[0], uv.shape[1]
        Pn = len(points)
        nd = self.ndev

        owner = np.arange(Pn, dtype=np.int64) % nd
        local_of = np.arange(Pn, dtype=np.int64) // nd
        P_cap = max(-(-Pn // nd), 1)
        pts_sh = np.zeros((nd, P_cap, 3), np.float32)
        pmask_sh = np.zeros((nd, P_cap), bool)
        pts_sh[owner, local_of] = points
        pmask_sh[owner, local_of] = point_mask

        fobs_g = np.repeat(np.arange(F, dtype=np.int32), Kslots)
        uv_g = uv.reshape(-1, 2)
        pid_g = local_idx.reshape(-1)
        m_g = obs_mask.reshape(-1)
        sel = np.flatnonzero(m_g)
        dev_sel = owner[pid_g[sel]]
        order = np.argsort(dev_sel, kind="stable")
        sel = sel[order]
        dev_sel = dev_sel[order]
        counts = np.bincount(dev_sel, minlength=nd)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(sel)) - starts[dev_sel]
        O_cap = max(int(counts.max()) if len(sel) else 0, 1)
        uv_sh = np.zeros((nd, O_cap, 2), np.float32)
        fobs_sh = np.zeros((nd, O_cap), np.int32)
        pid_sh = np.zeros((nd, O_cap), np.int32)
        omask_sh = np.zeros((nd, O_cap), bool)
        uv_sh[dev_sel, rank] = uv_g[sel]
        fobs_sh[dev_sel, rank] = fobs_g[sel]
        pid_sh[dev_sel, rank] = local_of[pid_g[sel]]
        omask_sh[dev_sel, rank] = True

        np_args = (
            np.asarray(K4, np.float32), np.asarray(cams, np.float32),
            pts_sh.reshape(nd * P_cap, 3),
            pmask_sh.reshape(-1),
            uv_sh.reshape(nd * O_cap, 2),
            fobs_sh.reshape(-1),
            pid_sh.reshape(-1),
            omask_sh.reshape(-1),
        )
        return np_args, owner, local_of

    def _run(self, np_args):
        """Solve over this process's shards of the packed problem."""
        mesh = self.mesh
        keys = ("pts", "pmask", "uv", "fobs", "pid", "omask")
        blocks = [a.reshape((self.ndev, -1) + a.shape[1:])
                  for a in np_args[2:]]
        shards = []
        for j, d in enumerate(mesh.local_devices):
            s = mesh.first_shard + j
            sh = {k: torch.from_numpy(np.ascontiguousarray(b[s])).to(d)
                  for k, b in zip(keys, blocks)}
            sh["fobs"] = sh["fobs"].long()
            sh["pid"] = sh["pid"].long()
            shards.append(sh)
        K4 = torch.from_numpy(np_args[0]).to(mesh.device)
        cams = torch.from_numpy(np_args[1]).to(mesh.device)
        return _solve_shards(mesh, self.cfg, self.window, K4, cams, shards)

    def solve_multiprocess(self, K4, cams, points, uv, local_idx, obs_mask,
                           point_mask):
        """Cross-process solve on a mesh that spans processes: every
        process passes the SAME full problem (the packing is
        deterministic), runs its own shards, and the per-iteration [D,D]
        reduction crosses the process boundary.  Returns (initial_cost,
        final_cost, cams') — what every process holds; the landmark shards
        stay process-local."""
        np_args, _, _ = self._pack_np(K4, cams, points, uv, local_idx,
                                      obs_mask, point_mask)
        _, camsf, _, costs = self._run(np_args)
        costs = costs.cpu().numpy()
        return (float(costs[0]), float(costs[1]),
                camsf.cpu().numpy().astype(np.float64))

    def solve(self, K4: np.ndarray, cams: np.ndarray, points: np.ndarray,
              uv: np.ndarray, local_idx: np.ndarray, obs_mask: np.ndarray,
              point_mask: np.ndarray) -> ShardedBAResult:
        """K4 [4], cams [F,6], points [P,3] (uid order), uv [F,K,2],
        local_idx [F,K] into points, obs_mask [F,K], point_mask [P]; every
        shard in this process."""
        Pn = len(points)
        nd = self.ndev
        P_cap = max(-(-Pn // nd), 1)
        np_args, owner, local_of = self._pack_np(
            K4, cams, points, uv, local_idx, obs_mask, point_mask)
        K4f, camsf, pts, costs = self._run(np_args)
        ptsf = torch.stack([p.to(self.mesh.device) for p in pts])
        ptsf = ptsf.cpu().numpy().reshape(nd, P_cap, 3)
        costs = costs.cpu().numpy()
        return ShardedBAResult(
            K4=K4f.cpu().numpy().astype(np.float64),
            cams=camsf.cpu().numpy().astype(np.float64),
            points=ptsf[owner, local_of].astype(np.float64),
            initial_cost=float(costs[0]),
            final_cost=float(costs[1]),
        )
