"""Step functions over the device-resident TrackerState, device-ingest
subset (counterpart of the JAX package's runtime/steps.py; the pipeline
semantics and the reference citations are documented there).

What differs from the JAX code, and why:

* JAX ``.at[i].set(v, mode="drop")`` silently drops out-of-range rows and
  JAX gathers clamp; torch raises on both.  Drops are explicit here: small
  per-frame arrays gather each row's last writer (``_scatter_drop``, so a
  repeated index resolves as JAX on the CPU resolves it, on every device);
  the map arena, too large to copy, sends dropped rows to a row outside the
  appended range with that row's own value (``_append_points``).  Gathers
  that could run past an arena are clamped.
* Where the JAX steps donated the state, these functions update the
  TrackerState in place and return it.
* ``lax.scan`` in ``advance_window`` is a Python loop that reads one flag
  per step from the device, so steps after the loop went idle are skipped
  instead of run as no-ops.
* RANSAC draws come from a ``torch.Generator`` on the state's device.

Each public step and the match/track halves of a scan step carry a
``torch.profiler.record_function`` span ("steps.<name>"), so a profile of
a run attributes host and device time per step (``profile_main.py``); with
no profiler active a span costs one no-op call.
"""

from __future__ import annotations

import math

import torch

from ..geometry import (compose_with_world, estimate_transformation,
                        reconstruct, solve_pnp_ransac)
from ..geometry.rotations import matrix_to_rodrigues, rodrigues_to_matrix
from ..geometry.triangulate import triangulate_midpoint_anchored
from ..models import frontend as fe
from ..ops import knn
from ..solver.ba import BAConfig, bundle_adjust_window
from .state import EngineConfig, TrackerState

BIG = knn.BIG


def _span(fn):
    return torch.profiler.record_function(f"steps.{fn.__name__}")(fn)


def _K_matrix(K4: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=K4.dtype, device=K4.device)
    o = torch.ones((), dtype=K4.dtype, device=K4.device)
    return torch.stack([torch.stack([K4[0], z, K4[2]]),
                        torch.stack([z, K4[1], K4[3]]),
                        torch.stack([z, z, o])])


def _frontend_cfg(cfg: EngineConfig) -> fe.FrontendConfig:
    return fe.FrontendConfig(
        max_keypoints=cfg.max_keypoints, threshold=cfg.threshold,
        descriptor=cfg.descriptor, ratio=cfg.ratio, metric=cfg.metric,
        descriptor_downscale=cfg.descriptor_downscale,
        sift_nearest=cfg.sift_nearest,
    )


def _scatter_drop(base: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(val, mode="drop")`` for a small array: rows with
    idx == len(base) are dropped, and of repeated indices the last write
    wins (JAX's rule on the CPU).  An index_put would leave the winner of a
    repeated index to the device's thread order; here each row's winner is
    the largest position that writes it (a max, which does not depend on
    order), and the result is a gather of the winners."""
    n = base.shape[0]
    idx = idx.long()
    pos = torch.arange(idx.shape[0], device=idx.device)
    win = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device)
    win = win.scatter_reduce(0, idx, pos, "amax")[:n]
    hit = (win >= 0).reshape((n,) + (1,) * (base.dim() - 1))
    return torch.where(hit, val[win.clamp(min=0)].to(base.dtype), base)


def _row(x: torch.Tensor, i) -> torch.Tensor:
    """``x[i]`` as a copy.  A 0-dim index tensor would make torch read it on
    the host (a sync) and return a view into ``x``; ring rows must not alias
    slots that later ingests overwrite."""
    i = torch.as_tensor(i, device=x.device).long().reshape(1)
    return x.index_select(0, i)[0]


def _select_good(cfg: EngineConfig, eligible, counts, pos):
    """The good-frame rule: tail-most first-fit or head-most max-matches
    (with the optional near-tie head preference)."""
    if cfg.use_first_fit:
        return torch.where(eligible, pos, torch.full_like(pos, -1)).max()
    best = torch.where(eligible, counts, torch.full_like(counts, -1)).max()
    if cfg.head_tie_tolerance > 0.0:
        cut = torch.ceil(best.to(torch.float32)
                         * (1.0 - cfg.head_tie_tolerance)).to(counts.dtype)
    else:
        cut = best
    return torch.argmax((eligible & (counts >= cut)).to(torch.int32))


# ---------------------------------------------------------------- ingest
@_span
def ingest(cfg: EngineConfig, state: TrackerState, gray_u8: torch.Tensor,
           rgb_small: torch.Tensor, slots: torch.Tensor):
    """Extract+describe a packed chunk (gray [C,H,W] u8 + colour plane
    [C,h,w,3] u8) into ring slots [C].  Returns (state, num_corners [C])."""
    res = fe.extract_and_describe_gray_batch(
        _frontend_cfg(cfg), gray_u8, rgb_small, cfg.color_downscale)
    xy = res["xy"]
    if cfg.use_undistortion:
        from ..geometry.projection import undistort_points

        K = _K_matrix(state.K4)
        xy = torch.stack([undistort_points(K, state.dist, u) for u in xy])
    slots = slots.long()
    state.ring_xy[slots] = xy
    state.ring_valid[slots] = res["valid"]
    state.ring_desc[slots] = res["desc"].to(state.ring_desc.dtype)
    state.ring_colors[slots] = res["colors"].to(torch.float32)
    return state, res["num_corners"]


# ------------------------------------------------------------- set prev
@_span
def set_prev_from_slot(cfg: EngineConfig, state: TrackerState, slot, R, t):
    """Promote a ring slot to the previous/reference frame with pose (R,t)."""
    R = R.to(torch.float32)
    t = t.to(torch.float32)
    xy = _row(state.ring_xy, slot)
    cam6 = torch.cat([matrix_to_rodrigues(R), t])
    state.prev_xy = xy
    state.prev_valid = _row(state.ring_valid, slot)
    state.prev_desc = _row(state.ring_desc, slot)
    state.prev_corr = torch.full_like(state.prev_corr, -1)
    state.prev_anchor_cam = cam6.expand(xy.shape[0], 6).clone()
    state.prev_anchor_xy = xy.clone()
    state.pose_R = R
    state.pose_t = t
    return state


# ----------------------------------------------------------- match+select
@_span
def _match_order(cfg, state, order, order_mask):
    res = fe.match_against_batch(
        _frontend_cfg(cfg), state.prev_desc, state.prev_valid,
        state.ring_desc[order], state.ring_valid[order], order_mask)
    return res, res["num_matches"]


@_span
def match_select(cfg: EngineConfig, state: TrackerState, order, order_mask):
    """Match the prev frame against the ring slots in ``order`` [B] (head
    first) and apply the good-frame rule.  Returns (train_all [B,K],
    mask_all [B,K], info = [found, good_pos, count_of_good], counts [B])."""
    res, counts = _match_order(cfg, state, order, order_mask)
    pos = torch.arange(counts.shape[0], device=counts.device)
    eligible = (pos >= cfg.skip_from_head) & order_mask & (
        counts >= cfg.required_matched)
    any_ok = eligible.any()
    good = torch.where(any_ok, _select_good(cfg, eligible, counts, pos),
                       torch.full_like(pos[0], -1))
    info = torch.stack([any_ok.long(), good,
                        torch.where(any_ok, _row(counts, good.clamp(min=0)),
                                    torch.zeros_like(counts[0]))])
    return res["train_idx"], res["is_match"], info, counts


# --------------------------------------------------------------- helpers
def _reproj(K, Xc, uv):
    pix = Xc @ K.T
    den = pix[:, 2:3]
    safe = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    return torch.linalg.norm(pix[:, :2] / safe - uv, dim=1), Xc[:, 2]


def _verify_gates(cfg, K, Rp, tp, Rn, tn, X, uv1, uv2):
    """Map-hygiene gates: reprojection < gate and positive depth in both
    views."""
    e1, z1 = _reproj(K, X @ Rp.T + tp, uv1)
    e2, z2 = _reproj(K, X @ Rn.T + tn, uv2)
    g = cfg.reproj_gate_px
    return (e1 < g) & (e2 < g) & (z1 > 0) & (z2 > 0)


def _verify_gates_anchored(cfg, K, R1s, t1s, Rn, tn, X, uv1, uv2):
    """_verify_gates with a PER-ROW first view (the track anchors)."""
    e1, z1 = _reproj(K, torch.einsum("nij,nj->ni", R1s, X) + t1s, uv1)
    e2, z2 = _reproj(K, X @ Rn.T + tn, uv2)
    g = cfg.reproj_gate_px
    return (e1 < g) & (e2 < g) & (z1 > 0) & (z2 > 0)


def _append_points(state: TrackerState, pts, colors, desc, add_mask):
    """Append the masked rows to the map arena (with their creation-frame
    descriptors).  Returns (state, ids [K] (-1 where not added), n_added).

    Rows that are not appended, or that overflow the arena, are written to
    row (map_count - 1) mod P with that row's own value: that row lies
    outside the appended range (P > K, checked by init_state), so the write
    changes nothing and needs no host sync to filter the rows first."""
    order = torch.cumsum(add_mask.long(), 0) - 1
    ids = state.map_count + order
    P = state.map_points.shape[0]
    ok = add_mask & (ids < P)
    dump = (state.map_count - 1) % P
    tgt = torch.where(ok, ids, dump)
    for arena, val in ((state.map_points, pts), (state.map_colors, colors),
                       (state.map_desc, desc)):
        arena[tgt] = torch.where(ok[:, None], val.to(arena.dtype),
                                 _row(arena, dump).expand_as(val))
    n_added = ok.sum()
    state.map_count = state.map_count + n_added
    return state, torch.where(ok, ids, torch.full_like(ids, -1)), n_added


def _pose_out(ok, n_corr, n_inl, n_new, n_matches, R, t):
    head = torch.stack([torch.as_tensor(v, device=R.device).to(torch.float32)
                        for v in (ok, n_corr, n_inl, n_new, n_matches)])
    return torch.cat([head, R.reshape(-1), t])


def _rebind_candidates(cfg, state):
    """Landmark ids sampled uniformly over the map's age range (strided by
    map_count), and which of them are real (pre-append) landmarks."""
    Mr = cfg.rebind_cap
    dev = state.map_count.device
    stride_n = torch.clamp_min(state.map_count, Mr)
    cand_ids = (torch.arange(Mr, device=dev) * stride_n) // Mr
    cand_real = cand_ids < state.map_count
    safe = cand_ids.clamp(max=state.map_points.shape[0] - 1)  # JAX clamps
    return cand_ids, cand_real, state.map_points[safe], state.map_desc[safe]


def _project_rows(K, Xc):
    pix = Xc @ K.T
    den = pix[:, 2:3]
    safe = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
    return pix[:, :2] / safe


def _top2_masked(d, allowed):
    dm = torch.where(allowed, d, torch.full_like(d, BIG))
    bestc = torch.argmin(dm, dim=1)
    d1 = torch.gather(dm, 1, bestc[:, None])[:, 0]
    d2 = dm.scatter(1, bestc[:, None], BIG).amin(1)
    return bestc, d1, d2


def _ratio2(cfg):
    return cfg.ratio * cfg.ratio if cfg.metric == "l2" else cfg.ratio


# -------------------------------------------------------------- bootstrap
@_span
def bootstrap_step(cfg: EngineConfig, state: TrackerState, slot, train,
                   mask, gen=None, idx=None):
    """First-pair processing: essential-RANSAC pose + chirality filter +
    triangulation + landmark creation, with the restart-boundary re-binding
    and monocular-scale rescue.  The first frame is ``state.prev_*`` with
    pose (state.pose_R, state.pose_t).  ``idx`` [S,8] overrides the RANSAC
    draw from ``gen``.  Returns (state, out [22])."""
    dev = state.K4.device
    K = _K_matrix(state.K4)
    new_xy = _row(state.ring_xy, slot)
    train_s = torch.where(mask, train, torch.zeros_like(train))
    uv1 = state.prev_xy
    uv2 = new_xy[train_s]

    pose = estimate_transformation(
        K, uv1, uv2, mask, use_ransac=cfg.use_ransac,
        threshold_px=cfg.ransac_threshold,
        distance_threshold=cfg.distance_threshold,
        num_hypotheses=cfg.ransac_iters, idx=idx, gen=gen)
    state.win_map_base = state.map_count.clone()
    chir = pose["chirality_mask"]
    R1, t1 = state.pose_R, state.pose_t
    R2, t2 = compose_with_world(R1, t1, pose["R"], pose["t"])
    X = reconstruct(K, R1, t1, R2, t2, uv1, uv2, chir)
    K_slots = uv1.shape[0]

    bind = torch.zeros(K_slots, dtype=torch.bool, device=dev)
    old_row_ids = torch.full((K_slots,), -1, dtype=torch.long, device=dev)
    scale_s = torch.ones((), device=dev)
    n_bind = torch.zeros((), dtype=torch.long, device=dev)
    n_rad = torch.zeros((), dtype=torch.long, device=dev)
    n_okr = torch.zeros((), dtype=torch.long, device=dev)
    if cfg.rebind_cap > 0 and cfg.restart_rebind:
        cand_ids, cand_real, cand_X, cand_desc = _rebind_candidates(cfg, state)
        Xc1 = cand_X @ R1.T + t1
        pc = _project_rows(K, Xc1)
        d = knn.distance_matrix(state.prev_desc, cand_desc, cfg.metric)
        rad = 4.0 * cfg.rebind_radius
        pixd2 = ((uv1[:, None, :] - pc[None, :, :]) ** 2).sum(-1)
        allowed = (cand_real & (Xc1[:, 2] > 0))[None, :] & (pixd2 < rad * rad)
        bestc, d1, d2 = _top2_masked(d, allowed)
        ok_r = (d1 < _ratio2(cfg) * d2) & (d2 < BIG / 2)
        vote = state.prev_valid & (d1 < BIG / 2)
        n_rad = vote.sum()
        n_okr = (state.prev_valid & ok_r).sum()
        old_best = cand_ids[bestc]
        z_old = Xc1[bestc, 2]
        z_new = (X @ R1.T + t1)[:, 2]
        r_ok = vote & chir & (z_new > 1e-6) & (z_old > 1e-6)
        ratios = torch.where(r_ok, z_old / torch.clamp_min(z_new, 1e-6),
                             torch.full_like(z_new, BIG))
        n_r = r_ok.sum()
        srt = torch.sort(ratios).values
        med = _row(srt, torch.clamp(n_r // 2, 0, K_slots - 1))
        inlier = r_ok & ((ratios - med).abs() < 0.25 * med)
        n_in = inlier.sum()
        consensus = (n_r >= 8) & (n_in >= (n_r + 1) // 2)
        scale_s = torch.where(consensus, torch.clamp(med, 0.05, 20.0),
                              torch.ones_like(med))
        bind = inlier & consensus
        old_row_ids = torch.where(bind, old_best, old_row_ids)
        n_bind = bind.sum()
        t2 = pose["R"] @ t1 + scale_s * pose["t"]
        C1 = -R1.T @ t1
        X = C1 + scale_s * (X - C1)

    colors = _row(state.ring_colors, slot)[train_s]
    desc_new = _row(state.ring_desc, slot)[train_s]
    add_mask = chir & ~bind
    state, ids, n_new = _append_points(state, X, colors, desc_new, add_mask)

    neg = torch.full((K_slots,), -1, dtype=torch.long, device=dev)
    row_corr = torch.where(bind, old_row_ids, torch.where(add_mask, ids, neg))
    first_corr = row_corr
    row_sel = (bind | add_mask) & mask
    second_corr = _scatter_drop(
        neg, torch.where(row_sel, train_s, K_slots),
        torch.where(row_sel, row_corr, neg))

    aa1 = matrix_to_rodrigues(state.pose_R)
    aa2 = matrix_to_rodrigues(R2)
    cam1 = torch.cat([aa1, state.pose_t])
    cam2 = torch.cat([aa2, t2])
    state.win_xy[0] = uv1
    state.win_xy[1] = new_xy
    state.win_corr[0] = first_corr
    state.win_corr[1] = second_corr
    state.win_cams[0] = cam1
    state.win_cams[1] = cam2
    state.win_used[0] = True
    state.win_used[1] = True

    # matched features inherit the FIRST frame as their track anchor; fresh
    # features anchor at this second frame
    scat = torch.where(mask, train_s, K_slots)
    anchor_cam = _scatter_drop(cam2.expand(K_slots, 6), scat,
                               cam1.expand(K_slots, 6))
    anchor_xy = _scatter_drop(new_xy, scat, uv1)

    state.prev_xy = new_xy
    state.prev_valid = _row(state.ring_valid, slot)
    state.prev_desc = _row(state.ring_desc, slot)
    state.prev_corr = second_corr
    state.prev_anchor_cam = anchor_cam
    state.prev_anchor_xy = anchor_xy
    state.step_ema = torch.linalg.norm((-R2.T @ t2) - (-R1.T @ t1))
    state.pose_R = R2
    state.pose_t = t2
    out = torch.cat([
        _pose_out(True, chir.sum(), pose["num_passed"], n_new, mask.sum(),
                  R2, t2),
        torch.stack([scale_s.to(torch.float32), n_bind.to(torch.float32),
                     n_rad.to(torch.float32), n_okr.to(torch.float32),
                     state.win_map_base.to(torch.float32)]),
    ])
    return state, out


# ------------------------------------------------------------- track step
@_span
def _track_core(cfg: EngineConfig, state: TrackerState, slot, train, mask,
                win_pos, gen=None, idx=None):
    """Accept the chosen candidate: PnP pose, triangulate, verified map
    merge, window bookkeeping.  Every update is gated on ok (enough PnP
    correspondences, no pose jump), so a rejected frame leaves the state as
    it was.  Returns (state, out [17])."""
    dev = state.K4.device
    K = _K_matrix(state.K4)
    new_xy = _row(state.ring_xy, slot)
    new_valid = _row(state.ring_valid, slot)
    new_desc = _row(state.ring_desc, slot)
    train_s = torch.where(mask, train, torch.zeros_like(train))
    K_slots = new_xy.shape[0]

    struct = torch.where(mask, state.prev_corr,
                         torch.full_like(state.prev_corr, -1))
    pm = struct >= 0
    Xh = state.map_points[torch.where(pm, struct, torch.zeros_like(struct))]
    uvh = new_xy[train_s]
    n_corr = pm.sum()
    ok = n_corr >= 4

    pnp = solve_pnp_ransac(K, Xh, uvh, pm, num_hypotheses=cfg.pnp_iters,
                           reproj_threshold_px=cfg.reproj_gate_px,
                           prior_R=state.pose_R, prior_t=state.pose_t,
                           idx=idx, gen=gen)
    Rn, tn = pnp["R"], pnp["t"]

    # pose-jump gate against the EMA of accepted steps (0 = no history)
    step_len = torch.linalg.norm((-Rn.T @ tn)
                                 - (-state.pose_R.T @ state.pose_t))
    if cfg.pose_jump_gate > 0:
        ok = ok & ((state.step_ema <= 0)
                   | (step_len <= cfg.pose_jump_gate * state.step_ema + 1e-3))

    uv1 = state.prev_xy
    uv2 = uvh
    if cfg.anchored_tri:
        R1s = rodrigues_to_matrix(state.prev_anchor_cam[:, :3])
        t1s = state.prev_anchor_cam[:, 3:]
        auv1 = state.prev_anchor_xy
        X, cospar = triangulate_midpoint_anchored(K, R1s, t1s, Rn, tn, auv1,
                                                  uv2, mask)
        verified = _verify_gates_anchored(cfg, K, R1s, t1s, Rn, tn, X, auv1,
                                          uv2)
        verified = verified & (cospar < math.cos(
            math.radians(cfg.parallax_min_deg)))
    else:
        X = reconstruct(K, state.pose_R, state.pose_t, Rn, tn, uv1, uv2, mask)
        verified = _verify_gates(cfg, K, state.pose_R, state.pose_t, Rn, tn,
                                 X, uv1, uv2)

    # existing-binding re-verification (softer gate) before propagation
    Xc = Xh @ Rn.T + tn
    pix = Xc @ K.T
    e_old = torch.linalg.norm(
        pix[:, :2] / torch.clamp_min(pix[:, 2:3].abs(), 1e-9) - uv2, dim=1)
    prop_ok = (e_old < 2.0 * cfg.reproj_gate_px) & (Xc[:, 2] > 0)

    is_old = mask & (state.prev_corr >= 0) & prop_ok
    neg = torch.full((K_slots,), -1, dtype=torch.long, device=dev)
    new_corr = _scatter_drop(neg, torch.where(is_old, train_s, K_slots),
                             torch.where(is_old, state.prev_corr, neg))

    # map re-binding before landmark creation (see the JAX code)
    if cfg.rebind_cap > 0:
        cand_ids, cand_real, cand_X, cand_desc = _rebind_candidates(cfg, state)
        Xcc = cand_X @ Rn.T + tn
        pc = _project_rows(K, Xcc)
        if cfg.metric == "l2":
            # candidate ranking tolerates bf16-rounded operands, as in the
            # JAX code (a plain matmul outside any kernel)
            a16 = new_desc.to(torch.bfloat16).float()
            b16 = cand_desc.to(torch.bfloat16).float()
            ab = a16 @ b16.T
            a2 = (new_desc.float() ** 2).sum(-1, keepdim=True)
            b2 = (cand_desc.float() ** 2).sum(-1)
            d = torch.clamp_min(a2 + b2[None, :] - 2.0 * ab, 0.0)
        else:
            d = knn.distance_matrix(new_desc, cand_desc, cfg.metric)
        pixd2 = ((new_xy[:, None, :] - pc[None, :, :]) ** 2).sum(-1)
        allowed = (cand_real & (Xcc[:, 2] > 0))[None, :] & (
            pixd2 < cfg.rebind_radius * cfg.rebind_radius)
        bestc, d1, d2 = _top2_masked(d, allowed)
        ok_r = (d1 < _ratio2(cfg) * d2) & (d2 < BIG / 2)
        # adaptive absolute gate: 90th percentile of the propagated
        # bindings' own descriptor distances
        lm_desc = state.map_desc[torch.where(is_old, state.prev_corr,
                                             torch.zeros_like(neg))]
        feat = new_desc[train_s]
        if cfg.metric == "hamming":
            good_d = torch.diagonal(knn.hamming_distance(feat[:, None],
                                                         lm_desc[:, None]),
                                    dim1=-2, dim2=-1)[:, 0]
        elif cfg.metric == "l1":
            good_d = (feat.float() - lm_desc.float()).abs().sum(-1)
        else:
            diff = feat.float() - lm_desc.float()
            good_d = (diff * diff).sum(-1)
        good_d = torch.where(is_old, good_d, torch.full_like(good_d, BIG))
        n_good = is_old.sum()
        srt = torch.sort(good_d).values
        q_idx = torch.clamp((n_good * 9) // 10, 0, good_d.shape[0] - 1)
        tau = torch.where(n_good >= 8, _row(srt, q_idx),
                          torch.full_like(srt[0], -1.0))
        bind = new_valid & (new_corr < 0) & ok_r & (d1 <= tau)
        new_corr = torch.where(bind, cand_ids[bestc], new_corr)

    bound_after = new_corr[train_s] >= 0
    add_mask = mask & (state.prev_corr < 0) & verified & ok & ~bound_after
    colors = _row(state.ring_colors, slot)[train_s]
    desc_created = _row(state.ring_desc, slot)[train_s]
    state, ids, n_new = _append_points(state, X, colors, desc_created,
                                       add_mask)
    new_corr = _scatter_drop(new_corr, torch.where(add_mask, train_s,
                                                   K_slots), ids)

    aa = matrix_to_rodrigues(Rn)
    cam_n = torch.cat([aa, tn])
    # window bookkeeping: one row, written only when the frame is accepted
    w_ok = ok & (win_pos < cfg.window)
    w = torch.clamp(torch.as_tensor(win_pos, device=dev), max=cfg.window - 1)
    w = w.long().reshape(1)
    for arr, val in ((state.win_xy, new_xy), (state.win_corr, new_corr),
                     (state.win_cams, cam_n), (state.win_used, w_ok)):
        arr.index_copy_(0, w, torch.where(w_ok, val, _row(arr, w))[None])

    anchor_cam_new = cam_n.expand(K_slots, 6)
    anchor_xy_new = new_xy
    if cfg.anchored_tri:
        scat = torch.where(mask, train_s, K_slots)
        anchor_cam_new = _scatter_drop(anchor_cam_new, scat,
                                       state.prev_anchor_cam)
        anchor_xy_new = _scatter_drop(anchor_xy_new, scat,
                                      state.prev_anchor_xy)

    def g(new, old):
        return torch.where(ok, new, old)

    state.prev_xy = g(new_xy, state.prev_xy)
    state.prev_valid = g(new_valid, state.prev_valid)
    state.prev_desc = g(new_desc, state.prev_desc)
    state.prev_corr = g(new_corr, state.prev_corr)
    state.prev_anchor_cam = g(anchor_cam_new, state.prev_anchor_cam)
    state.prev_anchor_xy = g(anchor_xy_new, state.prev_anchor_xy)
    state.step_ema = g(torch.where(state.step_ema > 0,
                                   0.7 * state.step_ema + 0.3 * step_len,
                                   step_len), state.step_ema)
    state.pose_R = g(Rn, state.pose_R)
    state.pose_t = g(tn, state.pose_t)
    out = _pose_out(ok, n_corr, pnp["num_inliers"], n_new, mask.sum(), Rn, tn)
    return state, out


# ----------------------------------------------------------------- BA step
@_span
def _ba_core(cfg: EngineConfig, state: TrackerState, win_fill: int):
    """Windowed BA over the device-resident window + map arena; writes the
    adjusted intrinsics, points and prev pose back and resets the window.
    Returns (state, packed = [rmse0, rmse1, num_res, n_iters, cams (F*6),
    Rmats (F*9)])."""
    Pw = cfg.window_points
    dev = state.K4.device
    corr = torch.where(state.win_used[:, None], state.win_corr,
                       torch.full_like(state.win_corr, -1))
    obs_mask = corr >= 0
    SENT = 2 ** 30
    sentinel = torch.where(obs_mask, corr, torch.full_like(corr, SENT))
    uniq = torch.unique(sentinel.reshape(-1))[:Pw]
    uids = torch.full((Pw,), SENT, dtype=torch.long, device=dev)
    uids[: uniq.shape[0]] = uniq
    pmask = uids < SENT
    local = torch.searchsorted(uids, sentinel.reshape(-1)).reshape(
        sentinel.shape)
    local = torch.where(obs_mask, torch.clamp(local, max=Pw - 1),
                        torch.zeros_like(local))
    # landmarks beyond the Pw cap are masked out, not aliased
    obs_mask = obs_mask & (uids[local] == sentinel)
    ids_safe = torch.where(pmask, uids, torch.zeros_like(uids))
    pts = state.map_points[ids_safe]

    bacfg = BAConfig(loss=cfg.ba_loss, loss_param=cfg.ba_loss_param,
                     max_iters=cfg.ba_iters, obs_cap=cfg.ba_obs_cap,
                     fix_intrinsics=not cfg.ba_adjust_intrinsics,
                     gauge_frame0=not cfg.ba_freeze_old)
    pfree = ids_safe >= state.win_map_base if cfg.ba_freeze_old else None
    K4f, camsf, ptsf, info = bundle_adjust_window(
        bacfg, state.K4, state.win_cams, pts, state.win_xy, local, obs_mask,
        pmask, pfree)

    state.map_points[uids[pmask]] = ptsf[pmask]
    last = max(int(win_fill) - 1, 0)
    Rmats = rodrigues_to_matrix(camsf[:, :3])
    packed = torch.cat([
        torch.stack([info["initial_rmse"], info["final_rmse"],
                     info["num_residuals"].to(camsf.dtype),
                     torch.tensor(float(info["num_iters"]), device=dev)]),
        camsf.reshape(-1), Rmats.reshape(-1)])
    state.K4 = K4f
    state.pose_R = Rmats[last]
    state.pose_t = camsf[last, 3:]
    _win_reset(state)
    return state, packed


def ba_step(cfg: EngineConfig, state: TrackerState, win_fill: int):
    """Standalone windowed-BA dispatch (classic loop + final flush)."""
    return _ba_core(cfg, state, win_fill)


def _win_reset(state: TrackerState) -> TrackerState:
    """Window reset without a solve (this window's landmarks are settled)."""
    state.win_used = torch.zeros_like(state.win_used)
    state.win_corr = torch.full_like(state.win_corr, -1)
    state.win_map_base = state.map_count.clone()
    return state


# ----------------------------------------------------- windowed device loop
@_span
def advance_window(cfg: EngineConfig, state: TrackerState, queue, q_head,
                   q_len, win_fill, gen=None, t_steps: int = 8,
                   visible: int = 0):
    """Process up to ``t_steps`` frames: each step matches the previous
    frame against the first ``visible`` unconsumed queue entries, applies
    the good-frame rule and tracks the winner.  The loop stops once a frame
    is not found, PnP fails, the queue drains or the window fills.

    Returns (state, packed [t_steps, 22], q_head, q_len) with packed[t] =
    [stepped, found, good_pos, count_good, ok, n_corr, n_inl, n_new,
     n_matches, R(9), t(3), win_pos]; rows after the loop stopped are 0."""
    dev = state.K4.device
    queue = torch.as_tensor(queue, device=dev).long()
    Q = queue.shape[0]
    Qv = min(visible, Q) if visible > 0 else Q
    iota_q = torch.arange(Qv, device=dev)
    q_head = torch.as_tensor(q_head, device=dev).long()
    q_len = torch.as_tensor(q_len, device=dev).long()
    win_pos = torch.as_tensor(win_fill, device=dev).long()
    alive = torch.ones((), dtype=torch.bool, device=dev)
    packed = torch.zeros((t_steps, 22), dtype=torch.float32, device=dev)
    for step in range(t_steps):
        active = alive & (q_len > 0) & (win_pos < cfg.window)
        if not bool(active):       # one host read per step; idle is final
            break
        order = queue[(q_head + iota_q) % Q]
        order_mask = iota_q < torch.clamp(q_len, max=Qv)
        res, counts = _match_order(cfg, state, order, order_mask)
        eligible = (iota_q >= cfg.skip_from_head) & order_mask & (
            counts >= cfg.required_matched)
        found = eligible.any()
        good = torch.where(found, _select_good(cfg, eligible, counts, iota_q),
                           torch.zeros_like(q_len))
        mask = _row(res["is_match"], good) & found
        state, out = _track_core(cfg, state, _row(order, good),
                                 _row(res["train_idx"], good), mask,
                                 win_pos, gen)
        accept = found & (out[0] > 0.5)
        q_head = torch.where(found, (q_head + good + 1) % Q, q_head)
        q_len = torch.where(found, q_len - good - 1, q_len)
        win_pos = torch.where(accept, win_pos + 1, win_pos)
        alive = alive & accept
        packed[step] = torch.cat([
            torch.stack([torch.ones((), device=dev), found.float(),
                         good.float(),
                         torch.where(found, _row(counts, good),
                                     torch.zeros_like(counts[0])).float()]),
            out, win_pos.float()[None]])
    return state, packed, q_head, q_len
