"""FAST-9/16 corner detection as a dense, fixed-shape tensor program
(counterpart of the JAX package's ops/fast.py): 16 ring comparisons as
shifted planes, contiguous-arc tests as windowed reductions, OpenCV-style
score, 3×3 non-max suppression with a raster tiebreak, then a fixed top-K.
``raw_corners`` is the same arc test run sparsely on the host, for host
ingest (OpenCV's FAST-9/16 corner list without its non-max suppression).

``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk`` promises
no order among ties (and on CUDA it has none), so the top-K here is a stable
descending sort, which keeps equal scores in raster order.
"""

from __future__ import annotations

import numpy as np
import torch

# FAST 16-pixel Bresenham circle of radius 3, (dx, dy), clockwise from top.
RING_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)
ARC_LEN = 9
BORDER = 3


def _ring_stack(gray: torch.Tensor) -> torch.Tensor:
    """[...,H,W] → [16,...,H,W]: ring pixel value at each center."""
    return torch.stack([
        torch.roll(gray, shifts=(-int(dy), -int(dx)), dims=(-2, -1))
        for dx, dy in RING_OFFSETS
    ])


def fast_score_map(gray: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST corner-score map [...,H,W] (0 where not a corner)."""
    gray = gray.to(torch.float32)
    d = _ring_stack(gray) - gray[None]               # [16,...,H,W]
    doubled = torch.cat([d, d[: ARC_LEN - 1]], dim=0)
    bright = None
    dark = None
    for s in range(16):
        win = doubled[s: s + ARC_LEN]
        mn = win.amin(dim=0)
        mx = win.amax(dim=0)
        bright = mn if bright is None else torch.maximum(bright, mn)
        dark = -mx if dark is None else torch.maximum(dark, -mx)
    score = torch.maximum(bright, dark)
    is_corner = score > threshold
    H, W = gray.shape[-2:]
    yy = torch.arange(H, device=gray.device)[:, None]
    xx = torch.arange(W, device=gray.device)[None, :]
    in_bounds = ((yy >= BORDER) & (yy < H - BORDER)
                 & (xx >= BORDER) & (xx < W - BORDER))
    return torch.where(is_corner & in_bounds, score, torch.zeros_like(score))


def _nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only 3×3 local maxima; plateaus keep the raster-first pixel
    (score minus a raster-index epsilon, strict >)."""
    H, W = score.shape[-2:]
    yy = torch.arange(H, device=score.device, dtype=torch.int32)[:, None]
    xx = torch.arange(W, device=score.device, dtype=torch.int32)[None, :]
    eps = (yy * W + xx).to(torch.float32) * 1e-7
    tiebroken = score - eps
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            r = torch.roll(tiebroken, (-dy, -dx), (-2, -1))
            nmax = r if nmax is None else torch.maximum(nmax, r)
    return torch.where(tiebroken > nmax, score, torch.zeros_like(score))


def detect_batch(gray: torch.Tensor, threshold: float = 20.0,
                 max_keypoints: int = 2048, nms: bool = True):
    """FAST keypoints of a frame batch [C,H,W].

    Returns dict: xy [C,K,2] f32 (x, y; strongest first), score [C,K],
    valid [C,K] bool, num_corners [C] (before the top-K cut)."""
    raw_score = fast_score_map(gray, threshold)
    score = _nms3x3(raw_score) if nms else raw_score
    C, H, W = score.shape
    flat = score.reshape(C, -1)
    num_corners = (flat > 0).sum(-1)
    top_scores, top_idx = torch.sort(flat, dim=-1, descending=True,
                                     stable=True)
    top_scores = top_scores[:, :max_keypoints]
    top_idx = top_idx[:, :max_keypoints]
    ys = top_idx // W
    xs = top_idx % W
    valid = top_scores > 0
    # sub-pixel: quadratic fit on the raw score 3×3 neighbourhood
    ysc = torch.clamp(ys, 1, H - 2)
    xsc = torch.clamp(xs, 1, W - 2)
    raw_flat = raw_score.reshape(C, -1)

    def _at(dy, dx):
        return torch.gather(raw_flat, 1, (ysc + dy) * W + (xsc + dx))

    c = _at(0, 0)
    dxm, dxp = _at(0, -1), _at(0, 1)
    dym, dyp = _at(-1, 0), _at(1, 0)
    denx = dxm + dxp - 2.0 * c
    deny = dym + dyp - 2.0 * c
    zero = torch.zeros_like(c)
    offx = torch.where(denx.abs() > 1e-6, 0.5 * (dxm - dxp) / denx, zero)
    offy = torch.where(deny.abs() > 1e-6, 0.5 * (dym - dyp) / deny, zero)
    offx = torch.clamp(offx, -0.5, 0.5)
    offy = torch.clamp(offy, -0.5, 0.5)
    xy = torch.stack([xs.to(torch.float32) + offx,
                      ys.to(torch.float32) + offy], dim=-1)
    return {
        "xy": torch.where(valid[..., None], xy, torch.zeros_like(xy)),
        "score": torch.where(valid, top_scores, torch.zeros_like(top_scores)),
        "valid": valid,
        "num_corners": num_corners,
    }


def detect(gray: torch.Tensor, threshold: float = 20.0,
           max_keypoints: int = 2048, nms: bool = True):
    """FAST keypoints of one [H,W] frame (``detect_batch`` on one lane)."""
    res = detect_batch(gray[None], threshold, max_keypoints, nms)
    return {k: v[0] for k, v in res.items()}


def arc_scores(g16: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """FAST-9/16 arc scores [N] int16 of an int16 plane at positions at least
    ``BORDER`` pixels inside it: the largest t with 9 contiguous ring pixels
    all brighter than centre + t or all darker than centre − t, less one
    (the dense ``fast_score_map``'s score, which is > threshold exactly
    where the arc test passes at that threshold)."""
    W = g16.shape[1]
    flat = ys * W + xs
    gr = g16.reshape(-1)
    ring = (RING_OFFSETS[:, 1].astype(np.int64) * W
            + RING_OFFSETS[:, 0].astype(np.int64))
    d = gr[flat[:, None] + ring[None, :]] - gr[flat][:, None]    # [N,16]
    doubled = np.concatenate([d, d[:, : ARC_LEN - 1]], axis=1)

    def win9(x, op):
        # extremum over 9 consecutive entries by doubling: 4 passes
        w2 = op(x[:, :-1], x[:, 1:])
        w4 = op(w2[:, :-2], w2[:, 2:])
        w8 = op(w4[:, :-4], w4[:, 4:])
        return op(w8[:, :16], x[:, 8:])

    bright = win9(doubled, np.minimum).max(-1)
    dark = -win9(doubled, np.maximum).min(-1)
    return np.maximum(bright, dark)


def raw_corners(gray, threshold):
    """OpenCV's raw FAST-9/16 corners (``FastFeatureDetector`` TYPE_9_16,
    no non-max suppression) of one u8 gray frame [H,W] (numpy or a CPU
    tensor): (xs [N] i64, ys [N] i64, score [N] int16) in raster order, the
    order OpenCV lists them in.  The arc test is ``fast_score_map``'s at the
    integer threshold OpenCV takes, with its border of 3.

    A 9-pixel arc of the 16-ring covers two compass points (ring 0, 4, 8,
    12) four apart, so a pixel whose compass points pass no such pair
    cannot be a corner; the exact arc test runs only on the pixels that
    pass (a few percent of a frame), which keeps this on the host's
    budget."""
    if isinstance(gray, torch.Tensor):
        gray = gray.cpu().numpy()
    g = np.ascontiguousarray(gray).astype(np.int16)
    H, W = g.shape
    t = int(threshold)
    if H <= 2 * BORDER or W <= 2 * BORDER:
        e = np.zeros(0, np.int64)
        return e, e, np.zeros(0, np.int16)
    c = g[BORDER:H - BORDER, BORDER:W - BORDER]

    def ring(k):
        dx, dy = (int(v) for v in RING_OFFSETS[k])
        return g[BORDER + dy:H - BORDER + dy, BORDER + dx:W - BORDER + dx]

    hi = c + t
    lo = c - t
    p0, p4, p8, p12 = (ring(k) for k in (0, 4, 8, 12))
    # a pair four apart passes: (b0&b4)|(b4&b8)|(b8&b12)|(b12&b0)
    # = (b0|b8)&(b4|b12), for the bright and the dark test
    cand = (p0 > hi) | (p8 > hi)
    cand &= (p4 > hi) | (p12 > hi)
    dark = (p0 < lo) | (p8 < lo)
    dark &= (p4 < lo) | (p12 < lo)
    cand |= dark
    Wc = W - 2 * BORDER
    flat = np.flatnonzero(cand)
    ys = flat // Wc + BORDER
    xs = flat % Wc + BORDER
    score = arc_scores(g, ys, xs)
    keep = score > t
    return xs[keep], ys[keep], score[keep]
