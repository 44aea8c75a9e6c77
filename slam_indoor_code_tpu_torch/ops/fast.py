"""FAST-9/16 corner detection as a dense, fixed-shape tensor program
(counterpart of the JAX package's ops/fast.py): 16 ring comparisons as
shifted planes, contiguous-arc tests as windowed reductions, OpenCV-style
score, 3×3 non-max suppression with a raster tiebreak, then a fixed top-K.

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
