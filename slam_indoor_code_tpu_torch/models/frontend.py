"""The feature frontend: gray → FAST → SIFT or ORB → colours, and the
previous-frame-vs-batch 2-NN match (counterpart of the JAX package's
models/frontend.py).

Two ingest halves.  Device ingest uploads the full gray plane and detects
on the device (``extract_and_describe_gray_batch``; the classic conductor,
pipeline/, uploads the RGB frames instead: ``extract_and_describe_batch``).  Host ingest detects on
the host (``host_detect_pack``) and uploads a pooled gray plane with the
keypoints; the device then only describes (``describe_packed_batch``).  The
JAX package's host half calls OpenCV; here it is numpy, equal to OpenCV
bit for bit (the tests hold it to cv2): ``host_gray`` is cv2's fixed-point
RGB→gray, ``fast.raw_corners`` cv2's FAST-9/16 corner list, and
``area_downscale`` cv2's INTER_AREA at an integer factor.  The host ORB
descriptor modes ("orb", "hybrid") need OpenCV's ORB pattern and are not
ported."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import fast, image, knn, orb, sift


@dataclass(frozen=True)
class FrontendConfig:
    """Static frontend parameters (same fields as the JAX package's)."""

    max_keypoints: int = 2048
    threshold: float = 20.0
    descriptor: str = "sift"   # 'sift' | 'orb'
    ratio: float = 0.7
    metric: str = "l2"         # 'l2' | 'l1' | 'hamming'
    descriptor_downscale: int = 1
    sift_nearest: str = "auto"


def pack_frames(frames, color_downscale: int = 4):
    """Host-side ingest payload packer: RGB uint8 frames → (gray [C,H,W] u8,
    rgb_small [C,H/d,W/d,3] u8), gray with OpenCV's fixed-point BT.601
    weights (77,150,29)/256 — the same bytes as the JAX package's packer."""
    d = color_downscale
    gray = np.empty((len(frames),) + frames[0].shape[:2], np.uint8)
    small = np.empty((len(frames), frames[0].shape[0] // d,
                      frames[0].shape[1] // d, 3), np.uint8)
    for i, f in enumerate(frames):
        acc = f[..., 0].astype(np.uint16)
        acc *= 77
        g = f[..., 1].astype(np.uint16)
        g *= 150
        acc += g
        b = f[..., 2].astype(np.uint16)
        b *= 29
        acc += b
        acc += 128
        acc >>= 8
        gray[i] = acc.astype(np.uint8)
        small[i] = f[: small.shape[1] * d: d, : small.shape[2] * d: d]
    return gray, small


# ----------------------------------------------------------- host ingest
def host_gray(rgb: np.ndarray) -> np.ndarray:
    """BT.601 gray of an RGB u8 frame [H,W,3] → [H,W] u8, bit for bit
    ``cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)``: OpenCV's 15-bit fixed point
    (0.299, 0.587, 0.114 as 9798, 19235, 3735 over 2¹⁵, rounded half up).
    ``pack_frames``' 8-bit weights are only within ±1 of it."""
    acc = rgb[..., 0].astype(np.uint32)
    acc *= 9798
    g = rgb[..., 1].astype(np.uint32)
    g *= 19235
    acc += g
    b = rgb[..., 2].astype(np.uint32)
    b *= 3735
    acc += b
    acc += 1 << 14
    acc >>= 15
    return acc.astype(np.uint8)


def area_downscale(gray: np.ndarray, d: int) -> np.ndarray:
    """The d×d block mean of a u8 plane [H,W] (H and W multiples of d),
    bit for bit ``cv2.resize(gray, (W//d, H//d), interpolation=INTER_AREA)``:
    at d=2 OpenCV rounds half up, at other factors half to even."""
    H, W = gray.shape
    if H % d or W % d:
        raise ValueError(f"area_downscale: {H}x{W} is not a multiple of "
                         f"{d}")
    s = np.zeros((H // d, W // d), np.int32)
    for dy in range(d):
        for dx in range(d):
            s += gray[dy::d, dx::d]
    n = d * d
    if d == 2:
        return ((s + 2) >> 2).astype(np.uint8)
    q, r = np.divmod(s, n)
    up = (2 * r > n) | ((2 * r == n) & (q % 2 == 1))
    return (q + up).astype(np.uint8)


# Neighbour offsets in _nms3x3's iteration order ((dy,dx), centre skipped).
_NEIGH8 = np.array([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                    if not (dy == 0 and dx == 0)], np.int64)


def _host_detect_frame(gray: np.ndarray, threshold: float):
    """FAST detection of one u8 gray frame on the host with the device
    detector's semantics (``fast.detect_batch``): the raw arc-test corners,
    their scores gated at ``score > threshold``, 3×3 NMS with the
    raster-index tie-break (one survivor per score plateau) and the
    quadratic subpixel fit on the score neighbourhood.

    Returns (xy [N,2] f32 subpixel coords strongest first, ixy [N,2] i64
    integer coords in the same order, num_corners int)."""
    H, W = gray.shape
    xs, ys, raw = fast.raw_corners(gray, threshold)
    if not len(xs):
        return (np.zeros((0, 2), np.float32), np.zeros((0, 2), np.int64), 0)
    score = raw.astype(np.float32)
    score = np.where(score > threshold, score, np.float32(0.0))

    # sparse score plane (non-corner pixels are 0, like the dense map)
    S = np.zeros((H, W), np.float32)
    S[ys, xs] = score
    ny = ys[:, None] + _NEIGH8[None, :, 0]          # [N,8]; raw corners are
    nx = xs[:, None] + _NEIGH8[None, :, 1]          # ≥3 px from the border
    s_n = S[ny, nx]
    eps = np.float32(1e-7)
    tb_c = score - (ys * W + xs).astype(np.float32) * eps
    tb_n = s_n - (ny * W + nx).astype(np.float32) * eps
    keep = tb_c > tb_n.max(axis=1)

    # the strongest-first order of the survivors; ties keep raster order
    order = np.flatnonzero(keep)
    order = order[np.argsort(-score[order], kind="stable")]
    c, sn = score[order], s_n[order]
    dxm, dxp = sn[:, 3], sn[:, 4]
    dym, dyp = sn[:, 1], sn[:, 6]
    denx = dxm + dxp - 2.0 * c
    deny = dym + dyp - 2.0 * c
    offx = np.where(np.abs(denx) > 1e-6, 0.5 * (dxm - dxp) / denx, 0.0)
    offy = np.where(np.abs(deny) > 1e-6, 0.5 * (dym - dyp) / deny, 0.0)
    xy = np.stack([xs[order] + np.clip(offx, -0.5, 0.5),
                   ys[order] + np.clip(offy, -0.5, 0.5)], -1).astype(
                       np.float32)
    ixy = np.stack([xs[order], ys[order]], -1)
    return xy, ixy, int(keep.sum())


def host_detect_pack(frames, threshold: float, max_keypoints: int,
                     ingest_downscale: int = 2, host_desc: str = "same"):
    """Host-side ingest of a chunk of RGB u8 frames: per frame the gray
    plane (``host_gray``), FAST with the device detector's semantics
    (``_host_detect_frame``), the strongest ``max_keypoints``, their colours
    sampled at full resolution and the 1/d pooled gray plane the device
    describes from.

    Returns dict of numpy arrays: gray_small [C,H/d,W/d] u8, xy [C,K,2] f32
    (full-resolution coords), valid [C,K] bool, colors [C,K,3] u8, counts
    [C] i32 (post-NMS corner totals, the requiredExtractedPointsCount
    gate).  Only ``host_desc="same"``: "orb" and "hybrid" need OpenCV's
    ORB pattern, which is not in this repository."""
    if host_desc != "same":
        raise NotImplementedError(
            f"host_desc={host_desc!r} needs OpenCV's ORB pattern (its "
            "learned 256 test pairs), which is not in this repository")
    d = ingest_downscale
    C = len(frames)
    H, W = frames[0].shape[:2]
    K = max_keypoints
    gray_small = np.empty((C, H // d, W // d), np.uint8)
    xy = np.zeros((C, K, 2), np.float32)
    valid = np.zeros((C, K), bool)
    colors = np.zeros((C, K, 3), np.uint8)
    counts = np.zeros((C,), np.int32)
    for i, f in enumerate(frames):
        gray = host_gray(f)
        kxy, ixy, num = _host_detect_frame(gray, threshold)
        counts[i] = num
        n = min(len(kxy), K)
        if n:
            xy[i, :n] = kxy[:n]
            valid[i, :n] = True
            colors[i, :n] = f[ixy[:n, 1], ixy[:n, 0]]
        gray_small[i] = area_downscale(gray, d) if d > 1 else gray
    return {"gray_small": gray_small, "xy": xy, "valid": valid,
            "colors": colors, "counts": counts}


def describe_packed_batch(cfg: "FrontendConfig", gray_small: torch.Tensor,
                          xy: torch.Tensor, valid: torch.Tensor,
                          ingest_downscale: int = 2) -> torch.Tensor:
    """Device half of host ingest: [C,h,w] u8 pooled gray + full-resolution
    keypoints → descriptors [C,K,D] (dense maps at 1/(d·descriptor_
    downscale) of coordinate space, the same math as device ingest)."""
    gray = gray_small.to(torch.float32)
    out = []
    for g, kxy, kv in zip(gray, xy, valid):
        if cfg.descriptor == "orb":
            res = orb.describe(g, kxy, kv, pre_downscale=ingest_downscale)
        else:
            res = sift.describe(g, kxy, kv, downscale=cfg.descriptor_downscale,
                                pre_downscale=ingest_downscale,
                                nearest=cfg.sift_nearest)
        out.append(res["desc"])
    return torch.stack(out)


# --------------------------------------------------------- device ingest
def _describe(cfg: FrontendConfig, gray, xy, valid):
    if cfg.descriptor == "orb":
        return orb.describe(gray, xy, valid)
    return sift.describe(gray, xy, valid, downscale=cfg.descriptor_downscale,
                         nearest=cfg.sift_nearest)


def extract_and_describe_batch(cfg: FrontendConfig, rgb_batch: torch.Tensor):
    """[B,H,W,3] u8 RGB frames → batched keypoints, descriptors and colours
    (the float BT.601 gray of ``image.rgb_to_gray``, FAST, then SIFT or ORB
    per frame): dict xy [B,K,2], valid [B,K], score [B,K], desc [B,K,D],
    colors [B,K,3] u8, num_corners [B].  Everything stays on the frames'
    device."""
    gray = image.rgb_to_gray(rgb_batch)
    det = fast.detect_batch(gray, cfg.threshold, cfg.max_keypoints)
    desc = torch.stack([
        _describe(cfg, gray[i], det["xy"][i], det["valid"][i])["desc"]
        for i in range(gray.shape[0])])
    colors = torch.stack([
        image.extract_patch_colors(rgb_batch[i], det["xy"][i])
        for i in range(gray.shape[0])])
    return {
        "xy": det["xy"],
        "valid": det["valid"],
        "score": det["score"],
        "desc": desc,
        "colors": colors,
        "num_corners": det["num_corners"],
    }


def extract_and_describe(cfg: FrontendConfig, rgb: torch.Tensor):
    """One frame [H,W,3] u8 → keypoints + descriptors + colours (the
    batch version on one lane): xy [K,2], valid [K], score [K], desc
    [K,D], colors [K,3], num_corners."""
    res = extract_and_describe_batch(cfg, rgb[None])
    return {k: v[0] for k, v in res.items()}


def detect_only_batch(cfg: FrontendConfig, rgb_batch: torch.Tensor):
    """[B,H,W,3] → FAST corner counts and keypoints (the batch-fill gate,
    requiredExtractedPointsCount)."""
    return fast.detect_batch(image.rgb_to_gray(rgb_batch), cfg.threshold,
                             cfg.max_keypoints, True)


def extract_and_describe_gray_batch(cfg: FrontendConfig,
                                    gray_u8: torch.Tensor,
                                    rgb_small: torch.Tensor,
                                    color_downscale: int = 4):
    """[C,H,W] u8 gray + [C,h,w,3] u8 colour plane → batched keypoints,
    descriptors and colours: dict xy [C,K,2], valid [C,K], score [C,K],
    desc [C,K,128] f32 (SIFT) or [C,K,8] int32 bit words (ORB), colors
    [C,K,3] u8, num_corners [C]."""
    gray = gray_u8.to(torch.float32)
    det = fast.detect_batch(gray, cfg.threshold, cfg.max_keypoints)
    desc = torch.stack([
        _describe(cfg, gray[i], det["xy"][i], det["valid"][i])["desc"]
        for i in range(gray.shape[0])])
    colors = torch.stack([
        image.extract_patch_colors(rgb_small[i],
                                   det["xy"][i] / float(color_downscale))
        for i in range(gray.shape[0])])
    return {
        "xy": det["xy"],
        "valid": det["valid"],
        "score": det["score"],
        "desc": desc,
        "colors": colors,
        "num_corners": det["num_corners"],
    }


def match_against_batch(cfg: FrontendConfig, desc_prev, valid_prev,
                        desc_batch, valid_batch, frame_mask):
    """Previous frame vs all B candidates (2-NN + Lowe ratio): train_idx
    [B,K], is_match [B,K], num_matches [B]."""
    return knn.match_batch(desc_prev, valid_prev, desc_batch, valid_batch,
                           frame_mask, ratio=cfg.ratio, metric=cfg.metric)


def frontend_config_from(cfg) -> FrontendConfig:
    """Build from a full framework Config (config.py)."""
    return FrontendConfig(
        max_keypoints=cfg.tpu.max_keypoints,
        threshold=float(cfg.featureExtractingThreshold),
        descriptor=cfg.descriptor_kind,
        ratio=float(cfg.knnMatcherDistance),
        metric=cfg.match_metric,
        descriptor_downscale=cfg.tpu.descriptor_downscale,
        sift_nearest=cfg.tpu.sift_nearest_sampling,
    )
