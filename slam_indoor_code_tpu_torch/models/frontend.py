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
``area_downscale`` cv2's INTER_AREA at an integer factor, and
``host_orb_bits`` ``cv2.ORB_create().compute`` (the host descriptor modes
"orb" and "hybrid", with OpenCV's pattern in ``ops/orb_pattern.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import fast, image, knn, orb, sift
from ..ops.orb_pattern import BIT_PATTERN_31


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


# ORB's border (edgeThreshold = patchSize = 31): compute() keeps a keypoint
# iff its rounded centre lies in [31, W-31) x [31, H-31)
_ORB_EDGE = 31


def _orb_gauss7() -> np.ndarray:
    """OpenCV's 7-tap Gaussian at σ = 2 as float32 (getGaussianKernel(7, 2,
    CV_32F)): exp(−x²/8) over x = −3..3, normalised in float64."""
    x = np.arange(7, dtype=np.float64) - 3.0
    t = np.exp(-0.125 * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


_ORB_GAUSS7 = _orb_gauss7()


def _orb_blur(gray: np.ndarray, strip: int = 32) -> np.ndarray:
    """ORB's 7×7 Gaussian (σ = 2, reflect-101 borders) of a u8 plane as
    OpenCV's separable float path computes it → [H,W] u8: the row pass
    sums k_i·p_i for i = 0..6 as a chain of float32 fused multiply-adds, the
    column pass starts from k_3·r_0 and adds k_j·(r_j + r_−j) for j = 1..3
    the same way, then rounds half to even.  A fused multiply-add rounds
    once: the product of a float32 pair and the float32 sum are exact in
    float64, so each step is computed there and rounded to float32.  (An
    exact float64 blur, or cv2.GaussianBlur on u8, each part from it at a
    few near-ties per hundred thousand keypoints.)  Runs in strips of
    ``strip`` rows, whose buffers stay in cache (2.5× faster at 4K)."""
    H, W = gray.shape
    k = _ORB_GAUSS7.astype(np.float64)
    p = np.pad(gray, 3, mode="reflect")          # numpy's reflect = 101
    out = np.empty((H, W), np.uint8)
    acc = np.empty((strip + 6, W), np.float64)
    r = np.empty((strip + 6, W), np.float32)
    c = np.empty((strip, W), np.float32)
    pair = np.empty((strip, W), np.float32)
    for y0 in range(0, H, strip):
        h = min(strip, H - y0)
        ps, a, rr = p[y0:y0 + h + 6], acc[:h + 6], r[:h + 6]
        np.multiply(ps[:, :W], k[0], out=a)
        rr[...] = a
        for i in range(1, 7):
            np.multiply(ps[:, i:i + W], k[i], out=a)
            a += rr
            rr[...] = a
        a, cc, pp = acc[:h], c[:h], pair[:h]
        np.multiply(rr[3:3 + h], k[3], out=a)
        cc[...] = a
        for j in range(1, 4):
            np.add(rr[3 + j:3 + j + h], rr[3 - j:3 - j + h], out=pp)
            np.multiply(pp, k[3 + j], out=a)
            a += cc
            cc[...] = a
        np.rint(cc, out=cc)
        out[y0:y0 + h] = cc
    return out


def _orb_offsets() -> tuple[np.ndarray, np.ndarray]:
    """The pattern's points rotated by the keypoints' angle → (dx, dy)
    [256,2] int64.  The JAX package hands ORB keypoints of angle −1, which
    compute() keeps: cos and sin of −1° in float32, x·cos − y·sin and
    x·sin + y·cos in float32, rounded half to even (every value lies at
    least 0.27 from a tie)."""
    ang = np.float32(-1.0) * np.float32(np.pi / 180.0)
    a, b = np.float32(np.cos(ang)), np.float32(np.sin(ang))
    px = BIT_PATTERN_31[..., 0].astype(np.float32)
    py = BIT_PATTERN_31[..., 1].astype(np.float32)
    dx = np.rint(px * a - py * b).astype(np.int64)
    dy = np.rint(px * b + py * a).astype(np.int64)
    return dx, dy


_ORB_DX, _ORB_DY = _orb_offsets()


def host_orb_bits(gray: np.ndarray, xy: np.ndarray, valid: np.ndarray,
                  max_keypoints: int) -> np.ndarray:
    """OpenCV's ORB descriptors of a full-resolution u8 gray frame [H,W] at
    keypoints xy [K,2] (valid [K]) → packed bits [max_keypoints, 32] u8,
    bit for bit ``cv2.ORB_create().compute`` on keypoints of size 31 and
    angle −1 (the JAX package's ``_host_orb_bits``).  Per kept keypoint:
    the blurred plane (``_orb_blur``) at its rounded centre plus each
    rotated pair's two points; bit k of byte i (LSB first) is set when the
    first point of pair 8i+k is darker.  ORB drops keypoints within 31 px
    of the border; those rows, and the invalid ones, stay zero."""
    K = max_keypoints
    out = np.zeros((K, 32), np.uint8)
    H, W = gray.shape
    xy = np.asarray(xy, np.float32)[:K]
    cx = np.rint(xy[:, 0]).astype(np.int64)
    cy = np.rint(xy[:, 1]).astype(np.int64)
    keep = (np.asarray(valid[:K], bool)
            & (cx >= _ORB_EDGE) & (cx < W - _ORB_EDGE)
            & (cy >= _ORB_EDGE) & (cy < H - _ORB_EDGE))
    rows = np.flatnonzero(keep)
    if not len(rows):
        return out
    blurred = _orb_blur(gray).ravel()
    centre = cy[rows] * W + cx[rows]
    v = blurred[centre[:, None, None] + (_ORB_DY * W + _ORB_DX)[None]]
    darker = (v[..., 0] < v[..., 1]).reshape(-1, 32, 8)  # [n,256,2] → bits
    out[rows] = np.packbits(darker, axis=-1, bitorder="little")[..., 0]
    return out


def host_detect_pack(frames, threshold: float, max_keypoints: int,
                     ingest_downscale: int = 2, host_desc: str = "same"):
    """Host-side ingest of a chunk of RGB u8 frames: per frame the gray
    plane (``host_gray``), FAST with the device detector's semantics
    (``_host_detect_frame``), the strongest ``max_keypoints``, their colours
    sampled at full resolution and the 1/d pooled gray plane the device
    describes from.

    ``host_desc`` adds full-resolution descriptor content the pooled gray
    cannot carry, as the JAX package's packer does:
      - "orb":    ORB bits per keypoint (``host_orb_bits``) and no gray
                  plane; the device matches them by Hamming.
      - "hybrid": the ORB bits beside the pooled gray; the device joins
                  pooled SIFT (128) and α·bits (256) into one L2
                  descriptor.
      - "same":   the pooled gray only.

    Returns dict of numpy arrays: gray_small [C,H/d,W/d] u8 (absent for
    "orb"), xy [C,K,2] f32 (full-resolution coords), valid [C,K] bool,
    colors [C,K,3] u8, counts [C] i32 (post-NMS corner totals, the
    requiredExtractedPointsCount gate), desc_bits [C,K,32] u8 (for "orb"
    and "hybrid")."""
    if host_desc not in ("same", "orb", "hybrid"):
        raise ValueError(f"unknown host descriptor {host_desc!r}")
    d = ingest_downscale
    C = len(frames)
    H, W = frames[0].shape[:2]
    K = max_keypoints
    want_gray = host_desc != "orb"
    gray_small = (np.empty((C, H // d, W // d), np.uint8) if want_gray
                  else None)
    xy = np.zeros((C, K, 2), np.float32)
    valid = np.zeros((C, K), bool)
    colors = np.zeros((C, K, 3), np.uint8)
    counts = np.zeros((C,), np.int32)
    bits = (np.zeros((C, K, 32), np.uint8) if host_desc != "same"
            else None)
    for i, f in enumerate(frames):
        gray = host_gray(f)
        kxy, ixy, num = _host_detect_frame(gray, threshold)
        counts[i] = num
        n = min(len(kxy), K)
        if n:
            xy[i, :n] = kxy[:n]
            valid[i, :n] = True
            colors[i, :n] = f[ixy[:n, 1], ixy[:n, 0]]
        if bits is not None:
            bits[i] = host_orb_bits(gray, xy[i], valid[i], K)
        if want_gray:
            gray_small[i] = area_downscale(gray, d) if d > 1 else gray
    out = {"xy": xy, "valid": valid, "colors": colors, "counts": counts}
    if want_gray:
        out["gray_small"] = gray_small
    if bits is not None:
        out["desc_bits"] = bits
    return out


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
