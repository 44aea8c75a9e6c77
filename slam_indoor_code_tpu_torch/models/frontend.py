"""The feature frontend, device half: gray → FAST → SIFT or ORB → colours,
and the previous-frame-vs-batch 2-NN match (counterpart of the JAX package's
models/frontend.py).  The OpenCV host frontend (host ingest) is not part of
this port yet (ROADMAP)."""

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


def _describe(cfg: FrontendConfig, gray, xy, valid):
    if cfg.descriptor == "orb":
        return orb.describe(gray, xy, valid)
    return sift.describe(gray, xy, valid, downscale=cfg.descriptor_downscale,
                         nearest=cfg.sift_nearest)


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
