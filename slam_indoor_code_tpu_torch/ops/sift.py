"""SIFT-style 128-float descriptors at FAST keypoints, dense-first
(counterpart of the JAX package's ops/sift.py): gradients → 8 soft-binned
orientation-energy maps → Gaussian pooling, then each keypoint reads 8
channels at itself (orientation) and at 16 rotated cell centres (the 4×4×8
descriptor), L2-normalised with the 0.2 clip.  Bit-compatibility with OpenCV
SIFT is not a goal; parity with the JAX package is."""

from __future__ import annotations

import math

import numpy as np
import torch

from .image import (gaussian_blur, sample_maps, sample_maps_bilinear,
                    sobel_gradients)

DESC_DIM = 128
GRID = 4
ORI_BINS = 8
CELL_SPACING = 4.0
POOL_SIGMA = 2.5


def _cell_offsets() -> np.ndarray:
    half = (GRID - 1) / 2.0
    ys, xs = np.mgrid[0:GRID, 0:GRID].astype(np.float32)
    xs = (xs - half) * CELL_SPACING
    ys = (ys - half) * CELL_SPACING
    return np.stack([xs.ravel(), ys.ravel()], axis=-1)


_OFFSETS = _cell_offsets()


def orientation_energy_maps(gray: torch.Tensor, blur_sigma: float = 1.6,
                            blur_radius: int = 4,
                            pool_sigma: float = POOL_SIGMA,
                            pool_radius: int = 5) -> torch.Tensor:
    """[H,W] → pooled orientation-energy stack [H,W,8]."""
    blur = gaussian_blur(gray, sigma=blur_sigma, radius=blur_radius)
    dx, dy = sobel_gradients(blur)
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    bin_f = (ang / (2.0 * math.pi) + 0.5) * ORI_BINS
    b0 = torch.floor(bin_f)
    frac = bin_f - b0
    b0 = b0.to(torch.int32) % ORI_BINS
    b1 = (b0 + 1) % ORI_BINS
    o = torch.arange(ORI_BINS, dtype=torch.int32, device=gray.device)
    maps = mag[..., None] * (
        (b0[..., None] == o) * (1.0 - frac[..., None])
        + (b1[..., None] == o) * frac[..., None])
    pooled = gaussian_blur(torch.movedim(maps, -1, 0), sigma=pool_sigma,
                           radius=pool_radius)
    return torch.movedim(pooled, 0, -1)


def _dominant_orientation(hist: torch.Tensor) -> torch.Tensor:
    """[K,8] pooled energies → angle [K] (parabolic refine of the argmax)."""
    b = torch.argmax(hist, dim=-1)
    rows = torch.arange(hist.shape[0], device=hist.device)
    h0 = hist[rows, (b - 1) % ORI_BINS]
    h1 = hist[rows, b]
    h2 = hist[rows, (b + 1) % ORI_BINS]
    denom = h0 - 2.0 * h1 + h2
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (h0 - h2) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    bin_center = b.to(torch.float32) + delta
    return (bin_center / ORI_BINS) * 2.0 * math.pi - math.pi


def describe(gray: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
             downscale: int = 1, pre_downscale: int = 1,
             nearest: str = "auto"):
    """SIFT descriptors for K keypoints of one [H,W] frame.

    Same contract as the JAX ``describe``: maps at 1/(downscale ·
    pre_downscale) of coordinate space; ``nearest`` "on"/"off"/"auto"
    (auto = nearest only at K >= 4096 with maps at >= 1/4 of coordinate
    space).  Returns dict: desc [K,128] f32, angle [K], valid [K]."""
    m = downscale * pre_downscale
    blur_sigma = max(1.6 / m, 0.6)
    pool_sigma = max(POOL_SIGMA / m, 1.0)
    blur_radius = max(int(np.ceil(2.5 * blur_sigma)), 2)
    pool_radius = max(int(np.ceil(2.0 * pool_sigma)), 2)
    if downscale > 1:
        d = downscale
        H, W = gray.shape
        Hc, Wc = (H // d) * d, (W // d) * d
        small = gray[:Hc, :Wc].reshape(Hc // d, d, Wc // d, d).mean((1, 3))
        pooled = orientation_energy_maps(small, blur_sigma, blur_radius,
                                         pool_sigma, pool_radius)
        scale = 1.0 / m
    else:
        pooled = orientation_energy_maps(gray, blur_sigma, blur_radius,
                                         pool_sigma, pool_radius)
        scale = 1.0 / pre_downscale

    h_kp = sample_maps(pooled, xy * scale)
    theta = _dominant_orientation(h_kp)
    c, s = torch.cos(theta), torch.sin(theta)

    offs = torch.as_tensor(_OFFSETS, device=xy.device)
    rx = c[:, None] * offs[None, :, 0] - s[:, None] * offs[None, :, 1]
    ry = s[:, None] * offs[None, :, 0] + c[:, None] * offs[None, :, 1]
    coords = (torch.stack([rx, ry], dim=-1) + xy[:, None, :]) * scale
    use_nearest = (nearest == "on" or
                   (nearest == "auto" and xy.shape[0] >= 4096 and m >= 4))
    if use_nearest:
        samples = sample_maps(pooled, coords)
    else:
        samples = sample_maps_bilinear(pooled, coords)

    # rotate the orientation bins by theta (circular linear interpolation)
    # as a per-keypoint 8×8 one-hot rotation matrix
    shift_f = (theta / (2.0 * math.pi) + 0.5) * ORI_BINS
    s0 = torch.floor(shift_f)
    frac = (shift_f - s0)[:, None, None]
    s0 = s0.to(torch.int32)
    o = torch.arange(ORI_BINS, dtype=torch.int32, device=xy.device)
    src0 = (o[None, :, None] + s0[:, None, None]) % ORI_BINS
    hit0 = (src0 == o[None, None, :]).to(samples.dtype)
    src1 = (src0 + 1) % ORI_BINS
    hit1 = (src1 == o[None, None, :]).to(samples.dtype)
    R = hit0 * (1.0 - frac) + hit1 * frac
    rotated = torch.einsum("kcj,kij->kci", samples, R)

    desc = rotated.reshape(-1, DESC_DIM)
    norm = torch.clamp_min(torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-6)
    desc = torch.clamp(desc / norm, 0.0, 0.2)
    norm = torch.clamp_min(torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-6)
    desc = desc / norm
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))
    return {"desc": desc, "angle": theta, "valid": valid}
