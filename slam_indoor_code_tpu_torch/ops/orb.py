"""Oriented-BRIEF (ORB-style) binary descriptors (counterpart of the JAX
package's ops/orb.py, which documents the design and the reference
citations): intensity-centroid orientation from two dense separable moment
maps read back with one two-channel gather per keypoint, then 256 BRIEF
point pairs nearest-sampled from the blurred image.

The sampling pattern is the JAX package's seeded numpy draw, so a bit means
the same pair in both packages.  The 256 bits are packed into 8 words held
as an int32 view of the JAX package's uint32 words (torch has no uint32
shifts); ``knn`` and the kernels read them as such.
"""

from __future__ import annotations

import numpy as np
import torch

from .image import gaussian_blur, nearest_sample, sample_maps, separable_conv

PATCH_RADIUS = 15          # ORB patch 31×31
N_BITS = 256
N_WORDS = N_BITS // 32


def _brief_pattern(seed: int = 7) -> np.ndarray:
    """[256,2,2] (pair, endpoint, xy) Gaussian BRIEF pattern, σ = patch/5,
    clipped to the patch (the JAX package's draw)."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    return np.clip(pts, -PATCH_RADIUS + 1, PATCH_RADIUS - 1).astype(np.float32)


_PATTERN = _brief_pattern()
_RAMP = np.arange(-PATCH_RADIUS, PATCH_RADIUS + 1, dtype=np.float32)
_ONES = np.ones(2 * PATCH_RADIUS + 1, dtype=np.float32)


def orientation_maps(gray_blur: torch.Tensor) -> torch.Tensor:
    """Dense centroid moments over a (2r+1)² square window: [H,W] → [H,W,2]
    (m10, m01)."""
    m10 = separable_conv(gray_blur, _RAMP, _ONES)
    m01 = separable_conv(gray_blur, _ONES, _RAMP)
    return torch.stack([m10, m01], dim=-1)


def orientations(gray_blur: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Keypoint orientations θ = atan2(m01, m10) via the dense moment maps."""
    m = sample_maps(orientation_maps(gray_blur), xy)   # [K,2]
    return torch.atan2(m[:, 1], m[:, 0])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K,256] bool → [K,8] int32 (little-endian bit order per word; the
    int32 view of the JAX package's uint32 words).  The sum runs in int64,
    so bit 31 is folded back to its two's-complement value."""
    K = bits.shape[0]
    b = bits.reshape(K, N_WORDS, 32).long()
    shifts = torch.arange(32, dtype=torch.long, device=bits.device)
    words = (b << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def describe(gray: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
             pre_downscale: int = 1):
    """ORB descriptors for K keypoints of one [H,W] frame.

    ``pre_downscale`` declares that ``gray`` is at 1/p of the coordinate
    resolution of ``xy``; the pattern and orientation sampling scale
    accordingly.

    Returns dict: desc [K,8] int32 packed bits, angle [K] float32 radians,
    valid [K] bool (propagated)."""
    cs = 1.0 / pre_downscale
    blur = gaussian_blur(gray, sigma=2.0, radius=4)
    theta = orientations(blur, xy * cs)
    c, s = torch.cos(theta), torch.sin(theta)
    pat = torch.from_numpy(_PATTERN).to(gray.device)   # [256,2,2]
    px, py = pat[..., 0], pat[..., 1]                  # [256,2]
    rx = c[:, None, None] * px[None] - s[:, None, None] * py[None]
    ry = s[:, None, None] * px[None] + c[:, None, None] * py[None]
    coords = (torch.stack([rx, ry], dim=-1) + xy[:, None, None, :]) * cs
    vals = nearest_sample(blur, coords)                # [K,256,2]
    desc = pack_bits(vals[..., 0] < vals[..., 1])
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))
    return {"desc": desc, "angle": theta, "valid": valid}


def describe_batch(gray: torch.Tensor, xy: torch.Tensor,
                   valid: torch.Tensor):
    """[B,H,W] × [B,K,2] × [B,K] → batched descriptors (``describe`` per
    frame, stacked; the JAX package vmaps it)."""
    outs = [describe(gray[i], xy[i], valid[i]) for i in range(gray.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
