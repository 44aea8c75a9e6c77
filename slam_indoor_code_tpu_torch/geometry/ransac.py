"""RANSAC fan-out sizing from the configured success probability.

The reference passes ``RPRANSACProb`` to ``cv::findEssentialMat``
(cameraTranslation.cpp:38-52), whose adaptive loop keeps drawing minimal
samples until P(at least one all-inlier sample) ≥ prob.  Data-dependent trip
counts don't fit XLA's static-shape model, so the TPU rebuild evaluates a
FIXED hypothesis fan-out in one batched program (essential.py / pnp.py) —
this module sizes that fan-out to the same statistical bound:

    S = ceil( log(1 − prob) / log(1 − w^n) )

with a conservative inlier-rate floor ``w`` (the adaptive loop would re-raise
w from data; a fixed plan must assume the worst case it wants to survive).
"""

from __future__ import annotations

import math


def ransac_fanout(prob: float, sample_size: int, cap: int,
                  inlier_floor: float = 0.5, floor: int = 64) -> int:
    """Hypothesis count meeting the ``prob`` success bound at the assumed
    worst-case inlier rate, rounded up to a multiple of 64 (lane-friendly
    batch dim), floored at ``floor`` and capped at ``cap`` (the configured
    ``tpu.ransac_iters`` compute budget)."""
    p = min(max(float(prob), 0.5), 1.0 - 1e-12)
    w_n = float(inlier_floor) ** int(sample_size)
    s = math.log1p(-p) / math.log1p(-w_n)
    s = int(math.ceil(s / 64.0)) * 64
    return max(int(floor), min(int(cap), s))


def sample_indices(mask, shape: tuple, gen=None):
    """Minimal-sample indices [S,k] drawn with replacement, uniformly over
    the True slots of ``mask`` [N] — the counterpart of the JAX package's
    ``jax.random.choice(key, N, (S,k), p=mask/Σmask)`` (inverse-CDF draw,
    no host sync).  The two generators give different numbers from one
    seed, so parity tests draw ``idx`` once and hand it to both packages.
    With no True slot the draw is meaningless and lands on slot N-1."""
    import torch

    w = mask.to(torch.float32)
    cdf = torch.cumsum(w, 0)
    u = torch.rand(shape, generator=gen, device=mask.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u.reshape(-1), right=True).reshape(shape)
    return idx.clamp_(max=mask.shape[0] - 1)
