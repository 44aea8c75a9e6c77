"""2-NN descriptor matching with the Lowe ratio test (counterpart of the JAX
package's ops/knn.py).

Dispatch mirrors ``_pallas_enabled`` by device: a CPU tensor takes the
float32 dense branch (the counterpart of JAX on the CPU), a CUDA tensor the
hand-written kernel (ops/cuda_kernels.py) for L2 and Hamming.  L1's kernel
(the per-pair TPU kernel ``top2_pallas``/``_l1_kernel``) is not ported yet,
so L1 on CUDA raises.

Metrics: 'l2' (squared; compare ratio²), 'l1', 'hamming' (packed bit words
held as an int32 view — torch has no uint32 ``>>`` on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_kernels import BIG, top2_batch, unpack_bits


def l2_distance_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[...,N,D] × [...,M,D] → [...,N,M] squared L2 via the matmul identity."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    ab = a @ b.transpose(-1, -2)
    return torch.clamp_min(a2 + b2.transpose(-1, -2) - 2.0 * ab, 0.0)


def l1_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,D] × [M,D] → [N,M] L1, tiled over queries so the peak intermediate
    is [TILE,M,D]."""
    TILE = 128
    out = [(a[i:i + TILE, None, :] - b[None, :, :]).abs().sum(-1)
           for i in range(0, a.shape[0], TILE)]
    if not out:
        return a.new_zeros((0, b.shape[0]))
    return torch.cat(out)


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Packed-bit Hamming: [...,N,W] int32 × [...,M,W] int32 → [...,N,M]
    float32.  popcount(x ^ y) = |x| + |y| − 2 x·y on the unpacked bits, which
    is exact in float32 for 256 bits."""
    ab = unpack_bits(a).float()
    bb = unpack_bits(b).float()
    na = ab.sum(-1, keepdim=True)
    nb = bb.sum(-1, keepdim=True)
    return na + nb.transpose(-1, -2) - 2.0 * (ab @ bb.transpose(-1, -2))


def distance_matrix(a, b, metric: str) -> torch.Tensor:
    if metric == "l2":
        return l2_distance_sq(a, b)
    if metric == "l1":
        return l1_distance(a, b)
    if metric == "hamming":
        return hamming_distance(a, b)
    raise ValueError(f"unknown metric {metric!r}")


def _top2(d: torch.Tensor):
    """Row-wise two smallest over the last axis → (d1, idx1, d2); the first
    index wins a tie, and d2 masks only the argmin column."""
    idx1 = torch.argmin(d, dim=-1)
    d1 = torch.gather(d, -1, idx1[..., None])[..., 0]
    d2 = d.scatter(-1, idx1[..., None], BIG).amin(-1)
    return d1, idx1, d2


def _ratio_mask(d1, d2, ratio: float, metric: str) -> torch.Tensor:
    # the JAX code squares the ratio in float32 (a traced f32 scalar)
    r = float(np.float32(ratio))
    if metric == "l2":
        r = float(np.float32(r) * np.float32(r))
    return d1 < r * d2


def match_pair(desc_a, valid_a, desc_b, valid_b, ratio: float = 0.7,
               metric: str = "l2"):
    """2-NN + ratio match of frame A against frame B (``match_batch`` on
    one candidate frame).

    Returns dict: train_idx [N] int64, is_match [N] bool, distance [N],
    num_matches."""
    res = match_batch(desc_a, valid_a, desc_b[None], valid_b[None],
                      torch.ones(1, dtype=torch.bool, device=desc_a.device),
                      ratio, metric)
    return {k: v[0] for k, v in res.items()}


def match_batch(desc_prev, valid_prev, desc_batch, valid_batch, frame_mask,
                ratio: float = 0.7, metric: str = "l2"):
    """Match the previous frame [N,D] against B candidate frames [B,M,D].

    Returns dict with a leading B axis: train_idx [B,N] int64,
    is_match [B,N], distance [B,N], num_matches [B]."""
    if desc_prev.device.type == "cuda":
        if metric == "l1":
            raise NotImplementedError(
                "L1 matching on CUDA needs the per-pair top-2 kernel "
                "(ROADMAP queue 2: top2_pallas/_l1_kernel)")
        d1, idx1, d2 = top2_batch(desc_prev, desc_batch, valid_batch, metric)
    else:
        if metric == "l1":
            d = torch.stack([l1_distance(desc_prev, db) for db in desc_batch])
        else:
            d = distance_matrix(desc_prev[None], desc_batch, metric)
        d = torch.where(valid_batch[:, None, :], d, torch.full_like(d, BIG))
        d1, idx1, d2 = _top2(d)
    is_match = (_ratio_mask(d1, d2, ratio, metric) & valid_prev[None, :]
                & (d1 < BIG / 2) & frame_mask[:, None])
    return {
        "train_idx": idx1.long(),
        "is_match": is_match,
        "distance": d1,
        "num_matches": is_match.sum(-1),
    }
