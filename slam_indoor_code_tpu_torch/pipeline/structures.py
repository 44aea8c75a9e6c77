"""Pipeline data model (counterpart of the JAX package's
pipeline/structures.py, host numpy): fixed-capacity analogues of the
reference's structs (src/mainModule/cycleProcessing/mainCycleStructures.h).

``TemporalFrameData``  ↔ TemporalImageData (mainCycleStructures.h:38-45):
keypoints / colors / matches-to-previous / pose / correspondSpatialPointIdx,
but every vector is a fixed-capacity array + validity mask.

``MapArena`` ↔ GlobalData.spatialPoints/Colors (mainCycleStructures.h:49-54):
a preallocated [max_points,3] arena with a fill cursor, so device code sees a
static shape while the host owns the append cursor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TemporalFrameData:
    """Per-frame state for the sliding window (capacity K keypoint slots)."""

    xy: np.ndarray            # [K,2] float32 keypoint coords
    valid: np.ndarray         # [K] bool
    desc: np.ndarray          # [K,D] (a device tensor once filled: float32
                              # SIFT or int32 ORB bit words)
    colors: np.ndarray        # [K,3] uint8 pixel colors at keypoints
    # matches between frame i-1 and i: per-slot of frame i-1's keypoints
    match_train: np.ndarray   # [K] int32 — index into THIS frame's keypoints
    match_mask: np.ndarray    # [K] bool — query slot has a ratio-passing match
    rotation: np.ndarray      # [3,3] world→camera
    motion: np.ndarray        # [3] translation (X_c = R X_w + t)
    correspond: np.ndarray    # [K] int32 — global map point id per keypoint, -1 = none
    frame_id: int = -1        # source frame index (pairs cameras with ground
                              # truth; not in the JAX package's struct)

    @staticmethod
    def empty(k: int, desc_dim: int, desc_dtype=np.float32) -> "TemporalFrameData":
        return TemporalFrameData(
            xy=np.zeros((k, 2), np.float32),
            valid=np.zeros(k, bool),
            desc=np.zeros((k, desc_dim), desc_dtype),
            colors=np.zeros((k, 3), np.uint8),
            match_train=np.zeros(k, np.int32),
            match_mask=np.zeros(k, bool),
            rotation=np.eye(3, dtype=np.float64),
            motion=np.zeros(3, np.float64),
            correspond=np.full(k, -1, np.int32),
        )


@dataclass
class BatchElement:
    """One candidate frame staged for good-frame selection (reference:
    BatchElement, mainCycleStructures.h:59-64)."""

    frame: np.ndarray         # HxWx3 uint8 RGB
    xy: np.ndarray            # [K,2]
    valid: np.ndarray         # [K]
    score: np.ndarray         # [K]
    desc: np.ndarray | None = None   # descriptors (a device tensor)
    colors: np.ndarray | None = None
    frame_id: int = -1        # source frame index (port only)


class MapArena:
    """Global 3-D map with fixed capacity and host-owned append cursor."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.points = np.zeros((capacity, 3), np.float64)
        self.colors = np.zeros((capacity, 3), np.uint8)
        self.count = 0

    def append(self, pts: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Append n points; returns their global ids [n]."""
        n = len(pts)
        if self.count + n > self.capacity:
            raise RuntimeError(
                f"map arena overflow: {self.count}+{n} > {self.capacity} "
                "(raise tpu.max_map_points)"
            )
        ids = np.arange(self.count, self.count + n, dtype=np.int32)
        self.points[ids] = pts
        self.colors[ids] = cols
        self.count += n
        return ids

    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        return self.points[: self.count].copy(), self.colors[: self.count].copy()


def harvest_pnp_correspondences(
    prev_correspond: np.ndarray,
    match_train: np.ndarray,
    match_mask: np.ndarray,
    new_xy: np.ndarray,
    arena: MapArena,
):
    """3D↔2D correspondences for PnP: for every ratio-passing match whose
    previous-frame keypoint is bound to a map point, pair that 3-D point with
    the new frame's keypoint coords (reference:
    getOldSpatialPointsAndNewFrameFeatureCoords,
    mainCycleInternals.cpp:207-219).

    Returns (X [K,3], uv [K,2], mask [K]) in fixed-size match-slot layout."""
    struct_idx = np.where(match_mask, prev_correspond, -1)
    mask = struct_idx >= 0
    safe = np.where(mask, struct_idx, 0)
    X = arena.points[safe]
    uv = new_xy[np.where(mask, match_train, 0)]
    return (
        X.astype(np.float32),
        uv.astype(np.float32),
        mask,
    )


def push_new_spatial_points(
    new_frame_colors: np.ndarray,
    new_points: np.ndarray,
    arena: MapArena,
    prev_correspond: np.ndarray,
    match_train: np.ndarray,
    match_mask: np.ndarray,
    new_correspond: np.ndarray,
    new_point_ok: np.ndarray | None = None,
    propagate_ok: np.ndarray | None = None,
) -> int:
    """Merge per-match triangulated points into the map (reference:
    pushNewSpatialPoints, mainCycleInternals.cpp:222-246): a match whose
    previous keypoint has no bound map point creates a new landmark (colored
    by the new frame's pixel); otherwise the existing landmark id propagates
    to the new frame's keypoint.  Mutates ``prev_correspond`` and
    ``new_correspond`` in place; returns number of new landmarks.

    Quality gates beyond the reference (which pushes every match unfiltered —
    gross triangulation failures then poison PnP/BA): ``new_point_ok`` admits
    a new landmark only if its triangulation verified (chirality + bounded
    reprojection), ``propagate_ok`` re-verifies an existing binding before
    propagating it to the new frame."""
    q = np.arange(len(match_mask))
    is_new = match_mask & (prev_correspond < 0)
    is_old = match_mask & (prev_correspond >= 0)
    if new_point_ok is not None:
        is_new = is_new & new_point_ok
    if propagate_ok is not None:
        is_old = is_old & propagate_ok

    # propagate existing ids
    new_correspond[match_train[is_old]] = prev_correspond[is_old]

    # append new landmarks
    new_q = q[is_new]
    if len(new_q):
        train = match_train[new_q]
        ids = arena.append(new_points[new_q], new_frame_colors[train])
        prev_correspond[new_q] = ids
        new_correspond[train] = ids
    return len(new_q)
