"""Synthetic-scene generator — the golden test oracle for the whole pipeline.

The reference had no tests and no ground truth (SURVEY.md §4); we build the
oracle the rebuild plan calls for: scenes with known K, known camera
trajectory, and known 3-D points, from which we derive (a) exact projected
correspondences for unit-testing geometry (essential / PnP / triangulation /
BA) and (b) rendered images with strong corner texture at the projected
locations for end-to-end pipeline tests and benchmarks.

Conventions (used across the framework):
  extrinsics (R_i, t_i):  X_cam = R_i @ X_world + t_i,   P_i = K [R_i | t_i]
  camera center:          C_i = -R_iᵀ t_i
poses.txt stores t_i, rotations.txt stores R_i — the same quantities the
reference writes (motion / rotation, mainCycle.cpp:101-104).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticScene:
    K: np.ndarray              # [3,3] intrinsics
    points: np.ndarray         # [N,3] world points
    colors: np.ndarray         # [N,3] uint8 per-point colors
    rotations: np.ndarray      # [F,3,3] world→camera
    translations: np.ndarray   # [F,3]
    image_size: tuple          # (H, W)

    def project(self, frame: int, noise: float = 0.0, rng=None) -> tuple[np.ndarray, np.ndarray]:
        """Project all points into frame ``frame``.

        Returns (uv [N,2], visible [N] bool).  Visibility = in front of the
        camera and inside the image bounds."""
        R, t = self.rotations[frame], self.translations[frame]
        Xc = self.points @ R.T + t
        z = Xc[:, 2]
        uvw = Xc @ self.K.T
        uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-12)
        H, W = self.image_size
        visible = (z > 0.1) & (uv[:, 0] >= 4) & (uv[:, 0] < W - 4) & (uv[:, 1] >= 4) & (uv[:, 1] < H - 4)
        if noise > 0:
            rng = rng or np.random.default_rng(0)
            uv = uv + rng.normal(0.0, noise, uv.shape)
        return uv, visible

    def centers(self) -> np.ndarray:
        return -np.einsum("fij,fj->fi", self.rotations.transpose(0, 2, 1), self.translations)

    def render(self, frame: int, rng_seed: int = 0) -> np.ndarray:
        """Render frame as HxWx3 uint8: per-point high-contrast square blobs
        on a mid-gray background.  Blob appearance is fixed per point, so the
        same landmark produces matchable descriptors across frames."""
        H, W = self.image_size
        rng = np.random.default_rng(rng_seed)
        # Stable per-point blob pattern: 7x7 binary texture scaled by color.
        if not hasattr(self, "_blob_cache"):
            n = len(self.points)
            self._blob_cache = rng.integers(0, 2, size=(n, 7, 7, 1)).astype(np.uint8)
        img = np.full((H, W, 3), 96, np.uint8)
        uv, vis = self.project(frame)
        order = np.argsort(-self.points[:, 2])  # far→near painter's order
        for i in order:
            if not vis[i]:
                continue
            u, v = int(round(uv[i, 0])), int(round(uv[i, 1]))
            blob = self._blob_cache[i] * self.colors[i][None, None, :]
            y0, y1 = max(0, v - 3), min(H, v + 4)
            x0, x1 = max(0, u - 3), min(W, u + 4)
            img[y0:y1, x0:x1] = blob[
                y0 - (v - 3) : 7 - ((v + 4) - y1), x0 - (u - 3) : 7 - ((u + 4) - x1)
            ]
        return img


def _lookat_rotation(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World→camera rotation for a camera at ``center`` looking at ``target``
    with +y-down image convention."""
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    # rows: camera x (right), y (down), z (forward)
    return np.stack([right, down, fwd])


def make_scene(
    n_points: int = 600,
    n_frames: int = 12,
    image_size: tuple = (480, 640),
    seed: int = 0,
    baseline: float = 0.12,
    kind: str = "arc",
) -> SyntheticScene:
    """Synthetic camera paths through a 3-D point cloud.

    ``kind='arc'``: camera slides sideways past a frontal cloud ~4–8 units
    away (good for short sequences; overlap decays at the ends).
    ``kind='hallway'``: camera walks forward through a corridor of points —
    constant overlap for arbitrarily long sequences, matching the reference's
    indoor hallway videos.  ``baseline`` is the inter-frame camera travel."""
    rng = np.random.default_rng(seed)
    H, W = image_size
    f = 0.9 * W
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]])

    rotations, translations = [], []
    if kind == "hallway":
        length = n_frames * baseline + 10.0
        # points on the corridor walls/floor/ceiling band, sparse in the middle
        side = rng.choice(4, n_points)
        u = rng.uniform(-0.4, 0.4, n_points)
        along = rng.uniform(1.0, length, n_points)
        x = np.where(side == 0, -2.5 + u, np.where(side == 1, 2.5 + u,
                     rng.uniform(-2.5, 2.5, n_points)))
        y = np.where(side == 2, -1.8 + u, np.where(side == 3, 1.8 + u,
                     rng.uniform(-1.8, 1.8, n_points)))
        points = np.stack([x, y, along], axis=1)
        for i in range(n_frames):
            center = np.array([0.05 * np.sin(0.3 * i), 0.03 * np.cos(0.4 * i),
                               i * baseline])
            target = center + np.array([0.0, 0.0, 5.0])
            R = _lookat_rotation(center, target)
            rotations.append(R)
            translations.append(-R @ center)
    else:
        points = np.stack(
            [
                rng.uniform(-3.0, 3.0, n_points),
                rng.uniform(-2.0, 2.0, n_points),
                rng.uniform(4.0, 8.0, n_points),
            ],
            axis=1,
        )
        for i in range(n_frames):
            center = np.array(
                [i * baseline - baseline * n_frames / 2, 0.02 * np.sin(i), 0.0])
            target = np.array([0.0, 0.0, 6.0])
            R = _lookat_rotation(center, target)
            rotations.append(R)
            translations.append(-R @ center)
    colors = rng.integers(140, 255, size=(n_points, 3)).astype(np.uint8)

    return SyntheticScene(
        K=K,
        points=points,
        colors=colors,
        rotations=np.stack(rotations),
        translations=np.stack(translations),
        image_size=image_size,
    )
