"""Batched multiview geometry (counterpart of the JAX package's geometry/):
fixed-shape, mask-aware, float32 tensor functions."""

from .essential import estimate_transformation, find_essential_ransac, recover_pose
from .pnp import solve_pnp_ransac
from .projection import (
    camera_depths,
    denormalize,
    homogeneous,
    normalize_pixels,
    project,
    projection_matrix,
    undistort_points,
)
from .rotations import matrix_to_rodrigues, project_to_so3, rodrigues_to_matrix, skew
from .triangulate import reconstruct, triangulate_dlt


def compose_with_world(R_w, t_w, R_rel, t_rel):
    """Chain a relative pose (X_c2 = R_rel X_c1 + t_rel) onto world→camera
    extrinsics of frame 1: R_2 = R_rel R_1, t_2 = R_rel t_1 + t_rel."""
    return R_rel @ R_w, R_rel @ t_w + t_rel


__all__ = [
    "camera_depths",
    "compose_with_world",
    "denormalize",
    "estimate_transformation",
    "find_essential_ransac",
    "homogeneous",
    "matrix_to_rodrigues",
    "normalize_pixels",
    "project",
    "project_to_so3",
    "projection_matrix",
    "reconstruct",
    "recover_pose",
    "rodrigues_to_matrix",
    "skew",
    "solve_pnp_ransac",
    "triangulate_dlt",
    "undistort_points",
]
