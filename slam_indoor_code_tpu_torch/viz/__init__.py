"""Visualization + surfacing (host-side numpy; a copy of the JAX package's
viz/, which imports no JAX)."""

from .mesh import (
    best_fitting_plane,
    build_scene_meshes,
    clusterize_points,
    delaunay,
    delaunay_bowyer_watson,
    make_mesh,
)
from .pointcloud import (export_mesh_ply, export_ply, render_png,
                         visualize_global_data)

__all__ = [
    "export_mesh_ply",
    "best_fitting_plane",
    "build_scene_meshes",
    "clusterize_points",
    "delaunay",
    "delaunay_bowyer_watson",
    "export_ply",
    "make_mesh",
    "render_png",
    "visualize_global_data",
]
