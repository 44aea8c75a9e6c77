"""Surfacing subsystem (a copy of the JAX package's viz/mesh.py, numpy and
scipy's Delaunay where present): point clustering → per-cluster best-fit plane →
Delaunay mesh with long-edge culling.

Reference counterpart: src/vizualization/delauney-triangulation/ —
``clusterizePoints`` builds a dense N×N weighted graph (euclid·w₁ + color·w₂
< max ⇒ edge) with an OpenMP-parallel fill and DFS connected components
(geomAdditionalFunc.cpp:105-163); ``getBestFittingPlaneByPoints`` fits a
plane by SVD of the centered 3×N (bestFittingPlane.cpp:11-40); ``makeMesh``
projects each cluster to its plane, Delaunay-triangulates (hand-rolled
Bowyer–Watson or cv::Subdiv2D) and culls long edges (bestFittingPlane.cpp:
42-127, bowyerWatson.cpp:9-85).

Rebuild: the O(N²) graph is one pairwise-distance einsum (the OpenMP pragma
dissolves into vectorization — SURVEY.md §2 item 3); components come from a
union-find on the edge list; Delaunay uses scipy.spatial (with a pure-numpy
Bowyer–Watson fallback that also serves as the reference algorithm)."""

from __future__ import annotations

import numpy as np


def pairwise_weighted_distance(
    points: np.ndarray,
    colors: np.ndarray,
    euclid_weight: float,
    color_weight: float,
) -> np.ndarray:
    """[N,3]×[N,3] → [N,N] combined distance: ‖Δx‖·w₁ + ‖Δc‖·w₂
    (geomAdditionalFunc.cpp:118-136's edge weight, computed densely)."""
    p = np.asarray(points, np.float64)
    c = np.asarray(colors, np.float64)
    d_e = np.sqrt(np.maximum(
        (p**2).sum(1)[:, None] + (p**2).sum(1)[None] - 2 * p @ p.T, 0.0))
    d_c = np.sqrt(np.maximum(
        (c**2).sum(1)[:, None] + (c**2).sum(1)[None] - 2 * c @ c.T, 0.0))
    return d_e * euclid_weight + d_c * color_weight


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def clusterize_points(
    points: np.ndarray,
    colors: np.ndarray,
    max_distance: float,
    euclid_weight: float = 1.0,
    color_weight: float = 1.0,
) -> list[np.ndarray]:
    """Connected components of the thresholded weighted-distance graph
    (clusterizePoints + findComps/dfs, geomAdditionalFunc.cpp:105-163).
    Returns a list of index arrays, largest first."""
    n = len(points)
    if n == 0:
        return []
    D = pairwise_weighted_distance(points, colors, euclid_weight, color_weight)
    ii, jj = np.nonzero(np.triu(D < max_distance, k=1))
    uf = _UnionFind(n)
    for a, b in zip(ii, jj):
        uf.union(int(a), int(b))
    roots = np.array([uf.find(i) for i in range(n)])
    comps = [np.flatnonzero(roots == r) for r in np.unique(roots)]
    comps.sort(key=len, reverse=True)
    return comps


def best_fitting_plane(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Least-squares plane through a point set via SVD of the centered cloud
    (getBestFittingPlaneByPoints, bestFittingPlane.cpp:11-40).

    Returns (centroid [3], normal [3], unit length)."""
    p = np.asarray(points, np.float64)
    centroid = p.mean(axis=0)
    _, _, Vt = np.linalg.svd(p - centroid, full_matrices=False)
    return centroid, Vt[2]


def project_to_plane(points: np.ndarray, centroid: np.ndarray, normal: np.ndarray):
    """Project points onto the plane and express them in an in-plane 2-D
    basis.  Returns (uv [N,2], basis (e1, e2))."""
    n = normal / np.linalg.norm(normal)
    seed = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    e1 = np.cross(n, seed)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    rel = points - centroid
    rel_in_plane = rel - np.outer(rel @ n, n)
    return np.stack([rel_in_plane @ e1, rel_in_plane @ e2], axis=1), (e1, e2)


def delaunay_bowyer_watson(uv: np.ndarray) -> np.ndarray:
    """Pure-numpy Bowyer–Watson Delaunay triangulation → [T,3] index triples
    (the reference's hand-rolled variant, bowyerWatson.cpp:9-85)."""
    pts = np.asarray(uv, np.float64)
    n = len(pts)
    if n < 3:
        return np.zeros((0, 3), np.int64)
    # Super-triangle far outside the cloud: with a near cloud a hull-triangle
    # circumcircle can reach a super vertex and get wrongly culled; 1000×span
    # keeps hull coverage exact while float64 still resolves circumcenters.
    mn, mx = pts.min(0), pts.max(0)
    span = max(float((mx - mn).max()), 1e-9)
    mid = (mn + mx) / 2
    sup = np.array([
        [mid[0] - 1000 * span, mid[1] - span],
        [mid[0] + 1000 * span, mid[1] - span],
        [mid[0], mid[1] + 1000 * span],
    ])
    P = np.vstack([pts, sup])
    tris: list[tuple[int, int, int]] = [(n, n + 1, n + 2)]

    def circumcircle(t):
        a, b, c = P[t[0]], P[t[1]], P[t[2]]
        d = 2 * (a[0] * (b[1] - c[1]) + b[0] * (c[1] - a[1]) + c[0] * (a[1] - b[1]))
        if abs(d) < 1e-12:
            return np.array([np.inf, np.inf]), np.inf
        ux = ((a @ a) * (b[1] - c[1]) + (b @ b) * (c[1] - a[1]) + (c @ c) * (a[1] - b[1])) / d
        uy = ((a @ a) * (c[0] - b[0]) + (b @ b) * (a[0] - c[0]) + (c @ c) * (b[0] - a[0])) / d
        center = np.array([ux, uy])
        return center, np.linalg.norm(a - center)

    for i in range(n):
        bad, polygon = [], []
        for t in tris:
            center, r = circumcircle(t)
            if np.linalg.norm(P[i] - center) < r:
                bad.append(t)
                polygon.extend([(t[0], t[1]), (t[1], t[2]), (t[2], t[0])])
        for t in bad:
            tris.remove(t)
        # boundary edges appear exactly once
        edges = {}
        for e in polygon:
            key = tuple(sorted(e))
            edges[key] = edges.get(key, 0) + 1
        for (a, b), cnt in edges.items():
            if cnt == 1:
                tris.append((a, b, i))
    out = [t for t in tris if max(t) < n]
    return np.asarray(out, np.int64).reshape(-1, 3)


def delaunay(uv: np.ndarray) -> np.ndarray:
    """scipy's Qhull Delaunay (the ``builtInTriangulation`` analogue,
    bowyerWatson.cpp:86-105) with Bowyer–Watson fallback."""
    if len(uv) < 3:
        return np.zeros((0, 3), np.int64)
    try:
        from scipy.spatial import Delaunay as _D

        return _D(np.asarray(uv, np.float64)).simplices.astype(np.int64)
    except Exception:
        return delaunay_bowyer_watson(uv)


def make_mesh(
    points: np.ndarray,
    max_edge: float | None = None,
) -> np.ndarray:
    """Cluster → plane → Delaunay → cull triangles with edges above
    ``max_edge`` (makeMesh, bestFittingPlane.cpp:42-127).  Returns [T,3]
    triangle indices into ``points``."""
    if len(points) < 3:
        return np.zeros((0, 3), np.int64)
    centroid, normal = best_fitting_plane(points)
    uv, _ = project_to_plane(np.asarray(points, np.float64), centroid, normal)
    tris = delaunay(uv)
    if max_edge is not None and len(tris):
        p = np.asarray(points, np.float64)
        e0 = np.linalg.norm(p[tris[:, 0]] - p[tris[:, 1]], axis=1)
        e1 = np.linalg.norm(p[tris[:, 1]] - p[tris[:, 2]], axis=1)
        e2 = np.linalg.norm(p[tris[:, 2]] - p[tris[:, 0]], axis=1)
        keep = (e0 < max_edge) & (e1 < max_edge) & (e2 < max_edge)
        tris = tris[keep]
    return tris


def build_scene_meshes(
    points: np.ndarray,
    colors: np.ndarray,
    max_distance: float,
    euclid_weight: float,
    color_weight: float,
    min_cluster_points: int,
    max_edge: float | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Full surfacing path of ``vizualizePointsAndCameras``
    (vizualizationModule.cpp:61-134): cluster, then mesh every cluster with
    ≥ TriangleMinimumPoints members.  Returns [(indices, triangles), ...]."""
    out = []
    for comp in clusterize_points(points, colors, max_distance,
                                  euclid_weight, color_weight):
        if len(comp) < min_cluster_points:
            continue
        tris = make_mesh(points[comp], max_edge=max_edge)
        if len(tris):
            out.append((comp, tris))
    return out
