"""The port's viz/ (numpy, scipy's Delaunay) against the JAX package's, on
the same inputs: twins of tests/test_viz.py that require the same clusters,
planes, triangles, PLY bytes, render and fly-cam moves as the JAX
package gives."""

import numpy as np
import pytest

import slam_indoor_code_tpu.viz as jviz
import slam_indoor_code_tpu_torch.viz as tviz
from slam_indoor_code_tpu.viz import pointcloud as jpc
from slam_indoor_code_tpu_torch.viz import pointcloud as tpc


def _same_components(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_clusterize_two_blobs(rng):
    a = rng.normal(0, 0.1, (40, 3))
    b = rng.normal(0, 0.1, (30, 3)) + np.array([10.0, 0, 0])
    pts = np.vstack([a, b])
    cols = np.zeros((70, 3))
    comps = tviz.clusterize_points(pts, cols, max_distance=1.0)
    assert sorted(map(len, comps), reverse=True) == [40, 30]
    _same_components(comps, jviz.clusterize_points(pts, cols, 1.0))


def test_clusterize_color_weight_splits(rng):
    pts = rng.normal(0, 0.05, (40, 3))
    cols = np.zeros((40, 3))
    cols[20:] = 200.0
    kw = dict(max_distance=1.0, euclid_weight=1.0, color_weight=1.0)
    comps = tviz.clusterize_points(pts, cols, **kw)
    assert len(comps) == 2
    _same_components(comps, jviz.clusterize_points(pts, cols, **kw))


def test_best_fitting_plane(rng):
    normal = np.array([1.0, 2.0, -1.0])
    normal /= np.linalg.norm(normal)
    e1 = np.cross(normal, [0, 0, 1.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(normal, e1)
    pts = np.array([3.0, -1.0, 2.0]) + rng.normal(0, 1, (100, 2)) @ np.stack(
        [e1, e2])
    pts += rng.normal(0, 0.001, pts.shape)
    c, n = tviz.best_fitting_plane(pts)
    assert abs(abs(n @ normal) - 1.0) < 1e-4
    jc, jn = jviz.best_fitting_plane(pts)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(n, jn)


@pytest.mark.parametrize("fn", ["delaunay", "delaunay_bowyer_watson"])
def test_delaunay_equals_jax(fn):
    uv = np.random.default_rng(123).uniform(0, 1, (25, 2))
    got = getattr(tviz, fn)(uv)
    assert len(got) > 20
    np.testing.assert_array_equal(got, getattr(jviz, fn)(uv))


def test_make_mesh_edge_culling(rng):
    pts = np.concatenate([rng.uniform(0, 1, (30, 2)),
                          np.array([[100.0, 100.0]])])
    pts3 = np.concatenate([pts, np.zeros((31, 1))], axis=1)
    tris_all = tviz.make_mesh(pts3)
    tris_culled = tviz.make_mesh(pts3, max_edge=5.0)
    assert len(tris_culled) < len(tris_all)
    assert not (tris_culled == 30).any()
    np.testing.assert_array_equal(tris_all, jviz.make_mesh(pts3))
    np.testing.assert_array_equal(tris_culled,
                                  jviz.make_mesh(pts3, max_edge=5.0))


def test_build_scene_meshes_and_mesh_ply_bytes(tmp_path, rng):
    uv = rng.uniform(0, 2.0, (80, 2))
    pts = np.concatenate([uv, 0.01 * rng.normal(size=(80, 1))], axis=1)
    cols = np.full((80, 3), 90.0)
    kw = dict(max_distance=5.0, euclid_weight=1.0, color_weight=0.01,
              min_cluster_points=10)
    got = tviz.build_scene_meshes(pts, cols, **kw)
    want = jviz.build_scene_meshes(pts, cols, **kw)
    assert len(got) == len(want) == 1
    for (gc, gt), (wc, wt) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gt, wt)
    n_t = tviz.export_mesh_ply(str(tmp_path / "t.ply"), pts, cols, got)
    n_j = jviz.export_mesh_ply(str(tmp_path / "j.ply"), pts, cols, want)
    assert n_t == n_j > 40
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("with_colors", [True, False])
def test_export_ply_bytes(tmp_path, rng, with_colors):
    pts = rng.normal(size=(50, 3))
    cols = rng.integers(0, 255, (50, 3)) if with_colors else None
    tviz.export_ply(str(tmp_path / "t.ply"), pts, cols)
    jviz.export_ply(str(tmp_path / "j.ply"), pts, cols)
    text = (tmp_path / "t.ply").read_text()
    assert "element vertex 50" in text
    assert text == (tmp_path / "j.ply").read_text()


def test_render_png_and_visualize_global_data(tmp_path, rng):
    """The headless artifacts: a PNG render and, through
    visualize_global_data, the cloud and mesh PLYs with the JAX package's
    bytes."""
    pytest.importorskip("matplotlib")
    from slam_indoor_code_tpu.io.logs import GlobalData as JGlobalData
    from slam_indoor_code_tpu_torch.config import Config
    from slam_indoor_code_tpu_torch.io.logs import GlobalData

    pts = rng.normal(0, 0.3, (60, 3)) * np.array([1, 1, 0.01])
    cols = np.full((60, 3), 128.0)
    R = np.tile(np.eye(3), (3, 1, 1))
    t = np.zeros((3, 3))
    tviz.render_png(str(tmp_path / "c.png"), pts, cols, R, t)
    assert (tmp_path / "c.png").stat().st_size > 1000
    cfg = Config(outputDataDir=str(tmp_path), TriangleMinimumPoints=10,
                 TriangleMaxDistance=5.0, TriangleEuclidDistanceWeight=1.0,
                 TriangleColorDistance=0.01)
    arts = {}
    for name, mod, gd in (("t", tpc, GlobalData()), ("j", jpc, JGlobalData())):
        gd.points, gd.colors = pts, cols
        gd.rotations, gd.positions = R, t
        arts[name] = mod.visualize_global_data(
            gd, cfg, interactive=False, out_prefix=str(tmp_path / name))
    assert arts["t"]["num_meshes"] == arts["j"]["num_meshes"] == 1
    for suffix in ("_cloud.ply", "_mesh.ply"):
        assert ((tmp_path / f"t{suffix}").read_bytes()
                == (tmp_path / f"j{suffix}").read_bytes())


def test_flycam_callbacks_equal_jax():
    """Key mapping of the reference's KeyboardViz3d: the same moves and
    speed clamps as the JAX package's callbacks, key for key."""
    keys = ["W", "S", "A", "D", " ", "C", "+", "W", " "] + ["-"] * 20 + [
        "W"] + ["+"] * 20 + ["C"]
    runs = []
    for mod in (tpc, jpc):
        moves = []
        cbs = mod.flycam_callbacks(moves.append, speed0=1.0)
        for k in keys:
            cbs[k]()
        runs.append((moves, cbs["_speed"]["speed"]))
    assert runs[0] == runs[1]
    assert runs[0][0][:6] == [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
                              (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                              (0.0, -1.0, 0.0), (0.0, 1.0, 0.0)]
    assert runs[0][1] == 2.5
