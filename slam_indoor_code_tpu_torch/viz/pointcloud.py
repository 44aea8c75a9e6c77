"""Point-cloud + camera-trajectory visualization (host-side; a copy of the
JAX package's viz/pointcloud.py: matplotlib and Open3D are imported only
where a PNG is rendered or a window opens).

Reference counterpart: src/vizualization/vizualizationModule.cpp (cv::viz 3-D
window with colored cloud, WTrajectory frusta, fly-cam keyboard handler) and
the 18-line Open3D viewer in python_utility/visualizer.py.

Rebuild: Open3D interactive viewer when available, PLY + matplotlib PNG
export for headless runs (CI/TPU pods have no display — artifacts replace
windows)."""

from __future__ import annotations

import os

import numpy as np


def export_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write an ASCII PLY — consumable by Open3D/MeshLab (and by the
    reference's python_utility workflow after txt→ply conversion)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None and len(colors) == n
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if has_color:
            c = np.asarray(colors).astype(np.uint8).reshape(-1, 3)
            for p, col in zip(points, c):
                f.write(f"{p[0]} {p[1]} {p[2]} {col[0]} {col[1]} {col[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


def export_mesh_ply(path: str, points: np.ndarray,
                    colors: np.ndarray | None,
                    meshes: list[tuple[np.ndarray, np.ndarray]]) -> int:
    """Write the per-cluster triangle meshes as ONE PLY with faces — the
    headless artifact counterpart of the reference's per-cluster cv::viz
    WMesh rendering (bestFittingPlane.cpp:42-127 builds a polygon list per
    cluster and vizualizationModule.cpp shows it).  Vertices are compacted to
    the union of meshed points; faces re-index into that compact set.
    Returns the number of faces written."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    used = np.unique(np.concatenate(
        [np.asarray(comp)[np.asarray(tris).ravel()] for comp, tris in meshes]
    )) if meshes else np.zeros((0,), np.int64)
    remap = np.full(len(points), -1, np.int64)
    remap[used] = np.arange(len(used))
    faces = []
    for comp, tris in meshes:
        comp = np.asarray(comp)
        for tri in np.asarray(tris).reshape(-1, 3):
            faces.append(remap[comp[tri]])
    has_color = colors is not None and len(colors) == len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(used)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if has_color:
            c = np.asarray(colors).astype(np.uint8).reshape(-1, 3)
            for i in used:
                p, col = points[i], c[i]
                f.write(f"{p[0]} {p[1]} {p[2]} {col[0]} {col[1]} {col[2]}\n")
        else:
            for i in used:
                p = points[i]
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
    return len(faces)


def camera_frustum_lines(R: np.ndarray, t: np.ndarray, scale: float = 0.1):
    """Line segments of one camera frustum in world coords (WTrajectory-style
    glyphs, vizualizationModule.cpp:44-59)."""
    C = -R.T @ t
    corners_cam = np.array(
        [[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float64
    ) * scale
    corners = corners_cam @ R + C  # R.T @ x = x @ R
    segs = []
    for i in range(4):
        segs.append((C, corners[i]))
        segs.append((corners[i], corners[(i + 1) % 4]))
    return segs


def render_png(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None,
    rotations: np.ndarray | None = None,
    positions: np.ndarray | None = None,
) -> None:
    """Headless matplotlib 3-D render: cloud + trajectory + frusta."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    pts = np.asarray(points).reshape(-1, 3)
    if len(pts):
        c = None
        if colors is not None and len(colors) == len(pts):
            c = np.clip(np.asarray(colors, np.float64) / 255.0, 0, 1)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c=c)
    if rotations is not None and positions is not None and len(rotations):
        centers = np.stack([-R.T @ t for R, t in zip(rotations, positions)])
        ax.plot(centers[:, 0], centers[:, 1], centers[:, 2], "r-", lw=2)
        for R, t in zip(rotations, positions):
            for a, b in camera_frustum_lines(R, t):
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "g-", lw=0.5)
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(path, dpi=110)
    plt.close(fig)


def visualize_global_data(gd, cfg, *, interactive: bool | None = None,
                          out_prefix: str | None = None) -> dict:
    """Full viz path (vizualizePointsAndCameras, vizualizationModule.cpp:
    61-134): cloud + trajectory (+ per-cluster meshes when the TRIANGLE_*
    config section asks for them).  Headless: exports .ply/.png; interactive:
    opens an Open3D window (fly-cam lives in Open3D itself, replacing the
    cv::viz KeyboardViz3d handler)."""
    out_prefix = out_prefix or os.path.join(cfg.outputDataDir, "viz")
    artifacts = {}
    export_ply(out_prefix + "_cloud.ply", gd.points, gd.colors)
    artifacts["ply"] = out_prefix + "_cloud.ply"
    render_png(out_prefix + ".png", gd.points, gd.colors, gd.rotations, gd.positions)
    artifacts["png"] = out_prefix + ".png"

    if cfg.TriangleMinimumPoints > 0 and len(gd.points) >= cfg.TriangleMinimumPoints:
        from .mesh import build_scene_meshes

        meshes = build_scene_meshes(
            gd.points, np.asarray(gd.colors),
            max_distance=cfg.TriangleMaxDistance,
            euclid_weight=cfg.TriangleEuclidDistanceWeight,
            color_weight=cfg.TriangleColorDistance,
            min_cluster_points=cfg.TriangleMinimumPoints,
        )
        artifacts["num_meshes"] = len(meshes)
        if meshes:
            n_faces = export_mesh_ply(out_prefix + "_mesh.ply", gd.points,
                                      np.asarray(gd.colors), meshes)
            artifacts["mesh_ply"] = out_prefix + "_mesh.ply"
            artifacts["num_faces"] = n_faces

    if interactive is None:
        interactive = bool(os.environ.get("DISPLAY"))
    if interactive:
        try:
            import open3d as o3d

            pcd = o3d.geometry.PointCloud()
            pcd.points = o3d.utility.Vector3dVector(gd.points)
            if len(gd.colors) == len(gd.points):
                pcd.colors = o3d.utility.Vector3dVector(
                    np.asarray(gd.colors, np.float64) / 255.0)
            show_flycam([pcd])
        except ImportError:
            pass
    return artifacts


def flycam_callbacks(view_translate, speed0: float = 1.0) -> dict:
    """Fly-cam key bindings with the reference's semantics (KeyboardViz3d,
    vizualizationModule.cpp:187-250): W/S forward/back and A/D strafe along
    the yaw heading, SPACE up / C down (speed², like the reference), +/-
    adjust speed in 0.25 steps within [0.25, 2.5].

    ``view_translate(delta_cam_xyz)`` applies a camera-frame translation —
    injected so the mapping is unit-testable without a GUI.  Returns
    {key: callback}; callbacks return True (geometry needs re-render)."""
    state = {"speed": float(speed0)}

    def move(dx, dy, dz):
        def cb(_vis=None):
            s = state["speed"]
            view_translate((dx * s, dy * abs(s) * s, dz * s))
            return True
        return cb

    def bump(delta):
        def cb(_vis=None):
            s = state["speed"] + delta
            state["speed"] = min(2.5, max(0.25, s))
            return True
        return cb

    return {
        "W": move(0.0, 0.0, 1.0),
        "S": move(0.0, 0.0, -1.0),
        "A": move(-1.0, 0.0, 0.0),
        "D": move(1.0, 0.0, 0.0),
        " ": move(0.0, -1.0, 0.0),   # space: up (viz y points down)
        "C": move(0.0, 1.0, 0.0),
        "+": bump(0.25),
        "-": bump(-0.25),
        "_speed": state,             # exposed for tests
    }


def show_flycam(geometries, speed: float = 1.0) -> None:
    """Open3D window with WASD/space/C fly-cam navigation — the interactive
    counterpart of the reference's cv::viz window + KeyboardViz3d handler
    (vizualizationModule.cpp:136-147, :187-250)."""
    import open3d as o3d

    vis = o3d.visualization.VisualizerWithKeyCallback()
    vis.create_window(window_name="slam_indoor_code_tpu_torch")
    for g in geometries:
        vis.add_geometry(g)

    def translate_cam(delta):
        ctr = vis.get_view_control()
        cam = ctr.convert_to_pinhole_camera_parameters()
        ext = np.asarray(cam.extrinsic).copy()
        # extrinsic is world→camera: moving the camera by delta (in camera
        # coords) shifts the translation column by -delta
        ext[:3, 3] -= np.asarray(delta, np.float64)
        cam.extrinsic = ext
        ctr.convert_from_pinhole_camera_parameters(cam, allow_arbitrary=True)

    cbs = flycam_callbacks(translate_cam, speed)
    for key, cb in cbs.items():
        if key == "_speed":
            continue
        if key == " ":
            codes = (32,)
        elif key == "+":
            # Open3D key callbacks use GLFW key codes, which have no '+':
            # the key arrives as Shift+'=' (code 61); also bind the keypad
            # plus (GLFW_KEY_KP_ADD = 334)
            codes = (61, 334)
        else:
            codes = (ord(key),)
        for code in codes:
            vis.register_key_callback(code, cb)
    vis.run()
    vis.destroy_window()


def matches_overlay(
    path: str,
    frame_a: np.ndarray,
    xy_a: np.ndarray,
    frame_b: np.ndarray,
    xy_b: np.ndarray,
    train_idx: np.ndarray,
    is_match: np.ndarray,
    max_lines: int = 200,
) -> None:
    """Side-by-side match visualization saved to disk — the headless
    counterpart of the reference's ``showMatchedPointsInTwoFrames`` debug
    window (featureMatchingCommon.cpp:52-68)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    H = max(frame_a.shape[0], frame_b.shape[0])
    Wa = frame_a.shape[1]
    canvas = np.zeros((H, Wa + frame_b.shape[1], 3), np.uint8)
    canvas[: frame_a.shape[0], :Wa] = frame_a
    canvas[: frame_b.shape[0], Wa:] = frame_b
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(canvas)
    q = np.flatnonzero(np.asarray(is_match))[:max_lines]
    tr = np.asarray(train_idx)
    for i in q:
        a = np.asarray(xy_a)[i]
        b = np.asarray(xy_b)[tr[i]]
        ax.plot([a[0], b[0] + Wa], [a[1], b[1]], "-", lw=0.4, color="lime")
    ax.set_axis_off()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
