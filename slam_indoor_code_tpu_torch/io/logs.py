"""Six-stream run logger + txt map/trajectory round-trip.

The reference opens six text streams under ``outputDataDir`` — main.txt,
points.txt, colors.txt, poses.txt, rotations.txt, time.txt — and writes all
numeric matrices space-separated at fixed 12-decimal precision
(reference: src/misc/IOmisc.cpp:10-25 ``openLogsStreams``, :88-109
``rawOutput`` with ``std::setprecision(12)``).  ``onlyViz`` mode re-parses
those files back into the global map (``getGlobalDataFromLogFiles``,
src/misc/IOmisc.cpp:133-178).  We reproduce the exact formats so a trajectory
produced by either implementation can be consumed by the other (and by the
ATE harness).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

STREAM_FILES = {
    "main": "main.txt",
    "points": "points.txt",
    "colors": "colors.txt",
    "poses": "poses.txt",
    "rotations": "rotations.txt",
    "time": "time.txt",
}

DIVIDER = "\n================================================================\n\n"


def format_matrix(matrix: np.ndarray) -> str:
    """Render a 2-D matrix the way the reference's ``rawOutput`` does:
    space-separated columns, newline-terminated rows, fixed 12 decimals
    (src/misc/IOmisc.cpp:88-109)."""
    m = np.asarray(matrix, dtype=np.float64)
    if m.ndim == 1:
        m = m[None, :]
    lines = []
    for row in m:
        lines.append(" ".join(f"{v:.12f}" for v in row))
    return "\n".join(lines) + "\n"


def write_matrix(matrix: np.ndarray, stream) -> None:
    stream.write(format_matrix(matrix))
    stream.flush()


class LogStreams:
    """Owns the six output streams of a run (reference: LogFilesStreams,
    src/misc/IOmisc.h:10-19).  Usable as a context manager."""

    def __init__(self, output_dir: str, mode: str = "w"):
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.main = open(os.path.join(output_dir, STREAM_FILES["main"]), mode)
        self.points = open(os.path.join(output_dir, STREAM_FILES["points"]), mode)
        self.colors = open(os.path.join(output_dir, STREAM_FILES["colors"]), mode)
        self.poses = open(os.path.join(output_dir, STREAM_FILES["poses"]), mode)
        self.rotations = open(os.path.join(output_dir, STREAM_FILES["rotations"]), mode)
        self.time = open(os.path.join(output_dir, STREAM_FILES["time"]), mode)

    def write_pose(self, rotation: np.ndarray, position: np.ndarray) -> None:
        """Append one accepted camera pose: position as a 1×3 row to poses.txt,
        rotation as 3 rows to rotations.txt (reference: mainCycle.cpp:101-104,
        170-175 writes ``motion.t()`` then the 3×3 rotation)."""
        write_matrix(np.asarray(position).reshape(1, 3), self.poses)
        write_matrix(np.asarray(rotation).reshape(3, 3), self.rotations)

    def write_map(self, points: np.ndarray, colors: np.ndarray) -> None:
        """Write the final map: Nx3 points and Nx3 colors, one per row
        (reference: src/main.cpp:103-106)."""
        if len(points):
            write_matrix(np.asarray(points).reshape(-1, 3), self.points)
            write_matrix(np.asarray(colors, dtype=np.float64).reshape(-1, 3), self.colors)

    def divider(self, stream) -> None:
        stream.write(DIVIDER)

    def close(self) -> None:
        for s in (self.main, self.points, self.colors, self.poses, self.rotations, self.time):
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class GlobalData:
    """Host-side accumulator for the reconstructed scene (reference:
    ``GlobalData``, src/mainModule/cycleProcessing/mainCycleStructures.h:49-54)."""

    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))
    rotations: np.ndarray = field(default_factory=lambda: np.zeros((0, 3, 3), np.float64))
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float64))
    # source frame index of each camera (the scheduler may legally skip
    # candidate frames — batch.cpp:93-98 — so cameras ≠ frames; ATE harnesses
    # need this to pair estimated cameras with ground-truth poses)
    frame_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))

    def append_cameras(self, rotations: np.ndarray, positions: np.ndarray,
                       frame_ids=None) -> None:
        self.rotations = np.concatenate([self.rotations, rotations.reshape(-1, 3, 3)])
        self.positions = np.concatenate([self.positions, positions.reshape(-1, 3)])
        if frame_ids is not None:
            self.frame_ids = np.concatenate(
                [self.frame_ids, np.asarray(frame_ids, np.int64).reshape(-1)])

    def append_points(self, points: np.ndarray, colors: np.ndarray) -> None:
        if len(points) == 0:
            return
        self.points = np.concatenate([self.points, points.reshape(-1, 3)])
        self.colors = np.concatenate(
            [self.colors, np.asarray(colors, np.uint8).reshape(-1, 3)]
        )

    def extend(self, other: "GlobalData") -> None:
        """Concatenate a sub-map produced by a restarted cycle (reference:
        ``insertNewGlobalData``, mainCycleInternals.cpp:249-261)."""
        self.append_points(other.points, other.colors)
        if len(other.rotations):
            self.append_cameras(other.rotations, other.positions,
                                other.frame_ids if len(other.frame_ids) ==
                                len(other.rotations) else None)

    @property
    def empty(self) -> bool:
        return len(self.points) == 0


def load_global_data_from_logs(output_dir: str) -> GlobalData:
    """Re-parse poses/rotations/points/colors txt back into a GlobalData, with
    the reference's count-consistency checks (``getGlobalDataFromLogFiles``,
    src/misc/IOmisc.cpp:133-178)."""

    def _read(name: str) -> np.ndarray:
        path = os.path.join(output_dir, STREAM_FILES[name])
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            return np.zeros((0,))
        return np.loadtxt(path, dtype=np.float64, ndmin=2)

    poses = _read("poses")
    rotations = _read("rotations")
    if rotations.size and rotations.shape[0] != 3 * poses.shape[0]:
        raise ValueError(
            "Count of rotations and translations must be equal: "
            f"{rotations.shape[0] // 3} rotations vs {poses.shape[0]} translations"
        )
    points = _read("points")
    colors = _read("colors")
    if points.size and (not colors.size or points.shape[0] != colors.shape[0]):
        raise ValueError(
            "Count of points and their colors must be equal: "
            f"{points.shape[0]} points vs {colors.shape[0] if colors.size else 0} colors"
        )
    gd = GlobalData()
    if poses.size:
        gd.positions = poses.reshape(-1, 3)
        gd.rotations = rotations.reshape(-1, 3, 3)
    if points.size:
        gd.points = points.reshape(-1, 3)
        gd.colors = colors.reshape(-1, 3).astype(np.uint8)
    return gd
