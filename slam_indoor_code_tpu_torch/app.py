"""Application driver (counterpart of the JAX package's app.py): the SLAM
restart loop over the device-resident engine — when a cycle loses track it
relaunches with the last good pose carried over, and sub-map results are
concatenated.  Writes the reference-format poses/rotations/points/colors/
main/time.txt logs to cfg.outputDataDir.

The camera comes from the config's OpenCV-XML ``calibrationPath`` (K, and
with ``useUndistortion`` the distortion coefficients DC), as in the JAX
package.

Not ported yet (ROADMAP): the classic host conductor
(``tpu.device_runtime=false``), the final global BA, checkpoint/resume,
calibration and file-path media.
"""

from __future__ import annotations

import numpy as np

from . import resolve_device
from .config import Config
from .io.logs import GlobalData, LogStreams, load_global_data_from_logs
from .io.media import ArraySource
from .io.xmlio import load_matrix_from_xml
from .utils.timer import ChronoTimer


def make_media(cfg: Config, frames=None):
    """In-memory frames (a list/array, or any object with ``next_frame``)."""
    if frames is None:
        raise NotImplementedError(
            "file-path media (photo globs, video) is not ported yet: pass "
            "frames in memory")
    if hasattr(frames, "next_frame"):
        return frames
    return ArraySource(frames)


def load_calibration(cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """K and distortion coefficients from the configured XML
    (defineCalibrationMatrix, cameraCalibration.cpp:34-37 +
    defineDistortionCoeffs, mainCycleInternals.cpp:68-75); DC is zeros when
    the file has none."""
    K = load_matrix_from_xml(cfg.calibrationPath, "K")
    try:
        dc = load_matrix_from_xml(cfg.calibrationPath, "DC").reshape(-1)
    except KeyError:
        dc = np.zeros(5)
    return K.astype(np.float64), dc.astype(np.float64)


def _load_dist(cfg: Config):
    """DC coefficients for useUndistortion (mainCycleInternals.cpp:68-75);
    None when disabled or the calibration has no DC entry."""
    if not (cfg.useUndistortion and cfg.calibrationPath):
        return None
    try:
        return load_matrix_from_xml(cfg.calibrationPath, "DC").reshape(-1)
    except Exception:
        return None


def _check_supported(cfg: Config) -> None:
    if not cfg.tpu.device_runtime:
        raise NotImplementedError("tpu.device_runtime=false (the classic host "
                                  "conductor) is not ported yet")
    if cfg.useBundleAdjustment and cfg.tpu.global_ba:
        raise NotImplementedError("tpu.global_ba is not ported yet")
    if cfg.tpu.checkpoint_path or cfg.tpu.resume_path:
        raise NotImplementedError("checkpoint/resume is not ported yet")
    if cfg.tpu.profile_dir:
        raise NotImplementedError("tpu.profile_dir is not ported yet")


def slam_main(cfg: Config, K: np.ndarray, frames=None, seed: int = 0,
              device=None) -> GlobalData:
    """Run the full SLAM pipeline with restart-on-track-loss on ``device``
    (None = CUDA; raises without a GPU).  With ``useUndistortion`` the
    keypoints are undistorted with the DC of ``calibrationPath``.  Returns
    the accumulated GlobalData (with ``frame_ids``) and writes the
    reference-format txt logs."""
    _check_supported(cfg)
    return _slam_main_device(cfg, K, frames=frames, seed=seed, device=device)


def _slam_main_device(cfg: Config, K: np.ndarray, frames=None, seed: int = 0,
                      device=None) -> GlobalData:
    """slam_main on the device-resident runtime (runtime/engine.py)."""
    from .runtime import DeviceEngine, EngineConfig

    timer = ChronoTimer()
    device = resolve_device(device)       # raises before any file is opened
    logs = LogStreams(cfg.outputDataDir)
    try:
        engine = DeviceEngine(
            make_media(cfg, frames), K, EngineConfig.from_config(cfg),
            batch_size=cfg.framesBatchSize,
            required_extracted=cfg.requiredExtractedPointsCount,
            logs=logs, seed=seed, dist=_load_dist(cfg), device=device)
        global_data = GlobalData()
        init_R, init_t = np.eye(3), np.zeros(3)
        while True:
            logs.main.write("Launching main cycle...\n")
            result = engine.run(init_R, init_t)
            global_data.extend(result["global_data"])
            if (result["status"] != "interrupted"
                    or result["last_pose"] is None):
                break
            init_R, init_t = result["last_pose"]
            if engine.media_exhausted:
                break
        pts, cols = engine.snapshot_map()
        global_data.points = pts
        global_data.colors = cols.astype(np.float64)
        logs.write_map(pts, cols)
        if global_data.empty:
            logs.main.write(
                "Couldn't process image sequence. Too little data.\n")
        timer.print_start_delta("Whole time: ", logs.time)
    finally:
        logs.close()
    return global_data


def run_from_config(cfg: Config, frames=None, K: np.ndarray | None = None,
                    device=None) -> GlobalData:
    """Top-level dispatch (main, src/main.cpp:28-74): ``onlyViz`` reloads
    the logs; otherwise SLAM, with K from ``calibrationPath`` unless the
    caller passes one."""
    if cfg.calibrate:
        raise NotImplementedError("calibration is not ported yet")
    if cfg.onlyViz:
        return load_global_data_from_logs(cfg.outputDataDir)
    if K is None:
        K, _dc = load_calibration(cfg)
    return slam_main(cfg, K, frames=frames, device=device)
