"""Application driver (counterpart of the JAX package's app.py): the SLAM
restart loop — when a cycle loses track it relaunches with the last good
pose carried over, and sub-map results are concatenated.  Writes the
reference-format poses/rotations/points/colors/main/time.txt logs to
cfg.outputDataDir.

Two execution paths with the same semantics: the device-resident engine
(runtime/engine.py, the default) and, with ``tpu.device_runtime=false``,
the classic host conductor (pipeline/main_cycle.py, the readable one).
Media comes from the config's photo glob or video file (io/media.py)
unless frames are passed in memory; the camera from its OpenCV-XML ``calibrationPath`` (K,
and with ``useUndistortion`` the distortion coefficients DC).
``tpu.global_ba`` adds the final full-trajectory BA (``_global_refine``);
``tpu.checkpoint_path``/``checkpoint_every`` snapshot the run and
``tpu.resume_path`` continues one (runtime/checkpoint.py);
``tpu.ingest="host"`` detects on the host and, with ``tpu.streaming``, runs
the engine's streaming loop; ``tpu.profile_dir`` writes a ``torch.profiler``
trace of the device runtime's run there.  ``calibrate`` runs the
chessboard calibration (calibration/), ``tpu.mesh_shape`` the meshed engine
(parallel/), and ``run_sequences_parallel`` tracks independent sequences
at once, one thread, card and CUDA stream each.

Video is read in AVI, MP4/QuickTime/3GPP, Matroska/WebM, MPEG program and
transport streams and raw elementary streams (io/avi.py, io/mp4.py,
io/matroska.py, io/mpegps.py, io/mpegts.py), in Motion-JPEG, uncompressed
I420/Y800, MPEG-4 Part 2 (Simple and Advanced Simple, with interlace:
field DCT, field vectors, field direct mode, the alternate scan; and with
data partitioning), MPEG-1/2 (4:2:0 and 4:2:2), H.263, VP8, VP9, FFV1 and
HuffYUV, each decoded by the port's own decoder (io/media.py); H.264,
HEVC, AV1 and the other codecs OpenCV reads for the JAX package raise
``NotImplementedError`` naming them (ROADMAP).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from . import resolve_device
from .config import Config
from .io.logs import GlobalData, LogStreams, load_global_data_from_logs
from .io.media import ArraySource, MediaSource
from .io.xmlio import load_matrix_from_xml
from .utils.timer import ChronoTimer


def make_media(cfg: Config, frames=None):
    """In-memory frames (a list/array, or any object with ``next_frame``),
    else the config's photo glob (or, with ``usePhotosCycle=false``, its
    video file) decoded by ``threadsCount`` workers."""
    if frames is not None:
        if hasattr(frames, "next_frame"):
            return frames
        return ArraySource(frames)
    return MediaSource(photos_pattern=cfg.photosPathPattern,
                       video_path=cfg.videoSourcePath,
                       use_photos=cfg.usePhotosCycle,
                       threads=max(1, cfg.threadsCount))


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


def slam_main(cfg: Config, K: np.ndarray, frames=None, seed: int = 0,
              device=None) -> GlobalData:
    """Run the full SLAM pipeline with restart-on-track-loss on ``device``
    (None = CUDA; raises without a GPU).  With ``useUndistortion`` the
    keypoints are undistorted with the DC of ``calibrationPath``.  Returns
    the accumulated GlobalData (the device runtime's with ``frame_ids``)
    and writes the reference-format txt logs.

    ``tpu.device_runtime=false`` runs the classic host conductor; the
    device runtime is the default."""
    if cfg.tpu.device_runtime:
        return _slam_main_device(cfg, K, frames=frames, seed=seed,
                                 device=device)
    return _slam_main_classic(cfg, K, frames=frames, seed=seed, device=device)


def _slam_main_classic(cfg: Config, K: np.ndarray, frames=None,
                       seed: int = 0, device=None) -> GlobalData:
    """slam_main on the classic host conductor (pipeline/main_cycle.py).
    ``tpu.profile_dir`` is not traced here, as in the JAX package."""
    from .models import frontend as fe
    from .pipeline import CycleSettings, MainCycle, MapArena
    from .solver.ba import WindowedBA

    timer = ChronoTimer()
    device = resolve_device(device)       # raises before any file is opened
    logs = LogStreams(cfg.outputDataDir)
    try:
        media = make_media(cfg, frames)
        arena = MapArena(cfg.tpu.max_map_points)
        ba_fn = None
        if cfg.useBundleAdjustment:
            loss, param = cfg.ba_loss
            ba_fn = WindowedBA(
                loss=loss, loss_param=param, max_iters=cfg.tpu.ba_max_iters,
                window=cfg.BAMaxFramesCnt,
                window_points=cfg.tpu.window_points, report=logs.main,
                adjust_intrinsics=cfg.tpu.ba_adjust_intrinsics,
                device=device)
        global_data = GlobalData()
        cycle = MainCycle(media, K, CycleSettings.from_config(cfg),
                          fe.frontend_config_from(cfg), arena, logs=logs,
                          ba_fn=ba_fn, seed=seed, dist=_load_dist(cfg),
                          device=device)
        init_R, init_t = np.eye(3), np.zeros(3)
        while True:
            logs.main.write("Launching main cycle...\n")
            result = cycle.run(init_R, init_t)
            global_data.extend(result["global_data"])
            if (result["status"] != "interrupted"
                    or result["last_frame"] is None):
                break
            # restart with pose carry-over (defineCameraPosition,
            # mainCycleInternals.cpp:122-133)
            init_R = result["last_frame"].rotation
            init_t = result["last_frame"].motion
            if cycle.scheduler.media_exhausted:
                break
        pts, cols = arena.snapshot()
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


@contextlib.contextmanager
def _device_trace(profile_dir: str, logs: LogStreams, device):
    """``tpu.profile_dir``: a ``torch.profiler`` trace (host ops and, on
    CUDA, the kernels) of the block, written to ``profile_dir`` as a
    Chrome-trace JSON (Perfetto, chrome://tracing).  The ``steps.*`` spans
    of runtime/steps.py name the work in it."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    logs.main.write(f"Profiling device trace to {profile_dir}\n")
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))


def _global_refine(engine, gd: GlobalData, logs, cfg: Config):
    """Final full-trajectory BA over every flushed camera and its windows'
    observations (solver/global_ba.py, matrix-free LM-PCG).  Updates ``gd``
    poses in place and returns the refined landmark table, or None when
    there is too little to refine or the refinement does not lower the
    reprojection RMSE."""
    from .geometry.rotations import matrix_to_rodrigues, rodrigues_to_matrix
    from .solver.global_ba import GlobalBAConfig, global_bundle_adjust

    obs = engine.global_observations()
    N = len(gd.rotations)
    if not obs or N < 12:
        return None
    # -1 placeholder frame ids must not key the camera map: duplicate keys
    # would attach another window's observations to one camera
    fid2idx = {int(f): i for i, f in enumerate(gd.frame_ids) if int(f) >= 0}
    rows, uv_l, pid_l = [], [], []
    for xy, corr, ids in obs:
        for r_i, fid in enumerate(ids):
            ci = fid2idx.get(int(fid), -1)
            if ci < 0:
                continue
            sel = np.flatnonzero(corr[r_i] >= 0)
            rows.append(np.full(len(sel), ci, np.int64))
            uv_l.append(xy[r_i][sel])
            pid_l.append(corr[r_i][sel])
    if not rows:
        return None
    ci = np.concatenate(rows)
    uv = np.concatenate(uv_l).astype(np.float32)
    pid = np.concatenate(pid_l).astype(np.int64)
    O = len(ci)
    padn = -(-O // 4096) * 4096 - O     # bucketed, as the JAX package pads
    uv = np.concatenate([uv, np.zeros((padn, 2), np.float32)])
    ci = np.concatenate([ci, np.zeros(padn, np.int64)])
    pid = np.concatenate([pid, np.zeros(padn, np.int64)])
    mask = np.concatenate([np.ones(O, bool), np.zeros(padn, bool)])

    Npad = -(-N // 16) * 16
    cams6 = np.zeros((Npad, 6), np.float32)
    cams6[:N, :3] = matrix_to_rodrigues(torch.from_numpy(
        np.asarray(gd.rotations[:N], np.float64))).numpy()
    cams6[:N, 3:] = np.asarray(gd.positions[:N])

    loss, param = cfg.ba_loss
    gcfg = GlobalBAConfig(loss=loss, loss_param=float(param),
                          max_iters=cfg.tpu.global_ba_iters,
                          cg_iters=cfg.tpu.global_ba_cg_iters)
    t0 = ChronoTimer()
    # solve over the live landmarks only (a bucketed slice of the arena):
    # every per-point vector and segment sum scales with the point table
    n_pts = int(engine.state.map_count)
    Pcap = max(-(-n_pts // 4096) * 4096, 4096)
    dev = engine.device

    def put(a):
        return torch.from_numpy(a).to(dev)

    camsf, ptsf, info = global_bundle_adjust(
        gcfg, engine.state.K4, put(cams6), engine.state.map_points[:Pcap],
        put(uv), put(ci), put(pid), put(mask))
    camsf = camsf.cpu().numpy().astype(np.float64)
    ptsf = ptsf[:n_pts].cpu().numpy().astype(np.float64)
    rmse0 = float(info["initial_rmse"])
    rmse1 = float(info["final_rmse"])
    logs.main.write(
        "Global Bundle Adjustment statistics (approximated RMSE):\n"
        f" #residuals: {int(info['num_residuals'])}\n"
        f" #cameras: {N}\n"
        f" Initial RMSE: {rmse0:.6f}\n"
        f" Final RMSE: {rmse1:.6f}\n")
    t0.print_start_delta("Global bundle adjustment: ", logs.time)
    # the LM loop accepts only cost decreases, but a degenerate observation
    # record can leave the RMSE flat while the gauge slides: keep the
    # windowed trajectory unless the refinement lowered the RMSE
    if not np.isfinite(rmse1) or rmse1 >= rmse0:
        logs.main.write("Global BA rejected (no RMSE improvement)\n")
        return None
    Rs = rodrigues_to_matrix(torch.from_numpy(camsf[:N, :3])).numpy()
    for i in range(N):
        gd.rotations[i] = Rs[i]
        gd.positions[i] = camsf[i, 3:]
    return ptsf


def _resume(cfg: Config, engine, media, global_data: GlobalData,
            logs: LogStreams) -> None:
    """Restore ``engine`` from ``tpu.resume_path``: skip the media the
    snapshot consumed (frames after its cursor re-pull deterministically)
    and re-emit its flushed trajectory, so the resumed run's output is the
    whole run's."""
    from .runtime import checkpoint_next_fid, load_checkpoint

    load_checkpoint(cfg.tpu.resume_path, engine)
    for _ in range(checkpoint_next_fid(cfg.tpu.resume_path)):
        media.next_frame()
    if engine.flushed_R:
        global_data.append_cameras(
            np.stack(engine.flushed_R), np.stack(engine.flushed_t),
            list(engine.flushed_ids))
        for R, t in zip(engine.flushed_R, engine.flushed_t):
            logs.write_pose(np.asarray(R, np.float64).reshape(3, 3),
                            np.asarray(t, np.float64).reshape(3))
    # a streaming snapshot may hold accepted frames of a window that has
    # not flushed yet: their poses were logged at acceptance, so they are
    # logged again (a classic snapshot follows a flush and holds none)
    n_open = engine._win_fill
    for R, t in zip(engine.trajectory_R[len(engine.trajectory_R) - n_open:],
                    engine.trajectory_t[len(engine.trajectory_t) - n_open:]):
        logs.write_pose(np.asarray(R, np.float64).reshape(3, 3),
                        np.asarray(t, np.float64).reshape(3))
    logs.main.write(f"Resumed from {cfg.tpu.resume_path} at "
                    f"{engine.frames_accepted} frames\n")


def _slam_main_device(cfg: Config, K: np.ndarray, frames=None, seed: int = 0,
                      device=None) -> GlobalData:
    """slam_main on the device-resident runtime (runtime/engine.py)."""
    from .runtime import DeviceEngine, EngineConfig

    timer = ChronoTimer()
    device = resolve_device(device)       # raises before any file is opened
    logs = LogStreams(cfg.outputDataDir)
    try:
        media = make_media(cfg, frames)
        use_global_ba = cfg.useBundleAdjustment and cfg.tpu.global_ba
        engine = DeviceEngine(
            media, K, EngineConfig.from_config(cfg),
            batch_size=cfg.framesBatchSize,
            required_extracted=cfg.requiredExtractedPointsCount,
            logs=logs, seed=seed, dist=_load_dist(cfg), device=device,
            checkpoint_path=cfg.tpu.checkpoint_path or None,
            checkpoint_every=cfg.tpu.checkpoint_every,
            collect_global_obs=use_global_ba)
        global_data = GlobalData()
        resume = bool(cfg.tpu.resume_path)
        if resume:
            _resume(cfg, engine, media, global_data, logs)
        init_R, init_t = np.eye(3), np.zeros(3)
        with _device_trace(cfg.tpu.profile_dir, logs, device):
            while True:
                logs.main.write("Launching main cycle...\n")
                result = engine.run(init_R, init_t, resume=resume)
                resume = False
                global_data.extend(result["global_data"])
                if (result["status"] != "interrupted"
                        or result["last_pose"] is None):
                    break
                init_R, init_t = result["last_pose"]
                if engine.media_exhausted:
                    break
            refined_pts = None
            if use_global_ba:
                refined_pts = _global_refine(engine, global_data, logs, cfg)
            pts, cols = engine.snapshot_map()
        if refined_pts is not None and len(refined_pts) == len(pts):
            pts = refined_pts
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
    """Top-level dispatch (main, src/main.cpp:28-74): ``calibrate`` runs the
    chessboard calibration; ``onlyViz`` reloads the logs; otherwise SLAM,
    with K from ``calibrationPath`` unless the caller passes one."""
    if cfg.calibrate:
        from .calibration.chessboard import main_calibration_entry_point

        main_calibration_entry_point(cfg, device=device)
        return GlobalData()
    if cfg.onlyViz:
        return load_global_data_from_logs(cfg.outputDataDir)
    if K is None:
        K, _dc = load_calibration(cfg)
    return slam_main(cfg, K, frames=frames, device=device)


def run_sequences_parallel(cfgs: list, Ks: list, frames_list: list | None = None,
                           seeds: list | None = None, device=None) -> list:
    """Track independent sequences at once, one thread each (the JAX
    package's multi-sequence data parallelism): sequence i runs
    ``slam_main(cfgs[i], Ks[i], frames_list[i], seeds[i] or i)`` on the
    machine's card i mod the card count (``device=None``), or on
    ``device`` when the caller names one (``"cpu"``).  On CUDA each thread
    launches on a stream of its own, so sequences that share a card
    overlap.  Returns the per-sequence GlobalData; a sequence's error is
    re-raised as ``RuntimeError("sequence i failed")``.  ``tpu.profile_dir``
    raises here: ``torch.profiler`` is not thread-safe."""
    import threading

    if any(c.tpu.profile_dir for c in cfgs):
        raise ValueError("run_sequences_parallel: tpu.profile_dir traces "
                         "one run (torch.profiler is not thread-safe)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    n = len(cfgs)
    results: list = [None] * n
    errors: list = [None] * n

    def worker(i):
        d = devs[i % len(devs)]
        try:
            frames = frames_list[i] if frames_list else None
            seed = seeds[i] if seeds else i
            with contextlib.ExitStack() as ctx:
                if d.type == "cuda":
                    ctx.enter_context(torch.cuda.device(d))
                    ctx.enter_context(torch.cuda.stream(torch.cuda.Stream(d)))
                results[i] = slam_main(cfgs[i], Ks[i], frames=frames,
                                       seed=seed, device=d)
        except Exception as e:  # noqa: BLE001 — surfaced per sequence
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"sequence {i} failed") from e
    return results
