"""Incremental SfM main cycle, the classic host conductor (counterpart of
the JAX package's pipeline/main_cycle.py).

Mirrors the reference's ``mainCycle`` control flow (src/mainModule/
cycleProcessing/mainCycle.cpp:73-240) with its scheduling semantics:

  bootstrap first pair (with head-promotion fallback)   mainCycle.cpp:243-316
  → loop { pick good frame from batch                   batch.cpp:59-99
           PnP-RANSAC pose                              mainCycle.cpp:155-161
           triangulate new matches                      mainCycle.cpp:182-191
           merge into map                               mainCycleInternals.cpp:222-246
           windowed BA + flush every BAMaxFramesCnt }   mainCycle.cpp:201-210
  track-loss restart with pose carry-over is driven one level up (app.py).

The compute inside each step is the port's tensor code on ``device``
(frontend, geometry, solver); this module is the readable host conductor
that owns the dynamic state (map cursor, batch list, logging) and reads the
results it needs back per step.  The random draws of RANSAC and PnP come
from one ``torch.Generator`` seeded from ``seed``.  Unlike the JAX
package's, the cameras it returns carry their source frame ids, as the
device runtime's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..geometry import (
    compose_with_world,
    estimate_transformation,
    reconstruct,
    solve_pnp_ransac,
)
from ..geometry.ransac import ransac_fanout
from ..io.logs import GlobalData, LogStreams
from ..models import frontend as fe
from ..utils.timer import ChronoTimer
from .batch import EMPTY_BATCH, FRAME_NOT_FOUND, BatchScheduler, GoodFrame
from .structures import (
    BatchElement,
    MapArena,
    TemporalFrameData,
    harvest_pnp_correspondences,
    push_new_spatial_points,
)


@dataclass
class CycleSettings:
    """Host-side processing conditions (reference: DataProcessingConditions,
    mainCycleStructures.h:21-33)."""

    required_extracted: int
    required_matched: int
    batch_size: int
    skip_from_head: int
    use_first_fit: bool
    head_tie_tolerance: float
    use_ransac: bool
    ransac_threshold: float
    distance_threshold: float
    use_ba: bool
    ba_window: int
    ransac_iters: int = 1024
    pnp_iters: int = 256

    @staticmethod
    def from_config(cfg) -> "CycleSettings":
        return CycleSettings(
            required_extracted=cfg.requiredExtractedPointsCount,
            required_matched=cfg.requiredMatchedPointsCount,
            batch_size=cfg.framesBatchSize,
            skip_from_head=cfg.skipFramesFromBatchHead,
            use_first_fit=cfg.useFirstFitInBatch,
            head_tie_tolerance=float(cfg.tpu.head_tie_tolerance),
            use_ransac=cfg.RPUseRANSAC,
            ransac_threshold=cfg.RPRANSACThreshold,
            distance_threshold=cfg.RPDistanceThreshold,
            use_ba=cfg.useBundleAdjustment,
            ba_window=cfg.BAMaxFramesCnt,
            # fan-out statistically matched to RPRANSACProb, capped by the
            # tpu.* compute budget (see geometry/ransac.py)
            ransac_iters=ransac_fanout(cfg.RPRANSACProb, 8,
                                       cfg.tpu.ransac_iters),
            pnp_iters=ransac_fanout(cfg.RPRANSACProb, 6,
                                    cfg.tpu.pnp_ransac_iters),
        )


def _element_to_frame_data(el: BatchElement,
                           gf: GoodFrame | None) -> TemporalFrameData:
    k = el.xy.shape[0]
    fd = TemporalFrameData.empty(k, 1)
    fd.xy = el.xy.cpu().numpy()
    fd.valid = el.valid.cpu().numpy()
    fd.desc = el.desc  # device tensor: stays on the device for matching
    fd.colors = np.asarray(el.colors)
    fd.frame_id = el.frame_id
    if gf is not None:
        fd.match_train = gf.match_train
        fd.match_mask = gf.match_mask
    return fd


class MainCycle:
    def __init__(
        self,
        media,
        K: np.ndarray,
        settings: CycleSettings,
        fcfg: fe.FrontendConfig,
        arena: MapArena,
        logs: LogStreams | None = None,
        ba_fn=None,
        seed: int = 0,
        dist: np.ndarray | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.K = self._put(K)
        self.K_host = np.asarray(K, np.float64)
        self.s = settings
        self.fcfg = fcfg
        self.arena = arena
        self.logs = logs
        self.ba_fn = ba_fn
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        # useUndistortion: keypoint coords are corrected right after
        # extraction, so all downstream geometry sees undistorted pixels —
        # the device runtime's placement (runtime/steps.py ingest)
        self.dist = None
        if dist is not None and np.any(np.asarray(dist) != 0):
            self.dist = self._put(np.asarray(dist).reshape(-1))
        self.scheduler = BatchScheduler(
            media, fcfg,
            batch_size=settings.batch_size,
            required_extracted=settings.required_extracted,
            required_matched=settings.required_matched,
            skip_from_head=settings.skip_from_head,
            use_first_fit=settings.use_first_fit,
            head_tie_tolerance=settings.head_tie_tolerance,
            report=logs.main if logs else None,
            K=self.K, dist=self.dist, device=self.device,
        )

    def _put(self, a) -> torch.Tensor:
        """Host array → float32 tensor on the device."""
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _matched_coords(self, prev: TemporalFrameData,
                        cur: TemporalFrameData):
        """Per-match-slot coordinate pairs (uv_prev[q], uv_cur[train]) and
        mask on the device — the fixed-slot analogue of
        getKeyPointCoordsFromFramePair (featureMatchingCommon.cpp:23-33)."""
        train = np.where(cur.match_mask, cur.match_train, 0)
        return (self._put(prev.xy), self._put(cur.xy[train]),
                torch.as_tensor(cur.match_mask, device=self.device))

    def _log_pose(self, fd: TemporalFrameData):
        if self.logs:
            self.logs.write_pose(fd.rotation, fd.motion)

    # --------------------------------------------------------------- bootstrap
    def _find_first_good_frame(self) -> TemporalFrameData | None:
        """Pop frames until one has ≥ required corners
        (findFirstGoodFrame, mainCycleInternals.cpp:136-155).

        After a track-loss restart the scheduler still holds staged batch
        frames (already past the corner gate): those come first — the
        reference drops its batch tail on restart."""
        if self.scheduler.batch:
            return _element_to_frame_data(self.scheduler.pop_head(), None)
        while True:
            f, fid = self.scheduler.pull()
            if f is None:
                return None
            res = fe.extract_and_describe(
                self.fcfg, torch.from_numpy(np.asarray(f)).to(self.device))
            if self.dist is not None:
                from ..geometry.projection import undistort_points

                res = dict(res)
                res["xy"] = undistort_points(self.K, self.dist, res["xy"])
            if int(res["num_corners"]) >= self.s.required_extracted:
                el = BatchElement(
                    frame=f, xy=res["xy"], valid=res["valid"],
                    score=res["score"], desc=res["desc"],
                    colors=res["colors"].cpu().numpy(), frame_id=fid,
                )
                return _element_to_frame_data(el, None)

    @torch.profiler.record_function("pipeline.bootstrap")
    def _bootstrap(self, init_R: np.ndarray, init_t: np.ndarray):
        """First-pair processing (processingFirstPairFrames,
        mainCycle.cpp:243-282).  Returns (frame0, frame1) or None."""
        first = self._find_first_good_frame()
        if first is None:
            return None
        while True:
            gf = self.scheduler.find_good_frame(
                first.desc, torch.as_tensor(first.valid, device=self.device))
            if gf == EMPTY_BATCH:
                return None
            if gf == FRAME_NOT_FOUND:
                # promote the batch head to first frame and retry
                # (defineFirstPairFrames, mainCycle.cpp:299-315)
                if not self.scheduler.batch:
                    return None
                first = _element_to_frame_data(self.scheduler.pop_head(),
                                               None)
                continue
            break

        second = _element_to_frame_data(gf.element, gf)
        first.rotation = np.asarray(init_R, np.float64)
        first.motion = np.asarray(init_t, np.float64)

        uv1, uv2, mask = self._matched_coords(first, second)
        pose = estimate_transformation(
            self.K, uv1, uv2, mask,
            use_ransac=self.s.use_ransac,
            threshold_px=self.s.ransac_threshold,
            distance_threshold=self.s.distance_threshold,
            num_hypotheses=self.s.ransac_iters,
            gen=self.gen,
        )
        chirality_t = pose["chirality_mask"]
        chirality = chirality_t.cpu().numpy()
        if self.logs:
            self.logs.main.write(
                f"Points passed chirality check count: {int(chirality.sum())}\n"
            )

        R1, t1 = self._put(first.rotation), self._put(first.motion)
        R2, t2 = compose_with_world(R1, t1, pose["R"], pose["t"])
        second.rotation = R2.cpu().numpy().astype(np.float64)
        second.motion = t2.cpu().numpy().astype(np.float64)

        X = reconstruct(self.K, R1, t1, self._put(second.rotation),
                        self._put(second.motion), uv1, uv2, chirality_t)
        X = X.cpu().numpy()

        # defineFeaturesCorrespondSpatialIndices (mainCycleInternals.cpp:
        # 178-204): every chirality-passing match becomes a landmark,
        # coloured by the second frame's pixel at the train keypoint
        q = np.flatnonzero(chirality)
        train = second.match_train[q]
        ids = self.arena.append(X[q], second.colors[train])
        first.correspond[q] = ids
        second.correspond[train] = ids

        self._log_pose(first)
        self._log_pose(second)
        return first, second

    # -------------------------------------------------------------- main loop
    def run(self, init_R=None, init_t=None):
        """One cycle (sub-map).  Returns dict with:
        'status': 'video_over' | 'interrupted' | 'no_data',
        'last_frame': TemporalFrameData | None  (pose carry-over for restart),
        'global_data': GlobalData (cameras of this cycle),
        'frames_accepted': int."""
        timer = ChronoTimer()
        init_R = np.eye(3) if init_R is None else init_R
        init_t = np.zeros(3) if init_t is None else init_t
        gd = GlobalData()

        boot = self._bootstrap(init_R, init_t)
        if boot is None:
            return {"status": "no_data", "last_frame": None,
                    "global_data": gd, "frames_accepted": 0}
        prev, cur = boot
        processed: list[TemporalFrameData] = [prev, cur]
        frames_accepted = 2
        if self.logs:
            timer.print_last_point_delta("MS for first-pair computations: ",
                                         self.logs.time)
            timer.update_last_point()

        status = "interrupted"
        while True:
            gf = self.scheduler.find_good_frame(
                cur.desc, torch.as_tensor(cur.valid, device=self.device))
            if gf == EMPTY_BATCH:
                status = "video_over"
                break
            if gf == FRAME_NOT_FOUND:
                if self.logs:
                    self.logs.main.write(
                        "No good frames in batch. Interrupt video "
                        "processing\n")
                status = "interrupted"
                break
            if self.logs:
                timer.update_last_point()

            new = _element_to_frame_data(gf.element, gf)
            if not self._track(cur, new, timer):
                status = "interrupted"
                break
            processed.append(new)
            frames_accepted += 1
            if len(processed) >= self.s.ba_window:
                self._ba_and_flush(processed, gd, timer)

            prev, cur = cur, new

        if processed:
            self._ba_and_flush(processed, gd, timer)

        return {
            "status": status,
            "last_frame": cur,
            "global_data": gd,
            "frames_accepted": frames_accepted,
        }

    @torch.profiler.record_function("pipeline.track")
    def _track(self, cur: TemporalFrameData, new: TemporalFrameData,
               timer) -> bool:
        """PnP pose of ``new`` from the map points ``cur`` sees, then the
        new landmarks triangulated against ``cur`` and merged into the map.
        False when too few 3-D↔2-D pairs are left for PnP."""
        # 3D↔2D harvest + PnP (mainCycle.cpp:138-161)
        X, uv, pmask = harvest_pnp_correspondences(
            cur.correspond, new.match_train, new.match_mask, new.xy,
            self.arena)
        if pmask.sum() < 4:
            if self.logs:
                self.logs.main.write(
                    "Not enough corresponding points for solvePnP RANSAC\n")
            return False
        R_cur, t_cur = self._put(cur.rotation), self._put(cur.motion)
        pnp = solve_pnp_ransac(
            self.K, self._put(X), self._put(uv),
            torch.as_tensor(pmask, device=self.device),
            num_hypotheses=self.s.pnp_iters,
            prior_R=R_cur, prior_t=t_cur, gen=self.gen,
        )
        new.rotation = pnp["R"].cpu().numpy().astype(np.float64)
        new.motion = pnp["t"].cpu().numpy().astype(np.float64)
        if self.logs:
            timer.print_last_point_delta(
                "RANSAC transformation estimation: ", self.logs.time)
            timer.update_last_point()
            self.logs.main.write(f"Used in solvePnP: {int(pmask.sum())}\n")
        self._log_pose(new)

        # triangulate all current matches against the previous frame
        # (mainCycle.cpp:182-191) and merge them into the map
        uv1, uv2, mmask = self._matched_coords(cur, new)
        Xnew = reconstruct(self.K, R_cur, t_cur, self._put(new.rotation),
                           self._put(new.motion), uv1, uv2, mmask)
        Xnew = Xnew.cpu().numpy()
        new_ok, prop_ok = self._verify_points(
            Xnew, cur, new, uv1.cpu().numpy(), uv2.cpu().numpy())
        push_new_spatial_points(
            new.colors, Xnew, self.arena,
            cur.correspond, new.match_train, new.match_mask, new.correspond,
            new_point_ok=new_ok, propagate_ok=prop_ok,
        )
        if self.logs:
            timer.print_last_point_delta("Reconstruction: ", self.logs.time)
            timer.update_last_point()
        return True

    def _verify_points(self, Xnew, cur, new, uv1, uv2, gate_px: float = 8.0):
        """Map-hygiene gates (beyond the reference, which pushes unfiltered):
        a new landmark must reproject within ``gate_px`` in both frames with
        positive depth; an existing binding must reproject within
        2·``gate_px`` in the new frame to propagate."""

        def _reproj(R, t, X, uv):
            Xc = X @ R.T + t
            z = Xc[:, 2]
            pix = Xc @ self.K_host.T
            pix = (pix[:, :2] / np.maximum(np.abs(pix[:, 2:3]), 1e-9)
                   * np.sign(pix[:, 2:3] + (pix[:, 2:3] == 0)))
            return np.linalg.norm(pix - uv, axis=1), z

        e1, z1 = _reproj(cur.rotation, cur.motion, Xnew, uv1)
        e2, z2 = _reproj(new.rotation, new.motion, Xnew, uv2)
        new_ok = (e1 < gate_px) & (e2 < gate_px) & (z1 > 0) & (z2 > 0)

        bound = cur.correspond >= 0
        Xold = self.arena.points[np.where(bound, cur.correspond, 0)]
        e_old, z_old = _reproj(new.rotation, new.motion, Xold, uv2)
        prop_ok = (e_old < 2.0 * gate_px) & (z_old > 0)
        return new_ok, prop_ok

    def _ba_and_flush(self, processed: list[TemporalFrameData],
                      gd: GlobalData, timer):
        """Windowed BA (if enabled), then the poses move to the cycle's
        GlobalData (bundleAdjustment + moveProcessedDataToGlobalStruct,
        mainCycle.cpp:201-210, 318-338)."""
        if self.s.use_ba and self.ba_fn is not None and len(processed) >= 2:
            # the BA adjusts the shared intrinsics in place, as the
            # reference writes back into calibrationMatrix
            # (bundleAdjustment.cpp:176-181)
            new_K = self.ba_fn(self.K_host, processed, self.arena)
            if new_K is not None:
                self.K_host = np.asarray(new_K, np.float64)
                self.K = self._put(new_K)
            if self.logs:
                timer.print_last_point_delta("Bundle adjustment: ",
                                             self.logs.time)
                timer.update_last_point()
        for fd in processed:
            gd.append_cameras(fd.rotation[None], fd.motion[None],
                              [fd.frame_id])
        processed.clear()
