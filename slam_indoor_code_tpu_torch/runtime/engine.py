"""Host conductor for the device-resident runtime, classic per-window loop
with device ingest (counterpart of the JAX package's runtime/engine.py).

Python owns control flow and ring-slot bookkeeping; every tensor lives on
the device.  One ``advance_window`` call tracks up to a BA window of frames
and returns one small status tensor the host reads; ``ba_step`` then solves
and resets the window, its stats read at the next flush.  Ring-slot
management mirrors the reference's batch semantics (fill to
framesBatchSize, consume head..good, carry the tail).

Not ported yet (ROADMAP): host ingest and the streaming loop (both need
OpenCV on the host; the adaptive FAST threshold acts on host ingest only),
checkpoint/resume, global BA, meshes, per-frame telemetry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..io.logs import GlobalData, LogStreams
from ..utils.timer import ChronoTimer
from . import steps
from .state import EngineConfig, init_state

FRAME_NOT_FOUND = -2


def resolve_ingest(mode: str) -> str:
    """Resolve the ingest policy.  "auto" is "device": on a PCIe-attached
    GPU the full-gray upload is cheap, which is what the JAX package's
    bandwidth probe concludes there.  "host" needs the OpenCV host
    frontend, which is not ported yet."""
    if mode in ("auto", "device"):
        return "device"
    if mode == "host":
        raise NotImplementedError(
            "ingest='host' needs the OpenCV host frontend and the streaming "
            "loop, not ported yet (ROADMAP: host ingest and streaming)")
    raise ValueError(f"unknown ingest mode {mode!r}")


class DeviceEngine:
    def __init__(self, media, K: np.ndarray, cfg: EngineConfig,
                 batch_size: int, required_extracted: int,
                 logs: LogStreams | None = None, seed: int = 0,
                 dist: np.ndarray | None = None, device=None):
        self.device = resolve_device(device)
        self.media = media
        if cfg.mesh_shape:
            raise NotImplementedError("mesh_shape: distribution is not "
                                      "ported yet (ROADMAP)")
        if cfg.per_frame_telemetry:
            raise NotImplementedError("per_frame_telemetry is not ported yet")
        cfg = dataclasses.replace(cfg, ingest_mode=resolve_ingest(
            cfg.ingest_mode), host_desc="same")
        if cfg.rebind_cap > 0:
            # rebind_radius is given in FHD-equivalent pixels: resolve to
            # actual pixels (cx ≈ width/2), floored at 1.5 px
            px = cfg.rebind_radius * (2.0 * float(K[0, 2])) / 1920.0
            cfg = dataclasses.replace(cfg, rebind_radius=max(px, 1.5))
        scale_w = (2.0 * float(K[0, 2])) / 1920.0
        if scale_w > 1.0:
            cfg = dataclasses.replace(
                cfg, reproj_gate_px=cfg.reproj_gate_px * scale_w)
        self.cfg = cfg
        self.batch_size = batch_size
        self.required_extracted = required_extracted
        self.logs = logs
        self.state = init_state(K, cfg, dist=dist, device=self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self._free = list(range(cfg.ring))
        self.batch: list[int] = []      # ring slots in batch order (head first)
        self._staged: list = []         # packed chunks: (slots, n, gray, small)
        self._pending: list = []        # dispatched ingests: (slots, n, counts)
        self._media_over = False
        self._win_fill = 0
        self.trajectory_R: list[np.ndarray] = []
        self.trajectory_t: list[np.ndarray] = []
        self.frames_accepted = 0
        self._frame_counter = 0
        self._slot_frame: dict[int, int] = {}
        self._prev_fid = -1
        self._win_ids: list[int] = []
        self._ba_pending = None

    # ------------------------------------------------------------- plumbing
    def _log_pose(self, R: np.ndarray, t: np.ndarray):
        if self.logs:
            self.logs.write_pose(np.asarray(R, np.float64).reshape(3, 3),
                                 np.asarray(t, np.float64).reshape(3))

    @staticmethod
    def _unpack(out: np.ndarray):
        ok, n_corr, n_inl, n_new, n_matches = out[:5]
        R = out[5:14].reshape(3, 3)
        t = out[14:17]
        return (bool(ok > 0.5), int(n_corr), int(n_inl), int(n_new),
                int(n_matches), R, t)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # ------------------------------------------------------------------ fill
    def _stage_chunk(self) -> bool:
        """Decode and pack the next chunk and start its upload; reserves
        ring slots immediately.  Returns False when no frame was staged."""
        from ..models.frontend import pack_frames

        C = self.cfg.fill_chunk
        if self._media_over or len(self._free) < C:
            return False
        chunk = []
        while len(chunk) < C:
            f = self.media.next_frame()
            if f is None:
                self._media_over = True
                break
            chunk.append(f)
        if not chunk:
            return False
        n = len(chunk)
        chunk = chunk + [chunk[-1]] * (C - n)  # padded lanes land in slots
        slots = np.array(self._free[:C], np.int64)
        self._free = self._free[C:]
        for i in range(n):
            self._slot_frame[int(slots[i])] = self._frame_counter + i
        self._frame_counter += n
        gray, small = pack_frames(chunk, self.cfg.color_downscale)
        self._staged.append((slots, n, self._dev(gray), self._dev(small)))
        return True

    def _dispatch_ingest(self) -> bool:
        """Launch ingest for the oldest staged chunk; its corner counts are
        read later (``_collect_ingest``)."""
        if not self._staged:
            return False
        slots, n, gray, small = self._staged.pop(0)
        self.state, counts = steps.ingest(self.cfg, self.state, gray, small,
                                          self._dev(slots))
        self._pending.append((slots, n, counts))
        return True

    def _collect_ingest(self) -> bool:
        """Admit the oldest dispatched chunk's frames (reads its counts)."""
        if not self._pending:
            return False
        slots, n, counts = self._pending.pop(0)
        counts = counts.cpu().numpy()[:n]
        for i in range(n):
            if counts[i] >= self.required_extracted:
                self.batch.append(int(slots[i]))
            else:
                self._free.append(int(slots[i]))
        for s in slots[n:]:
            self._free.append(int(s))
        if self.logs:
            self.logs.main.write(
                "Features count in frames added to batch: "
                + " ".join(str(int(c)) for c in counts
                           if c >= self.required_extracted)
                + f"\nBatch size: {len(self.batch)}\n")
        return True

    def fill(self, target: int | None = None) -> None:
        t0 = ChronoTimer()
        filled = False
        # fill one BA window past framesBatchSize, so every scan step still
        # sees a full batch_size candidate window
        if target is None:
            target = self.batch_size + self.cfg.window
        while len(self.batch) < target:
            while len(self._staged) < 3 and self._stage_chunk():
                pass
            if not self._pending and not self._dispatch_ingest():
                break
            self._collect_ingest()
            filled = True
        while len(self._staged) < 3 and self._stage_chunk():
            pass
        if not self._pending:
            self._dispatch_ingest()
        if filled and self.logs:
            t0.print_start_delta("MS for batch's filling: ", self.logs.time)

    def _consume_through(self, pos: int) -> int:
        """Free ring slots head..pos, return the chosen slot."""
        chosen = self.batch[pos]
        for s in self.batch[: pos + 1]:
            if s != chosen:
                self._free.append(s)
        self.batch = self.batch[pos + 1:]
        return chosen

    def _release(self, slot: int) -> None:
        self._free.append(slot)

    # ------------------------------------------------------------ main cycle
    def _set_prev(self, slot, init_R, init_t):
        self._prev_fid = self._slot_frame.get(slot, -1)
        self.state = steps.set_prev_from_slot(
            self.cfg, self.state, slot,
            self._dev(np.asarray(init_R, np.float32)),
            self._dev(np.asarray(init_t, np.float32)))
        self._release(slot)

    def _find_first_good_frame(self, init_R, init_t) -> bool:
        while True:
            if self.batch:
                self._set_prev(self._consume_through(0), init_R, init_t)
                return True
            if self._pending:
                self._collect_ingest()
                continue
            if not self._staged and not self._stage_chunk():
                return False
            self._dispatch_ingest()
            self._collect_ingest()

    def _match_select(self):
        B = self.batch_size + max(self.cfg.fill_chunk, self.cfg.window)
        order = np.zeros(B, np.int64)
        mask = np.zeros(B, bool)
        n = min(len(self.batch), self.batch_size)
        order[:n] = self.batch[:n]
        mask[:n] = True
        train_all, mask_all, info, counts = steps.match_select(
            self.cfg, self.state, self._dev(order), self._dev(mask))
        info = info.cpu().numpy()
        if self.logs:
            cc = counts.cpu().numpy()[:n]
            for bi in range(n - 1, self.cfg.skip_from_head - 1, -1):
                self.logs.main.write(
                    f"Batch index: {bi}; matched {int(cc[bi])}\n")
        return train_all, mask_all, int(info[0]), int(info[1])

    def _bootstrap(self, init_R, init_t) -> bool:
        if not self._find_first_good_frame(init_R, init_t):
            return False
        while True:
            self.fill()
            if not self.batch:
                return False
            train_all, mask_all, found, pos = self._match_select()
            if not found:
                # promote the batch head to first frame
                self._set_prev(self._consume_through(0), init_R, init_t)
                continue
            slot = self._consume_through(pos)
            second_fid = self._slot_frame.get(slot, -1)
            self.state, out = steps.bootstrap_step(
                self.cfg, self.state, slot, train_all[pos], mask_all[pos],
                gen=self.gen)
            self._release(slot)
            out_np = out.cpu().numpy()
            ok, chir, n_pass, n_new, n_matches, R2, t2 = self._unpack(out_np)
            if self.logs:
                self.logs.main.write(
                    f"Points passed chirality check count: {chir}\n")
                if out_np[21] > 0:
                    self.logs.main.write(
                        f"Restart re-bind: {int(out_np[18])} landmarks "
                        f"shared with the retained map "
                        f"(radius-pass {int(out_np[19])}, ratio-pass "
                        f"{int(out_np[20])}, map {int(out_np[21])}); "
                        f"bootstrap baseline rescaled by {out_np[17]:.4f}\n")
            self._log_pose(np.asarray(init_R), np.asarray(init_t))
            self._log_pose(R2, t2)
            self.trajectory_R.extend([np.asarray(init_R, np.float64), R2])
            self.trajectory_t.extend([np.asarray(init_t, np.float64), t2])
            self._win_ids = [self._prev_fid, second_fid]
            self._prev_fid = second_fid
            self._win_fill = 2
            self.frames_accepted += 2
            return True

    def _log_append_ba(self, out: np.ndarray, fill: int, ids: list,
                       gd: GlobalData, timer: ChronoTimer):
        """Write one packed BA stats/poses vector's statistics lines and
        append the flushed (post-BA) cameras."""
        F = self.cfg.window
        cams = out[4:4 + F * 6].reshape(F, 6)
        Rmats = out[4 + F * 6:].reshape(F, 3, 3)
        if self.logs:
            self.logs.main.write(
                "Bundle Adjustment statistics (approximated RMSE):\n"
                f" #residuals: {int(out[2])}\n"
                f" Initial RMSE: {out[0]:.6f}\n"
                f" Final RMSE: {out[1]:.6f}\n")
            timer.print_last_point_delta("Bundle adjustment: ", self.logs.time)
            timer.update_last_point()
        for i in range(fill):
            fid = ids[i] if i < len(ids) else -1
            gd.append_cameras(Rmats[i][None], cams[i, 3:][None], [fid])

    def _collect_ba(self, gd: GlobalData, timer: ChronoTimer):
        """Read + log the previously launched ba_step."""
        if self._ba_pending is None:
            return
        out, fill, ids = self._ba_pending
        self._ba_pending = None
        self._log_append_ba(out.cpu().numpy().astype(np.float64), fill, ids,
                            gd, timer)

    def _flush_window(self, gd: GlobalData, timer: ChronoTimer):
        """BA (if enabled) then move the window's poses to the trajectory.
        The BA's stats are read at the next flush (or the end of the run)."""
        self._collect_ba(gd, timer)
        if self._win_fill == 0:
            return
        if self.cfg.use_ba and self._win_fill >= 2:
            self.state, out = steps.ba_step(self.cfg, self.state,
                                            self._win_fill)
            self._ba_pending = (out, self._win_fill, list(self._win_ids))
        else:
            for i, (R, t) in enumerate(zip(
                    self.trajectory_R[-self._win_fill:],
                    self.trajectory_t[-self._win_fill:])):
                fid = self._win_ids[i] if i < len(self._win_ids) else -1
                gd.append_cameras(np.asarray(R)[None], np.asarray(t)[None],
                                  [fid])
        self._win_fill = 0
        self._win_ids = []

    def run(self, init_R=None, init_t=None) -> dict:
        """Main loop: bootstrap, then window after window of
        ``advance_window`` + BA flush until the media is over or tracking
        is lost."""
        timer = ChronoTimer()
        init_R = np.eye(3) if init_R is None else init_R
        init_t = np.zeros(3) if init_t is None else init_t
        gd = GlobalData()
        self.trajectory_R, self.trajectory_t = [], []
        if not self._bootstrap(init_R, init_t):
            return {"status": "no_data", "global_data": gd,
                    "frames_accepted": 0, "last_pose": None}
        status = "interrupted"
        B = self.batch_size + max(self.cfg.fill_chunk, self.cfg.window)
        T = self.cfg.window
        while True:
            self.fill()
            if not self.batch:
                status = "video_over"
                break
            if self._win_fill >= self.cfg.window:
                self._flush_window(gd, timer)
            queue = np.zeros(B, np.int64)
            nq = min(len(self.batch), B)
            queue[:nq] = self.batch[:nq]
            t_adv = ChronoTimer()
            self.state, packed, _qh, _ql = steps.advance_window(
                self.cfg, self.state, self._dev(queue), 0, nq,
                self._win_fill, self.gen, T, visible=self.batch_size)
            packed = packed.cpu().numpy()
            # one call tracks the whole window, so its wall time is shared
            # equally over the steps that scanned (time.txt format parity)
            win_ms = t_adv.start_delta_ms()
            n_active = int((packed[:, 0] > 0.5).sum())
            share_ms = win_ms / max(n_active, 1)

            stop = None
            for tstep in range(T):
                row = packed[tstep]
                if row[0] < 0.5:
                    break
                if self.logs:
                    idx = int(row[2]) if row[1] > 0.5 else FRAME_NOT_FOUND
                    self.logs.time.write(
                        f"Matching time for index {idx} : {share_ms:.0f}\n")
                if row[1] < 0.5:
                    stop = "interrupted"
                    if self.logs:
                        self.logs.main.write(
                            "No good frames in batch. Interrupt video "
                            "processing\n")
                    break
                good = int(row[2])
                slot = self._consume_through(good)
                fid = self._slot_frame.get(slot, -1)
                self._release(slot)
                ok, n_corr, n_inl, n_new, n_matches, R, t = self._unpack(
                    row[4:21])
                if not ok:
                    stop = "interrupted"
                    if self.logs:
                        self.logs.main.write(
                            "Not enough corresponding points for solvePnP "
                            "RANSAC\n")
                    break
                if self.logs:
                    self.logs.main.write(
                        f"Batch index: {good}; matched {int(row[3])}\n"
                        f"Used in solvePnP: {n_corr}\n")
                self._log_pose(R, t)
                self.trajectory_R.append(R)
                self.trajectory_t.append(t)
                self._win_ids.append(fid)
                self._prev_fid = fid
                self._win_fill += 1
                self.frames_accepted += 1
            if stop is not None:
                status = stop
                break

        self._flush_window(gd, timer)
        self._collect_ba(gd, timer)
        last_pose = None
        if len(self.trajectory_R):
            last_pose = (self.trajectory_R[-1], self.trajectory_t[-1])
        return {"status": status, "global_data": gd,
                "frames_accepted": self.frames_accepted,
                "last_pose": last_pose}

    # ----------------------------------------------------------- final data
    def snapshot_map(self) -> tuple[np.ndarray, np.ndarray]:
        """One bulk read of the reconstructed map at the end of the run."""
        n = int(self.state.map_count)
        pts = self.state.map_points[:n].cpu().numpy().astype(np.float64)
        cols = np.clip(self.state.map_colors[:n].cpu().numpy(), 0,
                       255).astype(np.uint8)
        return pts, cols

    @property
    def media_exhausted(self) -> bool:
        return (self._media_over and not self.batch and not self._staged
                and not self._pending)
