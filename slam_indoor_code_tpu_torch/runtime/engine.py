"""Host conductor for the device-resident runtime (counterpart of the JAX
package's runtime/engine.py).

Python owns control flow and ring-slot bookkeeping; every tensor lives on
the device.  Two steady-state loops:

* **Streaming** (``run_streaming``; host-ingest configs with
  ``streaming``): the candidate queue and its cursors live on the device
  (``steps.queue_append`` / ``steps.advance_stream``, which also solves the
  windowed BA on the step that fills the window), and the host processes
  each call's status rows up to two calls late, from pinned copies that an
  event says have landed.
* **Classic** (device ingest, or streaming off): one ``advance_window``
  call tracks up to a BA window of frames and returns one small status
  tensor the host reads; ``ba_step`` then solves and resets the window,
  its stats read at the next flush.  With ``per_frame_telemetry`` each call
  tracks one frame, so time.txt's "Matching time for index N" lines are
  each one step's own wall time.

Frames are packed on three packer threads and their payloads uploaded
from there, in chunk order.  Under host ingest the packer detects on the
host (``frontend.host_detect_pack``) with the FAST threshold captured on
the main thread when the chunk is staged, and ``_adapt_threshold`` lowers
it on feature-sparse stretches.  Ring-slot management mirrors the
reference's batch semantics (fill to framesBatchSize, consume head..good,
carry the tail).

With ``collect_global_obs`` each flushed window's observations are kept
for the final global BA (app._global_refine); with ``checkpoint_path`` and
``checkpoint_every`` the engine snapshots itself at window boundaries
(runtime/checkpoint.py; the streaming loop drains every call in flight
first), and ``run(resume=True)`` continues a restored engine without a new
bootstrap.

With ``mesh_shape`` (n,) the engine builds an n-shard mesh
(parallel/mesh.py): n distinct cards on CUDA, n virtual shards on the CPU,
and under a process group the shards of every process.  It hands the mesh
to the step functions, which split ingest's chunk axis, the candidates of
every match (one ``top2_batch`` launch per shard) and the windowed BA's
observations over it; the state and the payload uploads stay on the first
device, and every process of a group holds the whole state.  Streaming is
off under a mesh, as in the JAX package.

Under host ingest the descriptor source follows ``host_desc``
(``resolve_host_desc``): "same" uploads the pooled gray for the device to
describe, "orb" uploads OpenCV-equal ORB bit words from the host and
matches them by Hamming, "hybrid" uploads both and joins pooled SIFT with
the α-weighted bits into one L2 descriptor.
"""

from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import resolve_device
from ..io.logs import GlobalData, LogStreams
from ..utils.timer import ChronoTimer
from . import steps
from .checkpoint import save_checkpoint
from .state import EngineConfig, init_state

FRAME_NOT_FOUND = -2

_LINK_BW_MBPS: dict = {}


def measured_link_bandwidth_mbps(device) -> float:
    """Host→device transfer rate in MB/s, measured once per process and
    device: a 4 MB random probe (random, so a compressing transport cannot
    flatter it) uploaded, reduced on the device and the sum read back."""
    device = torch.device(device)
    key = str(device)
    if key not in _LINK_BW_MBPS:
        rng = np.random.default_rng(0)
        warm = torch.from_numpy(rng.integers(0, 255, (1 << 20,), np.uint8))
        probe = torch.from_numpy(rng.integers(0, 255, (4 << 20,), np.uint8))
        int(warm.to(device).sum())
        t0 = time.perf_counter()
        int(probe.to(device).sum())
        dt = max(time.perf_counter() - t0, 1e-6)
        _LINK_BW_MBPS[key] = 4.0 / dt
    return _LINK_BW_MBPS[key]


def resolve_ingest(mode: str, device) -> str:
    """Resolve the ingest policy: "auto" detects on the host (upload the
    pooled gray and the keypoints) when the link to ``device`` runs below
    400 MB/s, and keeps the all-device frontend (upload the full gray)
    when it is PCIe-class, as on a card.  A CPU device has no link to
    cross: "device"."""
    if mode in ("device", "host"):
        return mode
    if mode == "auto":
        if torch.device(device).type == "cpu":
            return "device"
        return ("host" if measured_link_bandwidth_mbps(device) < 400.0
                else "device")
    raise ValueError(f"unknown ingest mode {mode!r}")


def resolve_host_desc(cfg: EngineConfig) -> EngineConfig:
    """The JAX engine's host-descriptor rules: "auto" is "hybrid" (SIFT) or
    "orb" (ORB) under host ingest and "same" under device ingest; device
    ingest always describes on the device ("same"); an ORB config takes
    "orb" for "hybrid"; "orb" matches by Hamming."""
    hd = cfg.host_desc
    if hd == "auto":
        if cfg.ingest_mode == "host":
            hd = "orb" if cfg.descriptor == "orb" else "hybrid"
        else:
            hd = "same"
    if cfg.ingest_mode != "host":
        hd = "same"
    if cfg.descriptor == "orb" and hd == "hybrid":
        hd = "orb"
    cfg = dataclasses.replace(cfg, host_desc=hd)
    if hd == "orb":
        cfg = dataclasses.replace(cfg, metric="hamming")
    return cfg


class _Download:
    """A device→host copy in flight: pinned host buffers filled with
    non-blocking copies on the calling thread's current stream (the
    engine's: each sequence of ``app.run_sequences_parallel`` runs on a
    stream of its own) and an event recorded after them on that same
    stream (on the CPU, the tensors themselves)."""

    def __init__(self, tensors):
        self._event = None
        if tensors[0].device.type == "cuda":
            stream = torch.cuda.current_stream(tensors[0].device)
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)
        else:
            self._host = list(tensors)

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class DeviceEngine:
    def __init__(self, media, K: np.ndarray, cfg: EngineConfig,
                 batch_size: int, required_extracted: int,
                 logs: LogStreams | None = None, seed: int = 0,
                 dist: np.ndarray | None = None, device=None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 0,
                 collect_global_obs: bool = False):
        self.device = resolve_device(device)
        self.media = media
        cfg = dataclasses.replace(cfg, ingest_mode=resolve_ingest(
            cfg.ingest_mode, self.device))
        cfg = resolve_host_desc(cfg)
        if cfg.ingest_mode == "host" and cfg.ingest_downscale > 1 \
                and 2.0 * float(K[0, 2]) < 1024.0:
            # pooling exists to cut FHD upload bytes; below ~1024 px width
            # the descriptor-fidelity loss dominates (cx ≈ width/2 proxy)
            cfg = dataclasses.replace(cfg, ingest_downscale=1)
        if cfg.rebind_cap > 0:
            # rebind_radius is given in FHD-equivalent pixels: resolve to
            # actual pixels (cx ≈ width/2), floored at 1.5 px
            px = cfg.rebind_radius * (2.0 * float(K[0, 2])) / 1920.0
            cfg = dataclasses.replace(cfg, rebind_radius=max(px, 1.5))
        scale_w = (2.0 * float(K[0, 2])) / 1920.0
        if scale_w > 1.0:
            cfg = dataclasses.replace(
                cfg, reproj_gate_px=cfg.reproj_gate_px * scale_w)
        # window <= 2 runs the classic loop: the bootstrap pair fills the
        # window, and advance_stream flushes only inside a step; per-frame
        # telemetry times each step, and a mesh splits the classic steps,
        # so neither streams
        self._will_stream = (cfg.streaming and cfg.ingest_mode == "host"
                             and cfg.window > 2
                             and not cfg.mesh_shape
                             and not cfg.per_frame_telemetry)
        if self._will_stream:
            # slots free only when their call's rows are processed, up to
            # two calls late: ring headroom beyond the classic bound
            cfg = dataclasses.replace(cfg, ring=cfg.ring + 24)
        self.cfg = cfg
        self.mesh = self._make_mesh(cfg.mesh_shape)
        self.batch_size = batch_size
        self.required_extracted = required_extracted
        self.logs = logs
        self.state = init_state(K, cfg, dist=dist, device=self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self._free = list(range(cfg.ring))
        self.batch: list[int] = []      # ring slots in batch order (head first)
        self._staged: list = []         # packer futures of (slots, n, payload)
        self._pending: list = []        # dispatched ingests: (slots, n, counts)
        # three packer threads: a chunk packs (numpy releases the GIL) while
        # two earlier chunks upload; futures pop FIFO, so chunk order holds
        self._packer = ThreadPoolExecutor(max_workers=3)
        # the stream the engine's kernels run on: uploads from the packer
        # threads go into it
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
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
        # the live host FAST threshold (host ingest; _adapt_threshold).
        # Chunks capture it when staged, on the main thread, so which chunk
        # gets which threshold follows the collected counts only; the
        # checkpoint keeps it (v5)
        self._fast_threshold = float(cfg.threshold)
        self._fast_floor = max(5.0, float(cfg.threshold) / 4.0)
        # periodic snapshots at window boundaries, every `checkpoint_every`
        # accepted frames
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self._last_checkpoint_at = 0
        # final global BA: each flushed window's (xy, corr, frame ids)
        self.collect_global_obs = collect_global_obs
        self._global_obs: list = []
        # the flushed (post-BA) trajectory over the engine's life: what a
        # checkpoint keeps so a resumed run re-emits the whole trajectory
        self.flushed_R: list = []
        self.flushed_t: list = []
        self.flushed_ids: list = []
        # streaming cursors (run_streaming): the queue and its cursors stay
        # on the device; q_len reaches the host only in the status rows
        self._q_dev = None            # [ring] slot queue
        self._qhead_dev = None
        self._qlen_dev = None
        self._winfill_dev = None
        self._dead_dev = None
        self._inflight: list = []     # _Download of each call's outputs
        self._adm_total = 0           # frames appended to the device queue
        self._cons_known = 0          # frames consumed per processed rows
        self._stream_depth = 2        # most uncollected advance_stream calls
        # statistics: advance_stream calls, the scan steps they ran and the
        # bootstrap's match_select calls (one top2_batch launch each)
        self.stream_calls = 0
        self.stream_steps = 0
        self.match_select_calls = 0

    # ------------------------------------------------------------- plumbing
    def _make_mesh(self, mesh_shape):
        """The engine's one-axis mesh of prod(mesh_shape) shards (None for
        ``()``): on CUDA the cards from the engine's own on, raising when
        there are fewer than the mesh needs; on the CPU, virtual shards."""
        if not mesh_shape:
            return None
        from ..parallel.mesh import make_mesh

        n = math.prod(mesh_shape)
        if self.device.type == "cuda":
            first = (self.device.index if self.device.index is not None
                     else torch.cuda.current_device())
            devices = [torch.device("cuda", i)
                       for i in range(first, torch.cuda.device_count())]
        else:
            devices = [self.device] * n
        return make_mesh((n,), ("batch",), devices=devices)

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
    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Upload from a packer thread into the engine's stream: pinned, so
        the copy is asynchronous and the buffer is held until it lands."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._stream is None:
            return t.to(self.device)
        with torch.cuda.stream(self._stream):
            return t.pin_memory().to(self.device, non_blocking=True)

    def _stage_chunk(self) -> bool:
        """Read the next chunk and hand its packing and upload to a packer
        thread; reserves ring slots immediately.  Returns False when no
        frame was staged."""
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
        thr = self._fast_threshold     # captured here, on the main thread

        def pack_and_put():
            from ..models.frontend import host_detect_pack, pack_frames

            if self.cfg.ingest_mode == "host":
                hd = self.cfg.host_desc
                p = host_detect_pack(chunk, thr, self.cfg.max_keypoints,
                                     self.cfg.ingest_downscale, host_desc=hd)
                if hd == "orb":
                    # the bit words alone: no image plane travels.  The
                    # int32 view of the bytes (little-endian words, as the
                    # JAX package's uint32 view and ops/orb.py's packing)
                    head = (self._put(p["desc_bits"].view(np.int32)),)
                elif hd == "hybrid":
                    head = (self._put(p["gray_small"]),
                            self._put(p["desc_bits"]))
                else:
                    head = (self._put(p["gray_small"]),)
                return slots, n, head + (
                    self._put(p["xy"]), self._put(p["valid"]),
                    self._put(p["colors"]), p["counts"])
            gray, small = pack_frames(chunk, self.cfg.color_downscale)
            return slots, n, (self._put(gray), self._put(small))

        self._staged.append(self._packer.submit(pack_and_put))
        return True

    def _dispatch_host_payload(self, slots, payload) -> np.ndarray:
        """Dispatch the device half of a host-ingest chunk (the payload of
        ``_stage_chunk``: the ``host_desc`` arrays, then xy, valid, colours
        and the counts); returns its host-side corner counts."""
        *head, xy, valid, colors, counts = payload
        ingest = {"orb": steps.ingest_host_desc,
                  "hybrid": steps.ingest_host_hybrid,
                  "same": steps.ingest_host}[self.cfg.host_desc]
        self.state = ingest(self.cfg, self.state, *head, xy, valid, colors,
                            self._dev(slots), self.mesh)
        return counts

    def _dispatch_ingest(self) -> bool:
        """Launch ingest for the oldest staged chunk; its corner counts are
        read later (``_collect_ingest``; host ingest has them on the host)."""
        if not self._staged:
            return False
        slots, n, payload = self._staged.pop(0).result()
        if self.cfg.ingest_mode == "host":
            counts = self._dispatch_host_payload(slots, payload)
        else:
            gray, small = payload
            self.state, counts = steps.ingest(self.cfg, self.state, gray,
                                              small, self._dev(slots),
                                              self.mesh)
        self._pending.append((slots, n, counts))
        return True

    def _collect_ingest(self) -> bool:
        """Admit the oldest dispatched chunk's frames (reads its counts)."""
        if not self._pending:
            return False
        slots, n, counts = self._pending.pop(0)
        if isinstance(counts, torch.Tensor):
            counts = counts.cpu().numpy()
        counts = np.asarray(counts)[:n]
        self._adapt_threshold(counts)
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

    def _adapt_threshold(self, counts: np.ndarray) -> None:
        """Adaptive extraction gate (host ingest): when a chunk's post-NMS
        corner counts sag below ``required_extracted``, lower the FAST
        threshold for later chunks (by 3/4, down to the floor of 1/4 of the
        configured value); raise it back, never above the configured value,
        once the median is above 4× the requirement.  Every change is logged
        to main.txt; a healthy scene trips neither edge."""
        if (not self.cfg.adaptive_threshold or self.cfg.ingest_mode != "host"
                or len(counts) == 0):
            return
        med = float(np.median(counts))
        thr = self._fast_threshold
        if med < self.required_extracted and thr > self._fast_floor:
            new = max(self._fast_floor, round(thr * 0.75))
        elif (med > 4.0 * self.required_extracted
              and thr < self.cfg.threshold):
            new = min(float(self.cfg.threshold), round(thr / 0.75))
        else:
            return
        if new == thr:
            return
        self._fast_threshold = new
        if self.logs:
            self.logs.main.write(
                f"Adaptive FAST threshold: {thr:g} -> {new:g} "
                f"(median corners {med:g} vs required "
                f"{self.required_extracted})\n")

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
            self.cfg, self.state, self._dev(order), self._dev(mask),
            self.mesh)
        self.match_select_calls += 1
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
        # streaming: the first-pair search scans one reference batch; the
        # steady loop tops the queue up while the bootstrap math runs
        boot_target = self.batch_size if self._will_stream else None
        while True:
            self.fill(target=boot_target)
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
            self.flushed_R.append(Rmats[i])
            self.flushed_t.append(cams[i, 3:])
            self.flushed_ids.append(fid)

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
        if self.collect_global_obs:
            # copies: the scan steps write the window rows in place
            fill = self._win_fill
            self._global_obs.append((self.state.win_xy[:fill].clone(),
                                     self.state.win_corr[:fill].clone(),
                                     list(self._win_ids)))
        if self.cfg.use_ba and self._win_fill >= 2:
            self.state, out = steps.ba_step(self.cfg, self.state,
                                            self._win_fill, self.mesh)
            self._ba_pending = (out, self._win_fill, list(self._win_ids))
        else:
            for i, (R, t) in enumerate(zip(
                    self.trajectory_R[-self._win_fill:],
                    self.trajectory_t[-self._win_fill:])):
                fid = self._win_ids[i] if i < len(self._win_ids) else -1
                gd.append_cameras(np.asarray(R)[None], np.asarray(t)[None],
                                  [fid])
                self.flushed_R.append(np.asarray(R, np.float64))
                self.flushed_t.append(np.asarray(t, np.float64))
                self.flushed_ids.append(fid)
        self._win_fill = 0
        self._win_ids = []

    def _maybe_checkpoint(self, gd: GlobalData, timer: ChronoTimer):
        """Snapshot at a window boundary (right after a flush: the window is
        empty and consumption stands at a clean frame-id cursor).  The
        flushed window's BA is collected first, so the snapshot's flushed
        trajectory covers every accepted frame."""
        if (self.checkpoint_path and self.checkpoint_every > 0
                and self.frames_accepted - self._last_checkpoint_at
                >= self.checkpoint_every):
            self._collect_ba(gd, timer)
            save_checkpoint(self.checkpoint_path, self)
            self._last_checkpoint_at = self.frames_accepted
            if self.logs:
                self.logs.main.write(
                    f"Checkpoint saved at {self.frames_accepted} frames\n")

    # ------------------------------------------------------ streaming loop
    def _dispatch_stream_ingest(self, force: bool = False) -> bool:
        """Pop the oldest staged chunk once its pack is done (or wait for it
        with ``force``), dispatch its ingest and the device-queue append,
        and admit its frames on the host (host ingest counts on the host)."""
        if not self._staged:
            return False
        if not force and not self._staged[0].done():
            return False
        t0 = ChronoTimer()
        slots, n, payload = self._staged.pop(0).result()
        counts = np.asarray(self._dispatch_host_payload(slots, payload))
        C = len(slots)
        admit = np.zeros(C, bool)
        admit[:n] = counts[:n] >= self.required_extracted
        self._q_dev, self._qlen_dev = steps.queue_append(
            self._q_dev, self._qhead_dev, self._qlen_dev, self._dev(slots),
            self._dev(admit))
        for i in range(C):
            s = int(slots[i])
            if admit[i]:
                self.batch.append(s)
                self._adm_total += 1
            else:
                self._free.append(s)
        if self.logs:
            self.logs.main.write(
                "Features count in frames added to batch: "
                + " ".join(str(int(c)) for c in counts[:n]
                           if c >= self.required_extracted)
                + f"\nBatch size: {len(self.batch)}\n")
            t0.print_start_delta("MS for batch's filling: ", self.logs.time)
        return True

    def _fill_streaming(self) -> bool:
        """Stage chunks within the admission budget and dispatch the oldest
        whose pack is done.  Staged plus admitted frames may run (batch_size
        + T) + T·depth + 3·chunk ahead of the processed consumption: the
        dispatch rule needs batch_size + T queued beyond the T·depth frames
        the calls in flight may consume, and up to three chunks sit staged.
        Beyond that staging stops, so an interrupt wastes little upload and a
        snapshot does not lag the media cursor by dozens of frames."""
        progressed = False
        T = self.cfg.window
        C = self.cfg.fill_chunk
        lookahead = (self._adm_total - self._cons_known
                     + C * len(self._staged))
        limit = (self.batch_size + T) + T * self._stream_depth + 3 * C
        while (lookahead < limit and len(self._staged) < 3
               and self._stage_chunk()):
            progressed = True
            lookahead += C
        if self._dispatch_stream_ingest():
            progressed = True
        return progressed

    def _init_device_queue(self) -> None:
        """The host batch mirror becomes the device queue (after each
        bootstrap; later admissions go through queue_append)."""
        q = np.zeros(self.cfg.ring, np.int64)
        q[: len(self.batch)] = self.batch
        self._q_dev = self._dev(q)
        self._qhead_dev = self._dev(np.int64(0))
        self._qlen_dev = self._dev(np.int64(len(self.batch)))
        self._winfill_dev = self._dev(np.int64(self._win_fill))
        self._dead_dev = self._dev(np.bool_(False))
        self._adm_total = len(self.batch)
        self._cons_known = 0
        self._inflight = []

    def _dispatch_advance_stream(self, tail: bool = False) -> None:
        (self.state, self._qhead_dev, self._qlen_dev, self._winfill_dev,
         self._dead_dev, packed, ba_vec, obs_xy, obs_corr) = \
            steps.advance_stream(
                self.cfg, self.state, self._q_dev, self._qhead_dev,
                self._qlen_dev, self._winfill_dev, self._dead_dev, self.gen,
                self.cfg.window, visible=self.batch_size,
                collect_obs=self.collect_global_obs, tail=tail)
        self._inflight.append(_Download((packed, ba_vec, obs_xy, obs_corr)))
        self.stream_calls += 1

    def _finalize_stream_window(self, ba_vec, obs, gd: GlobalData,
                                timer: ChronoTimer):
        """One in-scan window flush: BA stats lines and the flushed
        (post-BA) cameras of the F frames at the head of ``_win_ids``."""
        F = self.cfg.window
        ids = list(self._win_ids[:F])
        if self.collect_global_obs and obs is not None:
            self._global_obs.append((torch.from_numpy(obs[0]),
                                     torch.from_numpy(obs[1]), ids))
        if self.cfg.use_ba:
            self._log_append_ba(np.asarray(ba_vec, np.float64), F, ids, gd,
                                timer)
        else:
            for i, (R, t) in enumerate(zip(self.trajectory_R[-F:],
                                           self.trajectory_t[-F:])):
                fid = ids[i] if i < len(ids) else -1
                gd.append_cameras(np.asarray(R)[None], np.asarray(t)[None],
                                  [fid])
                self.flushed_R.append(np.asarray(R, np.float64))
                self.flushed_t.append(np.asarray(t, np.float64))
                self.flushed_ids.append(fid)
        self._win_ids = self._win_ids[F:]

    def _collect_process(self, gd: GlobalData, timer: ChronoTimer):
        """Collect the oldest call in flight and process its status rows
        (trajectory, logs, window flushes, slot frees).  Returns a stop
        status, or None to go on."""
        if not self._inflight:
            return None
        packed, ba_vec, obs_xy, obs_corr = self._inflight.pop(0).result()
        T = packed.shape[0]
        win_ms = 0.0
        n_active = int((packed[:, 0] > 0.5).sum())
        self.stream_steps += n_active
        if self.logs and n_active:
            # one call tracks several frames: its collect interval is
            # shared equally over the steps that scanned (time.txt format)
            win_ms = timer.last_point_delta_ms() / max(n_active, 1)
            timer.update_last_point()
        obs = (obs_xy, obs_corr) if (self.collect_global_obs
                                     and obs_xy.size) else None
        for t in range(T):
            row = packed[t]
            if row[0] < 0.5:          # idle: queue below the floor, or dead
                break
            if self.logs:
                idx = int(row[2]) if row[1] > 0.5 else FRAME_NOT_FOUND
                self.logs.time.write(
                    f"Matching time for index {idx} : {win_ms:.0f}\n")
            if row[1] < 0.5:
                if self.logs:
                    self.logs.main.write(
                        "No good frames in batch. Interrupt video "
                        "processing\n")
                return "interrupted"
            good = int(row[2])
            if self.logs and good > 0:
                # head candidates with fewer matches than the chosen frame
                # are consumed unused (batch.cpp:93-98)
                for i in range(good):
                    sfid = self._slot_frame.get(self.batch[i], -1)
                    if self.cfg.use_first_fit:
                        why = (f"matched {int(row[24 + i])}; first-fit rule "
                               f"chose index {good}")
                    else:
                        why = (f"matched {int(row[24 + i])} < best "
                               f"{int(row[3])} at index {good}")
                    self.logs.main.write(
                        f"Skipped candidate at batch index {i} (frame "
                        f"{sfid}): {why}\n")
            slot = self._consume_through(good)
            fid = self._slot_frame.get(slot, -1)
            self._release(slot)
            self._cons_known += good + 1
            ok, n_corr, n_inl, n_new, n_matches, R, tv = self._unpack(
                row[4:21])
            if not ok:
                if self.logs:
                    self.logs.main.write(
                        "Not enough corresponding points for solvePnP "
                        "RANSAC\n")
                return "interrupted"
            if self.logs:
                self.logs.main.write(
                    f"Batch index: {good}; matched {int(row[3])}\n"
                    f"Used in solvePnP: {n_corr}\n")
            self._log_pose(R, tv)
            self.trajectory_R.append(R)
            self.trajectory_t.append(tv)
            self._win_ids.append(fid)
            self._prev_fid = fid
            self._win_fill = int(row[21])
            self.frames_accepted += 1
            if row[23] > 0.5:         # the window flushed on this step
                self._finalize_stream_window(ba_vec, obs, gd, timer)
        return None

    def _maybe_stream_checkpoint(self, gd: GlobalData, timer: ChronoTimer):
        """A snapshot in the streaming loop: drain every call in flight, so
        the host knows what the device did, then save (any drained point
        resumes: the media re-pulls everything not consumed).  Returns a stop
        status met while draining, else None."""
        if not (self.checkpoint_path and self.checkpoint_every > 0
                and self.frames_accepted - self._last_checkpoint_at
                >= self.checkpoint_every):
            return None
        while self._inflight:
            s = self._collect_process(gd, timer)
            if s is not None:
                return s
        save_checkpoint(self.checkpoint_path, self)
        self._last_checkpoint_at = self.frames_accepted
        if self.logs:
            self.logs.main.write(
                f"Checkpoint saved at {self.frames_accepted} frames\n")
        return None

    def run_streaming(self, init_R=None, init_t=None,
                      resume: bool = False) -> dict:
        """Streaming main loop: bootstrap, hand the queue to the device,
        then dispatch ``advance_stream`` whenever batch_size + T frames are
        surely queued beyond what the calls in flight may consume (or, at
        the tail, any), collecting each call's rows up to two calls late."""
        timer = ChronoTimer()
        init_R = np.eye(3) if init_R is None else init_R
        init_t = np.zeros(3) if init_t is None else init_t
        gd = GlobalData()
        if not (resume and self.frames_accepted > 0):
            self.trajectory_R, self.trajectory_t = [], []
            if not self._bootstrap(init_R, init_t):
                return {"status": "no_data", "global_data": gd,
                        "frames_accepted": 0, "last_pose": None}
        # settle the bootstrap's classic prefetches, then hand the queue
        # to the device
        while self._staged or self._pending:
            if not self._pending:
                self._dispatch_ingest()
            self._collect_ingest()
        self._init_device_queue()
        T = self.cfg.window
        need = self.batch_size + T
        status = None
        while status is None:
            while (status is None and self._inflight
                   and self._inflight[0].done()):
                status = self._collect_process(gd, timer)
            if status is not None:
                break
            status = self._maybe_stream_checkpoint(gd, timer)
            if status is not None:
                break
            self._fill_streaming()
            q_min = (self._adm_total - self._cons_known
                     - T * len(self._inflight))
            tail_ok = (self._media_over and not self._staged
                       and not self._pending and q_min > 0)
            if q_min >= need or tail_ok:
                self._dispatch_advance_stream(tail=tail_ok)
                if len(self._inflight) > self._stream_depth:
                    status = self._collect_process(gd, timer)
                continue
            if self._inflight:
                status = self._collect_process(gd, timer)
                continue
            if self._staged:
                self._dispatch_stream_ingest(force=True)
                continue
            if self._media_over:
                status = "video_over"
                break
            # nothing staged, in flight or consumable and the media not
            # over: the ring is full (cannot happen with the sized ring)
            status = "interrupted"
        # drain the calls in flight (their rows may hold accepted frames
        # and flushes issued before the stop)
        while self._inflight:
            s2 = self._collect_process(gd, timer)
            status = s2 if status in (None, "video_over") and s2 else status
        # the last partial window flushes through the classic path
        self._flush_window(gd, timer)
        self._collect_ba(gd, timer)
        last_pose = None
        if len(self.trajectory_R):
            last_pose = (self.trajectory_R[-1], self.trajectory_t[-1])
        return {"status": status or "video_over", "global_data": gd,
                "frames_accepted": self.frames_accepted,
                "last_pose": last_pose}

    # ------------------------------------------------------- classic loop
    def run(self, init_R=None, init_t=None, resume: bool = False) -> dict:
        """Main loop: bootstrap, then window after window of
        ``advance_window`` + BA flush until the media is over or tracking
        is lost; host-ingest configs with ``streaming`` go to
        ``run_streaming``.  ``resume=True`` continues a ``load_checkpoint``ed
        engine: the bootstrap is skipped (the restored previous frame and
        pose anchor tracking) and the restored trajectory is kept."""
        if self._will_stream:
            return self.run_streaming(init_R, init_t, resume)
        timer = ChronoTimer()
        init_R = np.eye(3) if init_R is None else init_R
        init_t = np.zeros(3) if init_t is None else init_t
        gd = GlobalData()
        if not (resume and self.frames_accepted > 0):
            self.trajectory_R, self.trajectory_t = [], []
            if not self._bootstrap(init_R, init_t):
                return {"status": "no_data", "global_data": gd,
                        "frames_accepted": 0, "last_pose": None}
        status = "interrupted"
        B = self.batch_size + max(self.cfg.fill_chunk, self.cfg.window)
        # per-frame telemetry runs one step per call, so each "Matching time
        # for index N" line below is that step's own wall time
        T = 1 if self.cfg.per_frame_telemetry else self.cfg.window
        while True:
            self.fill()
            if not self.batch:
                status = "video_over"
                break
            if self._win_fill >= self.cfg.window:
                self._flush_window(gd, timer)
                self._maybe_checkpoint(gd, timer)
            queue = np.zeros(B, np.int64)
            nq = min(len(self.batch), B)
            queue[:nq] = self.batch[:nq]
            t_adv = ChronoTimer()
            self.state, packed, _qh, _ql = steps.advance_window(
                self.cfg, self.state, self._dev(queue), 0, nq,
                self._win_fill, self.gen, T, visible=self.batch_size,
                mesh=self.mesh)
            packed = packed.cpu().numpy()
            # one call tracks up to T steps, so its wall time is shared
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

    def global_observations(self):
        """Every flushed window's (xy [f,K,2], corr [f,K], frame ids) on the
        host: the observation record of the final global BA."""
        return [(xy.cpu().numpy(), corr.cpu().numpy(), ids)
                for xy, corr, ids in self._global_obs]

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
