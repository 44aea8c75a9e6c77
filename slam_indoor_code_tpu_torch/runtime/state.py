"""Device-resident tracker state: one object holding the whole pipeline
(counterpart of the JAX package's runtime/state.py).

Fixed capacities (EngineConfig) make every tensor static-shape:
  K  keypoint slots per frame          R  candidate-ring slots
  P  map-arena landmark capacity       F  BA window frames
``EngineConfig`` has the same fields and the same ``from_config`` as the JAX
package's, so one JSON config drives both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.ransac import ransac_fanout


@dataclass(frozen=True)
class EngineConfig:
    """Static (hashable, shape-defining) runtime parameters.  One compile per
    distinct config — every threshold that could stay dynamic is folded in
    here for simplicity; re-jit on config change is the intended behaviour."""

    # shapes
    max_keypoints: int = 2048
    ring: int = 40               # candidate ring slots ≥ framesBatchSize + chunk
    map_cap: int = 1 << 18
    window: int = 8              # BAMaxFramesCnt
    window_points: int = 1 << 14
    fill_chunk: int = 8
    # frontend
    threshold: float = 20.0
    descriptor: str = "sift"
    ratio: float = 0.7
    metric: str = "l2"
    descriptor_downscale: int = 1
    sift_nearest: str = "auto"   # SIFT cell-sample interpolation (ops/sift.py)
    color_downscale: int = 4     # landmark-color plane at 1/d resolution
    # ingest policy: "device" = upload full gray, detect+describe on device;
    # "host" = OpenCV FAST on host, upload pooled gray + keypoints (the
    # slow-link path — see frontend.host_detect_pack); "auto" resolves by
    # measured link bandwidth at engine construction (engine.resolve_ingest)
    ingest_mode: str = "device"
    ingest_downscale: int = 2    # host-mode pooled-gray factor
    # host-mode descriptor source: "same" (device describes from the pooled
    # gray), "orb" (full-res cv2 ORB on host, Hamming matching, ~90 KB/frame
    # upload), "hybrid" (pooled-SIFT ⊕ α·orb-bits as one L2 descriptor).
    # Resolved from TpuConfig.host_descriptor="auto" by the engine.
    host_desc: str = "same"
    hybrid_alpha: float = 0.08   # weight of the bit block in hybrid L2
    # multi-chip: () = single device; (n,) shards the ingest/match fan-out
    # and the BA observation axis over an n-device "batch" mesh (steps.py
    # mesh hooks); the engine builds the Mesh and registers it
    mesh_shape: tuple = ()
    # streaming runtime (engine.run_streaming): device-held candidate queue +
    # in-scan BA flush; host trails the device by 1-2 dispatches
    streaming: bool = True
    # per-frame telemetry: classic loop with ONE-step dispatches so every
    # "Matching time for index N" line in time.txt is a true wall-clock
    # measurement of that step (batch.cpp:155-157 parity); costs the
    # per-dispatch sync the fused loops exist to avoid — a measurement mode
    per_frame_telemetry: bool = False
    # host-ingest adaptive extraction gate (engine._adapt_threshold):
    # lower the host FAST threshold when chunk corner counts sag below
    # required_extracted, bounded + logged; no-op on healthy scenes
    adaptive_threshold: bool = True
    # scheduler rule
    required_matched: int = 100
    skip_from_head: int = 0
    use_first_fit: bool = False
    # near-tie head preference (steps._select_good): 0.0 = strict reference
    # max-matches rule; e.g. 0.005 accepts the head when it is within 0.5%
    # of the best count (documented divergence knob — recovers the audited
    # near-tie skips for callers that want every camera)
    head_tie_tolerance: float = 0.0
    # geometry
    use_undistortion: bool = False
    use_ransac: bool = True
    ransac_threshold: float = 1.0
    distance_threshold: float = 50.0
    ransac_iters: int = 1024
    pnp_iters: int = 256
    reproj_gate_px: float = 8.0
    # BA
    # map re-binding (anti-drift): each tracked frame matches its unbound
    # features against the last `rebind_cap` landmarks by projected position
    # (< rebind_radius px under the PnP pose) + descriptor ratio test, and
    # re-binds instead of triangulating duplicates.  PnP then anchors on
    # older geometry, damping monocular scale drift across BA windows.
    # 0 disables (reference behaviour: bindings only propagate frame-to-frame)
    rebind_cap: int = 4096
    # NB: in EngineConfig as consumed by steps this is ACTUAL pixels;
    # DeviceEngine.__init__ resolves the config-level FHD-equivalent value
    # (TpuConfig.rebind_radius) to actual px using the calibration.
    rebind_radius: float = 12.0
    # restart-boundary re-binding (steps.bootstrap_step): at a track-loss
    # restart, match the new first frame against the RETAINED map and (a)
    # rescale the bootstrap baseline so the new sub-map's monocular scale
    # agrees with the old one (|t|=1 re-seeding teleports the concatenated
    # trajectory — measured 43-unit jumps at 384-frame restart boundaries),
    # (b) share the matched landmarks across the sub-map boundary.  Needs
    # rebind_cap > 0; no reference counterpart (src/main.cpp:89-101 carries
    # only the pose)
    restart_rebind: bool = True
    # pose-jump gate (steps._track_core): reject a PnP pose whose camera
    # center moved more than this factor times the EMA of accepted step
    # lengths (0 = off).  A catastrophic-but-consensused PnP solution
    # otherwise teleports the camera and corrupts the whole tail (measured:
    # a 43-unit accepted jump vs 0.25-unit true steps on the 384-frame
    # corridor).  The factor is far above any legitimate skip span (the
    # scheduler consumes at most a batch of candidates per accept).
    pose_jump_gate: float = 32.0
    use_ba: bool = False
    ba_loss: str = "huber"
    ba_loss_param: float = 1.0
    ba_iters: int = 25
    ba_obs_cap: int = 4096
    ba_adjust_intrinsics: bool = False
    ba_freeze_old: bool = False
    anchored_tri: bool = True
    parallax_min_deg: float = 1.0

    @property
    def desc_dim(self) -> int:
        if self.host_desc == "orb" or self.descriptor == "orb":
            return 8                      # 256 bits as uint32 words
        if self.host_desc == "hybrid":
            return 128 + 256              # pooled-SIFT ⊕ α·orb bits
        return 128

    @property
    def desc_dtype(self):
        # ORB bit words are held as an int32 view (torch has no uint32 >>)
        if self.host_desc == "orb" or self.descriptor == "orb":
            return torch.int32
        return torch.float32

    @staticmethod
    def from_config(cfg) -> "EngineConfig":
        loss, param = cfg.ba_loss
        return EngineConfig(
            max_keypoints=cfg.tpu.max_keypoints,
            # ring holds the live batch plus up to two staged (in-flight
            # upload) chunks plus the admit scratch chunk (the engine adds
            # streaming-lag headroom on top when the streaming loop will
            # actually run — DeviceEngine.__init__)
            ring=cfg.framesBatchSize + cfg.BAMaxFramesCnt + 24,
            streaming=cfg.tpu.streaming,
            per_frame_telemetry=cfg.tpu.per_frame_telemetry,
            map_cap=cfg.tpu.max_map_points,
            window=cfg.BAMaxFramesCnt,
            window_points=cfg.tpu.window_points,
            threshold=float(cfg.featureExtractingThreshold),
            descriptor=cfg.descriptor_kind,
            ratio=float(cfg.knnMatcherDistance),
            metric=cfg.match_metric,
            descriptor_downscale=cfg.tpu.descriptor_downscale,
            sift_nearest=cfg.tpu.sift_nearest_sampling,
            adaptive_threshold=cfg.tpu.adaptive_fast_threshold,
            ingest_mode=cfg.tpu.ingest,
            ingest_downscale=cfg.tpu.ingest_downscale,
            host_desc=cfg.tpu.host_descriptor,
            hybrid_alpha=float(cfg.tpu.hybrid_alpha),
            mesh_shape=tuple(cfg.tpu.mesh_shape),
            rebind_cap=cfg.tpu.rebind_cap,
            rebind_radius=float(cfg.tpu.rebind_radius),
            restart_rebind=cfg.tpu.restart_rebind,
            pose_jump_gate=float(cfg.tpu.pose_jump_gate),
            use_undistortion=cfg.useUndistortion,
            required_matched=cfg.requiredMatchedPointsCount,
            skip_from_head=cfg.skipFramesFromBatchHead,
            use_first_fit=cfg.useFirstFitInBatch,
            head_tie_tolerance=float(cfg.tpu.head_tie_tolerance),
            use_ransac=cfg.RPUseRANSAC,
            ransac_threshold=float(cfg.RPRANSACThreshold),
            distance_threshold=float(cfg.RPDistanceThreshold),
            # fan-out statistically matched to RPRANSACProb (the reference's
            # findEssentialMat confidence), capped by the tpu.* compute budget
            ransac_iters=ransac_fanout(cfg.RPRANSACProb, 8,
                                       cfg.tpu.ransac_iters),
            pnp_iters=ransac_fanout(cfg.RPRANSACProb, 6,
                                    cfg.tpu.pnp_ransac_iters),
            use_ba=cfg.useBundleAdjustment,
            ba_loss=loss,
            ba_loss_param=float(param),
            ba_iters=cfg.tpu.ba_max_iters,
            ba_adjust_intrinsics=cfg.tpu.ba_adjust_intrinsics,
            ba_freeze_old=cfg.tpu.ba_freeze_old,
            anchored_tri=cfg.tpu.anchored_triangulation,
            parallax_min_deg=float(cfg.tpu.parallax_min_deg),
        )


@dataclass
class TrackerState:
    """All pipeline state, as tensors on one device (same fields as the JAX
    package's TrackerState; counters are 0-dim int64 tensors, keypoint and
    landmark ids int64).  The step functions update it in place where the
    JAX package donated its buffers."""

    K4: torch.Tensor              # [4] fx, fy, cx, cy
    dist: torch.Tensor            # [5] OpenCV distortion coeffs
    map_points: torch.Tensor      # [P,3] f32
    map_colors: torch.Tensor      # [P,3] f32 (0-255)
    map_desc: torch.Tensor        # [P,D] landmark descriptor
    map_count: torch.Tensor       # () i64
    prev_xy: torch.Tensor         # [K,2]
    prev_valid: torch.Tensor      # [K] bool
    prev_desc: torch.Tensor       # [K,D]
    prev_corr: torch.Tensor       # [K] i64 (-1 = unbound)
    prev_anchor_cam: torch.Tensor  # [K,6] angle-axis+t of each track's anchor
    prev_anchor_xy: torch.Tensor  # [K,2] pixel in the anchor view
    pose_R: torch.Tensor          # [3,3] world→camera of the prev frame
    pose_t: torch.Tensor          # [3]
    ring_xy: torch.Tensor         # [R,K,2]
    ring_valid: torch.Tensor      # [R,K] bool
    ring_desc: torch.Tensor       # [R,K,D]
    ring_colors: torch.Tensor     # [R,K,3] f32
    win_xy: torch.Tensor          # [F,K,2]
    win_corr: torch.Tensor        # [F,K] i64
    win_cams: torch.Tensor        # [F,6] angle-axis+t
    win_used: torch.Tensor        # [F] bool
    win_map_base: torch.Tensor    # () i64 map_count at the window start
    step_ema: torch.Tensor        # () f32 EMA of accepted step lengths

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def init_state(K: np.ndarray, cfg: EngineConfig,
               dist: np.ndarray | None = None,
               device: torch.device | str = "cuda") -> TrackerState:
    k, desc_dim, desc_dtype = cfg.max_keypoints, cfg.desc_dim, cfg.desc_dtype
    ring, map_cap, window = cfg.ring, cfg.map_cap, cfg.window
    if map_cap <= k:
        # steps._append_points parks dropped rows outside the appended range,
        # which exists only while one frame's K rows cannot fill the arena
        raise ValueError(f"map_cap ({map_cap}) must exceed max_keypoints ({k})")
    f32, i64 = torch.float32, torch.int64
    K = np.asarray(K, np.float64)
    dist = np.zeros(5) if dist is None else np.asarray(dist).reshape(-1)[:5]

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def neg(shape):
        return torch.full(shape, -1, dtype=i64, device=device)

    return TrackerState(
        K4=torch.tensor([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dtype=f32,
                        device=device),
        dist=torch.tensor(dist, dtype=f32, device=device),
        map_points=z((map_cap, 3)),
        map_colors=z((map_cap, 3)),
        map_desc=z((map_cap, desc_dim), desc_dtype),
        map_count=z((), i64),
        prev_xy=z((k, 2)),
        prev_valid=z((k,), torch.bool),
        prev_desc=z((k, desc_dim), desc_dtype),
        prev_corr=neg((k,)),
        prev_anchor_cam=z((k, 6)),
        prev_anchor_xy=z((k, 2)),
        pose_R=torch.eye(3, dtype=f32, device=device),
        pose_t=z((3,)),
        ring_xy=z((ring, k, 2)),
        ring_valid=z((ring, k), torch.bool),
        ring_desc=z((ring, k, desc_dim), desc_dtype),
        ring_colors=z((ring, k, 3)),
        win_xy=z((window, k, 2)),
        win_corr=neg((window, k)),
        win_cams=z((window, 6)),
        win_used=z((window,), torch.bool),
        win_map_base=z((), i64),
        step_ema=z(()),
    )


def state_from_numpy(fields: dict[str, np.ndarray],
                     device: torch.device | str = "cuda") -> TrackerState:
    """A TrackerState from numpy leaves (e.g. a JAX TrackerState's
    ``{name: np.asarray(leaf)}``): the way a map built by the JAX package is
    carried across.  Integer leaves become int64 (uint32 bit words an int32
    view), float32 and bool stay."""
    out = {}
    for f in dataclasses.fields(TrackerState):
        a = np.asarray(fields[f.name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype.kind in "iu":
            a = a.astype(np.int64)
        out[f.name] = torch.from_numpy(np.array(a)).to(device)  # 0-d stays 0-d
    return TrackerState(**out)
