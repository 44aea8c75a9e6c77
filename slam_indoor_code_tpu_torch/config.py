"""Typed JSON configuration with drop-in field parity with the reference.

The reference validates a 40-field JSON schema eagerly at startup and exits
with a typed error message on any missing/mistyped field
(reference: src/config/config.cpp:23-52, schema table at
src/config/configData.h:73-126).  We reproduce that behaviour: the same field
names, the same types, the same eager full-schema validation — so every
`config/*.json` written for the reference binary loads unchanged here.

On top of the reference schema we add an optional ``tpu`` section holding the
static capacities that make every array shape in the pipeline fixed (the
single biggest design divergence from the reference's dynamic `std::vector`
world — see SURVEY.md §7 "Hard parts").  All ``tpu`` fields have defaults, so
reference configs need no edits.

JSON comments are accepted, matching the reference's
``json::parse(..., ignore_comments=true)`` (src/config/config.cpp:13).
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
from dataclasses import dataclass, field
from typing import Any

# ---------------------------------------------------------------------------
# Reference schema: exact (key, type) pairs from src/config/configData.h:73-126.
# Types: bool / int / float / str mirror BOOL / INTEGER / FLOATING / STRING.
# ---------------------------------------------------------------------------
REFERENCE_SCHEMA: dict[str, type] = {
    "onlyViz": bool,
    "calibrate": bool,
    "visualCalibration": bool,
    "calibrationPath": str,
    "usePhotosCycle": bool,
    "photosPathPattern": str,
    "videoSourcePath": str,
    "outputDataDir": str,
    "threadsCount": int,
    "useUndistortion": bool,
    "requiredExtractedPointsCount": int,
    "featureExtractingThreshold": int,
    "framesBatchSize": int,
    "skipFramesFromBatchHead": int,
    "useFirstFitInBatch": bool,
    "requiredMatchedPointsCount": int,
    "useFM-SIFT-FLANN": bool,
    "useFM-SIFT-BF": bool,
    "useFM-ORB": bool,
    "knnMatcherDistance": float,
    "RPUseRANSAC": bool,
    "RPRANSACProb": float,
    "RPRANSACThreshold": float,
    "RPDistanceThreshold": float,
    "useBundleAdjustment": bool,
    "BAMaxFramesCnt": int,
    "BAThreadsCnt": int,
    "BAUseTrivialLossFunction": bool,
    "BAUseHuberLossFunction": bool,
    "BAHuberLossFunctionParameter": float,
    "BAUseCauchyLossFunction": bool,
    "BACauchyLossFunctionParameter": float,
    "BAUseArctanLossFunction": bool,
    "BAArctanLossFunctionParameter": float,
    "BAUseTukeyLossFunction": bool,
    "BATukeyLossFunctionParameter": float,
    "TriangleMaxDistance": float,
    "TriangleEuclidDistanceWeight": float,
    "TriangleColorDistance": float,
    "TriangleMinimumPoints": int,
}

_TYPE_NAMES = {
    bool: "BOOLEAN",
    int: "INTEGER",
    float: "FLOATING POINT NUMBER",
    str: "STRING",
}


class ConfigError(Exception):
    """Raised on malformed config; CLI converts this to exit code 2, matching
    the reference's ``exit(2)`` on config failure (src/config/config.cpp:10,18)."""


def _strip_json_comments(text: str) -> str:
    """Remove // and /* */ comments outside of string literals."""
    out: list[str] = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
        elif c == '"':
            in_str = True
            out.append(c)
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _check_type(key: str, value: Any, expected: type) -> Any:
    """Validate one field with the reference's coercion semantics.

    nlohmann-json's ``get<double>()`` accepts integers and ``get<int>()``
    accepts integral doubles; ``get<bool>()`` is strict.  Mirror that.
    """
    if expected is bool:
        if isinstance(value, bool):
            return value
    elif expected is int:
        if isinstance(value, bool):
            pass  # bool is not an INTEGER
        elif isinstance(value, int):
            return value
        elif isinstance(value, float) and value.is_integer():
            return int(value)
    elif expected is float:
        if not isinstance(value, bool) and isinstance(value, (int, float)):
            return float(value)
    elif expected is str:
        if isinstance(value, str):
            return value
    raise ConfigError(
        f'Field "{key}" missed or has incorrect type!\n'
        f"Correct type is {_TYPE_NAMES[expected]}"
    )


@dataclass(frozen=True)
class TpuConfig:
    """Static capacities + TPU execution knobs (all shapes derive from these).

    These are the fixed arena sizes that replace the reference's dynamic
    vectors; see SURVEY.md §7.  They are hashable so a config change triggers
    exactly one re-jit.
    """

    max_keypoints: int = 2048       # top-K FAST corners kept per frame
    descriptor: str = "auto"        # "auto" → from useFM-* flags
    batch_pad: int = 0              # pad framesBatchSize to this (0 = exact)
    ransac_iters: int = 1024        # essential-matrix hypotheses scored at once
    pnp_ransac_iters: int = 256     # PnP hypotheses scored at once
    ba_max_iters: int = 30          # LM iterations per window
    ba_adjust_intrinsics: bool = False  # optimize shared K in BA (the reference
    #                                     does; free K lets windowed BA drift the
    #                                     monocular scale, so default off)
    max_map_points: int = 1 << 18   # global map arena capacity
    window_points: int = 1 << 14    # per-BA-window observed-point capacity
    use_pallas: bool = True         # Pallas fast paths (falls back to jnp off-TPU)
    device_runtime: bool = True     # device-resident engine (False = classic host conductor)
    descriptor_downscale: int = 1   # SIFT dense maps at 1/d resolution (2 for FHD)
    ingest: str = "auto"            # "device" | "host" | "auto": where FAST runs.
    #                                 "host" uploads a pooled gray plane +
    #                                 keypoints instead of full frames (the
    #                                 slow-link path); "auto" picks by measured
    #                                 link bandwidth at engine start
    ingest_downscale: int = 2       # host-ingest pooled-gray factor
    host_descriptor: str = "auto"   # host-ingest descriptor source:
    #                                 "same"   device describes from pooled gray
    #                                 "orb"    full-res cv2 ORB on host
    #                                          (Hamming; ~90 KB/frame upload)
    #                                 "hybrid" pooled-SIFT ⊕ α·orb bits (L2)
    #                                 "auto"   orb-configs→orb, sift→hybrid
    #                                          when the host path is active
    hybrid_alpha: float = 0.08      # bit-block weight in the hybrid L2
    rebind_cap: int = 4096          # anti-drift map re-binding: match unbound
    #                                 features to the last N landmarks by
    #                                 projected position + descriptor (0 = off,
    #                                 reference behaviour)
    rebind_radius: float = 24.0     # re-binding reprojection gate, in
    #                                 FHD-equivalent px (scaled by actual
    #                                 image width at engine start)
    pose_jump_gate: float = 32.0    # reject a PnP pose whose camera center
    #                                 moved more than this factor times the
    #                                 EMA of accepted step lengths (0=off):
    #                                 a consensused-but-catastrophic PnP
    #                                 otherwise teleports the camera and
    #                                 corrupts the whole tail.  Far above
    #                                 any legitimate batch-skip span
    restart_rebind: bool = True     # at a track-loss restart, re-bind the
    #                                 new first frame to the RETAINED map
    #                                 and rescale the bootstrap baseline to
    #                                 the old sub-map's monocular scale
    #                                 (|t|=1 re-seeding makes concatenated
    #                                 sub-maps scale-discontinuous; the
    #                                 reference restarts carry only the
    #                                 pose, src/main.cpp:89-101).  Needs
    #                                 rebind_cap > 0

    mesh_shape: tuple = ()          # () = single device; e.g. (2, 4) hosts×chips
    dtype: str = "float32"          # compute dtype for geometry (descriptors bf16-able)
    checkpoint_path: str = ""       # periodic run snapshot target (npz);
    checkpoint_every: int = 0       #   save every N accepted frames (0 = off)
    resume_path: str = ""           # resume a run from a snapshot (media must
    #                                 be the same source; frames consumed
    #                                 before the snapshot are skipped)
    profile_dir: str = ""           # write a jax.profiler device trace of the
    #                                 run here (open with TensorBoard/Perfetto
    #                                 for the per-stage device-time breakdown)
    ba_freeze_old: bool = False     # windowed BA holds landmarks created
    #                                 before the current window fixed (they
    #                                 anchor the cameras; only window-born
    #                                 points move).  Off by default: anchoring
    #                                 helps only once triangulation scale is
    #                                 healthy (see anchored_triangulation);
    #                                 False = the reference's
    #                                 adjust-everything behaviour
    anchored_triangulation: bool = True  # delayed triangulation: each track
    #                                 carries its first-observation (anchor)
    #                                 pose+pixel and only becomes a landmark
    #                                 once the anchor baseline passes the
    #                                 parallax gate — kills the monocular
    #                                 scale collapse of consecutive-frame
    #                                 triangulation
    parallax_min_deg: float = 1.0   # minimum anchor-ray angle for landmark
    #                                 creation (degrees)
    streaming: bool = True          # streaming runtime: device-resident
    #                                 candidate queue + in-scan windowed BA;
    #                                 the host trails the device by 1-2
    #                                 dispatches so relay round-trips leave
    #                                 the critical path (host-ingest configs
    #                                 only; the classic conductor remains for
    #                                 device ingest / per-frame telemetry)
    per_frame_telemetry: bool = False  # classic loop with one-step
    #                                 dispatches: every per-index matching
    #                                 time in time.txt is a true wall-clock
    #                                 measurement (slower; measurement mode)
    global_ba: bool = False         # final full-trajectory BA (matrix-free
    #                                 LM-PCG, solver/global_ba.py) — corrects
    #                                 accumulated monocular drift; active when
    #                                 useBundleAdjustment is on.  Default OFF
    #                                 for reference parity: the reference
    #                                 refines windowed-only
    #                                 (bundleAdjustment.cpp:122-127, no
    #                                 global pass exists there), and the
    #                                 anchored tracker already holds ATE far
    #                                 under the bound.  Opt in for the extra
    #                                 ~30x ATE headroom (benchmarked as
    #                                 BENCH_SUITE "headline_gba": 0.84x the
    #                                 headline throughput)
    global_ba_iters: int = 8        # LM iterations of the final refine.
    #                                 Measured trims (rounds 4+5), each at
    #                                 quality parity on the live problems:
    #                                 30->12 (RMSE 0.670 vs 0.668, 1/3 the
    #                                 cost), then 12->8 with cg 16->12
    #                                 (FHD 128-cam ATE 0.01% both ways;
    #                                 4K 48-cam ATE 0.003% / RMSE 0.77
    #                                 both ways; refine wall 689->419 ms)
    head_tie_tolerance: float = 0.0  # near-tie head preference in the
    #                                 good-frame rule: 0.0 = the reference's
    #                                 strict max-matches (batch.cpp:93-98);
    #                                 0.005 accepts the head frame when its
    #                                 match count is within 0.5% of the best
    #                                 (a documented DIVERGENCE knob: the
    #                                 strict rule's audited skips are
    #                                 near-ties 1-4 matches short — turn
    #                                 this on to keep every camera)
    adaptive_fast_threshold: bool = True  # host-ingest extraction gate
    #                                 adaptation: when a chunk's post-NMS
    #                                 corner counts sag below
    #                                 requiredExtractedPointsCount (the
    #                                 reference's static admission gate,
    #                                 batch.cpp:242-247, would drop every
    #                                 frame and force a track-loss restart),
    #                                 the host lowers the FAST threshold for
    #                                 subsequent chunks — bounded at 1/4 of
    #                                 the configured value, raised back when
    #                                 counts recover, every change logged to
    #                                 main.txt.  No effect while counts are
    #                                 healthy (the benchmark scenes never
    #                                 trigger it); host-ingest only (the
    #                                 device detector's threshold is
    #                                 compile-time static)
    sift_nearest_sampling: str = "auto"  # SIFT cell-sample interpolation:
    #                                 "on" = nearest map cell (4x fewer
    #                                 gathers), "off" = 4-corner bilinear,
    #                                 "auto" = nearest only at K>=4096 with
    #                                 maps at >=1/4 of coordinate space (the
    #                                 measured 4K/10k regime).  Explicit so
    #                                 large-K configs outside that operating
    #                                 point are never switched silently.
    global_ba_cg_iters: int = 12    # CG iterations per LM step (round-4
    #                                 measurement: RMSE 0.670 at cg=16 vs
    #                                 0.668 at cg=32 for half the solve
    #                                 time; 16->12 paired with the LM trim
    #                                 above at measured quality parity)


@dataclass(frozen=True)
class Config:
    """Full validated configuration: reference fields + TPU extension."""

    # --- reference fields, exact camelCase parity -------------------------
    onlyViz: bool = False
    calibrate: bool = False
    visualCalibration: bool = False
    calibrationPath: str = ""
    usePhotosCycle: bool = True
    photosPathPattern: str = ""
    videoSourcePath: str = ""
    outputDataDir: str = "."
    threadsCount: int = 1
    useUndistortion: bool = False
    requiredExtractedPointsCount: int = 400
    featureExtractingThreshold: int = 20
    framesBatchSize: int = 30
    skipFramesFromBatchHead: int = 0
    useFirstFitInBatch: bool = False
    requiredMatchedPointsCount: int = 100
    useFM_SIFT_FLANN: bool = False
    useFM_SIFT_BF: bool = True
    useFM_ORB: bool = False
    knnMatcherDistance: float = 0.7
    RPUseRANSAC: bool = True
    RPRANSACProb: float = 0.999
    RPRANSACThreshold: float = 1.0
    RPDistanceThreshold: float = 50.0
    useBundleAdjustment: bool = False
    BAMaxFramesCnt: int = 8
    BAThreadsCnt: int = 1
    BAUseTrivialLossFunction: bool = False
    BAUseHuberLossFunction: bool = True
    BAHuberLossFunctionParameter: float = 1.0
    BAUseCauchyLossFunction: bool = False
    BACauchyLossFunctionParameter: float = 1.0
    BAUseArctanLossFunction: bool = False
    BAArctanLossFunctionParameter: float = 1.0
    BAUseTukeyLossFunction: bool = False
    BATukeyLossFunctionParameter: float = 1.0
    TriangleMaxDistance: float = 1.0
    TriangleEuclidDistanceWeight: float = 1.0
    TriangleColorDistance: float = 1.0
    TriangleMinimumPoints: int = 10

    # --- TPU extension ----------------------------------------------------
    tpu: TpuConfig = field(default_factory=TpuConfig)

    # Key translation: JSON keys containing '-' map to '_' attribute names.
    _JSON_TO_ATTR = {
        "useFM-SIFT-FLANN": "useFM_SIFT_FLANN",
        "useFM-SIFT-BF": "useFM_SIFT_BF",
        "useFM-ORB": "useFM_ORB",
    }

    @property
    def matcher_type(self) -> str:
        """Matcher selection with the reference's priority order
        (src/mainModule/featureMatching/featureMatchingCommon.cpp:13-21):
        SIFT_BF first, then SIFT_FLANN, then ORB."""
        if self.useFM_SIFT_BF:
            return "sift_bf"
        if self.useFM_SIFT_FLANN:
            return "sift_flann"
        if self.useFM_ORB:
            return "orb_bf"
        raise ConfigError("No feature-matching backend enabled (useFM-* flags)")

    @property
    def ba_loss(self) -> tuple[str, float]:
        """Loss selection with the reference's priority order
        (src/mainModule/bundleAdjustment/bundleAdjustment.cpp:131-151)."""
        if self.BAUseTrivialLossFunction:
            return ("trivial", 1.0)
        if self.BAUseHuberLossFunction:
            return ("huber", self.BAHuberLossFunctionParameter)
        if self.BAUseCauchyLossFunction:
            return ("cauchy", self.BACauchyLossFunctionParameter)
        if self.BAUseArctanLossFunction:
            return ("arctan", self.BAArctanLossFunctionParameter)
        if self.BAUseTukeyLossFunction:
            return ("tukey", self.BATukeyLossFunctionParameter)
        return ("trivial", 1.0)  # Ceres nullptr loss == trivial

    @property
    def descriptor_kind(self) -> str:
        """'sift' (128-f32) or 'orb' (256-bit packed)."""
        if self.tpu.descriptor != "auto":
            return self.tpu.descriptor
        return "orb" if self.matcher_type == "orb_bf" else "sift"

    @property
    def match_metric(self) -> str:
        """Distance metric per matcher type: L2 for SIFT (BF & FLANN paths both
        rank by L2 in the reference CPU backend,
        featureMatchingCPU.cpp:26-35), Hamming for ORB."""
        return "hamming" if self.matcher_type == "orb_bf" else "l2"


def load_config(path: str, *, strict: bool = True) -> Config:
    """Load + validate a reference-format JSON config.

    ``strict=True`` reproduces the reference's eager full-schema check: every
    schema field must be present with the right type (src/config/config.cpp:23-52
    — note it validates even viz-only TRIANGLE_* fields unconditionally).
    ``strict=False`` fills missing fields from defaults (convenience for our
    own test configs).
    """
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise ConfigError(f"Failed to open config file: {e}") from e
    return parse_config(text, strict=strict)


def parse_config(text: str, *, strict: bool = True) -> Config:
    try:
        raw = json.loads(_strip_json_comments(text))
    except json.JSONDecodeError as e:
        raise ConfigError(
            "Failed to parse JSON config\n"
            "Make sure you specified path to JSON with correct semantics"
        ) from e
    if not isinstance(raw, dict):
        raise ConfigError("Config root must be a JSON object")

    values: dict[str, Any] = {}
    for key, expected in REFERENCE_SCHEMA.items():
        attr = Config._JSON_TO_ATTR.get(key, key)
        if key in raw:
            values[attr] = _check_type(key, raw[key], expected)
        elif strict:
            raise ConfigError(
                f'Field "{key}" missed or has incorrect type!\n'
                f"Correct type is {_TYPE_NAMES[expected]}"
            )

    tpu_raw = raw.get("tpu", {})
    if not isinstance(tpu_raw, dict):
        raise ConfigError('Field "tpu" must be a JSON object')
    tpu_fields = {f.name for f in dataclasses.fields(TpuConfig)}
    unknown = set(tpu_raw) - tpu_fields
    if unknown:
        raise ConfigError(f"Unknown tpu config fields: {sorted(unknown)}")
    if "mesh_shape" in tpu_raw:
        tpu_raw = dict(tpu_raw, mesh_shape=tuple(tpu_raw["mesh_shape"]))
    values["tpu"] = TpuConfig(**tpu_raw)

    return Config(**values)


def dump_config(cfg: Config) -> str:
    """Serialize back to reference-format JSON (reference keys, '-' restored)."""
    attr_to_json = {v: k for k, v in Config._JSON_TO_ATTR.items()}
    out: dict[str, Any] = {}
    for key in REFERENCE_SCHEMA:
        attr = Config._JSON_TO_ATTR.get(key, key)
        out[key] = getattr(cfg, attr)
    out["tpu"] = dataclasses.asdict(cfg.tpu)
    out["tpu"]["mesh_shape"] = list(cfg.tpu.mesh_shape)
    return json.dumps(out, indent=2)
