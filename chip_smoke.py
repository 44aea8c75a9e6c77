#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each followed by one flushed line with the elapsed seconds:

1. card     — name and power limit (nvidia-smi); fails without CUDA.
2. build    — every kernel source of the port, one nvcc per source, all
              started together; prints nvcc's register/shared-memory/spill
              report.
3. kernels  — each kernel's wrapper against its plain PyTorch version on
              the card, at the main path's shapes and at ragged/edge shapes,
              with the tolerances stated below; CUDA-event times of both
              (warm-up, then the median of 20) beside the bound.
4. main     — the port's ``slam_main`` on CUDA with the headline
              configuration (FHD 1080x1920, SIFT, L2 2-NN, PnP-RANSAC,
              windowed Huber BA, ``ingest="device"``) over a synthetic
              hallway rendered from a seed; launch counts reset just before
              and read just after; checks cameras, state placement and ATE
              against ground truth.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and prints
no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()

# H100 SXM dense peaks (NVIDIA data sheet) used for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Headline configuration (the JAX package's bench.py, pinned to device
# ingest) and its synthetic scene.
N_FRAMES = 32
MIN_CAMERAS = 24
ATE_MAX_FRAC = 0.05


def headline_config(out_dir: str):
    """The JAX package's bench.py headline configuration, ingest pinned to
    the device: FHD, SIFT, L2 ratio 0.8, 2048 keypoints, batch 16, 80
    required matches, 1024/64 RANSAC hypotheses, 4096 window points, Huber
    BA every 8 frames with 10 LM iterations, no global BA."""
    from slam_indoor_code_tpu_torch.config import Config, TpuConfig

    return Config(
        usePhotosCycle=True, outputDataDir=out_dir,
        requiredExtractedPointsCount=300, featureExtractingThreshold=20,
        framesBatchSize=16, requiredMatchedPointsCount=80,
        knnMatcherDistance=0.8, RPDistanceThreshold=500.0,
        useBundleAdjustment=True, BAMaxFramesCnt=8,
        BAUseHuberLossFunction=True, BAHuberLossFunctionParameter=2.0,
        tpu=TpuConfig(max_keypoints=2048, ransac_iters=1024,
                      pnp_ransac_iters=64, window_points=4096,
                      ba_max_iters=10, global_ba=False, ingest="device"))


def headline_scene(n_frames: int = N_FRAMES):
    """The benchmark's synthetic FHD hallway (seed 7) and its frames."""
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=1500, n_frames=n_frames,
                       image_size=(1080, 1920), seed=7, baseline=0.25,
                       kind="hallway")
    return scene, [scene.render(i) for i in range(n_frames)]


def phase(name: str, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{time.perf_counter() - T0:8.2f} s] {name} done {fields}",
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi unavailable (rc={smi.returncode})"
    print(line, flush=True)
    return torch.cuda.get_device_name(0), line


def build():
    from slam_indoor_code_tpu_torch.ops import build as kb

    t = time.perf_counter()
    libs = kb.build_all(force=True)
    for stem, info in libs.items():
        for ln in info["log"].splitlines():
            if any(k in ln for k in ("registers", "spill", "smem", "Compiling")):
                print(f"  {stem}: {ln.strip()}", flush=True)
    return time.perf_counter() - t


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_top2(rng, N, M, D, B, masked_frac=0.1, hamming=False,
               all_masked_lane=None):
    """One top2_batch case against top2_batch_plain on the card.

    Tolerances: Hamming is exact.  L2: idx1 equal wherever the plain
    version's top-2 gap exceeds 1e-3·max(1, d1), and where idx1 differs the
    two d1 agree within that gap; d1, d2 to rtol 1e-4 plus an absolute
    1e-6·(|a|²+|b|²)max for the float32 cancellation in |a|²+|b|²−2a·b
    (the two sum the products in different orders)."""
    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    if hamming:
        a = rng.integers(0, 2**32, (N, D), dtype=np.uint64).astype(
            np.uint32).view(np.int32)
        b = rng.integers(0, 2**32, (B, M, D), dtype=np.uint64).astype(
            np.uint32).view(np.int32)
    else:
        a = rng.normal(size=(N, D)).astype(np.float32)
        b = rng.normal(size=(B, M, D)).astype(np.float32)
        # exact duplicates: ties resolve to the lowest column, d2 == d1
        b[0, M // 2] = b[0, 3]
        a[0] = b[0, 3]
    vb = rng.random((B, M)) >= masked_frac
    if all_masked_lane is not None:
        vb[all_masked_lane] = False
    A, Bt, V = (torch.from_numpy(x).to(dev) for x in (a, b, vb))
    metric = "hamming" if hamming else "l2"
    k = [x.cpu().numpy() for x in ck.top2_batch(A, Bt, V, metric)]
    torch.cuda.synchronize()
    p = [x.cpu().numpy() for x in ck.top2_batch_plain(A, Bt, V, metric)]
    if hamming:
        for x, y, nm in zip(k, p, ("d1", "idx1", "d2")):
            if not np.array_equal(x, y):
                fail(f"hamming top2 {nm} differs at N={N} M={M} B={B}")
        return 0.0, (A, Bt, V, metric)
    kd1, ki1, kd2 = k
    pd1, pi1, pd2 = p
    gap_tol = 1e-3 * np.maximum(1.0, pd1)
    clear = (pd2 - pd1) > gap_tol
    if not np.array_equal(ki1[clear], pi1[clear]):
        fail(f"idx1 differs on clear rows at N={N} M={M} B={B}")
    diff = ki1 != pi1
    if np.any(np.abs(kd1[diff] - pd1[diff]) > gap_tol[diff]):
        fail(f"d1 differs beyond the gap where idx1 differs (N={N} M={M})")
    nrm = float((a.astype(np.float32) ** 2).sum(-1).max()
                + (b.astype(np.float32) ** 2).sum(-1).max())
    atol = 1e-6 * nrm
    for x, y, nm in ((kd1, pd1, "d1"), (kd2, pd2, "d2")):
        if not np.allclose(x, y, rtol=1e-4, atol=atol):
            fail(f"{nm} differs: max |Δ| {np.abs(x - y).max()} (N={N} M={M})")
    if all_masked_lane is not None:
        lane = all_masked_lane
        if not (np.all(kd1[lane] == np.float32(3e38)) and
                np.all(ki1[lane] == 0) and np.all(kd2[lane] == np.float32(3e38))):
            fail("all-masked lane must give d1=d2=3e38, idx1=0")
    if vb[0, 3] and vb[0, M // 2]:
        if ki1[0, 0] != 3 or kd2[0, 0] != kd1[0, 0]:
            fail("duplicate-column tie must pick the lowest column, d2 == d1")
    real = pd1 < 1e38
    err = float(max(np.abs(kd1 - pd1)[real].max(initial=0.0),
                    np.abs(kd2 - pd2)[pd2 < 1e38].max(initial=0.0)))
    return err, (A, Bt, V, metric)


def kernels():
    import numpy as np

    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(0)
    N = M = 2048
    D, B = 128, 16
    err, args = check_top2(rng, N, M, D, B)
    check_top2(rng, 1999, 1500, D, 3, all_masked_lane=1)
    check_top2(rng, 300, 257, 8, 4, hamming=True, all_masked_lane=2)
    ms = time_ms(lambda: ck.top2_batch(*args))
    plain_ms = time_ms(lambda: ck.top2_batch_plain(*args))
    flops = 2.0 * B * N * M * D
    nbytes = 4 * N * D + 4 * B * M * D + B * M + 3 * 4 * B * N
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {
        "name": "top2_batch",
        "route": "cuda",
        "source": "slam_indoor_code_tpu_torch/csrc/top2_batch.cu",
        "replaces": "slam_indoor_code_tpu/ops/pallas_kernels.py:225",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def main_path(card_line: str):
    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
    from slam_indoor_code_tpu_torch.metrics.ate import camera_centers
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine

    scene, frames = headline_scene()
    phase("render", frames=N_FRAMES)
    engines = []
    orig_init = DeviceEngine.__init__

    def spy_init(self, *a, **kw):   # keep a handle on the engine's state
        orig_init(self, *a, **kw)
        engines.append(self)

    with tempfile.TemporaryDirectory() as out:
        cfg = headline_config(out)
        DeviceEngine.__init__ = spy_init
        try:
            torch.cuda.synchronize()
            ck.top2_batch.launches = 0
            t = time.perf_counter()
            gd = slam_main(cfg, scene.K, frames=frames, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = ck.top2_batch.launches
        finally:
            DeviceEngine.__init__ = orig_init
        with open(f"{out}/poses.txt") as f:
            n_logged = sum(1 for _ in f)
    n_cams = len(gd.rotations)
    if n_cams < MIN_CAMERAS:
        fail(f"only {n_cams}/{N_FRAMES} frames became cameras")
    if n_logged < n_cams:
        fail(f"poses.txt has {n_logged} rows for {n_cams} cameras")
    for name, t in engines[0].state.tensors().items():
        if t.device.type != "cuda":
            fail(f"TrackerState.{name} is on {t.device}")
    # one launch per tracked frame; the bootstrap pair shares one
    if launches < n_cams - 1:
        fail(f"top2_batch launched {launches} times for {n_cams} cameras")
    est = camera_centers(gd.rotations, gd.positions)
    if not np.all(np.isfinite(est)) or not np.all(np.isfinite(gd.points)):
        fail("non-finite poses or map points")
    gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
    ate = absolute_trajectory_error(est, gt)
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    if not ate < ATE_MAX_FRAC * extent:
        fail(f"ATE {ate:.4f} >= {ATE_MAX_FRAC} of extent {extent:.3f}")
    print(f"main path: cameras {n_cams}/{N_FRAMES}  ATE {100 * ate / extent:.4f}%"
          f" of extent  map {len(gd.points)} points  wall {wall:.3f} s  "
          f"{N_FRAMES / wall:.3f} frames/s  top2_batch launches {launches}  "
          f"[{card_line}]", flush=True)
    return launches


def main() -> None:
    name, card_line = card()
    phase("card", device=repr(name))
    try:
        secs = build()
        phase("build", nvcc_s=f"{secs:.2f}")
        row = kernels()
        phase("kernels", top2_batch_ms=f"{row['ms']:.4f}",
              plain_ms=f"{row['plain_ms']:.4f}",
              bound_ms=f"{row['bound_ms']:.5f}",
              max_abs_err=f"{row['max_abs_err']:.3g}")
        row["launches"] = main_path(card_line)
        phase("main", top2_batch_launches=row["launches"])
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 — every phase failure fails the run
        import traceback

        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
    import torch

    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
