#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each followed by one flushed line with the elapsed seconds:

1. card     — name and power limit (nvidia-smi); fails without CUDA.
2. build    — every kernel source of the port, one nvcc per source, all
              started together; prints nvcc's register/shared-memory/spill
              report, and counts the tensor-core (HMMA) instructions that
              ``cuobjdump -sass`` shows in the L2/Hamming tile of both
              libraries that carry it (fails on none).
3. kernels  — each kernel's wrapper against its plain PyTorch version on
              the card, at the main path's shapes and at ragged/edge shapes
              (and ``top2_batch`` with metric "hamming" at ORB's shapes, and
              at D=384 at FHD and at the 4K point, held lane by lane),
              with the tolerances stated below; CUDA-event times of both
              (warm-up, then the median of 20) beside the bound and beside
              the two-call library yardstick (cdist + topk).
4. main     — the port's ``slam_main`` on CUDA with the headline
              configuration (FHD 1080x1920, SIFT, L2 2-NN, PnP-RANSAC,
              windowed Huber BA, ``ingest="device"``) over a synthetic
              hallway rendered from a seed; launch counts reset just before
              and read just after; checks cameras, state placement and ATE
              against ground truth.
5. l1       — the same frames and configuration through ``DeviceEngine.run``
              with ``EngineConfig.metric="l1"`` (the reference CUDA
              backend's NORM_L1 matcher): every scan step through
              ``top2_l1``, none through ``top2_batch``.
6. orb      — ``slam_main`` with only ``useFM-ORB`` set: ORB descriptors
              (int32 bit words), every scan step through ``top2_batch`` with
              metric "hamming".
7. global   — the headline with ``tpu.global_ba`` (8 LM iterations of 12
              CG steps, the config's defaults): the final global BA's RMSE
              before and after, whether it was accepted, its solve time, and
              the ATE before and after it.
8. resume   — the headline with ``tpu.checkpoint_path``/``checkpoint_every``
              crashes after its first snapshot; a second ``slam_main`` with
              ``tpu.resume_path`` continues it, and must give phase 4's
              cameras, poses and map bit for bit.
9. stream   — the headline with ``tpu.ingest="host"``,
              ``host_descriptor="same"`` and ``streaming`` (the pooled gray
              at d=2, the JAX default): FAST on the host in the packer
              threads, ``steps.advance_stream`` on the card.  Checks cameras,
              ATE and state placement as phase 4 does, and that
              ``top2_batch`` ran once per active scan step plus once per
              bootstrap ``match_select``, and no other kernel ran; prints
              the wall, frames/s, the host ingest ms per frame and the
              number of ``advance_stream`` calls.
10. hybrid  — the stream phase's configuration with the JAX default host
              descriptor, "auto": it must resolve to "hybrid" (pooled SIFT
              from the d=2 gray beside the host's full-resolution ORB bits,
              α = 0.08, D = 384); cameras and ATE as phase 4, one L2
              ``top2_batch`` launch per active scan step and bootstrap
              match, and a ring slot whose last 256 columns equal α times
              the uploaded bits; ``top2_batch`` then held to its plain
              version on the ring's own descriptors; prints the host ingest
              per frame (gray, FAST, ORB, pooling) and the tracking per
              frame.
11. hostorb — ``useFM-ORB`` under host ingest with "auto": it must resolve to
              "orb" (the host's ORB words matched by Hamming), pack and
              upload no gray plane, track as phase 4 and launch the
              Hamming ``top2_batch`` once per active scan step and bootstrap
              match; the kernel is timed and held exactly on the ring's
              host words (a kernel row of its own).
12. pair    — ``knn.match_pair`` on CUDA with the SIFT descriptors of two
              rendered frames: one ``top2_pair`` launch, the same matches as
              ``match_pair`` on CPU copies up to the rows the L2 tolerance
              leaves open.
13. classic — ``slam_main`` with ``tpu.device_runtime=false``: the classic
              host conductor (pipeline/) on the headline configuration, one
              ``top2_batch`` launch per matched ``find_good_frame`` scan
              (B = the batch's length, 1..16), the descriptors on the card,
              no other kernel; cameras and ATE as phase 4.
14. telemetry — the headline with ``per_frame_telemetry``: one step per
              ``advance_window`` call, one "Matching time for index" line
              in time.txt per scan step, one ``top2_batch`` launch per scan
              step (and per bootstrap ``match_select``); prints whether it
              equals phase 4 bit for bit and where the two part.
15. cli     — the 32 frames written as PNG files (numpy + zlib), K as XML,
              the configuration as JSON, then ``python3 -m
              slam_indoor_code_tpu_torch cfg.json --profile DIR`` as a
              subprocess: exit 0, the "map points" line, the six logs
              reloaded with its cameras at ATE < 5 %, a trace in DIR that
              names ``top2_l2_kernel`` and ``steps.`` spans; prints the
              photo decode ms per frame and which decoder ran.
16. calibrate — ``calibrate_camera`` on CUDA over 20 synthetic views of
              the 7x7 board through the headline's FHD K (distortion, 0.1 px
              noise, from a seed): fx and fy within 1 % of the truth, rms
              < 0.3 px, K within 2e-3 relative of the port's CPU result on
              the same views; the XML written and reloaded; the solve's
              seconds.
17. shard   — eight virtual shards on cuda:0: ``ShardedFrontend`` on 16
              FHD frames (two a shard), SIFT/L2 and ORB/Hamming, gives the
              unsplit call's match counts exactly with 8 ``top2_batch``
              launches per call; ``ShardedBA`` at the headline's BA shape
              (8 frames, 4096 window points, Huber 2, 10 LM iterations) is
              held to ``bundle_adjust_window`` with tests/test_parallel.py's
              rule (cams 5e-3, cost 5 %, points 0.15 / median 0.05).
18. mesh    — ``slam_main`` on the headline with ``tpu.mesh_shape=(cards,)``:
              on one card it must equal phase 4 bit for bit.
19. sequences — ``run_sequences_parallel`` on two 32-frame FHD sequences
              (the headline scene and the same hallway from seed 8), one
              thread and CUDA stream each: each equals its own solo run bit
              for bit; prints the parallel wall beside the two solo walls.
20. distributed — two processes of ``parallel/worker.py ba`` (gloo, both
              ranks on cuda:0; NCCL where each has a card) solve
              ``ShardedBA`` across the process boundary at the headline's
              BA shape: final cost within 1e-3 relative and cameras within
              5e-4 of a one-process solve.
21. 4k      — bench.py's 4K operating point (config #4: 2160x3840, 10,240
              keypoints, 8,192 window points, 256 PnP hypotheses, d=4,
              hybrid at α = 0.15, the global BA, ratio 0.70) under host
              ingest on 16 frames (two BA windows; cut from 48): at least
              12/16 cameras at ATE < 5 %, one L2 ``top2_batch`` launch per
              active scan step and bootstrap match; prints the host ingest
              per frame and its parts, the tracking per frame, the kernel's
              time per call at [10240,384] x [16,10240,384], the ring's size
              and the peak device memory; ``top2_batch`` then held to its
              plain version, lane by lane, on the 4K ring.
22. repro   — phases 4, 5, 6, 9, 13 and 10 once more in the same process:
              each second run must give the first run's cameras, map size,
              poses and map points bit for bit (the second stream, classic
              and hybrid runs are the warm ones).

No path may call a kernel's plain version on the card (each phase counts
those calls and fails on any).

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and prints
no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()

# H100 SXM dense peaks (NVIDIA data sheet) used for the bounds.  The f32
# peak counts an FMA as two operations; a plain add or subtract retires at
# half that rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BIG = 3.0e38

# Headline configuration (the JAX package's bench.py, pinned to device
# ingest) and its synthetic scene.  Every path is held to the same limits:
# the JAX package's L1, L2 and ORB engines on these 32 frames (CPU runs,
# scripts/headline_cpu.py) track 32/32 frames well inside them.
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


def orb_config(out_dir: str):
    """The headline configuration with only ``useFM-ORB`` set: ORB
    descriptors and Hamming 2-NN."""
    return dataclasses.replace(headline_config(out_dir), useFM_SIFT_BF=False,
                               useFM_SIFT_FLANN=False, useFM_ORB=True)


def stream_config(out_dir: str):
    """The headline configuration under host ingest: FAST on the host,
    the pooled gray (d=2) uploaded, "same" descriptors on the device, the
    streaming loop."""
    cfg = headline_config(out_dir)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, ingest="host", host_descriptor="same", streaming=True,
        ingest_downscale=2))


def hybrid_config(out_dir: str):
    """``stream_config`` with the JAX package's default host descriptor,
    "auto": under host ingest a SIFT configuration takes "hybrid" (pooled
    SIFT from the d=2 gray beside the host's full-resolution ORB bits,
    α = 0.08, one 384-dim L2 descriptor)."""
    cfg = stream_config(out_dir)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, host_descriptor="auto", hybrid_alpha=0.08))


def hostorb_config(out_dir: str):
    """``orb_config`` under host ingest with host descriptor "auto", which
    an ORB configuration takes as "orb": the host's ORB bits are the
    descriptors, matched by Hamming; no gray plane is uploaded."""
    cfg = orb_config(out_dir)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, ingest="host", host_descriptor="auto", streaming=True,
        ingest_downscale=2))


# The JAX package's 4K operating point (bench.py config #4) on its
# slow-link path, cut from 48 frames to 16 (two BA windows); widths uncut.
N_FRAMES_4K = 16
MIN_CAMERAS_4K = 12


def fourk_config(out_dir: str):
    """bench.py's config #4: 2160x3840, 10,240 keypoints, 8,192 window
    points, 256 PnP hypotheses, the pooled gray at d=4 with hybrid
    descriptors at α = 0.15, the final global BA, ratio 0.70, 500 required
    matches, 1000 required corners; host ingest pinned (the path the JAX
    4K point ran on its slow link), the streaming loop."""
    cfg = headline_config(out_dir)
    return dataclasses.replace(
        cfg, requiredMatchedPointsCount=500,
        requiredExtractedPointsCount=1000, knnMatcherDistance=0.70,
        tpu=dataclasses.replace(
            cfg.tpu, max_keypoints=10240, window_points=8192,
            pnp_ransac_iters=256, ingest="host", host_descriptor="auto",
            ingest_downscale=4, hybrid_alpha=0.15, global_ba=True,
            streaming=True))


def fourk_scene(n_frames: int = N_FRAMES_4K):
    """bench.py's 4K scene: the hallway at 2160x3840, 4000 points, seed
    13."""
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=4000, n_frames=n_frames,
                       image_size=(2160, 3840), seed=13, baseline=0.25,
                       kind="hallway")
    return scene, [scene.render(i) for i in range(n_frames)]


def headline_scene(n_frames: int = N_FRAMES, seed: int = 7):
    """The benchmark's synthetic FHD hallway (seed 7) and its frames."""
    from slam_indoor_code_tpu_torch.testing import make_scene

    scene = make_scene(n_points=1500, n_frames=n_frames,
                       image_size=(1080, 1920), seed=seed, baseline=0.25,
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


def tensor_core_instructions() -> dict:
    """HMMA instructions in top2_l2_kernel of the two libraries that carry
    the L2/Hamming tile, from ``cuobjdump -sass`` (beside nvcc).  Fails
    where there are none: the tile's product must run on the tensor
    cores."""
    from pathlib import Path

    from slam_indoor_code_tpu_torch.ops import build as kb

    tool = Path(kb.nvcc_path()).parent / "cuobjdump"
    found = {}
    for stem in ("top2_batch", "top2_pair"):
        res = subprocess.run([str(tool), "-sass", str(kb.library_path(stem))],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            fail(f"cuobjdump -sass {stem}: rc={res.returncode} "
                 f"{res.stderr.strip()[:300]}")
        n, inside = 0, False
        for ln in res.stdout.splitlines():
            if "Function :" in ln:
                inside = "top2_l2_kernel" in ln
            elif inside and "HMMA" in ln:
                n += 1
        if n == 0:
            fail(f"{stem}: no HMMA instruction in top2_l2_kernel")
        found[stem] = n
    print(f"  sass: HMMA instructions in top2_l2_kernel {json.dumps(found)}",
          flush=True)
    return found


def time_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call.  With inner = 1 the time includes the host's launch
    latency (the device waits for it); with more calls it hides behind the
    device's work where that is longer."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


# ------------------------------------------------------------------ kernels

def make_case(rng, N, M, D, B, masked_frac=0.1, hamming=False,
              all_masked_lane=None):
    """numpy inputs (a [N,D], b [B,M,D], vb [B,M]): normal f32 values (or
    random bit words) with an exact duplicate column in lane 0 that query
    row 0 equals, ~masked_frac of columns masked, optionally a lane with
    every column masked."""
    import numpy as np

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
    return a, b, vb


def on_card(*xs):
    import torch

    return tuple(torch.from_numpy(x).to("cuda") for x in xs)


def host(res):
    import torch

    torch.cuda.synchronize()
    return [x.cpu().numpy() for x in res]


def hold_exact(k, p, what):
    import numpy as np

    for x, y, nm in zip(k, p, ("d1", "idx1", "d2")):
        if not np.array_equal(x, y):
            fail(f"{what}: {nm} differs (must be exact)")


def hold_l2(k, p, a, b, what):
    """The L2 rule: idx1 equal wherever the plain version's top-2 gap
    exceeds 1e-3·max(1, d1), and where idx1 differs the two d1 agree within
    that gap; d1, d2 to rtol 1e-4 plus an absolute 1e-6·(|a|²+|b|²)max for
    the float32 cancellation in |a|²+|b|²−2a·b (the two sum the products in
    different orders).  Returns max |Δ| over real distances."""
    import numpy as np

    (kd1, ki1, kd2), (pd1, pi1, pd2) = k, p
    gap_tol = 1e-3 * np.maximum(1.0, pd1)
    clear = (pd2 - pd1) > gap_tol
    if not np.array_equal(ki1[clear], pi1[clear]):
        fail(f"{what}: idx1 differs on clear rows")
    diff = ki1 != pi1
    if np.any(np.abs(kd1[diff] - pd1[diff]) > gap_tol[diff]):
        fail(f"{what}: d1 differs beyond the gap where idx1 differs")
    nrm = float((a.astype(np.float32) ** 2).sum(-1).max()
                + (b.astype(np.float32) ** 2).sum(-1).max())
    for x, y, nm in ((kd1, pd1, "d1"), (kd2, pd2, "d2")):
        if not np.allclose(x, y, rtol=1e-4, atol=1e-6 * nrm):
            fail(f"{what}: {nm} differs: max |Δ| {np.abs(x - y).max()}")
    return max_err(k, p)


def hold_l1(k, p, what):
    """The L1 rule: idx1 equal wherever the plain version's top-2 gap
    exceeds 1e-5·max(1, d1); d1 and d2 to rtol 1e-5.  Returns max |Δ|."""
    import numpy as np

    (kd1, ki1, kd2), (pd1, pi1, pd2) = k, p
    clear = (pd2 - pd1) > 1e-5 * np.maximum(1.0, pd1)
    if not np.array_equal(ki1[clear], pi1[clear]):
        fail(f"{what}: idx1 differs on clear rows")
    for x, y, nm in ((kd1, pd1, "d1"), (kd2, pd2, "d2")):
        if not np.allclose(x, y, rtol=1e-5, atol=0.0):
            fail(f"{what}: {nm} differs: max |Δ| {np.abs(x - y).max()}")
    return max_err(k, p)


def max_err(k, p) -> float:
    import numpy as np

    (kd1, _, kd2), (pd1, _, pd2) = k, p
    return float(max(np.abs(kd1 - pd1)[pd1 < 1e38].max(initial=0.0),
                     np.abs(kd2 - pd2)[pd2 < 1e38].max(initial=0.0)))


def hold_edges(k, vb, what, all_masked_lane=None):
    """An all-masked lane gives d1 = d2 = 3e38, idx1 = 0; the duplicate
    column of make_case picks the lowest column with d2 == d1."""
    import numpy as np

    kd1, ki1, kd2 = (x if x.ndim == 2 else x[None] for x in k)
    if all_masked_lane is not None:
        lane = all_masked_lane
        if not (np.all(kd1[lane] == np.float32(BIG)) and
                np.all(ki1[lane] == 0) and np.all(kd2[lane] == np.float32(BIG))):
            fail(f"{what}: all-masked lane must give d1=d2=3e38, idx1=0")
    M = vb.shape[-1]
    if vb.reshape(-1, M)[0, 3] and vb.reshape(-1, M)[0, M // 2]:
        if ki1[0, 0] != 3 or kd2[0, 0] != kd1[0, 0]:
            fail(f"{what}: duplicate-column tie must pick the lowest column, "
                 "d2 == d1")


def library_top2(A, Bt, V, p):
    """The two-call yardstick: torch.cdist + torch.topk(2, smallest), with
    the column mask applied in between (a cheap masked_fill)."""
    import torch

    d = torch.cdist(A.expand(Bt.shape[0], -1, -1), Bt, p=p)
    d.masked_fill_(~V[:, None, :], BIG)
    return torch.topk(d, 2, dim=-1, largest=False)


def bound(flops, peak, nbytes):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def row(name, source, replaces, err, fn, plain_ms, bnd, two_call_ms):
    """A kernel's JSON row; ``fn`` calls its wrapper, timed once per event
    pair (``ms``, comparable with earlier PRs) and as 10 back-to-back calls
    (``back_to_back_ms``, closer to the device time of one launch)."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"slam_indoor_code_tpu_torch/csrc/{source}",
        "replaces": f"slam_indoor_code_tpu/ops/pallas_kernels.py:{replaces}",
        "launches": None,
        "max_abs_err": err,
        "ms": time_ms(fn),
        "back_to_back_ms": time_ms(fn, inner=10),
        "plain_ms": plain_ms,
        "bound_ms": bnd[0],
        "bound_by": bnd[1],
        # no single PyTorch call computes a masked top-2; library_top2 is
        # two (cdist, topk) with the mask applied between them
        "library_ms": None,
        "two_call_library_ms": two_call_ms,
    }


def kernels():
    """Every kernel against its plain version, timed at the main path's
    shapes.  Returns the JSON rows by key."""
    import numpy as np

    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(0)
    N = M = 2048
    D, B = 128, 16
    rows = {}

    # top2_batch: main shapes, ragged with a masked lane, Hamming, D=384
    # (the hybrid descriptor, query tile resident) and D=700 (staged in
    # chunks); lanes_per_block 2 and 4 must equal lanes_per_block 1 exactly
    a, b, vb = make_case(rng, N, M, D, B)
    A, Bt, V = on_card(a, b, vb)
    k = host(ck.top2_batch(A, Bt, V))
    err = hold_l2(k, host(ck.top2_batch_plain(A, Bt, V)), a, b, "top2_batch")
    hold_edges(k, vb, "top2_batch")
    for lpb in (2, 4):
        hold_exact(host(ck.top2_batch(A, Bt, V, lanes_per_block=lpb)), k,
                   f"top2_batch lanes_per_block={lpb}")
    for n_, m_, d_, b_, lane in ((1999, 1500, D, 3, 1), (2048, 2048, 384, 4,
                                                         None),
                                 (300, 500, 700, 2, None), (1999, 1500, D, 6,
                                                            5)):
        a2, b2, vb2 = make_case(rng, n_, m_, d_, b_, all_masked_lane=lane)
        args = on_card(a2, b2, vb2)
        k2 = host(ck.top2_batch(*args))
        hold_l2(k2, host(ck.top2_batch_plain(*args)), a2, b2,
                f"top2_batch {n_}x{m_}x{d_} B={b_}")
        hold_edges(k2, vb2, f"top2_batch {n_}x{m_}x{d_}", lane)
        for lpb in (2, 4):
            hold_exact(host(ck.top2_batch(*args, lanes_per_block=lpb)), k2,
                       f"top2_batch lanes_per_block={lpb} B={b_}")
    ah, bh, vh = make_case(rng, 300, 257, 8, 4, hamming=True,
                           all_masked_lane=2)
    hargs = on_card(ah, bh, vh)
    kh = host(ck.top2_batch(*hargs, metric="hamming"))
    hold_exact(kh, host(ck.top2_batch_plain(*hargs, metric="hamming")),
               "top2_batch hamming")
    hold_exact(host(ck.top2_batch(*hargs, metric="hamming",
                                  lanes_per_block=4)), kh,
               "top2_batch hamming lanes_per_block=4")

    flops = 2.0 * B * N * M * D
    nbytes = 4 * N * D + 4 * B * M * D + B * M + 3 * 4 * B * N
    bnd = bound(flops, PEAK_BF16_FLOPS, nbytes)
    plain_ms = time_ms(lambda: ck.top2_batch_plain(A, Bt, V))
    lib_ms = time_ms(lambda: library_top2(A, Bt, V, 2.0))
    rows["top2_batch"] = row(
        "top2_batch", "top2_batch.cu", 225, err,
        lambda: ck.top2_batch(A, Bt, V), plain_ms, bnd, lib_ms)
    for lpb in (2, 4):
        rows[f"lpb{lpb}"] = row(
            f"top2_batch(lanes_per_block={lpb})", "top2_batch.cu", 253, 0.0,
            lambda: ck.top2_batch(A, Bt, V, lanes_per_block=lpb),
            plain_ms, bnd, lib_ms)

    # top2_batch with metric="hamming" at ORB's shapes: 2048 x 2048
    # descriptors of 8 words (256 bits, unpacked to 0/1 bf16 by the
    # wrapper), 16 candidate frames, one lane all masked; exact.  The
    # two-call yardstick is cdist(p=0) on the unpacked bits, then topk.
    ah, bh, vh = make_case(rng, N, M, 8, B, hamming=True, all_masked_lane=5)
    oargs = on_card(ah, bh, vh)
    ko = host(ck.top2_batch(*oargs, metric="hamming"))
    hold_exact(ko, host(ck.top2_batch_plain(*oargs, metric="hamming")),
               "top2_batch hamming at ORB's shapes")
    hold_edges(ko, vh, "top2_batch hamming at ORB's shapes", 5)
    bits_a = ck.unpack_bits(oargs[0]).float()
    bits_b = ck.unpack_bits(oargs[1]).float()
    rows["hamming"] = row(
        "top2_batch(metric=hamming)", "top2_batch.cu", 225, 0.0,
        lambda: ck.top2_batch(*oargs, metric="hamming"),
        time_ms(lambda: ck.top2_batch_plain(*oargs, metric="hamming")),
        bound(2.0 * B * N * M * 256, PEAK_BF16_FLOPS,
              4 * N * 8 + 4 * B * M * 8 + B * M + 3 * 4 * B * N),
        time_ms(lambda: library_top2(bits_a, bits_b, oargs[2], 0.0)))

    # top2_pair: L2 at 2048x2048x128 (lane 0 of the main case) and ragged;
    # Hamming at 300x257x8 words, exact
    pargs = (A, Bt[0].contiguous(), V[0].contiguous())
    kp = host(ck.top2_pair(*pargs))
    perr = hold_l2(kp, host(ck.top2_pair_plain(*pargs)), a, b[0], "top2_pair")
    hold_edges(kp, vb[0], "top2_pair")
    a2, b2, vb2 = make_case(rng, 1999, 1500, D, 1)
    args = on_card(a2, b2[0], vb2[0])
    hold_l2(host(ck.top2_pair(*args)), host(ck.top2_pair_plain(*args)), a2,
            b2[0], "top2_pair 1999x1500")
    hp = (hargs[0], hargs[1][0].contiguous(), hargs[2][0].contiguous())
    hold_exact(host(ck.top2_pair(*hp, metric="hamming")),
               host(ck.top2_pair_plain(*hp, metric="hamming")),
               "top2_pair hamming")
    rows["top2_pair"] = row(
        "top2_pair", "top2_pair.cu", 57, perr,
        lambda: ck.top2_pair(*pargs),
        time_ms(lambda: ck.top2_pair_plain(*pargs)),
        bound(2.0 * N * M * D, PEAK_BF16_FLOPS,
              4 * (N + M) * D + M + 3 * 4 * N),
        time_ms(lambda: library_top2(pargs[0], pargs[1][None],
                                     pargs[2][None], 2.0)))

    # top2_l1: main shapes (bit-exact in practice: both add |a-b| in order),
    # ragged with a masked lane at D=32
    k1 = host(ck.top2_l1(A, Bt, V))
    lerr = hold_l1(k1, host(ck.top2_l1_plain(A, Bt, V)), "top2_l1")
    hold_edges(k1, vb, "top2_l1")
    a2, b2, vb2 = make_case(rng, 1999, 1500, 32, 3, all_masked_lane=1)
    args = on_card(a2, b2, vb2)
    k2 = host(ck.top2_l1(*args))
    hold_l1(k2, host(ck.top2_l1_plain(*args)), "top2_l1 3x1999x1500x32")
    hold_edges(k2, vb2, "top2_l1 3x1999x1500x32", 1)
    terms = float(B) * N * M * D
    rows["top2_l1"] = row(
        "top2_l1", "top2_l1.cu", 86, lerr,
        lambda: ck.top2_l1(A, Bt, V),
        time_ms(lambda: ck.top2_l1_plain(A, Bt, V)),
        # subtract + add (|.| is an operand modifier) per term, each at half
        # the FMA-counted f32 peak
        bound(2.0 * terms, PEAK_FP32_FLOPS / 2.0,
              4 * N * D + 4 * B * M * D + B * M + 3 * 4 * B * N),
        time_ms(lambda: library_top2(A, Bt, V, 1.0)))

    # top2_batch at the hybrid descriptor's D=384 (pooled SIFT ⊕ α·bits):
    # FHD's 2048 keypoints and bench.py's 4K point's 10240, 16 candidate
    # frames; the plain version and the two-call yardstick run lane by lane
    # (at 4K a [16,10240,10240] f32 distance block is 6.7 GB)
    for key, n_ in (("d384", N), ("d384_4k", 10240)):
        a3, b3, vb3 = make_case(rng, n_, n_, 384, B)
        args3 = on_card(a3, b3, vb3)
        k3 = host(ck.top2_batch(*args3))
        err3 = hold_l2(k3, host(plain_by_lane(*args3)), a3, b3,
                       f"top2_batch {n_}x{n_}x384 B={B}")
        hold_edges(k3, vb3, f"top2_batch {n_}x{n_}x384")
        rows[key] = row(
            f"top2_batch(D=384, N=M={n_})", "top2_batch.cu", 225, err3,
            lambda: ck.top2_batch(*args3),
            time_ms(lambda: plain_by_lane(*args3)),
            bound(2.0 * B * n_ * n_ * 384, PEAK_BF16_FLOPS,
                  4 * n_ * 384 + 4 * B * n_ * 384 + B * n_ + 3 * 4 * B * n_),
            time_ms(lambda: library_by_lane(*args3, 2.0)))
        del a3, b3, args3
    return rows


def library_by_lane(A, Bt, V, p):
    """``library_top2`` one candidate lane at a time (see plain_by_lane)."""
    return [library_top2(A, Bt[i:i + 1], V[i:i + 1], p)
            for i in range(Bt.shape[0])]


def host_words_row(engine):
    """``top2_batch`` with metric "hamming" on the host's ORB words as the
    hostorb path left them in its ring (ring_operands), held exactly to its
    plain version, as a kernel row."""
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    A, Bt, V = ring_operands(engine)
    k = host(ck.top2_batch(A, Bt, V, metric="hamming"))
    hold_exact(k, host(ck.top2_batch_plain(A, Bt, V, metric="hamming")),
               "top2_batch hamming on host ORB words")
    N, (B, M) = A.shape[0], V.shape
    bits_a, bits_b = ck.unpack_bits(A).float(), ck.unpack_bits(Bt).float()
    return row(
        "top2_batch(metric=hamming, host ORB words)", "top2_batch.cu", 225,
        0.0, lambda: ck.top2_batch(A, Bt, V, metric="hamming"),
        time_ms(lambda: ck.top2_batch_plain(A, Bt, V, metric="hamming")),
        bound(2.0 * B * N * M * 256, PEAK_BF16_FLOPS,
              4 * N * 8 + 4 * B * M * 8 + B * M + 3 * 4 * B * N),
        time_ms(lambda: library_top2(bits_a, bits_b, V, 0.0)))


# ------------------------------------------------------------- main paths

def rel_ate_pct(scene, rotations, positions, frame_ids) -> float:
    """ATE against ground truth (Sim(3)-aligned, paired by source frame
    id) as % of the trajectory extent."""
    import numpy as np

    from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
    from slam_indoor_code_tpu_torch.metrics.ate import camera_centers

    est = camera_centers(rotations, positions)
    gt = scene.centers()[np.asarray(frame_ids, np.int64)]
    return 100 * absolute_trajectory_error(est, gt) / float(
        np.linalg.norm(gt.max(0) - gt.min(0)))


def trajectory_ok(what, scene, gd, n_frames: int = N_FRAMES,
                  min_cameras: int = MIN_CAMERAS):
    """Cameras, finite poses and points, ATE against ground truth."""
    import numpy as np

    n_cams = len(gd.rotations)
    if n_cams < min_cameras:
        fail(f"{what}: only {n_cams}/{n_frames} frames became cameras")
    if not all(np.all(np.isfinite(x)) for x in (gd.rotations, gd.positions,
                                                 gd.points)):
        fail(f"{what}: non-finite poses or map points")
    ate_pct = rel_ate_pct(scene, gd.rotations, gd.positions, gd.frame_ids)
    if not ate_pct < 100 * ATE_MAX_FRAC:
        fail(f"{what}: ATE {ate_pct:.4f}% >= {100 * ATE_MAX_FRAC}% of extent")
    return n_cams, ate_pct


def on_cuda(what, engine):
    for name, t in engine.state.tensors().items():
        if t.device.type != "cuda":
            fail(f"{what}: TrackerState.{name} is on {t.device}")


PLAIN = ("top2_batch_plain", "top2_pair_plain", "top2_l1_plain")
PLAIN_CALLS = {"n": 0}


def count_plain_calls() -> None:
    """Wrap each kernel's plain version so that a call counts in
    PLAIN_CALLS: a path on the card must never reach one.  The kernel
    phase's comparisons call them directly and are not counted (they run
    before this is installed)."""
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    for name in PLAIN:
        fn = getattr(ck, name)

        def counted(*a, _fn=fn, **kw):
            PLAIN_CALLS["n"] += 1
            return _fn(*a, **kw)

        setattr(ck, name, counted)


def reset_counts():
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    for fn in (ck.top2_batch, ck.top2_pair, ck.top2_l1):
        fn.launches = 0
    ck.top2_batch.multi_lane_launches = 0
    ck.top2_batch.hamming_launches = 0
    PLAIN_CALLS["n"] = 0


def counts():
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    return {"top2_batch": ck.top2_batch.launches,
            "lpb": ck.top2_batch.multi_lane_launches,
            "hamming": ck.top2_batch.hamming_launches,
            "top2_pair": ck.top2_pair.launches,
            "top2_l1": ck.top2_l1.launches,
            "plain": PLAIN_CALLS["n"]}


def slam_run(cfg, scene, frames):
    """``slam_main(cfg)`` on CUDA, launch counts set to 0 just before and
    read just after → (counts, GlobalData, wall seconds, the runtime (the
    DeviceEngine, or the classic conductor's MainCycle), what the run
    logged: {"poses": the text of poses.txt, "picks": the chosen batch
    index of each scan step in time.txt}."""
    import torch

    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.pipeline import MainCycle
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine

    runtimes = []
    origs = {cls: cls.__init__ for cls in (DeviceEngine, MainCycle)}

    def spying(orig_init):
        def spy_init(self, *a, **kw):   # keep a handle on the runtime
            orig_init(self, *a, **kw)
            runtimes.append(self)
        return spy_init

    for cls, orig in origs.items():
        cls.__init__ = spying(orig)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        gd = slam_main(cfg, scene.K, frames=frames, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = counts()
    finally:
        for cls, orig in origs.items():
            cls.__init__ = orig
    with open(f"{cfg.outputDataDir}/poses.txt") as f:
        poses_text = f.read()
    with open(f"{cfg.outputDataDir}/time.txt") as f:
        picks = [int(ln.split()[4]) for ln in f
                 if ln.startswith("Matching time for index")]
    if n["plain"]:
        fail(f"a kernel's plain version was called {n['plain']} times on "
             "the card")
    return n, gd, wall, runtimes[0], {"poses": poses_text, "picks": picks}


def report(what, n_cams, ate_pct, gd, wall, n, card_line,
           n_frames: int = N_FRAMES):
    print(f"{what}: cameras {n_cams}/{n_frames}  ATE {ate_pct:.4f}%"
          f" of extent  map {len(gd.points)} points  wall {wall:.3f} s  "
          f"{n_frames / wall:.3f} frames/s  launches {json.dumps(n)}  "
          f"[{card_line}]", flush=True)


def main_path(card_line: str, scene, frames, what: str = "main path"):
    """``slam_main`` on CUDA with the headline configuration → (launch
    counts of the run, its GlobalData, what it logged: see slam_run)."""
    with tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, logged = slam_run(headline_config(out), scene,
                                               frames)
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    n_logged = logged["poses"].count("\n")
    if n_logged < n_cams:
        fail(f"poses.txt has {n_logged} rows for {n_cams} cameras")
    on_cuda(what, engine)
    # one launch per tracked frame; the bootstrap pair shares one
    if n["top2_batch"] < n_cams - 1:
        fail(f"top2_batch launched {n['top2_batch']} times for {n_cams} "
             "cameras")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    return n, gd, logged


def orb_path(card_line: str, scene, frames, what: str = "orb path"):
    """``slam_main`` with only ``useFM-ORB`` set → (launch counts,
    GlobalData): every scan step through the Hamming ``top2_batch``."""
    import torch

    with tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, _ = slam_run(orb_config(out), scene, frames)
    if (engine.cfg.descriptor, engine.cfg.metric) != ("orb", "hamming"):
        fail(f"{what}: the engine took {engine.cfg.descriptor}/"
             f"{engine.cfg.metric}, not orb/hamming")
    if engine.state.ring_desc.dtype != torch.int32 or tuple(
            engine.state.ring_desc.shape[-1:]) != (8,):
        fail(f"{what}: descriptors {engine.state.ring_desc.dtype} "
             f"{tuple(engine.state.ring_desc.shape)}, not int32 [..,8]")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    if n["hamming"] < n_cams - 1:
        fail(f"{what}: the Hamming top2_batch launched {n['hamming']} times "
             f"for {n_cams} cameras")
    if n["top2_batch"] != n["hamming"] or n["top2_l1"] or n["top2_pair"]:
        fail(f"{what}: launched another kernel than the Hamming top2_batch: "
             f"{n}")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    return n, gd


def global_path(card_line: str, scene, frames, gd_main):
    """The headline with ``tpu.global_ba`` → (launch counts, the solve's
    numbers).  The windowed trajectory handed to the refinement is phase
    4's (collecting the observations changes nothing), which is checked."""
    import math

    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch import app
    from slam_indoor_code_tpu_torch.solver import global_ba

    rec = {}
    orig_refine = app._global_refine
    orig_solve = global_ba.global_bundle_adjust

    def spy_refine(engine, gd, logs, cfg):
        rec["before"] = rel_ate_pct(scene, gd.rotations, gd.positions,
                                    gd.frame_ids)
        rec["same_windowed"] = (
            np.array_equal(gd.rotations, gd_main.rotations)
            and np.array_equal(gd.positions, gd_main.positions))
        out = orig_refine(engine, gd, logs, cfg)
        rec["accepted"] = out is not None
        return out

    def spy_solve(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = orig_solve(*a, **kw)
        torch.cuda.synchronize()
        rec["solve_s"] = time.perf_counter() - t
        rec["info"] = {k: float(v) for k, v in res[2].items()}
        rec["obs"] = int(a[4].shape[0])
        rec["cams"] = int(a[2].shape[0])
        return res

    app._global_refine, global_ba.global_bundle_adjust = spy_refine, spy_solve
    try:
        with tempfile.TemporaryDirectory() as out:
            cfg = headline_config(out)
            cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
                cfg.tpu, global_ba=True))
            n, gd, wall, engine, _ = slam_run(cfg, scene, frames)
            with open(f"{out}/main.txt") as f:
                logged = "Global Bundle Adjustment statistics" in f.read()
    finally:
        app._global_refine, global_ba.global_bundle_adjust = (orig_refine,
                                                              orig_solve)
    if "info" not in rec or not logged:
        fail("global: the final global BA did not run")
    info = rec["info"]
    if not math.isfinite(info["final_rmse"]):
        fail(f"global: final RMSE {info['final_rmse']}")
    n_cams, ate_pct = trajectory_ok("global", scene, gd)
    on_cuda("global", engine)
    print(f"global: cameras {n_cams}/{N_FRAMES}  RMSE "
          f"{info['initial_rmse']:.6f} -> {info['final_rmse']:.6f} px over {int(info['num_residuals'])}"
          f" residuals ({rec['obs']} padded, {rec['cams']} camera slots), "
          f"{info['num_iters']:.0f} LM iterations, "
          f"{'accepted' if rec['accepted'] else 'rejected'}  solve "
          f"{rec['solve_s']:.3f} s  ATE {rec['before']:.4f}% -> "
          f"{ate_pct:.4f}% of extent  windowed trajectory equals the main "
          f"path's: {rec['same_windowed']}  wall {wall:.3f} s  "
          f"[{card_line}]", flush=True)
    return n, rec


def resume_path(card_line: str, scene, frames, gd_main):
    """The headline with ``tpu.checkpoint_path`` and ``checkpoint_every``
    = 16 crashes in the first window after its first snapshot; a second
    ``slam_main`` with ``tpu.resume_path`` continues it and must equal phase
    4's run bit for bit.  At 32 frames the engine has read every frame of
    its media before its first snapshot (ingest prefetches up to ~48), so
    the crash is raised in the next ``advance_window`` instead of by the
    media.  → launch counts of the resumed run."""
    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.runtime import checkpoint_next_fid, steps

    with tempfile.TemporaryDirectory() as out:
        ck = os.path.join(out, "run.npz")
        cfg = headline_config(os.path.join(out, "killed"))
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, checkpoint_path=ck, checkpoint_every=16))
        orig = steps.advance_window

        def crashing(*a, **kw):
            if os.path.exists(ck):
                raise RuntimeError("simulated crash")
            return orig(*a, **kw)

        steps.advance_window = crashing
        try:
            slam_main(cfg, scene.K, frames=frames, seed=0)
            fail("resume: the run did not crash after a snapshot")
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
        finally:
            steps.advance_window = orig
        next_fid = checkpoint_next_fid(ck)
        size_mb = os.path.getsize(ck) / 1e6
        cfg = headline_config(os.path.join(out, "resumed"))
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, resume_path=ck))
        n, gd, wall, engine, _ = slam_run(cfg, scene, frames)
        with open(os.path.join(out, "resumed", "main.txt")) as f:
            if "Resumed from" not in f.read():
                fail("resume: main.txt has no 'Resumed from' line")
    on_cuda("resume", engine)
    same_run("resume (resumed vs uninterrupted)", gd_main, gd)
    print(f"resume: crashed after a snapshot at source frame {next_fid - 1} "
          f"({size_mb:.1f} MB npz); the resumed run ({wall:.3f} s, launches "
          f"{json.dumps(n)}) equals the uninterrupted one  [{card_line}]",
          flush=True)
    return n


@contextlib.contextmanager
def timed_host_ingest():
    """Time every ``host_detect_pack`` call (the host ingest, run in the
    engine's packer threads) while the block runs, and inside it the gray
    conversion, FAST, the ORB bits and the pooling → {"s": seconds summed
    over the calls, "frames": frames packed, "parts": {part: seconds},
    "gray_planes": chunks that returned a gray plane}."""
    import threading

    from slam_indoor_code_tpu_torch.models import frontend

    spent = {"s": 0.0, "frames": 0, "gray_planes": 0,
             "parts": {"gray": 0.0, "fast": 0.0, "orb": 0.0, "pool": 0.0}}
    lock = threading.Lock()
    names = {"gray": "host_gray", "fast": "_host_detect_frame",
             "orb": "host_orb_bits", "pool": "area_downscale"}
    origs = {attr: getattr(frontend, attr)
             for attr in ("host_detect_pack", *names.values())}

    def timed(chunk, *a, **kw):
        t = time.perf_counter()
        out = origs["host_detect_pack"](chunk, *a, **kw)
        with lock:
            spent["s"] += time.perf_counter() - t
            spent["frames"] += len(chunk)
            spent["gray_planes"] += "gray_small" in out
        return out

    def timed_part(part, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            with lock:
                spent["parts"][part] += time.perf_counter() - t
            return out
        return run

    frontend.host_detect_pack = timed
    for part, attr in names.items():
        setattr(frontend, attr, timed_part(part, origs[attr]))
    try:
        yield spent
    finally:
        for attr, fn in origs.items():
            setattr(frontend, attr, fn)


@contextlib.contextmanager
def timed_tracking():
    """Time every ``steps.advance_stream`` call on the main thread (the
    streaming loop's scan steps and in-scan BA; its host reads make the
    call wait for the card) → {"s": seconds, "calls": calls}."""
    from slam_indoor_code_tpu_torch.runtime import steps

    spent = {"s": 0.0, "calls": 0}
    orig = steps.advance_stream

    def timed(*a, **kw):
        t = time.perf_counter()
        out = orig(*a, **kw)
        spent["s"] += time.perf_counter() - t
        spent["calls"] += 1
        return out

    steps.advance_stream = timed
    try:
        yield spent
    finally:
        steps.advance_stream = orig


def ingest_line(spent, n_frames: int) -> str:
    """Host ingest ms per frame and its parts, from timed_host_ingest."""
    f = max(spent["frames"], 1)
    parts = ", ".join(f"{k} {1e3 * v / f:.3f}"
                      for k, v in spent["parts"].items())
    return (f"host ingest {1e3 * spent['s'] / f:.3f} ms per frame ({parts}; "
            f"{spent['frames']} frames packed for {n_frames} on "
            f"{os.cpu_count()} cores)")


def stream_path(card_line: str, scene, frames, what: str = "stream path"):
    """``slam_main`` with ``stream_config`` → (launch counts, GlobalData):
    every active scan step and each bootstrap ``match_select`` through
    ``top2_batch``, nothing else; the host ingest timed per frame."""
    with timed_host_ingest() as spent, \
            tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, _ = slam_run(stream_config(out), scene, frames)
    cfg = engine.cfg
    if not (engine._will_stream and cfg.ingest_mode == "host"
            and cfg.host_desc == "same" and cfg.ingest_downscale == 2):
        fail(f"{what}: the engine took ingest {cfg.ingest_mode}, "
             f"host_desc {cfg.host_desc}, d={cfg.ingest_downscale}, "
             f"streaming {engine._will_stream}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    hold_stream_launches(what, n, engine, "l2")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    print(f"{what}: {ingest_line(spent, N_FRAMES)}, "
          f"{engine.stream_calls} advance_stream calls, "
          f"{engine.stream_steps} active scan steps, "
          f"{engine.match_select_calls} bootstrap match_select  "
          f"[{card_line}]", flush=True)
    return n, gd


def plain_by_lane(A, Bt, V, metric: str = "l2"):
    """``top2_batch_plain`` one candidate lane at a time, concatenated: the
    plain version holds [1,N,M] f32 distances at once instead of [B,N,M]
    (6.7 GB at the 4K shape)."""
    import torch

    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    outs = [ck.top2_batch_plain(A, Bt[i:i + 1], V[i:i + 1], metric)
            for i in range(Bt.shape[0])]
    return tuple(torch.cat(x) for x in zip(*outs))


def ring_operands(engine, lanes: int = 16):
    """The ring of a finished run as the path hands it to ``top2_batch``:
    the slot of the earliest frame still held as the query, the next
    ``lanes`` frames' slots as the candidates, their validity as the column
    mask → (A [K,D], Bt [lanes,K,D], V [lanes,K]) on the card."""
    import torch

    by_frame = sorted(engine._slot_frame.items(), key=lambda kv: kv[1])
    idx = torch.tensor([slot for slot, _ in by_frame[:lanes + 1]],
                       device=engine.state.ring_desc.device)
    st = engine.state
    return (st.ring_desc[idx[0]].contiguous(),
            st.ring_desc[idx[1:]].contiguous(),
            st.ring_valid[idx[1:]].contiguous())


def hold_on_ring(engine, metric: str, what: str) -> float:
    """``top2_batch`` on the ring's own descriptors (ring_operands) against
    its plain version, lane by lane: Hamming exact, L2 by ``hold_l2``.
    Returns max |Δ|."""
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    A, Bt, V = ring_operands(engine)
    k = host(ck.top2_batch(A, Bt, V, metric=metric))
    p = host(plain_by_lane(A, Bt, V, metric))
    if metric == "hamming":
        hold_exact(k, p, what)
        return 0.0
    return hold_l2(k, p, host((A,))[0], host((Bt,))[0], what)


@contextlib.contextmanager
def host_desc_calls():
    """Count the calls of the three host-ingest steps while the block runs
    → {"same": n, "hybrid": n, "orb": n, "ring": ...}; the first
    ``ingest_host_hybrid`` call also records one ring slot it wrote in
    "ring": {"slot", "equal" (its last 256 columns equal α × the uploaded
    bits, MSB first), "rows" (rows with a bit set), "sift_rows" (rows with
    a SIFT value)}."""
    import numpy as np

    from slam_indoor_code_tpu_torch.runtime import steps

    calls = {"same": 0, "hybrid": 0, "orb": 0, "ring": {}}
    names = {"same": "ingest_host", "hybrid": "ingest_host_hybrid",
             "orb": "ingest_host_desc"}
    origs = {k: getattr(steps, v) for k, v in names.items()}

    def counted(kind):
        def run(cfg, state, *a, **kw):
            state = origs[kind](cfg, state, *a, **kw)
            calls[kind] += 1
            if kind == "hybrid" and not calls["ring"]:
                desc_bits, slots = a[1], a[5]
                slot = int(slots[0])
                bits = np.unpackbits(desc_bits[0].cpu().numpy(), axis=-1,
                                     bitorder="big")
                got = state.ring_desc[slot].cpu().numpy()
                calls["ring"] = {
                    "slot": slot,
                    "equal": bool(np.array_equal(
                        got[:, 128:], np.float32(cfg.hybrid_alpha) * bits)),
                    "rows": int(bits.any(-1).sum()),
                    "sift_rows": int((got[:, :128] != 0).any(-1).sum())}
            return state
        return run

    for kind, name in names.items():
        setattr(steps, name, counted(kind))
    try:
        yield calls
    finally:
        for kind, name in names.items():
            setattr(steps, name, origs[kind])


def host_desc_run(cfg_fn, scene, frames):
    """``slam_run`` of ``cfg_fn`` with the host ingest, its parts, the
    tracking calls, the host-ingest steps and the peak device memory
    recorded → (counts, GlobalData, wall, engine, ingest, tracking, step
    calls, peak bytes)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    with host_desc_calls() as calls, timed_host_ingest() as spent, \
            timed_tracking() as trk, tempfile.TemporaryDirectory() as out:
        n, gd, wall, engine, _ = slam_run(cfg_fn(out), scene, frames)
    peak = torch.cuda.max_memory_allocated()
    return n, gd, wall, engine, spent, trk, calls, peak


def hold_stream_launches(what, n, engine, metric: str):
    """One ``top2_batch`` launch per active scan step and per bootstrap
    ``match_select``, all with ``metric``, and no other kernel."""
    want = engine.stream_steps + engine.match_select_calls
    if n["top2_batch"] != want or engine.stream_steps == 0:
        fail(f"{what}: top2_batch launched {n['top2_batch']} times for "
             f"{engine.stream_steps} active scan steps and "
             f"{engine.match_select_calls} bootstrap matches")
    n_metric = n["top2_batch"] if metric == "l2" else n["hamming"]
    if (n_metric != n["top2_batch"] or n["top2_l1"] or n["top2_pair"]
            or (metric == "l2" and n["hamming"])):
        fail(f"{what}: launched another kernel than the {metric} "
             f"top2_batch: {n}")


def hybrid_path(card_line: str, scene, frames, what: str = "hybrid path"):
    """``slam_main`` with ``hybrid_config`` (host descriptor "auto" under
    host ingest) → (launch counts, GlobalData, engine): it must resolve to
    "hybrid" with 384-dim descriptors, track as the other paths do, launch
    the L2 ``top2_batch`` once per active scan step and bootstrap match, and
    write α × the host's bits into the last 256 columns of a ring slot."""
    n, gd, wall, engine, spent, trk, calls, _ = host_desc_run(
        hybrid_config, scene, frames)
    cfg = engine.cfg
    if not (engine._will_stream and cfg.ingest_mode == "host"
            and cfg.host_desc == "hybrid" and cfg.desc_dim == 384
            and cfg.metric == "l2" and cfg.ingest_downscale == 2
            and tuple(engine.state.ring_desc.shape[-1:]) == (384,)):
        fail(f"{what}: the engine took ingest {cfg.ingest_mode}, host_desc "
             f"{cfg.host_desc}, D={cfg.desc_dim}, metric {cfg.metric}, "
             f"d={cfg.ingest_downscale}, streaming {engine._will_stream}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    hold_stream_launches(what, n, engine, "l2")
    ring = calls["ring"]
    if calls["same"] or calls["orb"] or not calls["hybrid"]:
        fail(f"{what}: host-ingest steps {calls}")
    if not (ring.get("equal") and ring["rows"] > 100
            and ring["sift_rows"] > 100):
        fail(f"{what}: ring slot {ring}: the last 256 columns are not "
             "α × the host's bits")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    print(f"{what}: {ingest_line(spent, N_FRAMES)}; tracking "
          f"{1e3 * trk['s'] / N_FRAMES:.3f} ms per frame in "
          f"{trk['calls']} advance_stream calls; ring slot {ring['slot']}: "
          f"columns 128..383 equal {cfg.hybrid_alpha} x the uploaded bits on"
          f" {ring['rows']} rows  [{card_line}]", flush=True)
    return n, gd, engine


def hostorb_path(card_line: str, scene, frames, what: str = "hostorb path"):
    """``slam_main`` with ``hostorb_config`` (ORB, host descriptor "auto"
    under host ingest) → (launch counts, GlobalData, engine): it must
    resolve to "orb", upload no gray plane (no chunk packs one, only
    ``ingest_host_desc`` runs), track as the other paths do and launch the
    Hamming ``top2_batch`` once per active scan step and bootstrap
    match."""
    import torch

    n, gd, wall, engine, spent, trk, calls, _ = host_desc_run(
        hostorb_config, scene, frames)
    cfg = engine.cfg
    if not (engine._will_stream and cfg.ingest_mode == "host"
            and cfg.host_desc == "orb" and cfg.metric == "hamming"):
        fail(f"{what}: the engine took ingest {cfg.ingest_mode}, host_desc "
             f"{cfg.host_desc}, metric {cfg.metric}, streaming "
             f"{engine._will_stream}")
    if engine.state.ring_desc.dtype != torch.int32 or tuple(
            engine.state.ring_desc.shape[-1:]) != (8,):
        fail(f"{what}: descriptors {engine.state.ring_desc.dtype} "
             f"{tuple(engine.state.ring_desc.shape)}, not int32 [..,8]")
    if spent["gray_planes"] or calls["same"] or calls["hybrid"] or \
            not calls["orb"]:
        fail(f"{what}: a gray plane was packed or described: "
             f"{spent['gray_planes']} chunks with a gray plane, steps "
             f"{calls}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    hold_stream_launches(what, n, engine, "hamming")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    print(f"{what}: {ingest_line(spent, N_FRAMES)}; tracking "
          f"{1e3 * trk['s'] / N_FRAMES:.3f} ms per frame in "
          f"{trk['calls']} advance_stream calls; no gray plane packed or "
          f"uploaded, {calls['orb']} ingest_host_desc calls  "
          f"[{card_line}]", flush=True)
    return n, gd, engine


def fourk_path(card_line: str, scene, frames, kernel_ms: float,
               bound_ms: float):
    """``slam_main`` with ``fourk_config`` on the 4K scene → (launch
    counts, GlobalData, engine): hybrid descriptors at 10,240 keypoints,
    at least 12/16 cameras at ATE < 5 %; prints the host ingest per frame
    and its parts beside the tracking per frame, the ring's size and the
    peak device memory, and the kernel's time per call at this shape."""
    what = "4k path"
    n, gd, wall, engine, spent, trk, calls, peak = host_desc_run(
        fourk_config, scene, frames)
    cfg = engine.cfg
    if not (engine._will_stream and cfg.host_desc == "hybrid"
            and cfg.desc_dim == 384 and cfg.ingest_downscale == 4
            and cfg.max_keypoints == 10240 and cfg.hybrid_alpha == 0.15):
        fail(f"{what}: the engine took host_desc {cfg.host_desc}, D="
             f"{cfg.desc_dim}, d={cfg.ingest_downscale}, K="
             f"{cfg.max_keypoints}, α={cfg.hybrid_alpha}, streaming "
             f"{engine._will_stream}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd, N_FRAMES_4K,
                                    MIN_CAMERAS_4K)
    on_cuda(what, engine)
    hold_stream_launches(what, n, engine, "l2")
    if not calls["ring"].get("equal"):
        fail(f"{what}: ring slot {calls['ring']}: the last 256 columns are "
             "not α × the host's bits")
    ring_mb = engine.state.ring_desc.numel() * 4 / 1e6
    report(what, n_cams, ate_pct, gd, wall, n, card_line, N_FRAMES_4K)
    print(f"{what}: {ingest_line(spent, N_FRAMES_4K)}; tracking "
          f"{1e3 * trk['s'] / N_FRAMES_4K:.3f} ms per frame in "
          f"{trk['calls']} advance_stream calls; top2_batch "
          f"{kernel_ms:.4f} ms per call at [10240,384] x [16,10240,384] "
          f"(bound {bound_ms:.4f} ms); ring {tuple(engine.state.ring_desc.shape)}"
          f" {ring_mb:.1f} MB; peak device memory {peak / 1e9:.3f} GB  "
          f"[{card_line}]", flush=True)
    return n, gd, engine


def run_engine(scene, frames, metric: str):
    """``DeviceEngine.run`` on CUDA with the headline configuration and
    ``EngineConfig.metric`` set, restarted on track loss as slam_main does
    → (GlobalData with the map, engine)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.io.logs import GlobalData
    from slam_indoor_code_tpu_torch.io.media import ArraySource
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine, EngineConfig

    cfg = headline_config("unused")
    ecfg = dataclasses.replace(EngineConfig.from_config(cfg), metric=metric)
    engine = DeviceEngine(ArraySource(frames), scene.K, ecfg,
                          batch_size=cfg.framesBatchSize,
                          required_extracted=cfg.requiredExtractedPointsCount,
                          seed=0, device="cuda")
    gd = GlobalData()
    init_R, init_t = np.eye(3), np.zeros(3)
    while True:
        res = engine.run(init_R, init_t)
        gd.extend(res["global_data"])
        if res["status"] != "interrupted" or res["last_pose"] is None:
            break
        init_R, init_t = res["last_pose"]
        if engine.media_exhausted:
            break
    gd.points, _ = engine.snapshot_map()
    return gd, engine


def l1_path(card_line: str, scene, frames, what: str = "l1 path"):
    """The L1 matching path: run_engine with metric="l1" → (launch counts,
    GlobalData)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    gd, engine = run_engine(scene, frames, "l1")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n = counts()
    if engine.cfg.metric != "l1":
        fail("the engine did not take metric='l1'")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    if n["top2_l1"] < n_cams - 1:
        fail(f"top2_l1 launched {n['top2_l1']} times for {n_cams} cameras")
    if n["top2_batch"] != 0:
        fail(f"the L1 path launched top2_batch {n['top2_batch']} times")
    print(f"{what}: cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of "
          f"extent  map {len(gd.points)} points  wall {wall:.3f} s  "
          f"{N_FRAMES / wall:.3f} frames/s  launches {json.dumps(n)}  "
          f"[{card_line}]", flush=True)
    return n, gd


def same_run(what: str, first, second, tag: str = "repro") -> None:
    """Two runs of one path on the same frames and seed must agree bit for
    bit: the same cameras (source frame ids), map size, poses and map
    points."""
    import numpy as np

    fields = {"cameras": (np.asarray(first.frame_ids),
                          np.asarray(second.frame_ids)),
              "map size": (len(first.points), len(second.points)),
              "rotations": (first.rotations, second.rotations),
              "positions": (first.positions, second.positions),
              "map points": (first.points, second.points)}
    for name, (x, y) in fields.items():
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            fail(f"{what}: {name} differ between two runs")
    print(f"{tag} {what}: the two runs equal bit for bit: cameras "
          f"{len(first.rotations)}, map {len(first.points)} points",
          flush=True)


def pair_entry(card_line: str, frames):
    """knn.match_pair on CUDA with 2048-keypoint SIFT descriptors of frames
    0 and 2 against match_pair on CPU copies of the same tensors.  The
    kernel rounds its operands to bf16 (as the TPU kernel does) where the
    CPU path keeps f32, so rows may differ where the bf16-rounded plain
    version decides the ratio test otherwise than the f32 one, or where its
    ratio margin d1 − r²·d2 is inside the L2 rule's distance tolerance
    (rtol 1e-4 plus 1e-6·(|a|²+|b|²) on each of d1 and d2); nowhere
    else."""
    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch.models.frontend import (
        FrontendConfig, extract_and_describe_gray_batch, pack_frames)
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck
    from slam_indoor_code_tpu_torch.ops import knn

    ratio = 0.8
    gray, small = pack_frames([frames[0], frames[2]])
    det = extract_and_describe_gray_batch(
        FrontendConfig(max_keypoints=2048, threshold=20.0, ratio=ratio),
        torch.from_numpy(gray).cuda(), torch.from_numpy(small).cuda())
    desc, valid = det["desc"], det["valid"]
    if tuple(desc.shape) != (2, 2048, 128):
        fail(f"pair: descriptors {tuple(desc.shape)}")
    torch.cuda.synchronize()
    reset_counts()
    got = knn.match_pair(desc[0], valid[0], desc[1], valid[1], ratio, "l2")
    torch.cuda.synchronize()
    n = counts()
    if n["top2_pair"] != 1 or sum(n.values()) != 1:
        fail(f"pair: match_pair launched {n}")
    dc, vc = desc.cpu(), valid.cpu()
    ref = knn.match_pair(dc[0], vc[0], dc[1], vc[1], ratio, "l2")
    pd1, _, pd2 = (x.numpy() for x in ck.top2_pair_plain(dc[0], dc[1], vc[1]))
    r2 = np.float32(ratio) * np.float32(ratio)
    atol = 1e-6 * float((dc.float() ** 2).sum(-1).max()) * 2.0
    margin_tol = (1e-4 * pd1 + atol) + r2 * (1e-4 * np.minimum(pd2, 1e30)
                                             + atol)
    plain_match = (pd1 < r2 * pd2) & vc[0].numpy() & (pd1 < BIG / 2)
    ref_match = ref["is_match"].numpy()
    open_rows = (np.abs(pd1 - r2 * pd2) <= margin_tol) | (
        plain_match != ref_match)
    got_match = got["is_match"].cpu().numpy()
    if np.any(got_match[~open_rows] != ref_match[~open_rows]):
        fail("pair: is_match differs outside the open rows")
    both = got_match & ref_match
    if np.any(got["train_idx"].cpu().numpy()[both]
              != ref["train_idx"].numpy()[both]):
        fail("pair: train_idx differs on rows both sides match")
    n_got, n_ref = int(got["num_matches"]), int(ref["num_matches"])
    if abs(n_got - n_ref) > int(open_rows.sum()) or n_ref < 100:
        fail(f"pair: num_matches {n_got} vs CPU {n_ref} "
             f"({int(open_rows.sum())} open rows)")
    print(f"pair entry: num_matches {n_got} on the card, {n_ref} on the CPU "
          f"copies, {int(open_rows.sum())} open rows, launches "
          f"{json.dumps(n)}  [{card_line}]", flush=True)
    return n


def classic_config(out_dir: str):
    """The headline configuration on the classic host conductor
    (``tpu.device_runtime=false``)."""
    cfg = headline_config(out_dir)
    return dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, device_runtime=False))


def classic_path(card_line: str, scene, frames, what: str = "classic path"):
    """``slam_main`` with ``classic_config`` → (launch counts, GlobalData):
    one ``top2_batch`` launch per ``find_good_frame`` scan that matched,
    the descriptors on the card, no other kernel."""
    from slam_indoor_code_tpu_torch.models import frontend
    from slam_indoor_code_tpu_torch.pipeline import MainCycle

    devices = set()
    orig = frontend.match_against_batch

    def spy(fcfg, desc_prev, valid_prev, desc_batch, *a, **kw):
        devices.add((desc_prev.device.type, desc_batch.device.type))
        return orig(fcfg, desc_prev, valid_prev, desc_batch, *a, **kw)

    frontend.match_against_batch = spy
    try:
        with tempfile.TemporaryDirectory() as out:
            n, gd, wall, cycle, _ = slam_run(classic_config(out), scene,
                                             frames)
    finally:
        frontend.match_against_batch = orig
    if not isinstance(cycle, MainCycle):
        fail(f"{what}: slam_main did not take the classic conductor")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    if devices != {("cuda", "cuda")}:
        fail(f"{what}: descriptors matched on {sorted(devices)}")
    scans = cycle.scheduler.scans
    if n["top2_batch"] != scans or scans == 0:
        fail(f"{what}: top2_batch launched {n['top2_batch']} times for "
             f"{scans} matched find_good_frame scans")
    if n["top2_l1"] or n["top2_pair"] or n["hamming"] or n["lpb"]:
        fail(f"{what}: launched another kernel than the L2 top2_batch: {n}")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    print(f"{what}: {scans} find_good_frame scans, one top2_batch launch "
          f"each  [{card_line}]", flush=True)
    return n, gd


def first_divergence(a, b):
    """The first camera at which two runs part (a different source frame or
    pose, bit for bit), None where they are equal throughout."""
    import numpy as np

    n = min(len(a.rotations), len(b.rotations))
    for i in range(n):
        if (a.frame_ids[i] != b.frame_ids[i]
                or not np.array_equal(a.rotations[i], b.rotations[i])
                or not np.array_equal(a.positions[i], b.positions[i])):
            return i
    if len(a.rotations) != len(b.rotations):
        return n
    return None


def telemetry_path(card_line: str, scene, frames, gd_l2, logged_l2):
    """The headline with ``per_frame_telemetry``: the device runtime's
    classic loop one step per call, one "Matching time for index" line per
    scan step in time.txt, one ``top2_batch`` launch per scan step (and per
    bootstrap ``match_select``).  Prints whether it equals the fused L2
    run bit for bit and, if not, where the two part → launch counts."""
    import numpy as np

    with tempfile.TemporaryDirectory() as out:
        cfg = headline_config(out)
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, per_frame_telemetry=True))
        n, gd, wall, engine, logged = slam_run(cfg, scene, frames)
    picks, picks_l2 = logged["picks"], logged_l2["picks"]
    what = "telemetry"
    if engine._will_stream or not engine.cfg.per_frame_telemetry:
        fail(f"{what}: the engine did not take the one-step classic loop")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    if len(picks) < n_cams - 2:
        fail(f"{what}: {len(picks)} 'Matching time for index' lines for "
             f"{n_cams} cameras")
    if n["top2_batch"] != len(picks) + engine.match_select_calls:
        fail(f"{what}: top2_batch launched {n['top2_batch']} times for "
             f"{len(picks)} scan steps and {engine.match_select_calls} "
             "bootstrap matches")
    if n["top2_l1"] or n["top2_pair"] or n["hamming"] or n["lpb"]:
        fail(f"{what}: launched another kernel than the L2 top2_batch: {n}")
    report(what, n_cams, ate_pct, gd, wall, n, card_line)
    part = first_divergence(gd_l2, gd)
    same_map = (len(gd.points) == len(gd_l2.points)
                and np.array_equal(gd.points, gd_l2.points))
    step = next((i for i, (x, y) in enumerate(zip(picks_l2, picks))
                 if x != y), None)
    if step is None and len(picks) != len(picks_l2):
        step = min(len(picks), len(picks_l2))
    print(f"{what}: {len(picks)} per-step time.txt lines; equals the fused "
          f"L2 run bit for bit: cameras and poses "
          f"{part is None}, map {same_map}; first camera that differs: "
          f"{part}; first scan step whose chosen index differs: {step} "
          f"(fused {picks_l2[step:step + 3] if step is not None else '-'}, "
          f"per-frame {picks[step:step + 3] if step is not None else '-'})"
          f"  [{card_line}]", flush=True)
    return n


def cli_path(card_line: str, scene, frames, gd_l2, logged_l2):
    """The reference binary's contract: the 32 frames as PNG files, K as
    OpenCV XML, the headline configuration as JSON (three decode workers),
    then ``python3 -m slam_indoor_code_tpu_torch cfg.json --profile DIR``
    as a subprocess.  It must exit 0 and print the "map points" line; its
    six logs must reload with its cameras at ATE < 5 % (poses.txt holds
    each frame's pose as accepted, before the windowed BA moves it); DIR
    must hold a trace naming ``top2_l2_kernel`` and ``steps.`` spans.
    Prints whether its poses.txt equals phase 4's byte for byte (the same
    frames, K and seed) and times the photo decode per frame in this
    process."""
    import glob
    import re

    import numpy as np

    from slam_indoor_code_tpu_torch.config import dump_config
    from slam_indoor_code_tpu_torch.io import native
    from slam_indoor_code_tpu_torch.io.logs import load_global_data_from_logs
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.io.png import write_png
    from slam_indoor_code_tpu_torch.io.xmlio import save_matrix_to_xml

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        photos, out, prof = (os.path.join(root, d)
                             for d in ("photos", "out", "prof"))
        for d in (photos, out):
            os.makedirs(d)
        t = time.perf_counter()
        for i, f in enumerate(frames):
            write_png(os.path.join(photos, f"frame_{i}.png"), f)
        write_s = time.perf_counter() - t
        save_matrix_to_xml(os.path.join(root, "cam.xml"), scene.K, "K")
        cfg = dataclasses.replace(
            headline_config(out), threadsCount=3,
            photosPathPattern=os.path.join(photos, "*.png"),
            calibrationPath=os.path.join(root, "cam.xml"))
        cfg_path = os.path.join(root, "cfg.json")
        with open(cfg_path, "w") as f:
            f.write(dump_config(cfg))

        decoder = "native (libjpeg/libpng)"
        if not native.available():
            why = [ln for ln in native.build_error().splitlines()
                   if "error" in ln] or ["?"]
            decoder = (f"numpy PNG reader (io/png.py); the native build "
                       f"failed: {why[0].strip()[:120]}")
        t = time.perf_counter()
        src = MediaSource(photos_pattern=cfg.photosPathPattern, threads=3)
        decoded = list(src)
        decode_ms = 1e3 * (time.perf_counter() - t) / max(len(decoded), 1)
        if len(decoded) != len(frames) or not all(
                np.array_equal(a, b) for a, b in zip(decoded, frames)):
            fail("cli: the decoded photos differ from the rendered frames")

        env = dict(os.environ, PYTHONPATH=repo)
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "slam_indoor_code_tpu_torch", cfg_path,
             "--profile", prof], capture_output=True, text=True,
            timeout=600, cwd=repo, env=env)
        run_s = time.perf_counter() - t
        if r.returncode != 0:
            fail(f"cli: exit {r.returncode}: {r.stderr[-2000:]}")
        m = re.search(r"map points: (\d+); cameras: (\d+)", r.stdout)
        if m is None:
            fail(f"cli: no 'map points' line in {r.stdout[-500:]!r}")
        n_pts, n_cams = int(m.group(1)), int(m.group(2))
        for name in ("poses", "rotations", "points", "colors", "main",
                     "time"):
            if not os.path.getsize(os.path.join(out, f"{name}.txt")):
                fail(f"cli: {name}.txt is empty")
        gd = load_global_data_from_logs(out)
        with open(os.path.join(out, "poses.txt")) as f:
            same = f.read() == logged_l2["poses"]
        traces = glob.glob(os.path.join(prof, "*.json"))
        text = "".join(open(p).read() for p in traces)
        trace_mb = sum(os.path.getsize(p) for p in traces) / 1e6
    if len(gd.rotations) != n_cams or len(gd.points) != n_pts:
        fail(f"cli: the logs reload {len(gd.rotations)} cameras and "
             f"{len(gd.points)} points, the run printed {n_cams} and {n_pts}")
    if n_cams < MIN_CAMERAS:
        fail(f"cli: only {n_cams}/{N_FRAMES} frames became cameras")
    if n_cams == N_FRAMES:
        fids = np.arange(N_FRAMES)
    elif n_cams == len(gd_l2.rotations):
        fids = gd_l2.frame_ids
    else:
        fail(f"cli: {n_cams} cameras cannot be paired with ground truth")
    ate_pct = rel_ate_pct(scene, gd.rotations, gd.positions, fids)
    if not ate_pct < 100 * ATE_MAX_FRAC:
        fail(f"cli: ATE {ate_pct:.4f}% >= {100 * ATE_MAX_FRAC}% of extent")
    if "top2_l2_kernel" not in text or "steps." not in text:
        fail(f"cli: the trace in {len(traces)} file(s) names "
             f"top2_l2_kernel: {'top2_l2_kernel' in text}, steps. spans: "
             f"{'steps.' in text}")
    print(f"cli: exit 0, cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}% of "
          f"extent (logs reloaded)  map {n_pts} points  subprocess "
          f"{run_s:.3f} s (profiled)  trace {trace_mb:.1f} MB in "
          f"{len(traces)} file(s) names top2_l2_kernel and steps. spans  "
          f"poses.txt equals the main path's byte for byte: {same}  decode "
          f"{decode_ms:.3f} ms per frame (3 workers, {os.cpu_count()} cores; "
          f"{decoder}); PNG writing {1e3 * write_s / len(frames):.1f} ms per "
          f"frame  [{card_line}]", flush=True)

# ------------------------------------------------------- distribution slice

def sync_time(fn):
    """(fn(), seconds) with the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def board_views(K, n_views: int, seed: int = 3):
    """``n_views`` views of the 7x7 chessboard through K with distortion
    (0.08, -0.15, 0.001, -0.0005, 0) and 0.1 px noise, from a seed."""
    import numpy as np

    from slam_indoor_code_tpu_torch.calibration import make_object_points

    rng = np.random.default_rng(seed)
    obj = make_object_points()
    k1, k2, p1, p2, k3 = 0.08, -0.15, 0.001, -0.0005, 0.0
    views = []
    for _ in range(n_views):
        aa = rng.normal(0, 0.3, 3)
        th = np.linalg.norm(aa)
        k = aa / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        t = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40),
                      rng.uniform(400, 700)])
        Xc = obj @ R.T + t
        x, y = Xc[:, 0] / Xc[:, 2], Xc[:, 1] / Xc[:, 2]
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        uv = np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], 1)
        views.append(uv + rng.normal(0, 0.1, uv.shape))
    return obj, views


def calibrate_phase(card_line: str, scene):
    """``calibrate_camera`` on CUDA over 20 synthetic views of the board
    through the headline's FHD K: fx and fy within 1 %, rms < 0.3 px, K
    within 2e-3 relative of the port's CPU result on the same views; the
    XML written and reloaded."""
    import numpy as np

    from slam_indoor_code_tpu_torch.calibration import calibrate_camera
    from slam_indoor_code_tpu_torch.io.xmlio import (
        load_matrix_from_xml, save_calib_parameters_to_xml)

    obj, views = board_views(scene.K, 20)
    (K, dist, rvecs, tvecs, rms), secs = sync_time(
        lambda: calibrate_camera(obj, views, device="cuda"))
    t = time.perf_counter()
    Kc, _, _, _, rms_c = calibrate_camera(obj, views, device="cpu")
    cpu_s = time.perf_counter() - t
    for i, name in ((0, "fx"), (1, "fy")):
        err = abs(K[i, i] - scene.K[i, i]) / scene.K[i, i]
        if not err < 0.01:
            fail(f"calibrate: {name} {K[i, i]:.3f} is {100 * err:.3f}% from "
                 f"the truth {scene.K[i, i]:.3f}")
    if not rms < 0.3:
        fail(f"calibrate: rms {rms:.4f} px >= 0.3")
    rel = float(np.abs(K - Kc).max() / np.abs(Kc).max())
    if not rel < 2e-3:
        fail(f"calibrate: K on the card is {rel:.3g} (relative) from the "
             "CPU's")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cam.xml")
        save_calib_parameters_to_xml(path, K, dist.reshape(1, 5), rvecs,
                                     tvecs)
        if not (np.allclose(load_matrix_from_xml(path, "K"), K, atol=1e-6)
                and load_matrix_from_xml(path, "R").shape == (20, 3)):
            fail("calibrate: the XML does not reload K and the 20 views")
    print(f"calibrate: 20 views at FHD, fx {K[0, 0]:.4f} fy {K[1, 1]:.4f} "
          f"(truth {scene.K[0, 0]:.1f}), cx {K[0, 2]:.4f} cy {K[1, 2]:.4f}, "
          f"k1 {dist[0]:.5f} k2 {dist[1]:.5f}, rms {rms:.5f} px (CPU "
          f"{rms_c:.5f}); K vs CPU max rel {rel:.3g}; solve {secs:.4f} s on "
          f"the card, {cpu_s:.4f} s on the CPU ({os.cpu_count()} cores); XML "
          f"reloaded  [{card_line}]", flush=True)
    return secs


def ba_window_problem(scene, F: int = 8, slots: int = 2048,
                      points: int = 4096, seed: int = 77):
    """The headline's BA window shape from its scene: F frames of ``slots``
    keypoint slots over a ``points`` table whose first rows are the scene's
    landmarks; each frame observes the landmarks it sees (0.3 px noise),
    the poses after the first are perturbed by 0.02 and the points by 0.05
    (tests/test_parallel.py's problem at this size)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.geometry.rotations import \
        matrix_to_rodrigues

    import torch

    rng = np.random.default_rng(seed)
    n_real = min(len(scene.points), points)
    K4 = np.array([scene.K[0, 0], scene.K[1, 1], scene.K[0, 2],
                   scene.K[1, 2]], np.float32)
    uv = np.zeros((F, slots, 2), np.float32)
    idx = np.zeros((F, slots), np.int32)
    mask = np.zeros((F, slots), bool)
    cams = np.zeros((F, 6), np.float32)
    for f in range(F):
        uvf, vis = scene.project(f, noise=0.3, rng=rng)
        seen = np.flatnonzero(vis[:n_real])[:slots]
        uv[f, :len(seen)] = uvf[seen]
        idx[f, :len(seen)] = seen
        mask[f, :len(seen)] = True
        aa = matrix_to_rodrigues(torch.from_numpy(
            scene.rotations[f].astype(np.float32))).numpy()
        cams[f, :3] = aa + (rng.normal(0, 0.02, 3) if f else 0)
        cams[f, 3:] = scene.translations[f] + (rng.normal(0, 0.02, 3)
                                               if f else 0)
    pts = np.zeros((points, 3), np.float32)
    pts[:n_real] = scene.points[:n_real] + rng.normal(0, 0.05, (n_real, 3))
    pmask = np.zeros(points, bool)
    pmask[:n_real] = True
    return K4, cams, pts, uv, idx, mask, pmask


def shard_phase(card_line: str, scene, frames):
    """Eight virtual shards on cuda:0.  ``ShardedFrontend`` on 16 FHD
    frames (two a shard), SIFT/L2 and ORB/Hamming: the unsplit call's match
    counts exactly, 8 ``top2_batch`` launches per call.  ``ShardedBA`` at
    the headline's BA shape (8 frames, 4096 window points, Huber 2, 10 LM
    iterations) held to ``bundle_adjust_window`` with
    tests/test_parallel.py's rule → ({path: launches}, BA seconds)."""
    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch.models import frontend as fe
    from slam_indoor_code_tpu_torch.parallel import (ShardedBA,
                                                     ShardedFrontend,
                                                     make_mesh)
    from slam_indoor_code_tpu_torch.solver.ba import (BAConfig,
                                                      bundle_adjust_window)

    cuda0 = torch.device("cuda", 0)
    mesh = make_mesh((8,), ("batch",), devices=[cuda0] * 8)
    rgb = torch.from_numpy(np.stack(frames[1:17])).to(cuda0)
    launches = {}
    for path, desc, metric in (("shard", "sift", "l2"),
                               ("shard (hamming)", "orb", "hamming")):
        fcfg = fe.FrontendConfig(max_keypoints=2048, threshold=20.0,
                                 descriptor=desc, ratio=0.8, metric=metric)
        sf = ShardedFrontend(mesh, fcfg)
        cand = sf.extract_and_describe_batch(rgb)
        prev = fe.extract_and_describe(fcfg, torch.from_numpy(
            frames[0]).to(cuda0))
        fmask = torch.ones(16, dtype=torch.bool, device=cuda0)
        torch.cuda.synchronize()
        reset_counts()
        m_sh, sh_s = sync_time(lambda: sf.match_against_batch(
            prev["desc"], prev["valid"], cand["desc"], cand["valid"], fmask))
        n = counts()
        m_ref, ref_s = sync_time(lambda: fe.match_against_batch(
            fcfg, prev["desc"], prev["valid"], cand["desc"], cand["valid"],
            fmask))
        if n["top2_batch"] != 8 or n["plain"]:
            fail(f"{path}: {n['top2_batch']} top2_batch launches for 8 "
                 f"shards ({n})")
        if metric == "hamming" and n["hamming"] != 8:
            fail(f"{path}: {n['hamming']} Hamming launches for 8 shards")
        got = m_sh["num_matches"].cpu().numpy()
        want = m_ref["num_matches"].cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"{path}: sharded match counts {got.tolist()} differ from "
                 f"the unsplit call's {want.tolist()}")
        if not int(got[0]) > 100:
            fail(f"{path}: only {int(got[0])} matches on the next frame")
        launches[path] = n["top2_batch"]
        print(f"{path}: ShardedFrontend ({desc}/{metric}) on 8 virtual "
              f"shards of cuda:0, B=16 FHD frames: counts equal the unsplit "
              f"call's exactly {got.tolist()}; 8 top2_batch launches; "
              f"sharded match {1e3 * sh_s:.3f} ms, unsplit "
              f"{1e3 * ref_s:.3f} ms (host clock, synchronised)  "
              f"[{card_line}]", flush=True)

    prob = ba_window_problem(scene)
    cfg = BAConfig(loss="huber", loss_param=2.0, max_iters=10)
    dev_args = [torch.from_numpy(a).to(cuda0) for a in prob]
    (_, cams_s, pts_s, info), single_s = sync_time(
        lambda: bundle_adjust_window(cfg, *dev_args))
    res, sharded_s = sync_time(
        lambda: ShardedBA(mesh, cfg, window=8).solve(*prob))
    cams_s = cams_s.cpu().numpy()
    pts_s = pts_s.cpu().numpy()
    fc = float(info["final_cost"])
    real = prob[6]
    dcam = float(np.abs(res.cams - cams_s).max())
    dpt = np.linalg.norm(res.points[real] - pts_s[real], axis=1)
    if not (dcam < 5e-3 and res.final_cost < 0.2 * res.initial_cost
            and abs(res.final_cost - fc) / fc < 0.05
            and float(np.abs(res.points[real] - pts_s[real]).max()) < 0.15
            and float(np.median(dpt)) < 0.05):
        fail(f"shard BA: cams max|d| {dcam:.3g}, cost {res.initial_cost:.3f}"
             f" -> {res.final_cost:.3f} vs single {fc:.3f}, points max|d| "
             f"{float(np.abs(res.points[real] - pts_s[real]).max()):.3g} "
             f"median {float(np.median(dpt)):.3g}")
    print(f"shard BA: ShardedBA on 8 virtual shards of cuda:0, 8 frames x "
          f"2048 slots, {int(real.sum())} of 4096 window points, Huber 2, "
          f"10 LM iterations: cost {res.initial_cost:.3f} -> "
          f"{res.final_cost:.3f} (bundle_adjust_window {fc:.3f}, "
          f"{info['num_iters']} iterations), cams max|d| {dcam:.3g}, points "
          f"median |d| {float(np.median(dpt)):.3g}; solve {sharded_s:.4f} s "
          f"sharded, {single_s:.4f} s single  [{card_line}]", flush=True)
    return launches, sharded_s


def mesh_phase(card_line: str, scene, frames, gd_l2):
    """``slam_main`` on the headline with ``mesh_shape=(cards,)``: on one
    card it must equal the L2 main path bit for bit → launch counts."""
    import torch

    n_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as out:
        cfg = headline_config(out)
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, mesh_shape=(n_cards,)))
        n, gd, wall, engine, _ = slam_run(cfg, scene, frames)
    what = "mesh"
    if engine.mesh is None or engine.mesh.size != n_cards:
        fail(f"{what}: the engine built the mesh {engine.mesh}")
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    on_cuda(what, engine)
    if n["top2_l1"] or n["top2_pair"] or n["hamming"] or n["lpb"]:
        fail(f"{what}: launched another kernel than the L2 top2_batch: {n}")
    report(f"{what} ({n_cards} card(s))", n_cams, ate_pct, gd, wall, n,
           card_line)
    if n_cards == 1:
        same_run("mesh (1 card) and the L2 main path", gd_l2, gd,
                 tag="mesh:")
    return n


def sequences_phase(card_line: str, scene, frames, gd_l2):
    """``run_sequences_parallel`` on two 32-frame FHD sequences (the
    headline scene, and the same hallway from scene seed 8; RANSAC seed 0
    both), each thread on a CUDA stream of its own: each equals its own
    solo run (``slam_main`` on the default stream) bit for bit; the
    parallel wall beside the sum of the two solo walls, taken warm just
    before it → launch counts of the parallel run."""
    import torch

    from slam_indoor_code_tpu_torch.app import run_sequences_parallel

    scene2, frames2 = headline_scene(seed=8)
    solos, walls = [], []
    for sc, fr in ((scene, frames), (scene2, frames2)):
        with tempfile.TemporaryDirectory() as out:
            _, gd, wall, _, _ = slam_run(headline_config(out), sc, fr)
        solos.append(gd)
        walls.append(wall)
    same_run("solo headline (warm) and the L2 main path", gd_l2, solos[0],
             tag="sequences:")
    with tempfile.TemporaryDirectory() as o0, \
            tempfile.TemporaryDirectory() as o1:
        cfgs = [headline_config(o0), headline_config(o1)]
        torch.cuda.synchronize()
        reset_counts()
        out, wall = sync_time(lambda: run_sequences_parallel(
            cfgs, [scene.K, scene2.K], [frames, frames2], seeds=[0, 0]))
        n = counts()
    if n["plain"] or n["top2_l1"] or n["top2_pair"] or n["hamming"]:
        fail(f"sequences: launched another kernel than top2_batch: {n}")
    for i, (sc, gd, solo) in enumerate(zip((scene, scene2), out, solos)):
        n_cams, ate_pct = trajectory_ok(f"sequence {i}", sc, gd)
        same_run(f"sequence {i} and its solo run", solo, gd,
                 tag="sequences:")
        print(f"sequences: sequence {i} cameras {n_cams}/{N_FRAMES} ATE "
              f"{ate_pct:.4f}% of extent", flush=True)
    if n["top2_batch"] < len(out[0].rotations) + len(out[1].rotations) - 2:
        fail(f"sequences: {n['top2_batch']} top2_batch launches for "
             f"{len(out[0].rotations)} + {len(out[1].rotations)} cameras")
    print(f"sequences: two 32-frame FHD sequences on "
          f"{torch.cuda.device_count()} card(s), one thread and CUDA stream "
          f"each: wall {wall:.3f} s against the solo walls {walls[0]:.3f} + "
          f"{walls[1]:.3f} = {sum(walls):.3f} s (ratio "
          f"{wall / sum(walls):.3f}); launches {json.dumps(n)}  "
          f"[{card_line}]", flush=True)
    return n, wall, walls


def distributed_phase(card_line: str):
    """Two worker processes (``parallel/worker.py ba``) run
    ``ShardedBA.solve_multiprocess`` across the process boundary on the
    card at the headline's BA shape (gloo with both ranks on cuda:0 on one
    card, NCCL where each rank has its own): final cost within 1e-3
    relative and cameras within 5e-4 of the one-process solve, checked by
    each worker → the workers' lines."""
    import re
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "slam_indoor_code_tpu_torch.parallel.worker",
         "ba", f"127.0.0.1:{port}", "2", str(r), "--device", "cuda",
         "--frames", "8", "--slots", "2048", "--points", "4096"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=repo, env=env) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    wall = time.perf_counter() - t
    lines = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        m = re.search(r"^proc \d .*cross-process BA cost.* OK$", out, re.M)
        if p.returncode != 0 or m is None:
            fail(f"distributed: rank {r} exit {p.returncode}:\n"
                 f"{out[-2500:]}")
        lines.append(m.group(0))
    for ln in lines:
        print(f"distributed: {ln}  [{card_line}]", flush=True)
    print(f"distributed: two processes, {wall:.3f} s from spawn to exit",
          flush=True)
    return lines


def main() -> None:
    name, card_line = card()
    phase("card", device=repr(name))
    try:
        secs = build()
        hmma = tensor_core_instructions()
        phase("build", nvcc_s=f"{secs:.2f}", hmma=json.dumps(hmma))
        rows = kernels()
        phase("kernels", **{r["name"].replace(" ", ""): (
            f"{r['ms']:.4f}ms(plain={r['plain_ms']:.4f},"
            f"bound={r['bound_ms']:.5f},err={r['max_abs_err']:.3g})")
            for r in rows.values()})
        scene, frames = headline_scene()
        phase("render", frames=N_FRAMES)
        count_plain_calls()
        n, gd_l2, logged_l2 = main_path(card_line, scene, frames)
        rows["top2_batch"]["launches"] = n["top2_batch"]
        # top2_batch's launches on each path that runs it
        by_path = {"main": n["top2_batch"]}
        rows["top2_batch"]["launches_by_path"] = by_path
        for lpb in (2, 4):
            rows[f"lpb{lpb}"]["launches"] = n["lpb"]
        phase("main", top2_batch_launches=n["top2_batch"])
        n, gd_l1 = l1_path(card_line, scene, frames)
        rows["top2_l1"]["launches"] = n["top2_l1"]
        phase("l1", top2_l1_launches=n["top2_l1"])
        n, gd_orb = orb_path(card_line, scene, frames)
        rows["hamming"]["launches"] = n["hamming"]
        by_path["orb (hamming)"] = n["hamming"]
        phase("orb", hamming_launches=n["hamming"])
        n, rec = global_path(card_line, scene, frames, gd_l2)
        by_path["global"] = n["top2_batch"]
        phase("global", top2_batch_launches=n["top2_batch"],
              solve_s=f"{rec['solve_s']:.3f}")
        n = resume_path(card_line, scene, frames, gd_l2)
        by_path["resume"] = n["top2_batch"]
        phase("resume", top2_batch_launches=n["top2_batch"])
        n, gd_stream = stream_path(card_line, scene, frames)
        by_path["stream"] = n["top2_batch"]
        phase("stream", top2_batch_launches=n["top2_batch"])
        n, gd_hybrid, engine = hybrid_path(card_line, scene, frames)
        rows["d384"]["launches"] = n["top2_batch"]
        by_path["hybrid (D=384)"] = n["top2_batch"]
        err = hold_on_ring(engine, "l2", "top2_batch on the hybrid ring")
        phase("hybrid", top2_batch_launches=n["top2_batch"],
              ring_max_abs_err=f"{err:.3g}")
        n, _, engine = hostorb_path(card_line, scene, frames)
        rows["host_words"] = host_words_row(engine)
        rows["host_words"]["launches"] = n["hamming"]
        by_path["hostorb (hamming)"] = n["hamming"]
        del engine
        phase("hostorb", hamming_launches=n["hamming"])
        n = pair_entry(card_line, frames)
        rows["top2_pair"]["launches"] = n["top2_pair"]
        phase("pair", top2_pair_launches=n["top2_pair"])
        n, gd_classic = classic_path(card_line, scene, frames)
        by_path["classic"] = n["top2_batch"]
        phase("classic", top2_batch_launches=n["top2_batch"])
        n = telemetry_path(card_line, scene, frames, gd_l2, logged_l2)
        by_path["telemetry"] = n["top2_batch"]
        phase("telemetry", top2_batch_launches=n["top2_batch"])
        cli_path(card_line, scene, frames, gd_l2, logged_l2)
        phase("cli")
        calib_s = calibrate_phase(card_line, scene)
        phase("calibrate", solve_s=f"{calib_s:.4f}")
        shard_launches, shard_ba_s = shard_phase(card_line, scene, frames)
        by_path.update(shard_launches)
        phase("shard", top2_batch_launches=json.dumps(shard_launches),
              ba_s=f"{shard_ba_s:.4f}")
        n = mesh_phase(card_line, scene, frames, gd_l2)
        by_path["mesh"] = n["top2_batch"]
        phase("mesh", top2_batch_launches=n["top2_batch"])
        n, seq_wall, solo_walls = sequences_phase(card_line, scene, frames,
                                                  gd_l2)
        by_path["sequences"] = n["top2_batch"]
        phase("sequences", top2_batch_launches=n["top2_batch"],
              wall_s=f"{seq_wall:.3f}",
              solo_s=f"{solo_walls[0]:.3f}+{solo_walls[1]:.3f}")
        distributed_phase(card_line)
        phase("distributed")
        scene4k, frames4k = fourk_scene()
        n, _, engine = fourk_path(card_line, scene4k, frames4k,
                                  rows["d384_4k"]["ms"],
                                  rows["d384_4k"]["bound_ms"])
        rows["d384_4k"]["launches"] = n["top2_batch"]
        by_path["4k (D=384)"] = n["top2_batch"]
        err = hold_on_ring(engine, "l2", "top2_batch on the 4K ring")
        del engine, frames4k
        phase("4k", top2_batch_launches=n["top2_batch"],
              ring_max_abs_err=f"{err:.3g}")
        _, again, _ = main_path(card_line, scene, frames, "main path, run 2")
        same_run("main path", gd_l2, again)
        _, again = classic_path(card_line, scene, frames,
                                "classic path, run 2")
        same_run("classic path", gd_classic, again)
        _, again = l1_path(card_line, scene, frames, "l1 path, run 2")
        same_run("l1 path", gd_l1, again)
        _, again = orb_path(card_line, scene, frames, "orb path, run 2")
        same_run("orb path", gd_orb, again)
        _, again = stream_path(card_line, scene, frames, "stream path, run 2")
        same_run("stream path", gd_stream, again)
        _, again, _ = hybrid_path(card_line, scene, frames,
                                  "hybrid path, run 2")
        same_run("hybrid path", gd_hybrid, again)
        phase("repro", runs=12)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 — every phase failure fails the run
        import traceback

        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
    import torch

    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
