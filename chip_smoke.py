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
              (and ``top2_batch`` with metric "hamming" at ORB's shapes),
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
6. pair     — ``knn.match_pair`` on CUDA with the SIFT descriptors of two
              rendered frames: one ``top2_pair`` launch, the same matches as
              ``match_pair`` on CPU copies up to the rows the L2 tolerance
              leaves open.
7. repro    — phases 4 and 5 once more in the same process: each second
              run must give the first run's cameras, map size, poses and
              map points bit for bit.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and prints
no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
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
# ingest) and its synthetic scene.  The L1 path is held to the same limits:
# the JAX package's L1 engine on these 32 frames (CPU run,
# scripts/jax_l1_headline_cpu.py) tracks 32/32 frames well inside them.
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
    return rows


# ------------------------------------------------------------- main paths

def trajectory_ok(what, scene, gd):
    """Cameras, finite poses and points, ATE against ground truth."""
    import numpy as np

    from slam_indoor_code_tpu_torch.metrics import absolute_trajectory_error
    from slam_indoor_code_tpu_torch.metrics.ate import camera_centers

    n_cams = len(gd.rotations)
    if n_cams < MIN_CAMERAS:
        fail(f"{what}: only {n_cams}/{N_FRAMES} frames became cameras")
    est = camera_centers(gd.rotations, gd.positions)
    if not np.all(np.isfinite(est)) or not np.all(np.isfinite(gd.points)):
        fail(f"{what}: non-finite poses or map points")
    gt = scene.centers()[np.asarray(gd.frame_ids, np.int64)]
    ate = absolute_trajectory_error(est, gt)
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    if not ate < ATE_MAX_FRAC * extent:
        fail(f"{what}: ATE {ate:.4f} >= {ATE_MAX_FRAC} of extent {extent:.3f}")
    return n_cams, 100 * ate / extent


def on_cuda(what, engine):
    for name, t in engine.state.tensors().items():
        if t.device.type != "cuda":
            fail(f"{what}: TrackerState.{name} is on {t.device}")


def reset_counts():
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    for fn in (ck.top2_batch, ck.top2_pair, ck.top2_l1):
        fn.launches = 0
    ck.top2_batch.multi_lane_launches = 0
    ck.top2_batch.hamming_launches = 0


def counts():
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    return {"top2_batch": ck.top2_batch.launches,
            "lpb": ck.top2_batch.multi_lane_launches,
            "hamming": ck.top2_batch.hamming_launches,
            "top2_pair": ck.top2_pair.launches,
            "top2_l1": ck.top2_l1.launches}


def main_path(card_line: str, scene, frames, what: str = "main path"):
    """``slam_main`` on CUDA with the headline configuration → (launch
    counts of the run, its GlobalData)."""
    import torch

    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.runtime import DeviceEngine

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
            reset_counts()
            t = time.perf_counter()
            gd = slam_main(cfg, scene.K, frames=frames, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            n = counts()
        finally:
            DeviceEngine.__init__ = orig_init
        with open(f"{out}/poses.txt") as f:
            n_logged = sum(1 for _ in f)
    n_cams, ate_pct = trajectory_ok(what, scene, gd)
    if n_logged < n_cams:
        fail(f"poses.txt has {n_logged} rows for {n_cams} cameras")
    on_cuda(what, engines[0])
    # one launch per tracked frame; the bootstrap pair shares one
    if n["top2_batch"] < n_cams - 1:
        fail(f"top2_batch launched {n['top2_batch']} times for {n_cams} "
             "cameras")
    print(f"{what}: cameras {n_cams}/{N_FRAMES}  ATE {ate_pct:.4f}%"
          f" of extent  map {len(gd.points)} points  wall {wall:.3f} s  "
          f"{N_FRAMES / wall:.3f} frames/s  launches {json.dumps(n)}  "
          f"[{card_line}]", flush=True)
    return n, gd


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


def same_run(what: str, first, second) -> None:
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
            fail(f"{what}: {name} differ between two runs in one process")
    print(f"repro {what}: two runs equal bit for bit: cameras "
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
        n, gd_l2 = main_path(card_line, scene, frames)
        rows["top2_batch"]["launches"] = n["top2_batch"]
        for lpb in (2, 4):
            rows[f"lpb{lpb}"]["launches"] = n["lpb"]
        rows["hamming"]["launches"] = n["hamming"]
        phase("main", top2_batch_launches=n["top2_batch"])
        n, gd_l1 = l1_path(card_line, scene, frames)
        rows["top2_l1"]["launches"] = n["top2_l1"]
        phase("l1", top2_l1_launches=n["top2_l1"])
        n = pair_entry(card_line, frames)
        rows["top2_pair"]["launches"] = n["top2_pair"]
        phase("pair", top2_pair_launches=n["top2_pair"])
        _, again = main_path(card_line, scene, frames, "main path, run 2")
        same_run("main path", gd_l2, again)
        _, again = l1_path(card_line, scene, frames, "l1 path, run 2")
        same_run("l1 path", gd_l1, again)
        phase("repro", runs=4)
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
