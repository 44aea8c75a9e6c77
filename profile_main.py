#!/usr/bin/env python3
"""Where the port's main path spends its time on the card.

    python3 profile_main.py [l2|l1|orb|stream|classic|tile|diverge|sequences]
    python3 profile_main.py stream [hybrid|hostorb|4k]
    python3 profile_main.py nullspace

Runs chip_smoke.py's headline configuration (FHD, 32 frames) through the
port's ``slam_main`` on CUDA (with ``l1``: through ``DeviceEngine.run`` with
``EngineConfig.metric="l1"``, chip_smoke.run_engine; with ``orb``: with only
``useFM-ORB`` set, chip_smoke.orb_config; with ``stream``: host ingest and
the streaming loop, chip_smoke.stream_config; with ``classic``: the classic
host conductor, chip_smoke.classic_config) twice unprofiled —
cold, then warm — and once under ``torch.profiler``.  Prints the card, the
profiled run's wall time, the share of that wall time in which the device
ran any kernel, the host and device time of each span ("steps.<name>", see
runtime/steps.py; "pipeline.<name>" on the classic conductor, see
pipeline/) and the kernels with the most device time; with ``stream`` also
the host ingest of each run, timed around every ``host_detect_pack`` call
in the packer threads (chip_smoke.timed_host_ingest; the profiler records
no op of those threads), split into the gray conversion, FAST, the ORB bits
and the pooling, beside the tracking per frame (the host wall of the
``advance_stream`` calls, chip_smoke.timed_tracking).  ``stream hybrid``
takes chip_smoke.hybrid_config (host descriptor "auto", which is "hybrid");
``stream hostorb`` chip_smoke.hostorb_config (ORB, "auto" is "orb");
``stream 4k`` takes chip_smoke.fourk_config on chip_smoke.fourk_scene
(bench.py's 4K point, 16 frames).  Writes the full table to
chiprun_out/profile_main[_l1|_orb|_stream[_hybrid|_hostorb|_4k]|_classic].txt.

With ``diverge``: the stream configuration once on CUDA and once on the
CPU (same frames, seed 0), every ``advance_stream`` step's row recorded
(flags, chosen index, the match counts of its candidates); prints the first
active step whose match counts differ and the first whose flags or chosen
index differ, the two count vectors there, the largest descriptor
difference between the two devices at that step, and the counts that the
CPU's f32 matcher and the kernel's bf16 plain version give on the card's
descriptors (which tells the descriptor's rounding from the matcher's).

With ``tile``: where the time of the L2/Hamming tile (csrc/top2_l2.cuh)
goes at the main path's shapes.  Builds copies of ``top2_batch`` with one
part of the tile taken out at a time (the epilogue, the tensor-core
products, the candidate loads, then all three), launches each through its C
entry point on bf16 operands and prints its time beside the whole kernel's.
The results of the reduced builds are wrong; only their times are read.

With ``sequences``: where the wall of ``app.run_sequences_parallel`` goes
on one card (chip_smoke.py's sequences phase: the headline scene and the
same hallway from scene seed 8).  Times each sequence solo (warm, twice),
then the two at once three ways: as they are; with Python's thread switch
interval at 0.5 ms instead of 5 ms (a thread that waited on the card takes
the interpreter back sooner); and with the Jacobian lock
(utils/autodiff.py) timed, to give the seconds the threads waited on it.
Each parallel result must equal its solo run bit for bit.

With ``nullspace``: why the DLT nullspaces (geometry/nullspace.py) solve in
float64 on CUDA.  On a batch of 4096 PnP-shaped 12x12 AᵀA from near-flat
6-point clouds, the smallest eigenpair from ``torch.linalg.eigh`` in
float32 on the CPU (LAPACK) and on CUDA (cuSOLVER), and in float64 on
CUDA, each against float64 LAPACK: the eigenvector's |cos| (minimum and
the share below 0.999) and the eigenvalue's median.  Then chip_smoke.py's
realtex scene through ``slam_main`` on CUDA for RANSAC seeds 0-3, with the
nullspaces in float32 (the solver as it was) and as they are now, and on
the CPU for seed 0: cameras, frame ids and ATE of each.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke

# The parts of top2_l2.cuh that the ``tile`` mode takes out: the text each
# edit replaces (it must occur once) and its stand-in, which keeps the
# operands of the removed work live so that the compiler keeps the rest.
_FOLD = "top2_fold(d, c0 + cl, d1[r], i1[r], d2[r]);"
_MMA = ("mma_bf16(acc[mi][2 * nb], af[mi], bf[0], bf[1]);",
        "mma_bf16(acc[mi][2 * nb + 1], af[mi], bf[2], bf[3]);")
_PARTS = {
    "epilogue (distance and top-2 fold; one add per distance left)":
        [(_FOLD, "d1[r] += v + bb;")],
    "tensor-core products (one integer op per fragment left)":
        [(_MMA[0], "acc[mi][2 * nb][0] += __uint_as_float(af[mi][0] ^ bf[0]);"),
         (_MMA[1], "acc[mi][2 * nb + 1][0] += "
                   "__uint_as_float(af[mi][1] ^ bf[2]);")],
    "candidate loads after the first stages":
        [("    if (item < nitems) {",
          "    if (item < nitems && item < L2_STAGES - 1) {")],
}
_PARTS["all three"] = [e for edits in list(_PARTS.values()) for e in edits]


def tile_parts() -> None:
    """Time the tile with each part taken out (see the module docstring)."""
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path

    import numpy as np

    from slam_indoor_code_tpu_torch.ops import build
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    _, card_line = chip_smoke.card()
    src = build.CSRC_DIR
    header = (src / "top2_l2.cuh").read_text()
    variants = {"whole kernel": [], **_PARTS}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, edits) in enumerate(variants.items()):
            d = Path(tmp) / f"v{i}"
            d.mkdir()
            text = header
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"tile: {old!r} is not in top2_l2.cuh "
                                     "exactly once")
                text = text.replace(old, new)
            (d / "top2_l2.cuh").write_text(text)
            for f in ("top2_merge.cuh", "top2_batch.cu"):
                shutil.copy(src / f, d / f)
            procs[name] = (d, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / "top2_batch.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        fns = {}
        for name, (d, p) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise SystemExit(f"tile: nvcc failed for {name}:\n{log}")
            fns[name] = ctypes.CDLL(str(d / "lib.so")).top2_batch_launch
            ck.set_signature(fns[name], "top2_batch_launch")

        N = M = 2048
        D, B = 128, 16
        a, b, vb = chip_smoke.make_case(np.random.default_rng(0), N, M, D, B)
        A, Bt, V = chip_smoke.on_card(a, b, vb)
        a16, b16 = A.to(torch.bfloat16), Bt.to(torch.bfloat16)
        mask = V.view(torch.uint8)
        outs = [torch.empty((B, N), dtype=t, device="cuda")
                for t in (torch.float32, torch.int32, torch.float32)]
        stream = torch.cuda.current_stream().cuda_stream
        whole = None
        for name, fn in fns.items():
            def launch(fn=fn):
                err = fn(a16.data_ptr(), b16.data_ptr(), mask.data_ptr(),
                         *(o.data_ptr() for o in outs), N, M, D, B, 1, stream)
                if err != 0:
                    raise SystemExit(f"tile: {name}: cudaError {err}")
            if whole is None:   # the unedited copy must hold its plain version
                launch()
                chip_smoke.hold_l2(chip_smoke.host(outs),
                                   chip_smoke.host(ck.top2_batch_plain(A, Bt, V)),
                                   a, b, "tile: whole kernel")
            ms = chip_smoke.time_ms(launch, reps=50, inner=10)
            if whole is None:
                whole = ms
                bound = 2.0 * B * N * M * D / chip_smoke.PEAK_BF16_FLOPS * 1e3
                label, note = name, f"(bound {bound:.5f} ms by operations)"
            else:
                label = f"without the {name}"
                note = f"(the part's share: {100 * (whole - ms) / whole:.1f}%)"
            print(f"[{card_line}] tile at B={B} N={N} M={M} D={D}, {label}: "
                  f"{ms:.4f} ms {note}", flush=True)


def _busy_ms(events) -> float:
    """Union of the device kernels' time ranges, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def _stream_steps(device: str, scene, frames) -> list:
    """The stream configuration through ``slam_main`` on ``device`` →
    per active ``advance_stream`` step: (row [found, good_pos, count_good],
    counts of the visible window, the descriptors it matched: prev [K,D],
    candidates [B,K,D], valid masks), all on the host."""
    import numpy as np

    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.runtime import steps

    rec, seen = [], []
    orig_adv, orig_match = steps.advance_stream, steps._match_order

    def adv(cfg, *a, **kw):
        out = orig_adv(cfg, *a, **kw)
        packed = out[5].cpu().numpy()
        for row in packed:
            if row[0] > 0.5:
                rec.append((row[1:4].copy(), row[24:].copy()))
        return out

    def match(cfg, state, order, order_mask):
        seen.append(tuple(x.cpu().numpy() for x in (
            state.prev_desc, state.prev_valid, state.ring_desc[order],
            state.ring_valid[order], order_mask)))
        return orig_match(cfg, state, order, order_mask)

    steps.advance_stream, steps._match_order = adv, match
    try:
        with tempfile.TemporaryDirectory() as out:
            gd = slam_main(chip_smoke.stream_config(out), scene.K,
                           frames=frames, seed=0, device=device)
    finally:
        steps.advance_stream, steps._match_order = orig_adv, orig_match
    # the bootstrap's match_select comes first in ``seen``
    descs = seen[len(seen) - len(rec):]
    print(f"{device}: {len(gd.rotations)} cameras, {len(rec)} active steps",
          flush=True)
    return [(r, c, d) for (r, c), d in zip(rec, descs)], np.asarray(
        gd.frame_ids)


def diverge() -> None:
    """See the module docstring (``diverge``)."""
    import numpy as np

    from slam_indoor_code_tpu_torch.ops import build, knn
    from slam_indoor_code_tpu_torch.ops import cuda_kernels as ck

    _, card_line = chip_smoke.card()
    build.build_all()
    scene, frames = chip_smoke.headline_scene()
    card, fid_card = _stream_steps("cuda", scene, frames)
    cpu, fid_cpu = _stream_steps("cpu", scene, frames)
    print(f"[{card_line}] cameras: card {fid_card.tolist()}, cpu "
          f"{fid_cpu.tolist()}", flush=True)
    first_count = next((k for k, (a, b) in enumerate(zip(card, cpu))
                        if not np.array_equal(a[1], b[1])), None)
    print(f"first active step whose match counts differ: {first_count}",
          flush=True)
    for k, ((rc, cc, dc), (rp, cp, dp)) in enumerate(zip(card, cpu)):
        if np.array_equal(rc[:2], rp[:2]):
            continue
        print(f"first active step whose flags or chosen index differ: {k}; "
              f"[found, good_pos, count_good] card {rc.tolist()}, cpu "
              f"{rp.tolist()}", flush=True)
        print(f"  match counts of the visible window: card "
              f"{cc.astype(int).tolist()}, cpu {cp.astype(int).tolist()}",
              flush=True)
        same_masks = all(np.array_equal(x, y) for x, y in
                         zip((dc[1], dc[3], dc[4]), (dp[1], dp[3], dp[4])))
        print(f"  descriptors: max |card - cpu| prev "
              f"{np.abs(dc[0] - dp[0]).max():.3g}, candidates "
              f"{np.abs(dc[2] - dp[2]).max():.3g}; valid masks equal: "
              f"{same_masks}", flush=True)
        t = [torch.from_numpy(x) for x in dc]
        res = knn.match_batch(*t, ratio=0.8, metric="l2")
        d1, i1, d2 = ck.top2_batch_plain(t[0], t[2], t[3])
        bf16 = knn._result(d1, i1, d2, t[1][None, :] & t[4][:, None], 0.8,
                           "l2")
        print(f"  on the card's descriptors, on the CPU: the f32 matcher "
              f"{res['num_matches'].numpy().tolist()}, the kernel's bf16 "
              f"plain version {bf16['num_matches'].numpy().tolist()}  "
              f"[{card_line}]", flush=True)
        return
    n = min(len(card), len(cpu))
    print(f"no flags or chosen index differ over the first {n} active "
          f"steps; active steps: card {len(card)}, cpu {len(cpu)}  "
          f"[{card_line}]", flush=True)
    for name, rows in (("card", card), ("cpu", cpu)):
        for k in range(max(n - 1, 0), len(rows)):
            print(f"  {name} step {k}: [found, good_pos, count_good] "
                  f"{rows[k][0].tolist()}, counts "
                  f"{rows[k][1].astype(int).tolist()}", flush=True)


def sequences() -> None:
    import threading

    from slam_indoor_code_tpu_torch.app import (run_sequences_parallel,
                                                slam_main)
    from slam_indoor_code_tpu_torch.ops import build
    from slam_indoor_code_tpu_torch.utils import autodiff

    _, card_line = chip_smoke.card()
    build.build_all()
    runs = [chip_smoke.headline_scene(), chip_smoke.headline_scene(seed=8)]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    solos, walls = [], []
    for sc, fr in runs:
        for _ in range(2):                   # the second run is the warm one
            with tempfile.TemporaryDirectory() as out:
                gd, wall = timed(lambda: slam_main(
                    chip_smoke.headline_config(out), sc.K, frames=fr))
        solos.append(gd)
        walls.append(wall)
    print(f"[{card_line}] solo walls (warm): {walls[0]:.3f} + "
          f"{walls[1]:.3f} = {sum(walls):.3f} s", flush=True)

    class TimedLock:
        def __init__(self, lock):
            self.lock, self.waited, self.n = lock, 0.0, 0

        def __enter__(self):
            t = time.perf_counter()
            self.lock.acquire()
            self.waited += time.perf_counter() - t
            self.n += 1

        def __exit__(self, *exc):
            self.lock.release()

    def parallel(label):
        with tempfile.TemporaryDirectory() as o0, \
                tempfile.TemporaryDirectory() as o1:
            cfgs = [chip_smoke.headline_config(o) for o in (o0, o1)]
            out, wall = timed(lambda: run_sequences_parallel(
                cfgs, [sc.K for sc, _ in runs], [fr for _, fr in runs],
                seeds=[0, 0]))
        for i, (gd, solo) in enumerate(zip(out, solos)):
            chip_smoke.same_run(f"sequence {i} ({label})", solo, gd,
                                tag="sequences:")
        print(f"[{card_line}] parallel, {label}: wall {wall:.3f} s (ratio "
              f"{wall / sum(walls):.3f} of the solo walls)", flush=True)
        return wall

    parallel("as is")
    default = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        parallel("switch interval 0.5 ms")
    finally:
        sys.setswitchinterval(default)
    plain = autodiff._LOCK
    autodiff._LOCK = TimedLock(threading.RLock())
    try:
        parallel("Jacobian lock timed")
        lock = autodiff._LOCK
        print(f"[{card_line}] Jacobian lock: {lock.n} acquisitions, "
              f"{lock.waited:.3f} s waited in all", flush=True)
    finally:
        autodiff._LOCK = plain


def nullspace() -> None:
    import torch

    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.geometry import essential, pnp, triangulate
    from slam_indoor_code_tpu_torch.geometry import nullspace as ns

    _, card_line = chip_smoke.card()
    chip_smoke.build()
    g = torch.Generator().manual_seed(0)
    X = (torch.randn(4096, 6, 3, generator=g)
         * torch.tensor([2.0, 1.0, 0.05]) + torch.tensor([0.0, 0.0, 5.0]))
    x = torch.randn(4096, 6, 2, generator=g) * 0.3
    Xh = torch.cat([X, torch.ones(4096, 6, 1)], -1)
    zeros = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, zeros, -x[..., :1] * Xh], -1),
                   torch.cat([zeros, Xh, -x[..., 1:] * Xh], -1)], 1)
    AtA = torch.einsum("sij,sik->sjk", A, A)
    w64, v64 = torch.linalg.eigh(AtA.double())
    for what, a in (("float32 LAPACK (cpu)", AtA),
                    ("float32 cuSOLVER (cuda)", AtA.cuda()),
                    ("float64 cuSOLVER (cuda)", AtA.cuda().double())):
        w, v = torch.linalg.eigh(a)
        cos = (v[..., 0].cpu().double() * v64[..., 0]).sum(-1).abs()
        print(f"eigh {what}: smallest eigenvector |cos| against float64 "
              f"LAPACK min {float(cos.min()):.6f}, share < 0.999 "
              f"{float((cos < 0.999).double().mean()):.4f}; smallest "
              f"eigenvalue median {float(w[:, 0].median()):.4e} (float64 "
              f"LAPACK {float(w64[:, 0].median()):.4e})  [{card_line}]",
              flush=True)

    def float32_solver(AtA):
        return torch.linalg.eigh(AtA)[1][..., 0]

    scene = chip_smoke.realtex_scene()
    frames = [scene.render(i, device="cuda")
              for i in range(chip_smoke.N_FRAMES_RT)]
    runs = [("cuda, nullspace float32", "cuda", s, float32_solver)
            for s in range(4)]
    runs += [("cuda, nullspace as now", "cuda", s, ns.smallest_eigenvector)
             for s in range(4)]
    runs += [("cpu", "cpu", 0, ns.smallest_eigenvector)]
    for what, device, seed, solver in runs:
        for m in (essential, pnp, triangulate):
            m.smallest_eigenvector = solver
        with tempfile.TemporaryDirectory() as out:
            gd = slam_main(chip_smoke.headline_config(out), scene.K,
                           frames=frames, seed=seed, device=device)
        ate = chip_smoke.rel_ate_pct(scene, gd.rotations, gd.positions,
                             gd.frame_ids)
        print(f"realtex {what}, seed {seed}: cameras "
              f"{len(gd.rotations)}/{chip_smoke.N_FRAMES_RT} ids "
              f"{[int(i) for i in gd.frame_ids]} ATE {ate:.4f}%  "
              f"[{card_line}]", flush=True)
    for m in (essential, pnp, triangulate):
        m.smallest_eigenvector = ns.smallest_eigenvector


def main() -> None:
    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.ops import build

    metric = sys.argv[1] if len(sys.argv) > 1 else "l2"
    if metric == "tile":
        return tile_parts()
    if metric == "diverge":
        return diverge()
    if metric == "sequences":
        return sequences()
    if metric == "nullspace":
        return nullspace()
    if metric not in ("l2", "l1", "orb", "stream", "classic"):
        raise SystemExit(f"mode must be l2, l1, orb, stream, classic, tile, "
                         f"diverge, sequences or nullspace, got {metric!r}")
    variant = sys.argv[2] if metric == "stream" and len(sys.argv) > 2 else ""
    if variant not in ("", "hybrid", "hostorb", "4k"):
        raise SystemExit(f"stream takes hybrid, hostorb or 4k, got "
                         f"{variant!r}")
    _, card_line = chip_smoke.card()
    build.build_all()
    scene, frames = (chip_smoke.fourk_scene() if variant == "4k"
                     else chip_smoke.headline_scene())
    walls = []
    with tempfile.TemporaryDirectory() as out:
        cfg = {"orb": chip_smoke.orb_config,
               "stream": {"": chip_smoke.stream_config,
                          "hybrid": chip_smoke.hybrid_config,
                          "hostorb": chip_smoke.hostorb_config,
                          "4k": chip_smoke.fourk_config}[variant],
               "classic": chip_smoke.classic_config}.get(
                   metric, chip_smoke.headline_config)(out)

        ingest = []          # (host ingest, tracking) of each run

        def run():
            if metric == "l1":
                return chip_smoke.run_engine(scene, frames, "l1")[0]
            with chip_smoke.timed_host_ingest() as spent, \
                    chip_smoke.timed_tracking() as trk:
                gd = slam_main(cfg, scene.K, frames=frames)
            ingest.append((spent, trk))
            return gd

        for _ in range(2):                   # cold (first) run, then warm
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        print(f"[{card_line}] {metric} unprofiled wall: cold {walls[0]:.1f} "
              f"ms, warm {walls[1]:.1f} ms "
              f"({len(frames) / walls[1] * 1e3:.3f} frames/s warm)",
              flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            gd = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    busy = _busy_ms(prof.events())
    print(f"[{card_line}] profiled run: {len(gd.rotations)} cameras, wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall, idle "
          f"{100 * (1 - busy / wall_ms):.1f}%)", flush=True)
    avg = prof.key_averages()
    # each span appears twice: its host range and its range on the device
    # timeline; the kernels it launched are summed under self device time
    prefixes = ("steps.", "pipeline.")
    spans: dict[str, list] = {}
    for e in avg:
        if e.key.startswith(prefixes):
            row = spans.setdefault(e.key, [0.0, 0, 0.0])
            row[0] = max(row[0], e.cpu_time_total / 1e3)
            row[1] = max(row[1], e.count)
    kernels_in = {k: 0.0 for k in spans}
    for e in prof.events():       # host ops carry the kernels they launched
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(prefixes):
            p = p.cpu_parent
        if p is not None:
            kernels_in[p.name] += sum(k.duration for k in e.kernels) / 1e3
    print("spans: host ms (span wall on the host) / kernel ms launched "
          "directly inside (innermost span) / calls")
    for k, (host, calls, _) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:28s} {host:10.1f} {kernels_in[k]:10.1f} {calls:6d}")
    if metric == "stream":
        for name, (spent, trk) in zip(("cold", "warm", "profiled"), ingest):
            print(f"[{card_line}] {name} run: "
                  f"{chip_smoke.ingest_line(spent, len(frames))}; tracking "
                  f"{1e3 * trk['s'] / len(frames):.3f} ms per frame in "
                  f"{trk['calls']} advance_stream calls", flush=True)
    table = avg.table(sort_by="self_device_time_total", row_limit=25)
    print(table, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    suffix = ("" if metric == "l2" else f"_{metric}") + (
        f"_{variant}" if variant else "")
    with open(f"chiprun_out/profile_main{suffix}.txt", "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=200))


if __name__ == "__main__":
    main()
