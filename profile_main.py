#!/usr/bin/env python3
"""Where the port's main path spends its time on the card.

    python3 profile_main.py [l2|l1|tile]

Runs chip_smoke.py's headline configuration (FHD, 32 frames) through the
port's ``slam_main`` on CUDA (with ``l1``: through ``DeviceEngine.run`` with
``EngineConfig.metric="l1"``, chip_smoke.run_engine) twice unprofiled —
cold, then warm — and once under ``torch.profiler``.  Prints the card, the
profiled run's wall time, the share of that wall time in which the device
ran any kernel, the host and device time of each step span
("steps.<name>", see runtime/steps.py) and the kernels with the most device
time.  Writes the full table to chiprun_out/profile_main[_l1].txt.

With ``tile``: where the time of the L2/Hamming tile (csrc/top2_l2.cuh)
goes at the main path's shapes.  Builds copies of ``top2_batch`` with one
part of the tile taken out at a time (the epilogue, the tensor-core
products, the candidate loads, then all three), launches each through its C
entry point on bf16 operands and prints its time beside the whole kernel's.
The results of the reduced builds are wrong; only their times are read.
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


def main() -> None:
    from slam_indoor_code_tpu_torch.app import slam_main
    from slam_indoor_code_tpu_torch.ops import build

    metric = sys.argv[1] if len(sys.argv) > 1 else "l2"
    if metric == "tile":
        return tile_parts()
    if metric not in ("l2", "l1"):
        raise SystemExit(f"mode must be l2, l1 or tile, got {metric!r}")
    _, card_line = chip_smoke.card()
    build.build_all()
    scene, frames = chip_smoke.headline_scene()
    walls = []
    with tempfile.TemporaryDirectory() as out:
        cfg = chip_smoke.headline_config(out)

        def run():
            if metric == "l1":
                return chip_smoke.run_engine(scene, frames, "l1")[0]
            return slam_main(cfg, scene.K, frames=frames)

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
    spans: dict[str, list] = {}
    for e in avg:
        if e.key.startswith("steps."):
            row = spans.setdefault(e.key, [0.0, 0, 0.0])
            row[0] = max(row[0], e.cpu_time_total / 1e3)
            row[1] = max(row[1], e.count)
    kernels_in = {k: 0.0 for k in spans}
    for e in prof.events():       # host ops carry the kernels they launched
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("steps."):
            p = p.cpu_parent
        if p is not None:
            kernels_in[p.name] += sum(k.duration for k in e.kernels) / 1e3
    print("step spans: host ms (span wall on the host) / kernel ms launched "
          "directly inside (innermost span) / calls")
    for k, (host, calls, _) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:28s} {host:10.1f} {kernels_in[k]:10.1f} {calls:6d}")
    table = avg.table(sort_by="self_device_time_total", row_limit=25)
    print(table, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    suffix = "_l1" if metric == "l1" else ""
    with open(f"chiprun_out/profile_main{suffix}.txt", "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=200))


if __name__ == "__main__":
    main()
