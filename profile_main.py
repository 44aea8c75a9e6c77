#!/usr/bin/env python3
"""Where the port's main path spends its time on the card.

    python3 profile_main.py [l2|l1]

Runs chip_smoke.py's headline configuration (FHD, 32 frames) through the
port's ``slam_main`` on CUDA (with ``l1``: through ``DeviceEngine.run`` with
``EngineConfig.metric="l1"``, chip_smoke.run_engine) twice unprofiled —
cold, then warm — and once under ``torch.profiler``.  Prints the card, the
profiled run's wall time, the share of that wall time in which the device
ran any kernel, the host and device time of each step span
("steps.<name>", see runtime/steps.py) and the kernels with the most device
time.  Writes the full table to chiprun_out/profile_main[_l1].txt.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke


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
    if metric not in ("l2", "l1"):
        raise SystemExit(f"metric must be l2 or l1, got {metric!r}")
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
