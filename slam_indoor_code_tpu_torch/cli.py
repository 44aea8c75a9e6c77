"""CLI entry point: ``python -m slam_indoor_code_tpu_torch <config.json>``.

The JAX package's CLI contract (the reference binary's, src/main.cpp:28-74):
one argument — the JSON config path; exit 2 on a missing argument or a
config error; dispatches to onlyViz / SLAM and prints the "map points: …;
cameras: …" line.

Flags:
  --viz                 write viz artifacts at the end
  --checkpoint PATH     periodic run snapshots to PATH (npz)
  --checkpoint-every N  snapshot every N accepted frames (default 64)
  --resume PATH         resume a previous run from its snapshot
  --profile DIR         write a torch.profiler trace of the run to DIR
  --device cpu|cuda     where the port runs (default cuda; raises without a
                        GPU rather than fall back to the CPU)
"""

from __future__ import annotations

import sys

from .app import run_from_config
from .config import ConfigError, load_config


def _flag_value(argv: list[str], flag: str) -> str | None:
    if flag in argv:
        i = argv.index(flag)
        if i + 1 < len(argv):
            return argv[i + 1]
    return None


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("Please specify path to JSON-config as the second argument",
              file=sys.stderr)
        return 2
    try:
        cfg = load_config(argv[0])
    except ConfigError as e:
        print(e, file=sys.stderr)
        return 2

    device = _flag_value(argv, "--device") or "cuda"
    if device not in ("cpu", "cuda"):
        print(f"--device expects cpu or cuda, got '{device}'", file=sys.stderr)
        return 2
    ck = _flag_value(argv, "--checkpoint")
    every = _flag_value(argv, "--checkpoint-every")
    resume = _flag_value(argv, "--resume")
    profile = _flag_value(argv, "--profile")
    if ck or every or resume or profile:
        import dataclasses

        if every is not None:
            try:
                every = int(every)
            except ValueError:
                # the exit-2 contract of config schema errors
                print(f"--checkpoint-every expects an integer, got '{every}'",
                      file=sys.stderr)
                return 2
        tpu = dataclasses.replace(
            cfg.tpu,
            checkpoint_path=ck or cfg.tpu.checkpoint_path,
            checkpoint_every=every if every else
            (cfg.tpu.checkpoint_every or (64 if ck else 0)),
            resume_path=resume or cfg.tpu.resume_path,
            profile_dir=profile or cfg.tpu.profile_dir,
        )
        cfg = dataclasses.replace(cfg, tpu=tpu)

    gd = run_from_config(cfg, device=device)
    print(
        f"map points: {len(gd.points)}; cameras: {len(gd.rotations)}; "
        f"logs in {cfg.outputDataDir}"
    )
    if "--viz" in argv:
        from .viz.pointcloud import visualize_global_data

        visualize_global_data(gd, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
