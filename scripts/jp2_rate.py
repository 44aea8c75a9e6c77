#!/usr/bin/env python3
"""Tracking on JPEG 2000 frames of the headline, on the card: for each
directory given, ``slam_main`` with chip_smoke.py's headline configuration
on its ``frame_*.jp2`` (read by io/jp2.py), printing the cameras, the ATE
as % of the extent and the files' size.  The frames are written here by
Pillow (the card has no JPEG 2000 encoder), one directory per rate:

    python scripts/jp2_rate.py --write DIR RATE [RATE ...]   # Pillow
    python3 scripts/jp2_rate.py DIR/rate_* [...]             # the card
"""

import dataclasses
import glob
import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def write(root: str, rates) -> None:
    from PIL import Image

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    from test_torch_jp2 import HEADLINE_OPTIONS, headline_frames

    frames = headline_frames()
    for rate in rates:
        d = os.path.join(root, f"rate_{rate}")
        os.makedirs(d, exist_ok=True)
        opts = dict(HEADLINE_OPTIONS,
                    quality_layers=[4 * rate, 2 * rate, rate])
        for i, f in enumerate(frames):
            b = io.BytesIO()
            Image.fromarray(f).save(b, "JPEG2000", **opts)
            with open(os.path.join(d, f"frame_{i:02d}.jp2"), "wb") as fh:
                fh.write(b.getvalue())


def track(dirs) -> None:
    import torch

    import chip_smoke as cs
    from slam_indoor_code_tpu_torch import app

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    scene, _ = cs.headline_scene()
    print(cs.card()[1], flush=True)
    for d in dirs:
        paths = glob.glob(os.path.join(d, "frame_*.jp2"))
        out = os.path.join(d, "out")
        cfg = dataclasses.replace(cs.headline_config(out),
                                  photosPathPattern=os.path.join(
                                      d, "frame_*.jp2"))
        os.makedirs(out, exist_ok=True)
        gd = app.slam_main(cfg, scene.K, device="cuda")
        ate = (cs.rel_ate_pct(scene, gd.rotations, gd.positions,
                              gd.frame_ids) if len(gd.rotations) >= 3
               else float("nan"))
        mb = sum(os.path.getsize(p) for p in paths) / 1e6
        print(f"{os.path.basename(d)}: {len(paths)} frames, {mb:.3f} MB, "
              f"cameras {len(gd.rotations)}/{len(paths)}, ATE {ate:.4f}% "
              "of extent", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--write":
        write(sys.argv[2], [int(r) for r in sys.argv[3:]])
    else:
        track(sys.argv[1:])
