"""Damaged photos against cv2.imread, on the CPU: seeded cuts and bit flips
of each set of tests/test_torch_photo_damage.py (the three JPEG sets at
240x320 — baseline q95, restart interval 4, progressive — the other
samplings and the numpy writers' JPEGs, the TIFF strips and the formats
that agreed before), each case written to a file and read by
``cv2.imread`` on one thread and by the port's ``io/photo.decode``.
Prints, for each set, the cases that differ by kind of damage and of
difference ("port None, cv2 a frame", "pixels differ", ...), and keeps
each differing file as ``photo_damage_<set>_<kind>_<seed>.bin`` in the
working directory.  Exit status 1 when a case differed.

    python scripts/photo_damage_fuzz.py --cases 1000 --seed 0

A third of each set's cases are cuts, the rest single-bit flips; about a
minute per 1000 cases of a 240x320 JPEG set.
"""

import argparse
import collections
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", type=int, default=300,
                    help="cases per set (default 300)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the first seed (cases use seed .. seed+cases-1)")
    ap.add_argument("--sets", default="baseline,restart,progressive",
                    help="comma-separated sets: JPEG kinds of jpeg_file "
                         "(baseline, restart, progressive, 422, 444, gray, "
                         "prog422, ..., mjpeg, mjpeg-rst, mjpeg-prog), "
                         "TIFF kinds of tiff_file (lzw-cv2, deflate-pil, "
                         "...) or other_file's (png, webp, ...)")
    args = ap.parse_args()

    import cv2
    import pathlib

    import test_torch_photo_damage as t
    from slam_indoor_code_tpu_torch.testing import photos

    cv2.setNumThreads(1)
    tmp = pathlib.Path(tempfile.mkdtemp())
    bad = 0
    for name in args.sets.split(","):
        if name in ("lzw-cv2", "lzw-pil", "deflate-pil", "packbits-pil",
                    "none-pil", "deflate-pred", "deflate16-be",
                    "packbits-planar"):
            data = t.tiff_file(name)
        elif name in ("png", "bmp", "ppm", "webp", "webp-lossless", "gif",
                      "jp2"):
            data = t.other_file(name)
        else:
            data = t.jpeg_file(name, 240, 320)
        counts = collections.Counter()
        for k in range(args.cases):
            seed = args.seed + k
            kind = "cut" if k % 3 == 0 else "flip"
            damaged = photos.damage(data, seed, kind)
            what = t.outcome(tmp, damaged)
            if what:
                counts[f"{kind}: {what}"] += 1
                with open(f"photo_damage_{name}_{kind}_{seed}.bin",
                          "wb") as f:
                    f.write(damaged)
        bad += sum(counts.values())
        print(f"{name}: {args.cases} cases ({(args.cases + 2) // 3} cuts), "
              f"{sum(counts.values())} differ {dict(counts)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
