"""FFV1, HuffYUV and FFVHuff video against cv2 on random encoder
configurations, on the CPU.

Each case draws, from ``--seed``, the encoder (libavcodec's ``ffv1``,
``ffvhuff`` or ``huffyuv``), a pan over a blurred-noise texture
(tests/test_torch_vp9.py::pan, some with noise) at a size from a list
(odd ones included), the GOP length and the pixel format (yuv420p,
yuv422p, gray, rgb24, bgra; those each encoder takes, through
tests/test_torch_mp4.py::lavc_encode), and the encoder's options: for
``ffv1`` the level (0, 1, 3), coder (Golomb-Rice, range coder with the
default or a custom table), context model, slices (4, 6, 9, 12, 16, 24,
30) and slice CRCs; for the HuffYUV encoders the predictor (left,
gradient, median), FFVHuff's tables in every frame (context 1) and the
interlaced flag (``+ilme``).  It codes the frames with the libavcodec
cv2's wheel carries and writes them into an AVI (the extradata after the
bitmap header; tests/test_torch_ffv1.py and test_torch_huffyuv.py's
``write_stream``) or, for FFV1, a Matroska file.  The port's frames
through ``MediaSource`` must equal cv2's bit for bit, in cv2's frame
count; a layout the port refuses by name (``NotImplementedError``) is
counted apart; each case that differs is printed, its file kept in the
working directory as ``lossless_fuzz_<seed>_<case>.<ext>``.  Options
the encoder refuses together are skipped.  Exit status 1 when a case
differed.

    python scripts/lossless_fuzz.py --seed 1 --cases 40

Needs cv2 and its libavcodec; about 20 s per 40 cases.
"""

import argparse
import os
import random
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

SIZES = [(48, 64), (37, 53), (72, 96), (96, 128), (120, 176), (144, 176),
         (33, 40), (300, 64), (240, 320)]
FORMATS = {"ffv1": ["yuv420p", "yuv422p", "gray", "bgra"],
           "ffvhuff": ["yuv420p", "yuv422p", "gray", "rgb24", "bgra"],
           "huffyuv": ["yuv422p", "rgb24", "bgra"]}


def draw_options(rng, codec: str, pix_fmt: str) -> dict:
    opts = {"g": str(rng.choice([1, 3, 5, 12]))}
    if codec == "ffv1":
        level = rng.choice(["0", "1", "3"])
        opts.update(level=level, coder=rng.choice(["0", "-2", "1", "2"]),
                    context=rng.choice(["0", "1"]))
        if level == "3":
            opts["slices"] = str(rng.choice([4, 6, 9, 12, 16, 24, 30]))
            opts["slicecrc"] = rng.choice(["0", "1"])
        return opts
    rgb = pix_fmt in ("rgb24", "bgra")
    opts["pred"] = rng.choice(["left", "plane"] if rgb
                              else ["left", "plane", "median"])
    if codec == "ffvhuff":
        opts["context"] = rng.choice(["0", "1"])
    if rng.random() < 0.3:
        opts["flags"] = "+ilme"
    return opts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cases", type=int, default=40)
    args = ap.parse_args()

    import numpy as np

    import test_torch_ffv1 as tf
    import test_torch_huffyuv as th
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from test_torch_mp4 import cv2_rgb, lavc_encode, lavc_extradata
    from test_torch_vp9 import pan

    rng = random.Random(args.seed)
    bad = run = refused = 0
    tmp = tempfile.mkdtemp()
    try:
        for case in range(args.cases):
            codec = rng.choice(list(FORMATS))
            pix_fmt = rng.choice(FORMATS[codec])
            h, w = rng.choice(SIZES)
            frames = pan(rng.choice([2, 4, 7]), h=h, w=w,
                         dy=rng.choice([0, 1, 3]), dx=rng.choice([0, 2, 5]),
                         seed=rng.randint(0, 9),
                         noise=rng.choice([0.0, 3.0, 12.0]))
            opts = draw_options(rng, codec, pix_fmt)
            try:
                packets, ctx = lavc_encode(codec, frames, dict(opts),
                                           pix_fmt=pix_fmt)
            except AssertionError:
                continue                # options the encoder refuses
            run += 1
            extra = lavc_extradata(ctx)
            ext = "mkv" if codec == "ffv1" and rng.random() < 0.4 else "avi"
            path = os.path.join(tmp, f"case.{ext}")
            if codec == "ffv1":
                tf.write_stream(path, packets, extra, w, h)
            else:
                th.write_stream(path, packets, extra, w, h,
                                b"HFYU" if codec == "huffyuv" else b"FFVH")
            want = cv2_rgb(path)
            try:
                got = list(MediaSource(video_path=path, use_photos=False))
                err = ""
            except NotImplementedError:
                refused += 1
                continue
            except ValueError as e:     # an error is a difference
                got, err = [], str(e)
            ok = (len(got) == len(want)
                  and all(np.array_equal(a, b) for a, b in zip(got, want)))
            if not ok:
                bad += 1
                keep = f"lossless_fuzz_{args.seed}_{case}.{ext}"
                shutil.copy(path, keep)
                print(f"case {case}: {h}x{w} {codec} {pix_fmt} {opts}: "
                      f"{len(got)} frames, cv2 {len(want)} {err} -> {keep}",
                      flush=True)
    finally:
        shutil.rmtree(tmp)
    print(f"seed {args.seed}: {bad} of {run} cases differ from cv2 "
          f"({refused} refused by name)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
