"""H.263 and H.263+ video against cv2 on random encoder configurations, on
the CPU.

Each case draws, from ``--seed``, the encoder (libavcodec's ``h263`` at a
standard size, or ``h263p`` at a standard or custom size: multiples of 4,
most not whole macroblocks), a pan over a blurred-noise texture
(tests/test_torch_vp9.py::pan, some with noise), the GOP length, a fixed
quantiser (1-31) or a bit rate, and a set of tools: 4MV and OBMC
(Annex F) for either encoder, GOB headers (``ps``), and for ``h263p``
each of unrestricted vectors (D), advanced intra coding with modified
quantisation (I, T), deblocking (J), slices (K) and the alternative
inter VLC (S).  It codes the frames with the libavcodec cv2's wheel
carries (tests/test_torch_mp4.py::lavc_encode) and writes them as a raw
``.h263`` stream, a 3GP (``s263``), an AVI or a Matroska file
(tests/test_torch_h263.py::write_stream).  The port's frames through
``MediaSource`` and its Y planes must equal cv2's bit for bit, in cv2's
frame count; each case that does not is printed, its file kept in the
working directory as ``h263_fuzz_<seed>_<case>.<ext>``.  Options the
encoder refuses together are skipped.  Exit status 1 when a case
differed.

    python scripts/h263_fuzz.py --seed 1 --cases 40

Needs cv2 and its libavcodec; about 15 s per 40 cases.
"""

import argparse
import os
import random
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

STANDARD = [(96, 128), (144, 176), (288, 352), (576, 704)]
CUSTOM = [(52, 68), (100, 148), (36, 44), (64, 64), (120, 176), (92, 200),
          (240, 320), (180, 124), (360, 640)]
PLUS_TOOLS = [("umv", "1"), ("aiv", "1"), ("structured_slices", "1"),
              ("obmc", "1")]
PLUS_FLAGS = ["+aic", "+loop", "+mv4"]


def draw_options(rng, plus: bool) -> dict:
    opts, flags = {}, []
    if rng.random() < 0.5:
        flags.append("+mv4")
    if rng.random() < 0.4:
        opts["obmc"] = "1"
    if plus:
        for k, v in PLUS_TOOLS:
            if rng.random() < 0.5:
                opts[k] = v
        flags += [f for f in PLUS_FLAGS if f != "+mv4"
                  and rng.random() < 0.5]
    if flags:
        opts["flags"] = "".join(sorted(set(flags)))
    if rng.random() < 0.4:
        opts["ps"] = str(rng.choice([150, 300, 800, 3000]))
    opts["g"] = str(rng.choice([1, 3, 6, 12, 30]))
    if rng.random() < 0.6:
        q = rng.choice([1, 2, 3, 5, 8, 13, 20, 31])
        opts["qmin"] = opts["qmax"] = str(q)
    else:
        opts["b"] = rng.choice(["40k", "150k", "600k", "2M"])
    return opts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cases", type=int, default=40)
    args = ap.parse_args()

    import numpy as np

    import test_torch_h263 as ht
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from test_torch_mp4 import cv2_rgb
    from test_torch_mpeg2 import cv2_luma
    from test_torch_vp9 import pan

    rng = random.Random(args.seed)
    bad, run = 0, 0
    tmp = tempfile.mkdtemp()
    try:
        for case in range(args.cases):
            plus = rng.random() < 0.7
            h, w = rng.choice(STANDARD + (CUSTOM if plus else []))
            frames = pan(rng.choice([4, 7, 10]), h=h, w=w,
                         dy=rng.choice([0, 1, 2, 5, 9]),
                         dx=rng.choice([0, 1, 3, 7, 12]),
                         seed=rng.randint(0, 9),
                         noise=rng.choice([0.0, 0.0, 4.0, 12.0]))
            opts = draw_options(rng, plus)
            try:
                packets = ht.encode(frames, opts, "h263p" if plus else "h263")
            except AssertionError:
                continue                # options the encoder refuses
            run += 1
            ext = rng.choice(["h263", "3gp", "avi", "mkv"])
            path = os.path.join(tmp, f"case.{ext}")
            ht.write_stream(path, packets, w, h,
                            fourcc=b"U263" if plus and ext == "avi"
                            and rng.random() < 0.5 else b"H263")
            want = cv2_rgb(path)
            try:
                got = list(MediaSource(video_path=path, use_photos=False))
                luma = [p[0] for p in ht.port_planes(path)[0]]
                err = ""
            except ValueError as e:     # a refusal is a difference too
                got, luma, err = [], [], str(e)
            want_y = cv2_luma(path)
            ok = (len(got) == len(want) == len(luma) == len(want_y)
                  and all(np.array_equal(a, b) for a, b in zip(got, want))
                  and all(np.array_equal(a, b)
                          for a, b in zip(luma, want_y)))
            if not ok:
                bad += 1
                keep = f"h263_fuzz_{args.seed}_{case}.{ext}"
                shutil.copy(path, keep)
                print(f"case {case}: {h}x{w} "
                      f"{'h263p' if plus else 'h263'} {opts}: "
                      f"{len(got)} frames, cv2 {len(want)} {err} -> {keep}",
                      flush=True)
    finally:
        shutil.rmtree(tmp)
    print(f"seed {args.seed}: {bad} of {run} cases differ from cv2")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
