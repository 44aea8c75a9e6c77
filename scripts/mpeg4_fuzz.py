"""MPEG-4 Part 2 against cv2 on random encoder configurations, on the CPU.

Each case draws, from ``--seed``, a frame size (odd sizes and ones that
are not whole macroblocks among them), a stretch of the seed-5/6/7 test
scene, and libavcodec ``mpeg4`` encoder options (B-frames, 4MV,
quarter-pel, AC prediction, MPEG quantisation with or without loaded
matrices, fixed quantisers, video packets, GOP and scene-cut settings,
motion search and RD choices), codes the frames with the libavcodec cv2's
wheel carries (tests/test_torch_mp4.py::lavc_encode), and writes them
into an AVI under a random fourcc, sometimes with another encoder's user
data (Xvid's and DivX's builds: FFmpeg's per-build workarounds) and
sometimes packed as DivX packs B-VOPs.  The port's frames through
``MediaSource`` and its Y planes must equal cv2's bit for bit; each case
that does not is printed, its file kept in the working directory as
``mpeg4_fuzz_<seed>_<case>.avi``.  Options the encoder refuses together
are skipped.  Exit status 1 when a case differed.

    python scripts/mpeg4_fuzz.py --seed 1 --cases 40

Needs cv2 and its libavcodec; a few minutes per 40 cases.
"""

import argparse
import os
import random
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

SIZES = [(38, 54), (37, 53), (66, 90), (120, 176), (144, 176), (240, 320),
         (17, 30), (100, 96)]
FLAGS = ["+mv4", "+qpel", "+aic", "+cgop", "+qscale"]
CHOICES = [("mpeg_quant", ["0", "1"]), ("trellis", ["0", "1"]),
           ("me_range", ["0", "16", "64"]), ("ps", ["0", "150", "400"]),
           ("b_strategy", ["0", "1", "2"]), ("g", ["6", "12", "300"]),
           ("sc_threshold", ["0", "1000000000"]),
           ("lumi_mask", ["0", "0.3"]), ("dia_size", ["0", "2", "-2"]),
           ("last_pred", ["0", "2"]), ("subq", ["8"]),
           ("bidir_refine", ["0", "4"])]
USER_DATA = [None, None, b"XviD0005", b"XviD0050", b"DivX503b1393p",
             b"DivX501b1000", b"DivX400b2000"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cases", type=int, default=40)
    args = ap.parse_args()

    import cv2
    import numpy as np

    import test_torch_mp4 as mp4t
    from slam_indoor_code_tpu_torch.io import avi
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import make_scene, mjpeg

    rng = random.Random(args.seed)
    scenes, bad, run = {}, 0, 0
    tmp = tempfile.mkdtemp()
    try:
        for case in range(args.cases):
            hw = rng.choice(SIZES)
            span, sc_seed = rng.choice([12, 20, 40, 80]), rng.choice([5, 6, 7])
            if (span, sc_seed) not in scenes:
                sc = make_scene(n_points=400, n_frames=span, seed=sc_seed,
                                baseline=0.3)
                scenes[span, sc_seed] = [sc.render(i)
                                         for i in range(min(span, 12))]
            n = rng.choice([6, 10, 12])
            frames = [np.ascontiguousarray(cv2.resize(f, hw[::-1]))
                      for f in scenes[span, sc_seed][:n]]
            flags = "".join(rng.sample(FLAGS, rng.randint(0, 4)))
            opts = {"bf": str(rng.choice([0, 1, 2, 3, 4])),
                    "mbd": rng.choice(["simple", "bits", "rd"])}
            if flags:
                opts["flags"] = flags
            if "+qscale" in flags or rng.random() < 0.5:
                q = rng.choice([2, 3, 6, 12, 20, 31])
                opts["qmin"] = opts["qmax"] = str(q)
            for k, vals in CHOICES:
                if rng.random() < 0.35:
                    opts[k] = rng.choice(vals)
            matrices = None
            if opts.get("mpeg_quant") == "1" and rng.random() < 0.5:
                matrices = ([rng.randint(8, 60) for _ in range(64)],
                            [rng.randint(8, 60) for _ in range(64)])
            user = rng.choice(USER_DATA)
            pack = rng.random() < 0.3
            fourcc = rng.choice([b"XVID", b"FMP4", b"DX50", b"DIVX"])
            try:
                samples = mp4t.lavc_encode("mpeg4", frames, opts,
                                           matrices=matrices)[0]
            except AssertionError:
                continue                # options the encoder refuses
            run += 1
            if pack:
                samples = mjpeg.pack_divx(samples, user or b"DivX503b1393p")
            elif user:
                samples[0] = mjpeg.with_user_data(samples[0], user)
            path = os.path.join(tmp, "case.avi")
            mjpeg.write_avi(path, samples, hw[1], hw[0], fourcc=fourcc)
            want = mp4t.cv2_rgb(path)
            got = list(MediaSource(video_path=path, use_photos=False))
            ok = len(got) == len(want) and all(
                np.array_equal(a, b) for a, b in zip(got, want))
            if ok:
                video = avi.open_video(path)
                luma = mp4t.port_luma(video)
                video.close()
                want_y = mp4t.cv2_luma(path, hw)
                ok = len(luma) == len(want_y) and all(
                    np.array_equal(a, b) for a, b in zip(luma, want_y))
            if not ok:
                bad += 1
                keep = f"mpeg4_fuzz_{args.seed}_{case}.avi"
                shutil.copy(path, keep)
                print(f"case {case}: {hw} {opts} user {user} packed {pack} "
                      f"{fourcc} matrices {matrices is not None}: "
                      f"{len(got)} frames, cv2 {len(want)} -> {keep}",
                      flush=True)
    finally:
        shutil.rmtree(tmp)
    print(f"seed {args.seed}: {bad} of {run} cases differ from cv2")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
