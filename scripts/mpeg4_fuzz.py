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
sometimes packed as DivX packs B-VOPs.  A case is progressive, interlaced
(``+ildct``, ``+ilme``; some with each frame's fields from two renders) or
data-partitioned, and some have a sample damaged (cut or bytes flipped).
The reference is cv2's decode (on one thread where a sample is damaged:
FFmpeg's threads make a concealed frame vary between reads), or, for an
interlaced stream, libavcodec's own decode (tests/test_torch_mpeg2.py::
lavc_decode; RGB through libswscale): cv2 returns uninitialised memory for
interlaced frames.  The port's frames through ``MediaSource`` and its Y
planes must equal the reference's bit for bit, in cv2's count; of a
damaged stream, the frames decoded from the samples before the damaged
one.  Each case that does not is
printed, its file kept in the working directory as
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
    from slam_indoor_code_tpu_torch.io import avi, mpeg4
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import make_scene, mjpeg
    from test_torch_mpeg2 import lavc_decode

    def port(path):
        """The port's RGB frames (through ``MediaSource``), Y planes and
        the sample each frame was decoded from, for ``path``."""
        rgb = list(MediaSource(video_path=path, use_photos=False))
        video = avi.open_video(path)
        dec = mpeg4.Decoder(video.extradata, video.fourcc)
        luma, tags = [], []
        for i, f in enumerate(video.frames):
            planes = dec.decode_yuv(video.read(f), i)
            if dec.failed:
                break
            if planes is not None and video.frames[dec.tag][2]:
                luma.append(planes[0])
                tags.append(dec.tag)
        else:
            planes = dec.flush_yuv()
            if planes is not None and video.frames[dec.tag][2]:
                luma.append(planes[0])
                tags.append(dec.tag)
        video.close()
        return rgb, luma, tags

    def same(a, b):
        return len(a) == len(b) and all(
            np.array_equal(x, y) for x, y in zip(a, b))

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
            mode = rng.choice(["progressive", "progressive", "interlaced",
                               "partitioned"])
            if mode == "interlaced" and rng.random() < 0.5:
                for f, g in zip(frames, frames[1:] + frames[-1:]):
                    f[1::2] = g[1::2]       # fields from two renders
            flags = "".join(rng.sample(FLAGS, rng.randint(0, 4)))
            if mode == "interlaced":
                flags += rng.choice(["+ildct", "+ildct+ilme", "+ilme"])
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
            if mode == "interlaced" and rng.random() < 0.5:
                opts["alternate_scan"] = "1"
            if mode == "partitioned":
                opts["data_partitioning"] = "1"
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
            damage = None
            if rng.random() < 0.3 and len(samples) > 2:
                k = rng.randrange(1, len(samples))
                damage = (k, rng.choice(["half", "90pct", "2bytes", "flip"]))
                samples[k] = mp4t._damage(samples[k], damage[1])
            mjpeg.write_avi(path, samples, hw[1], hw[0], fourcc=fourcc)
            if mode == "interlaced":
                ref = lavc_decode(samples, codec="mpeg4")
                want = [mp4t.swscale_rgb(*p, chroma_left=True) for p in ref]
                want_y = [p[0] for p in ref]
            elif damage:
                want = mp4t.cv2_rgb_one_thread(path)
                want_y = mp4t.cv2_luma(path, hw)
            else:
                want = mp4t.cv2_rgb(path)
                want_y = mp4t.cv2_luma(path, hw)
            count = len(mp4t.cv2_rgb(path))
            got, luma, tags = port(path)
            if damage is None:
                ok = len(got) == count and same(got, want) and same(
                    luma, want_y)
            else:
                ok = len(got) == count == len(luma) and (
                    mode == "interlaced" or len(want) == count)
                for j, tag in enumerate(tags):
                    if tag < damage[0]:
                        ok = ok and j < len(want) and np.array_equal(
                            got[j], want[j]) and np.array_equal(luma[j],
                                                                want_y[j])
            if not ok:
                bad += 1
                keep = f"mpeg4_fuzz_{args.seed}_{case}.avi"
                shutil.copy(path, keep)
                print(f"case {case}: {mode} {hw} {opts} user {user} packed "
                      f"{pack} {fourcc} matrices {matrices is not None} "
                      f"damage {damage}: {len(got)} frames, cv2 {count} -> "
                      f"{keep}", flush=True)
    finally:
        shutil.rmtree(tmp)
    print(f"seed {args.seed}: {bad} of {run} cases differ from the "
          f"reference")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
