"""VP9 against cv2 on random libvpx-vp9 encoder configurations, on the CPU.

Each case draws, from ``--seed``, a frame size (odd sizes and ones that are
not whole superblocks among them), a pan over a blurred-noise texture
(tests/test_torch_vp9.py::pan, sometimes with noise added, which draws
compound prediction), and libvpx-vp9 encoder options (one or two passes,
alt-ref frames and lag, deadline and cpu-used, CRF, tile
columns and rows, frame-parallel and error-resilient modes, lossless,
aq-mode, GOP length, row-mt), codes the frames with the libavcodec cv2's
wheel carries (tests/test_torch_mp4.py::lavc_encode), and writes them into
a WebM, an MKV or a ``VP90`` AVI.  The port's frames through
``MediaSource`` and its Y planes must equal cv2's bit for bit, in cv2's
frame count; each case that does not is printed, its file kept in the
working directory as ``vp9_fuzz_<seed>_<case>.<ext>``.  Options the encoder
refuses together are skipped, and so are those it crashes on (each encode
runs in a forked process).  Exit status 1 when a case differed.

    python scripts/vp9_fuzz.py --seed 1 --cases 40

Needs cv2 and its libavcodec; under a minute per 40 cases.
"""

import argparse
import os
import random
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

SIZES = [(96, 160), (97, 131), (53, 37), (64, 64), (120, 176), (144, 256),
         (9, 17), (130, 520), (66, 90), (100, 200)]
CHOICES = [("deadline", ["good", "realtime", "best"]),
           ("cpu-used", ["0", "1", "2", "4", "5", "8"]),
           ("crf", ["4", "20", "32", "50", "63"]),
           ("tile-columns", ["0", "1", "2"]), ("tile-rows", ["0", "1", "2"]),
           ("frame-parallel", ["0", "1"]), ("error-resilient", ["0", "1"]),
           ("aq-mode", ["0", "1", "2", "3"]), ("g", ["4", "12", "9999"]),
           ("row-mt", ["0", "1"]), ("lag-in-frames", ["0", "8", "16"]),
           ("arnr-strength", ["0", "3", "6"])]


def encode_isolated(frames, opts: dict, two_pass: bool):
    """test_torch_vp9.encode in a forked process: the packets, or None
    when the encoder refuses the options or crashes on them."""
    import multiprocessing

    import test_torch_vp9 as vt

    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)

    def child():
        try:
            send.send(vt.encode(frames, opts, two_pass))
        except AssertionError:
            send.send(None)

    proc = ctx.Process(target=child)
    proc.start()
    send.close()
    try:
        packets = recv.recv()
    except EOFError:
        packets = None
    proc.join()
    return packets if proc.exitcode == 0 else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cases", type=int, default=40)
    args = ap.parse_args()

    import numpy as np

    import test_torch_vp9 as vt
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg
    from test_torch_mp4 import cv2_rgb
    from test_torch_webm import cv2_luma

    rng = random.Random(args.seed)
    bad, run = 0, 0
    tmp = tempfile.mkdtemp()
    try:
        for case in range(args.cases):
            h, w = rng.choice(SIZES)
            n = rng.choice([6, 10, 16])
            noise = rng.choice([0, 0, 4])
            frames = vt.pan(n, h=h, w=w, dy=rng.choice([0, 1, 2]),
                            dx=rng.choice([0, 1, 3]),
                            seed=rng.randint(0, 9), noise=noise)
            opts = {k: rng.choice(v) for k, v in CHOICES
                    if rng.random() < 0.4}
            if rng.random() < 0.15:
                opts["lossless"] = "1"
            two_pass = rng.random() < 0.4
            if two_pass and rng.random() < 0.8:
                opts["auto-alt-ref"] = "1"
            packets = encode_isolated(frames, opts, two_pass)
            if packets is None:
                continue                # options the encoder refuses
            run += 1
            ext = rng.choice(["webm", "mkv", "avi"])
            path = os.path.join(tmp, f"case.{ext}")
            if ext == "avi":
                mjpeg.write_avi(path, packets, w, h, fourcc=b"VP90")
            else:
                vt.write_webm(path, packets, h, w)
            want = cv2_rgb(path)
            try:
                got = list(MediaSource(video_path=path, use_photos=False))
                luma = vt.port_luma(path)
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
                keep = f"vp9_fuzz_{args.seed}_{case}.{ext}"
                shutil.copy(path, keep)
                print(f"case {case}: {h}x{w} {opts} two-pass {two_pass} "
                      f"noise {noise}: {len(got)} frames, cv2 {len(want)} "
                      f"{err} -> {keep}", flush=True)
    finally:
        shutil.rmtree(tmp)
    print(f"seed {args.seed}: {bad} of {run} cases differ from cv2")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
