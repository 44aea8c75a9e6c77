"""MPEG-4 Part 2, VP8 and VP9 video on the CPU, two measurements:

``decode``: the committed FHD fixture
(slam_indoor_code_tpu_torch/testing/video_fixtures/headline_mp4v.mp4, the
32 headline frames as OpenCV's ``mp4v`` writer makes them) parsed by
io/mp4.py and decoded by io/mpeg4.py on one thread; with ``--webm``,
headline_vp8.webm (the same frames as OpenCV's ``VP80`` writer makes
them) parsed by io/matroska.py and decoded by io/vp8.py; with ``--vp9``,
headline_vp9.webm (the same frames coded by libvpx-vp9 in two passes:
hidden alt-ref frames in superframes, compound prediction, 4 tile
columns) parsed by io/matroska.py and decoded by io/vp9.py; with ``--asp``,
headline_asp_packed.avi (the same frames coded with every MPEG-4 Advanced
Simple tool and packed as DivX packs B-VOPs) parsed by io/avi.py and
decoded by io/mpeg4.py, frames in display order: ms for the
parse, and ms per frame to I420 planes and to RGB, best of ``--reps``
passes.

``ate``: tests/test_torch_mp4.py's end-to-end file (the 540x960 seed-5
scene, 14 frames, written by cv2's ``mp4v`` writer) through ``slam_main``
of one package over RANSAC seeds 0-3, as that test configures it: one line
per seed with cameras and ATE as a share of the trajectory extent.  The
JAX package's numbers move with Python's hash seed and with the process's
history, so run it under several ``PYTHONHASHSEED`` values:

    python scripts/mp4_cpu.py decode [--webm | --vp9 | --asp]
    PYTHONHASHSEED=1 JAX_PLATFORMS=cpu python scripts/mp4_cpu.py ate jax
    python scripts/mp4_cpu.py ate torch

``ate`` needs cv2 (to write the file) and, for ``jax``, the JAX package.
"""

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

FIXTURE = os.path.join(ROOT, "slam_indoor_code_tpu_torch", "testing",
                       "video_fixtures", "headline_mp4v.mp4")
FIXTURE_WEBM = os.path.join(os.path.dirname(FIXTURE), "headline_vp8.webm")
FIXTURE_ASP = os.path.join(os.path.dirname(FIXTURE),
                           "headline_asp_packed.avi")
FIXTURE_VP9 = os.path.join(os.path.dirname(FIXTURE), "headline_vp9.webm")


def decode(reps: int, webm: bool, asp: bool, vp9_: bool = False) -> None:
    from slam_indoor_code_tpu_torch.io import (avi, matroska, mp4, mpeg4, vp8,
                                               vp9)

    t = time.perf_counter()
    if webm:
        video = matroska.MkvVideo(FIXTURE_WEBM)
        make = vp8.Decoder
    elif vp9_:
        video = matroska.MkvVideo(FIXTURE_VP9)
        make = vp9.Decoder
    elif asp:
        video = avi.AviVideo(FIXTURE_ASP)
        make = lambda: mpeg4.Decoder(b"", video.fourcc)  # noqa: E731
    else:
        video = mp4.Mp4Video(FIXTURE)
        make = lambda: mpeg4.Decoder(video.extradata)  # noqa: E731
    parse_ms = 1e3 * (time.perf_counter() - t)
    samples = [video.read(f) for f in video.frames]
    best = {}
    for _ in range(reps):
        for name in ("yuv", "rgb"):
            dec = make()
            run = dec.decode_yuv if name == "yuv" else dec.decode
            t = time.perf_counter()
            for s in samples:
                run(s)
            if asp:             # the reference held back
                dec.flush_yuv() if name == "yuv" else dec.flush()
            ms = 1e3 * (time.perf_counter() - t) / len(samples)
            best[name] = min(best.get(name, ms), ms)
    print(f"{video.codec}: parse {parse_ms:.3f} ms; decode {best['yuv']:.3f} "
          f"ms per frame to I420, {best['rgb']:.3f} ms to RGB (one thread, "
          f"best of {reps}, {len(samples)} FHD frames)")


def ate(package: str) -> None:
    import numpy as np
    import torch

    from slam_indoor_code_tpu_torch.testing import make_scene
    from test_torch_mp4 import write_cv2_video
    from test_torch_video import _cfg, _rel_ate

    torch.set_num_threads(1)
    scene = make_scene(n_points=700, n_frames=14, image_size=(540, 960),
                       seed=5, baseline=0.3)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "seq.mp4")
        write_cv2_video(path, [scene.render(i) for i in range(14)], "mp4v")
        if package == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            from slam_indoor_code_tpu import app, config
            from slam_indoor_code_tpu.io.media import MediaSource
            frames = list(MediaSource(video_path=path, use_photos=False))
            kw = {"frames": frames}
        else:
            from slam_indoor_code_tpu_torch import app, config
            kw = {"device": "cpu"}
        for seed in range(4):
            gd = app.slam_main(_cfg(config, path, d), np.asarray(scene.K),
                               seed=seed, **kw)
            print(f"{package} seed {seed} hash seed "
                  f"{os.environ.get('PYTHONHASHSEED', 'random')}: cameras "
                  f"{len(gd.rotations)} ATE {_rel_ate(scene, gd):.6f}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    d = sub.add_parser("decode")
    d.add_argument("--reps", type=int, default=3)
    g = d.add_mutually_exclusive_group()
    g.add_argument("--webm", action="store_true")
    g.add_argument("--asp", action="store_true")
    g.add_argument("--vp9", action="store_true")
    a = sub.add_parser("ate")
    a.add_argument("package", choices=["jax", "torch"])
    args = ap.parse_args()
    if args.what == "decode":
        decode(args.reps, args.webm, args.asp, args.vp9)
    else:
        ate(args.package)


if __name__ == "__main__":
    main()
