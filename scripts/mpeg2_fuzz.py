"""MPEG-1/2 video against cv2 on random encoder configurations, on the CPU.

Each case draws, from ``--seed``, a frame size (odd sizes and ones that are
not whole macroblocks among them), a pan over a blurred-noise texture
(tests/test_torch_vp9.py::pan), the encoder (libavcodec's ``mpeg2video``,
or ``mpeg1video`` at 25 fps) and its options (B pictures 0-3, GOP length,
closed GOPs, interlaced DCT and motion, alternate scan, B-15 intra VLCs,
non-linear quantiser scale, intra DC precision 8-11, a quantiser range or
a bit rate, loaded matrices, the colour matrix, 4:2:2 chroma), codes the
frames with the libavcodec cv2's wheel carries
(tests/test_torch_mp4.py::lavc_encode), sets progressive_frame to 1 in
every picture (cv2 returns uninitialised memory for frames flagged
interlaced; the decoding does not change), sometimes damages a picture
(cut or bytes flipped), and writes them as an elementary stream, a
transport or program stream (testing/mpegmux.py) or an ``MPEG`` AVI.  The
port's frames through ``MediaSource`` and its Y planes (for a BT.709
stream as cv2 reads them: through libswscale's conversion via RGB) must
equal cv2's bit for bit, in cv2's frame count (the Y of a BT.709 4:2:2
stream libavcodec's own, through ctypes); of a damaged stream, cv2's
on one thread (FFmpeg's slice threads conceal in their own order), the
frames decoded from the pictures before the damaged one.  Each case that
does not is printed, its file kept in the working directory as
``mpeg2_fuzz_<seed>_<case>.<ext>``.  Options the encoder refuses together
are skipped.  Exit status 1 when a case differed.

    python scripts/mpeg2_fuzz.py --seed 1 --cases 40

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

SIZES = [(96, 128), (38, 54), (37, 53), (99, 130), (64, 64), (120, 176),
         (144, 256), (51, 64), (130, 520), (240, 320)]
CHOICES = [("bf", ["0", "1", "2", "3"]), ("g", ["3", "6", "12", "30"]),
           ("alternate_scan", ["0", "1"]), ("intra_vlc", ["0", "1"]),
           ("dc", ["8", "9", "10", "11"]),
           ("colorspace", ["bt709", "smpte170m", "bt470bg"])]


def encode(frames, opts: dict, mpeg1: bool, matrices):
    """test_torch_mpeg2.encode: the packets, or None when the encoder
    refuses the options."""
    import test_torch_mpeg2 as mt

    try:
        return mt.encode(frames, opts, mpeg1, matrices)
    except AssertionError:
        return None


def draw_options(rng, mpeg1: bool) -> dict:
    opts = {k: rng.choice(v) for k, v in CHOICES if rng.random() < 0.45}
    if mpeg1:                       # MPEG-2 syntax only
        for k in ("alternate_scan", "intra_vlc", "dc", "colorspace"):
            opts.pop(k, None)
    else:
        flags = [f for f in ("+ildct", "+ilme") if rng.random() < 0.4]
        if rng.random() < 0.2:
            flags.append("+cgop")
            opts["sc_threshold"] = "1000000000"
        if flags:
            opts["flags"] = "".join(flags)
        if rng.random() < 0.3:
            opts["non_linear_quant"] = "1"
            opts["qmax"] = str(rng.choice([8, 20, 28]))
        if "colorspace" in opts:
            opts["seq_disp_ext"] = "always"
    kind = rng.random()
    if kind < 0.4:
        q = rng.choice([1, 2, 4, 8, 16, 31])
        opts["qmin"] = str(min(q, int(opts.get("qmax", 31))))
        opts["qmax"] = str(max(q, int(opts["qmin"])))
    elif kind < 0.8:
        opts["b"] = rng.choice(["30k", "100k", "400k", "2M"])
    return opts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cases", type=int, default=40)
    args = ap.parse_args()

    import numpy as np

    import test_torch_mpeg2 as mt
    from slam_indoor_code_tpu_torch.io import avi, mpeg12
    from slam_indoor_code_tpu_torch.io.media import MediaSource
    from slam_indoor_code_tpu_torch.testing import mjpeg, mpegmux
    from test_torch_mp4 import _damage, cv2_rgb, cv2_rgb_one_thread
    from test_torch_mp4 import lavc_encode
    from test_torch_vp9 import pan

    def port(path):
        """The port's (Y, U, V) planes of ``path`` in display order, the
        picture each was decoded from, and the stream's colour matrix."""
        video = avi.open_video(path)
        dec = mpeg12.Decoder(video.extradata, video.width, video.height)
        out, tags = [], []
        for i, f in enumerate(video.frames):
            planes = dec.decode_yuv(video.read(f), i)
            if dec.failed:
                break
            if planes is not None and video.frames[dec.tag][2]:
                out.append(planes)
                tags.append(dec.tag)
        else:
            planes = dec.flush_yuv()
            if planes is not None and video.frames[dec.tag][2]:
                out.append(planes)
                tags.append(dec.tag)
        matrix = dec.stats()["matrix_coefficients"]
        video.close()
        return out, tags, matrix

    rng = random.Random(args.seed)
    bad, run = 0, 0
    tmp = tempfile.mkdtemp()
    try:
        for case in range(args.cases):
            h, w = rng.choice(SIZES)
            mpeg1 = rng.random() < 0.25
            frames = pan(rng.choice([6, 10, 16]), h=h, w=w,
                         dy=rng.choice([0, 1, 2, 5]),
                         dx=rng.choice([0, 1, 3, 7]), seed=rng.randint(0, 9))
            opts = draw_options(rng, mpeg1)
            matrices = mt._matrices(rng.randint(0, 99)) \
                if rng.random() < 0.2 else None
            c422 = not mpeg1 and h % 2 == 0 and rng.random() < 0.35
            if c422:
                try:
                    packets = lavc_encode("mpeg2video", frames, opts,
                                          matrices=matrices,
                                          pix_fmt="yuv422p")[0]
                except AssertionError:
                    packets = None
            else:
                packets = encode(frames, opts, mpeg1, matrices)
            if packets is None:
                continue                # options the encoder refuses
            run += 1
            packets = [mt.progressive(p) for p in packets]
            damage = None
            if rng.random() < 0.3:
                k = rng.randrange(1, len(packets))
                damage = (k, rng.choice(["half", "90pct", "2bytes", "flip"]))
                packets[k] = _damage(packets[k], damage[1])
            ext = rng.choice(["m2v", "ts", "mpg", "avi"])
            path = os.path.join(tmp, f"case.{ext}")
            if ext == "ts":
                mpegmux.write_ts(path, packets, stream_type=1 if mpeg1 else 2)
            elif ext == "mpg":
                mpegmux.write_ps(path, packets, mpeg1=mpeg1)
            elif ext == "avi":
                mjpeg.write_avi(path, packets, w, h, fourcc=b"MPEG")
            else:
                with open(path, "wb") as fh:
                    fh.write(b"".join(packets))
            want = cv2_rgb_one_thread(path) if damage else cv2_rgb(path)
            count = len(cv2_rgb(path))
            try:
                got = list(MediaSource(video_path=path, use_photos=False))
                planes, tags, matrix = port(path)
                luma = [p[0] if matrix != 1 or c422 else
                        mt.swscale_y_read(*p, 1) for p in planes]
                err = ""
            except ValueError as e:     # a refusal is a difference too
                got, luma, tags, err = [], [], [], str(e)
            want_y = mt.cv2_luma(path)
            if c422 and matrix == 1 and luma:
                # cv2 reads the Y of a BT.709 4:2:2 frame through a
                # conversion not reproduced: libavcodec's own Y instead
                luma = [p[0] for p in planes]
                want_y = [p[0] for p in mt.lavc_decode(packets)][:len(luma)]
            ok = len(got) == len(want) == len(luma) == len(want_y) == count
            for j, (a, b, y, wy) in enumerate(zip(got, want, luma, want_y)):
                if damage is None or tags[j] < damage[0]:
                    ok = ok and np.array_equal(a, b) and np.array_equal(y,
                                                                        wy)
            if not ok:
                bad += 1
                keep = f"mpeg2_fuzz_{args.seed}_{case}.{ext}"
                shutil.copy(path, keep)
                print(f"case {case}: {h}x{w} {'mpeg1' if mpeg1 else 'mpeg2'}"
                      f"{' 4:2:2' if c422 else ''} {opts} matrices "
                      f"{matrices is not None} damage {damage}: "
                      f"{len(got)} frames, cv2 {count} {err} -> {keep}",
                      flush=True)
    finally:
        shutil.rmtree(tmp)
    print(f"seed {args.seed}: {bad} of {run} cases differ from cv2")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
