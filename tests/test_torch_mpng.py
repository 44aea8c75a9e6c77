"""PNG as a video frame (``MPNG`` in AVI and Matroska, ``png `` in
QuickTime, ``mp4v`` with objectTypeIndication 0x6D in MP4) against
``cv2.VideoCapture``, whose FFmpeg backend reads each frame with FFmpeg's
png decoder and swscale, not libpng (io/png.py's ``decode_video_frame``,
and its ``parser_packets`` for the demuxers that run FFmpeg's png
parser):

- cv2's own writers into each container (8-bit RGB), equal to cv2 and to
  the frames written;
- every layout FFmpeg decodes, written by Pillow and by hand into an
  MPNG AVI: gray 1-16 bits, gray+alpha, RGB, RGBA, palettes of 1-8 bits
  with and without tRNS, plain and Adam7 (16-bit gray rounds to 8 bits);
  16-bit RGB and RGBA, which swscale dithers, refused by name;
- FFmpeg's own rules: no CRC checked, a chunk that runs past the data,
  image data cut short before IEND (the rows it does not reach are zero
  bytes), an unknown row filter (a zero row), no IEND (a frame only
  where every row was read), and the packets the png parser cuts in AVI
  and Matroska (junk after IEND joins the next frame, a damaged IEND
  joins two), which MOV does not cut;
- cut and flipped frames against cv2 on one thread (cv2's count, every
  frame equal);
- the committed fixtures (cv2's writers: ``mpng_cv2.avi``,
  ``mpng_cv2.mkv``, ``png_cv2.mov``) against their recorded sha256
  (rewrite them with ``PYTHONPATH=.:tests python tests/test_torch_mpng.py
  --write-fixtures``)."""

import json
import pathlib
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from slam_indoor_code_tpu_torch.io import avi, png
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg, photos
from test_torch_mp4 import cv2_rgb, cv2_rgb_one_thread, write_cv2_video
from test_torch_mpeg2 import _sha
from test_torch_photos import _PNG_MODES, _pil_png, scene_image
from test_torch_vp9 import pan
from test_torch_webm import write_mkv

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "slam_indoor_code_tpu_torch" / "testing" / "video_fixtures"
DIGESTS = FIXTURES / "cv2_sha256.json"
SMALL_FIXTURES = ("mpng_cv2.avi", "mpng_cv2.mkv", "png_cv2.mov")
HW = (37, 53)


def mux(path, frames: list, hw=HW) -> pathlib.Path:
    """PNG files as the frames of a video of ``path``'s container: an
    MPNG AVI (testing/mjpeg.py) or an MPNG Matroska file (a VfW bitmap
    header)."""
    path = pathlib.Path(path)
    h, w = hw
    if path.suffix == ".mkv":
        bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MPNG",
                          w * h * 3, 0, 0, 0, 0)
        write_mkv(path, frames, w, h, codec="V_MS/VFW/FOURCC",
                  doctype=b"matroska", private=bih)
    else:
        mjpeg.write_avi(str(path), frames, w, h, fourcc=b"MPNG")
    return path


def port(path):
    return list(MediaSource(video_path=str(path), use_photos=False))


def equal_cv2(path, n=None, one_thread=False):
    want = (cv2_rgb_one_thread if one_thread else cv2_rgb)(path) or []
    got = port(path)
    assert len(got) == len(want), (len(got), len(want))
    if n is not None:
        assert len(got) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return got


def _chunk(kind: bytes, body: bytes) -> bytes:
    return photos._png_chunk(kind, body)


def _rgb_png(img, rows=None, z=None, iend=True) -> bytes:
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         1) if rows is None else rows
    z = zlib.compress(raw.tobytes(), 9) if z is None else z
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + _chunk(b"IDAT", z)
        + (_chunk(b"IEND", b"") if iend else b""))


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("ext,fourcc", [("avi", "MPNG"), ("mkv", "MPNG"),
                                        ("mov", "png "), ("mp4", "png ")])
def test_cv2_writers_equal_cv2_and_the_frames(tmp_path, ext, fourcc):
    """cv2's PNG writers (an ``mp4v`` entry with object type 0x6D in
    .mp4): the container's codec is "png" and every frame equals cv2's
    and the frame written."""
    frames = pan(5, 72, 88, dy=1, dx=2)
    path = tmp_path / f"v.{ext}"
    write_cv2_video(path, frames, fourcc)
    assert avi.open_video(str(path)).codec == "png"
    got = equal_cv2(path, 5)
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("mode", _PNG_MODES)
def test_pillow_layouts_equal_cv2(tmp_path, mode, interlace):
    """Pillow's PNG of each mode, plain and Adam7, as MPNG frames."""
    frames = [_pil_png(scene_image(*HW, seed=s), mode, interlace)
              for s in (7, 8)]
    equal_cv2(mux(tmp_path / "m.avi", frames), 2)


_PASSES = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, ch] samples packed into PNG rows of ``depth`` bits."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint16)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filtered(rows: np.ndarray, bpp: int, start: int) -> bytes:
    """Each row with a filter byte, the filters cycling from ``start``."""
    out, prior = [], np.zeros(rows.shape[1], np.uint8)
    for y, row in enumerate(rows):
        k = (start + y) % 5
        r, p = row.astype(np.int16), prior.astype(np.int16)
        a = np.concatenate([np.zeros(bpp, np.int16), r[:-bpp]])
        if k == 4:
            f = photos.paeth_filter(np.stack([prior, row]), bpp)[1]
        else:
            pred = (np.zeros_like(r), a, p, (a + p) // 2)[k]
            f = ((r - pred) % 256).astype(np.uint8)
        out.append(bytes([k]) + f.tobytes())
        prior = row
    return b"".join(out)


def png_of(samples, depth, ctype, interlace, plte=b"") -> bytes:
    """A PNG of the [h, w, ch] ``samples``, plain or Adam7, the rows of
    each pass cycling through the five filters."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = _PASSES if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_filtered(_rows(samples[y0::dy, x0::dx], depth), bpp, i)
                   for i, (x0, y0, dx, dy) in enumerate(passes)
                   if w > x0 and h > y0)
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
        + (_chunk(b"PLTE", plte) if plte else b"")
        + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (8, 0),
                                         (16, 0), (8, 2), (1, 3), (2, 3),
                                         (4, 3), (8, 3), (8, 4), (16, 4),
                                         (8, 6)])
def test_every_depth_and_colour_type_equal_cv2(tmp_path, depth, ctype):
    """Hand-written PNGs of every depth and colour type FFmpeg decodes to
    8 bits without dithering, the rows cycling through the five filters
    (a palette shorter than the indices reach: black past it; 16-bit gray
    rounded to 8 bits), equal to cv2.  Their Adam7 form, which FFmpeg
    flags interlaced and cv2 5.0 then returns as uninitialised memory
    (swscale refuses the frame), gives the same frame as the plain one."""
    rng = np.random.default_rng(depth * 10 + ctype)
    h, w = 19, 23
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    samples = rng.integers(0, 1 << depth, (h, w, ch))
    plte = rng.integers(0, 256, 3 * min(200, 1 << depth),
                        np.uint8).tobytes() if ctype == 3 else b""
    plain = png_of(samples, depth, ctype, 0, plte)
    got = equal_cv2(mux(tmp_path / "d.avi", [plain], (h, w)), 1)
    adam7 = png_of(samples, depth, ctype, 1, plte)
    np.testing.assert_array_equal(
        port(mux(tmp_path / "i.avi", [adam7], (h, w)))[0], got[0])


@pytest.mark.parametrize("ctype", [2, 6])
def test_sixteen_bit_rgb_refused_by_name(tmp_path, ctype):
    """16-bit RGB and RGBA frames, which swscale dithers to 8 bits: cv2
    reads them, the port names them."""
    img = (scene_image(*HW).astype(np.uint16) * 257)
    if ctype == 6:
        img = np.dstack([img, img[..., :1]])
    frame = photos._png(HW[1], HW[0], 16, ctype, np.concatenate(
        [np.zeros((HW[0], 1), np.uint8), img.astype(">u2").view(
            np.uint8).reshape(HW[0], -1)], 1).tobytes())
    path = mux(tmp_path / "s.avi", [frame])
    assert len(cv2_rgb(path)) == 1
    with pytest.raises(NotImplementedError, match="16-bit RGB or RGBA"):
        port(path)


def test_ffmpeg_rules_equal_cv2(tmp_path):
    """Each of FFmpeg's rules against cv2, the damaged frame between two
    good ones: a bad CRC everywhere (unchecked), IDAT cut short with IEND
    kept (zero rows), an unknown filter byte (a zero row), no IEND after
    complete or cut image data, an empty chunk of an unknown kind, a
    chunk past the data."""
    a, b = scene_image(*HW, seed=7), scene_image(*HW, seed=8)
    good = _rgb_png(a)
    rows = np.concatenate([np.zeros((HW[0], 1), np.uint8),
                           b.reshape(HW[0], -1)], 1)
    z = zlib.compress(rows.tobytes(), 9)
    bad_filter = rows.copy()
    bad_filter[HW[0] // 2, 0] = 9
    crc = bytearray(_rgb_png(b))
    for i in range(len(crc)):
        if crc[i:i + 4] in (b"IHDR", b"IDAT", b"IEND"):
            n = struct.unpack(">I", crc[i - 4:i])[0]
            crc[i + 4 + n] ^= 0xFF
    cases = {
        "bad crcs": bytes(crc),
        "idat cut, iend": _rgb_png(b, z=z[:len(z) // 2]),
        "bad filter": _rgb_png(b, rows=bad_filter),
        "no iend": _rgb_png(b, iend=False),
        "cut, no iend": _rgb_png(b, z=z[:len(z) // 2], iend=False),
        "unknown chunk": _rgb_png(b)[:-12] + _chunk(b"zzZz", b"")
        + _chunk(b"IEND", b""),
        "chunk past the data": _rgb_png(b)[:-12] + struct.pack(">I", 99)
        + b"tEXt",
    }
    for name, frame in cases.items():
        for ext in ("avi", "mkv"):
            equal_cv2(mux(tmp_path / f"r.{ext}", [good, frame, good]),
                      one_thread=True)
        assert name


def test_png_parser_cuts_as_ffmpeg_does(tmp_path):
    """AVI and Matroska packets cut again by FFmpeg's png parser: junk
    after a frame's IEND starts the next packet (which then fails), a
    damaged IEND tag joins a frame to the next; in MOV, which runs no
    parser, the frame with the damaged IEND still decodes."""
    a, b = scene_image(*HW, seed=7), scene_image(*HW, seed=8)
    good = _rgb_png(a)
    cases = {
        "junk after iend": _rgb_png(b) + b"junk!",
        "iend cut to its tag": _rgb_png(b)[:-4],
        "iend tag damaged": _rgb_png(b)[:-8] + b"IENx" + b"\0" * 4,
        "iend ancillary": _rgb_png(b)[:-12] + _chunk(b"iEND", b""),
    }
    packets = png.parser_packets([(0, len(good + good))],
                                 lambda o, n: (good + good)[o:o + n])
    assert packets == [((0, len(good)),), ((len(good), len(good)),)]
    for name, frame in cases.items():
        for ext in ("avi", "mkv"):
            equal_cv2(mux(tmp_path / f"p.{ext}", [good, frame, good, good]),
                      one_thread=True)
        assert name
    frames = pan(3, 72, 88, dy=1, dx=2)
    path = tmp_path / "q.mov"
    write_cv2_video(path, frames, "png ")
    data = bytearray(path.read_bytes())
    i = data.index(b"IEND")
    data[i + 3] ^= 1
    path.write_bytes(bytes(data))
    equal_cv2(path, 3, one_thread=True)


@pytest.mark.parametrize("interlace", [0, 1])
def test_image_data_ending_early_equal_cv2(tmp_path, interlace):
    """IEND after image data cut at 21 points: FFmpeg gives the frame
    where the rows reached are a twentieth of a plain image's, or all of
    an Adam7 image's first pass (its frames then are cv2 5.0's
    uninitialised memory: only the count is held), and drops it
    otherwise."""
    h, w = 100, 20
    samples = np.random.default_rng(interlace).integers(0, 256, (h, w, 3))
    full = png_of(samples, 8, 2, interlace)
    at = full.index(b"IDAT") + 4
    n = struct.unpack(">I", full[at - 8:at - 4])[0]
    raw = zlib.decompress(full[at:at + n])
    kept = 0
    for frac in np.linspace(0, 1, 21):
        c = zlib.compressobj(9)
        z = c.compress(raw[:int(len(raw) * frac)]) + c.flush(zlib.Z_SYNC_FLUSH)
        cut = full[:at - 8] + _chunk(b"IDAT", z) + full[at + n + 4:]
        path = mux(tmp_path / "e.avi", [cut, full], (h, w))
        if interlace:
            got, want = port(path), cv2_rgb_one_thread(path) or []
            assert len(got) == len(want)
        else:
            got = equal_cv2(path, one_thread=True)
        kept += len(got) == 2
    assert 0 < kept < 21


@pytest.mark.parametrize("mode,interlace", [("RGB", 0), ("P-trns", 1),
                                            ("L", 1)])
def test_cut_and_flipped_frames_equal_cv2_on_one_thread(tmp_path, mode,
                                                        interlace):
    """Cuts anywhere past the first frame's start, and 120 single-bit
    flips inside the frames, in an MPNG AVI of three frames: cv2's count,
    every frame equal."""
    frames = [_pil_png(scene_image(*HW, seed=s), mode, interlace)
              for s in (7, 8, 9)]
    data = mux(tmp_path / "m.avi", frames).read_bytes()
    spans = [(data.index(f), len(f)) for f in frames]
    rng = np.random.default_rng(len(mode) + interlace)
    cases = [data[:n] for n in range(spans[0][0], len(data), 97)]
    for _ in range(120):
        b = bytearray(data)
        o, n = spans[int(rng.integers(0, 3))]
        b[o + int(rng.integers(0, n))] ^= 1 << int(rng.integers(0, 8))
        cases.append(bytes(b))
    counts = []
    for case in cases:
        p = tmp_path / "c.avi"
        p.write_bytes(case)
        counts.append(len(equal_cv2(p, one_thread=True)))
    assert min(counts) < 3 and max(counts) == 3


# ---------------------------------------------------------- fixtures

def _digest(path) -> dict:
    rgb = cv2_rgb(path)
    return {"frames": len(rgb), "shape": list(rgb[0].shape),
            "rgb_sha256": [_sha(f) for f in rgb]}


def write_fixtures() -> None:
    """cv2's MPNG and ``png `` writers on a small pan, with the sha256 of
    cv2's RGB frames beside the other fixtures' in cv2_sha256.json."""
    small = pan(4, 96, 128, dy=1, dx=2)
    for name in SMALL_FIXTURES:
        write_cv2_video(FIXTURES / name, small,
                        "png " if name.endswith(".mov") else "MPNG")
    table = json.loads(DIGESTS.read_text())
    for name in SMALL_FIXTURES:
        table[name] = _digest(FIXTURES / name)
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256():
    """The committed fixtures (what chip_smoke.py holds the card to):
    cv2's decode still gives the recorded sha256, and so does the
    port's."""
    table = json.loads(DIGESTS.read_text())
    for name in SMALL_FIXTURES:
        path = FIXTURES / name
        want = table[name]
        assert path.stat().st_size <= 120_000, name
        assert _digest(path) == want, name
        assert [_sha(f) for f in port(path)] == want["rgb_sha256"], name


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
