"""The port's PFM, Radiance HDR and Sun raster readers (io/pfm.py,
io/hdr.py over native/hdr.cpp, io/sunras.py) against ``cv2.imread`` of the
same bytes written to a file, bit for bit, None included (a ``cv2.error``
from ``imread``'s size check counts as None, and the port raises
``ValueError`` there):

- PFM: cv2's writer, both byte orders, scales other than 1 (the samples
  times 1/|scale|), halves (rounded to even), negatives, NaN and the
  infinities (0), values past 32-bit integers (0); the header as OpenCV's
  ``read_number`` reads it; a gray ``Pf`` (None in colour); cuts and
  flips;
- Radiance HDR: cv2's writer (new-style runs) at widths below 8 (flat)
  and above, both magics, ``EXPOSURE`` before and after FORMAT, other
  header lines, ``32-bit_rle_xyze`` and every orientation other than
  ``-Y +X`` (None), flat and old-style scanlines, exponents that
  overflow, lines past fgets' 127 bytes; cuts and flips;
- testing/photos.py's PFM, HDR and Sun raster writers;
- Sun raster: cv2's writer and testing/photos.py's (1, 8, 24, 32 bits,
  gray or a palette, short palettes), type 0 and 1, run-length coded and
  RGB-ordered files (None: OpenCV 5.0 reads neither), cuts and flips;
- the committed fixtures in ``testing/photo_fixtures/`` against their
  sha256 in ``cv2_sha256_pfm_hdr_sunras.json`` (null: cv2 gives no image;
  a lossy WebP cut where libwebp refuses it is among them; rewrite them
  with ``PYTHONPATH=.:tests python tests/test_torch_pfm_hdr_sunras.py
  --write-fixtures``);
- MediaSource on a glob of Sun raster frames against the JAX package's."""

import hashlib
import json
import pathlib
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
from slam_indoor_code_tpu_torch.io import photo
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import make_scene, photos
from test_torch_photos import no_native, scene_image  # noqa: F401

torch.set_num_threads(1)

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "slam_indoor_code_tpu_torch" / "testing" / "photo_fixtures")
DIGESTS = FIXTURES / "cv2_sha256_pfm_hdr_sunras.json"
SIZES = ((1, 1), (2, 3), (7, 8), (19, 23), (37, 53))


def cv2_read(tmp_path, data: bytes, name: str):
    """``cv2.imread`` (colour) of ``data`` as RGB; None where it gives no
    image or raises."""
    p = tmp_path / name
    p.write_bytes(data)
    try:
        img = cv2.imread(str(p))
    except cv2.error:
        return None
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def port_read(data: bytes):
    try:
        return photo.decode(data)
    except ValueError:
        return None


def same_as_cv2(tmp_path, data: bytes, name: str):
    want = cv2_read(tmp_path, data, name)
    got = port_read(data)
    assert (got is None) == (want is None), (got is None, want is None)
    if want is not None:
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    return got


def damaged(data: bytes, seed: int, cuts: int = 40, flips: int = 120,
            start: int = 0):
    """Cuts at evenly spaced lengths, and single-bit flips from ``start``
    on (the magic left whole: another magic is another format)."""
    rng = np.random.default_rng(seed)
    step = max(1, len(data) // cuts)
    out = [data[:n] for n in range(0, len(data), step)]
    for _ in range(flips):
        b = bytearray(data)
        i = int(rng.integers(start, len(b)))
        b[i] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    return out


def hold_damage(tmp_path, data: bytes, name: str, seed: int, start: int):
    results = [same_as_cv2(tmp_path, d, name)
               for d in damaged(data, seed, start=start)]
    assert any(r is None for r in results)
    assert any(r is not None for r in results)


# ------------------------------------------------------------------ PFM
def pfm(arr, scale=-1.0, gray=False, sep=b"\n") -> bytes:
    h, w = arr.shape[:2]
    head = (b"Pf" if gray else b"PF") + b"\n" + b"%d %d" % (w, h) + sep \
        + repr(float(scale)).encode() + b"\n"
    return head + np.ascontiguousarray(arr[::-1]).astype(
        "<f4" if scale < 0 else ">f4").tobytes()


@pytest.mark.parametrize("hw", SIZES)
def test_pfm_from_cv2_equals_cv2(tmp_path, hw):
    """cv2's PFM writer, 0-255 floats (the 8-bit image back) and 0-1
    floats (only 0 and 1: no scale is applied)."""
    rgb = scene_image(*hw)
    for f in (rgb.astype(np.float32), rgb.astype(np.float32) / 255):
        data = cv2.imencode(".pfm", np.ascontiguousarray(f[..., ::-1]))[1]
        got = same_as_cv2(tmp_path, data.tobytes(), "x.pfm")
        if f.max() > 1:
            np.testing.assert_array_equal(got, rgb)


@pytest.mark.parametrize("scale", [-1.0, 1.0, -3.0, 0.37, -255.0, 7.77,
                                   -1e-3, -float("inf")])
def test_pfm_scales_byte_orders_and_rounding_equal_cv2(tmp_path, scale):
    """Little- and big-endian samples, times 1/|scale|, rounded half to
    even and saturated; NaN, the infinities and values past 32-bit
    integers give 0."""
    rng = np.random.default_rng(int(min(abs(scale), 1e6) * 100))
    x = rng.uniform(-50, 300, (9, 11, 3)).astype(np.float32)
    x *= np.float32(min(1.0, abs(scale)))
    x[0, :8, 0] = [0.5, 1.5, 2.5, -0.5, 254.5, np.nan, np.inf, 3e9]
    x[1, :4, 1] = [-np.inf, 1e9, -3e9, 255.5]
    same_as_cv2(tmp_path, pfm(x, scale), "x.pfm")


@pytest.mark.parametrize("head", [
    b"PF\n5 3\n-1.0\n", b"PF\n5 3 -1.0\n", b"PF\n5\t3\n-1\n",
    b"PF\n+5 3\n-1.0\n", b"PF\n5abc 3\n-1.0\n", b"PF\n5 3\n-1.0abc\n",
    b"PF\n5 3\nabc\n", b"PF\n5 3\n-0x1p0\n", b"PF\n5 3\n-1.0\r\n",
    b"PF\n5 3\n-1.0", b"PF\n 5 3\n-1.0\n", b"PF\n5  3\n-1.0\n",
    b"PF\n5 3\n\n-1.0\n", b"PF\n0 3\n-1.0\n", b"PF\n5 3\n-inf\n",
    b"PF\n5 3\n-nan\n", b"PF\n#c\n5 3\n-1.0\n", b"PF \n5 3\n-1.0\n",
    b"PF\r\n5 3\n-1.0\n", b"PF\n5 3\n-1e0\xff\n"])
def test_pfm_headers_as_opencv_reads_them(tmp_path, head):
    """Each number ends at the first whitespace byte (C's atoi/atof of
    what precedes it), the samples start right after the scale's."""
    x = np.random.default_rng(3).uniform(0, 255, (3, 5, 3)).astype("<f4")
    same_as_cv2(tmp_path, head + x.tobytes() + bytes(8), "x.pfm")


def test_gray_pfm_gives_none_as_in_cv2(tmp_path):
    """A gray map (``Pf``) read in colour: OpenCV's reader fails."""
    x = np.random.default_rng(4).uniform(0, 255, (4, 6)).astype(np.float32)
    assert cv2_read(tmp_path, pfm(x, gray=True), "x.pfm") is None
    assert port_read(pfm(x, gray=True)) is None


def test_pfm_cut_and_flipped_equal_cv2(tmp_path):
    x = scene_image(19, 23).astype(np.float32)
    hold_damage(tmp_path, pfm(x), "x.pfm", 5, start=2)


# ------------------------------------------------------------------ HDR
HDR_HEAD = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n"


def hdr_from_cv2(hw, gain=1.0, seed=7) -> bytes:
    f = scene_image(*hw, seed=seed).astype(np.float32) / 255 * gain
    return cv2.imencode(".hdr", np.ascontiguousarray(f[..., ::-1]))[1] \
        .tobytes()


@pytest.mark.parametrize("gain", [0.3, 1.0, 2.7])
@pytest.mark.parametrize("hw", SIZES + ((61, 130),))
def test_hdr_from_cv2_equals_cv2(tmp_path, hw, gain):
    """cv2's writer: new-style runs where the width is 8 to 32767, flat
    RGBE below; each float times 255."""
    same_as_cv2(tmp_path, hdr_from_cv2(hw, gain), "x.hdr")


def _rgbe(h, w, seed, exps=(120, 140)):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    px[..., 3] = rng.integers(*exps, (h, w))
    return px


@pytest.mark.parametrize("head", [
    HDR_HEAD, b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n",
    b"#?RADIANCE\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=0.5\nGAMMA=2.2\n\n"
    b"-Y %d +X %d\n",
    b"#?RADIANCE\nSOFTWARE=" + b"x" * 300 + b"\nFORMAT=32-bit_rle_rgbe\n\n"
    b"-Y %d +X %d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y %d +X %d\n",
    b"#?RADIANCE\n\n-Y %d +X %d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y %d +X %d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d -X %d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+X %d -Y %d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y%d+X%d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n-Y %d +X %d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n-Y %d +X %d\n",
    b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y %d +X %d\r\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n\n-Y %d +X %d\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 0%d +X %d\n"])
@pytest.mark.parametrize("w", [5, 9])
def test_hdr_headers_as_opencv_reads_them(tmp_path, head, w):
    """Header lines to an empty one, one of them exactly the RGBE FORMAT
    (EXPOSURE and GAMMA ignored, XYZE refused), then ``-Y h +X w`` only;
    flat pixels with exponents from 120 to 140."""
    h = 4
    same_as_cv2(tmp_path, head % (h, w) + _rgbe(h, w, w).tobytes(), "x.hdr")


def test_hdr_flat_old_style_and_overflowing_pixels_equal_cv2(tmp_path):
    """Exponents 0 (black), 1 and 255 (past 32-bit integers: 0), old-style
    runs (1, 1, 1, n: read as pixels), a flat scanline after coded ones
    (the rest of the image flat) and a scanline of another width."""
    w, h = 12, 5
    px = _rgbe(h, w, 1, exps=(0, 256))
    px[0, :4] = [[1, 1, 1, 5], [200, 10, 3, 255], [9, 9, 9, 0], [7, 8, 9, 1]]
    flat = HDR_HEAD % (h, w) + px.tobytes()
    same_as_cv2(tmp_path, flat, "x.hdr")
    one = hdr_from_cv2((1, w))                     # one coded scanline
    line = one[one.index(b"+X %d\n" % w) + len(b"+X %d\n" % w):]
    assert line[:2] == b"\x02\x02"
    # a coded scanline, then flat ones: the rest read as pixels
    same_as_cv2(tmp_path, HDR_HEAD % (h, w) + line + px[1:].tobytes(),
                "x.hdr")
    wrong = bytearray(line)
    wrong[3] ^= 1                                  # the width it states
    same_as_cv2(tmp_path, HDR_HEAD % (h, w) + bytes(wrong) * h, "x.hdr")


@pytest.mark.parametrize("hw", [(5, 7), (19, 40)])
def test_hdr_cut_and_flipped_equal_cv2(tmp_path, hw):
    data = hdr_from_cv2(hw, 1.7)
    hold_damage(tmp_path, data, "x.hdr", hw[1], start=10)


# ------------------------------------------------------------ Sun raster
def _sun_cases(hw):
    rgb = scene_image(*hw)
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    idx = rng.integers(0, 256, hw, dtype=np.uint8)
    bits = rng.integers(0, 2, hw, dtype=np.uint8)
    gray_pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    return {
        "cv2": cv2.imencode(".ras", rgb[..., ::-1])[1].tobytes(),
        "rgb24": photos.encode_sun_raster(rgb),
        "rgb32": photos.encode_sun_raster(rgb, depth=32),
        "gray8": photos.encode_sun_raster(rgb[..., 1], depth=8),
        "pal8": photos.encode_sun_raster(idx, depth=8, palette=pal),
        "short_pal8": photos.encode_sun_raster(idx, depth=8,
                                               palette=pal[:40]),
        "gray_pal8": photos.encode_sun_raster(idx, depth=8,
                                              palette=gray_pal),
        "bits1": photos.encode_sun_raster(bits, depth=1),
        "pal1": photos.encode_sun_raster(bits, depth=1, palette=pal[:2]),
        "rle24": photos.encode_sun_raster(rgb, rle=True),
        "rle8": photos.encode_sun_raster(idx, depth=8, rle=True,
                                         palette=pal),
        "rgb_order24": photos.encode_sun_raster(rgb, rgb_order=True),
    }, rgb


@pytest.mark.parametrize("hw", SIZES)
def test_sun_raster_variants_equal_cv2(tmp_path, hw):
    """Each depth, gray or a palette (short ones: black past them), cv2's
    own writer and testing/photos.py's; 24 and 32-bit files give the
    frame; run-length coded and RGB-ordered ones give None, as OpenCV
    5.0 reads neither."""
    cases, rgb = _sun_cases(hw)
    for name, data in cases.items():
        got = same_as_cv2(tmp_path, data, "x.ras")
        if name in ("cv2", "rgb24", "rgb32"):
            np.testing.assert_array_equal(got, rgb)
        if name.startswith(("rle", "rgb_order")):
            assert got is None, name


@pytest.mark.parametrize("field,values", [
    ("depth", [0, 2, 4, 16, 33]), ("type", [0, 4, 5, 0xFFFF]),
    ("maptype", [1, 2]), ("maplength", [3, 768, 769, 1 << 20]),
    ("width", [0, -5]), ("height", [0, -1])])
def test_sun_raster_header_fields_equal_cv2(tmp_path, field, values):
    """The header's rules: the depths read, the types, map types and map
    lengths OpenCV takes, and sizes above 0."""
    at = {"width": 4, "height": 8, "depth": 12, "type": 20, "maptype": 24,
          "maplength": 28}[field]
    for data in (photos.encode_sun_raster(scene_image(7, 9)[..., 0],
                                          depth=8),
                 photos.encode_sun_raster(scene_image(7, 9))):
        for v in values:
            b = bytearray(data + bytes(2048))
            b[at:at + 4] = struct.pack(">i", v)
            same_as_cv2(tmp_path, bytes(b), "x.ras")


@pytest.mark.parametrize("name", ["cv2", "rgb32", "pal8", "bits1"])
def test_sun_raster_cut_and_flipped_equal_cv2(tmp_path, name):
    cases, _ = _sun_cases((19, 23))
    hold_damage(tmp_path, cases[name], "x.ras", len(name), start=4)


@pytest.mark.parametrize("hw", SIZES + ((61, 130),))
def test_numpy_writers_equal_cv2(tmp_path, hw):
    """testing/photos.py's PFM, Radiance HDR (new-style literal runs) and
    Sun raster writers, which the card's glob and timings use: cv2 reads
    them as the port does; PFM and Sun raster give the frame back, HDR
    its RGBE rounding of it (within 1 grey level)."""
    rgb = scene_image(*hw)
    for ext, data in (("pfm", photos.encode_pfm(rgb)),
                      ("hdr", photos.encode_hdr(rgb)),
                      ("ras", photos.encode_sun_raster(rgb)),
                      ("ras", photos.encode_sun_raster(rgb, depth=32))):
        got = same_as_cv2(tmp_path, data, "x." + ext)
        if ext == "hdr":
            assert np.abs(got.astype(int) - rgb).max() <= 1
        else:
            np.testing.assert_array_equal(got, rgb)


# ------------------------------------------------------------- fixtures
def fixture_files() -> dict:
    """name -> bytes of the committed PFM, HDR and Sun raster fixtures."""
    rgb = scene_image(37, 53, seed=11)
    rng = np.random.default_rng(2)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    idx = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    f = rgb.astype(np.float32)
    return {
        "pfm_cv2.pfm": cv2.imencode(".pfm", np.ascontiguousarray(
            f[..., ::-1]))[1].tobytes(),
        "pfm_scale3_be.pfm": pfm(f * 3 + 0.5, 3.0),
        "hdr_cv2_rle.hdr": hdr_from_cv2((37, 53), 1.3, seed=11),
        "hdr_flat_exposure.hdr": (
            b"#?RGBE\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 7\n"
            + _rgbe(6, 7, 9).tobytes()),
        "sunras_cv2.ras": cv2.imencode(".ras", rgb[..., ::-1])[1].tobytes(),
        "sunras_pal8.ras": photos.encode_sun_raster(idx, depth=8,
                                                    palette=pal[:100]),
        "sunras_32.sr": photos.encode_sun_raster(rgb, depth=32),
        "sunras_rle_none.ras": photos.encode_sun_raster(rgb, rle=True),
        "webp_lossy_cut_none.webp": _refused_lossy_webp(rgb),
    }


def _refused_lossy_webp(rgb) -> bytes:
    """cv2's q80 lossy WebP of a grainy ``rgb`` cut (its RIFF and chunk
    sizes made to match) where its last token partition runs out: libwebp
    refuses it, and native/vp8.cpp's video reading would not."""
    grain = np.random.default_rng(3).integers(-40, 40, rgb.shape)
    bgr = np.clip(rgb.astype(int) + grain, 0, 255).astype(np.uint8)[..., ::-1]
    data = cv2.imencode(".webp", np.ascontiguousarray(bgr),
                        [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes()
    assert data[12:16] == b"VP8 "
    n = (len(data) - 20) * 2 // 3
    return (b"RIFF" + struct.pack("<I", 12 + n) + b"WEBPVP8 "
            + struct.pack("<I", n) + data[20:20 + n])


def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def write_fixtures() -> None:
    """The fixtures, and the sha256 of cv2's RGB of each (None where cv2
    gives no image) beside the other photo fixtures'."""
    table = {}
    for name, data in fixture_files().items():
        path = FIXTURES / name
        path.write_bytes(data)
        img = cv2.imread(str(path))
        table[name] = None if img is None else {
            "shape": list(img.shape), "sha256": _sha(img[..., ::-1])}
    DIGESTS.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_cv2_and_port_equal_recorded_sha256(no_native):
    """The committed fixtures (what chip_smoke.py holds the card to): cv2
    still gives the recorded sha256, or None, and so does the port through
    MediaSource's reader."""
    table = json.loads(DIGESTS.read_text())
    assert sorted(table) == sorted(fixture_files())
    assert sum(table[k] is None for k in table) == 2
    for name, want in table.items():
        path = FIXTURES / name
        img = cv2.imread(str(path))
        got = list(MediaSource(photos_pattern=str(path)))
        if want is None:
            assert img is None and got == [], name
            continue
        assert _sha(img[..., ::-1]) == want["sha256"], name
        assert len(got) == 1 and list(got[0].shape) == want["shape"], name
        assert _sha(got[0]) == want["sha256"], name


# ------------------------------------------------------------ sequences
def test_sun_raster_glob_equals_jax_media_source(tmp_path, no_native):
    """A glob of Sun raster frames (cv2's writer and the numpy one, 24
    and 32-bit), a run-length coded one skipped by both, through both
    MediaSources: the same frames in the same order, equal to the
    frames."""
    sc = make_scene(n_points=300, n_frames=6, seed=5, baseline=0.3)
    frames = [sc.render(i) for i in range(6)]
    writers = (lambda f: cv2.imencode(".ras", f[..., ::-1])[1].tobytes(),
               photos.encode_sun_raster,
               lambda f: photos.encode_sun_raster(f, depth=32))
    for i, f in enumerate(frames):
        (tmp_path / f"frame_{i:02d}.ras").write_bytes(writers[i % 3](f))
    (tmp_path / "frame_06.ras").write_bytes(
        photos.encode_sun_raster(frames[0], rle=True))
    pattern = str(tmp_path / "frame_*.ras")
    want = list(JMediaSource(photos_pattern=pattern, threads=3))
    got = list(MediaSource(photos_pattern=pattern, threads=3))
    assert len(got) == len(want) == 6
    for a, b, f in zip(got, want, frames):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, f)


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
