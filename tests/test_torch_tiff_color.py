"""The port's TIFF reader (io/tiff.py) on the images libtiff 4.7's RGBA
interface converts for OpenCV 5.0's ``imread``, against ``cv2.imread`` of
the same bytes written to a file, bit for bit, None included:

- floating-point samples (16, 32 and 64-bit, 1, 3 and 4 samples, chunky
  and planar, predictor 3): no image, as cv2 gives none; the compressions
  cv2's libtiff is built without (LZMA, Zstandard, WebP, LERC): no image;
  the ones it reads and the port does not (CCITT, old-style JPEG,
  ThunderScan, JPEG 2000 in TIFF, ...): ``NotImplementedError`` naming
  them; ICC Lab, ITU Lab, LogL and LogLuv: no image;
- YCbCr (photometric 6) uncompressed, Deflate, PackBits and LZW, in the
  data units of every YCbCrSubsampling libtiff reads (and None for the
  others), images that cut a unit, strips and tiles, ReferenceBlackWhite
  and YCbCrCoefficients; the whole map: a 4096x4096 image holding each of
  the 2^24 (Y, Cb, Cr) triples once, with the default and other reference
  and coefficients;
- CMYK (photometric 5) of InkSet 1 at 8 bits, chunky and planar, over a
  grid of inks, and None for other ink sets, 16 bits and extra samples;
- CIE Lab (photometric 8) at 8 and 16 bits, and the whole 8-bit map
  (2^24 triples), with the default and another white point;
- JPEG compression (7): cv2's writer at several RowsPerStrip, Pillow's
  RGB, grey and YCbCr, the numpy writer (testing/photos.py, JPEGTables
  and abbreviated strips) in strips and tiles cut by the image's edges,
  every JPEG sampling against YCbCrSubsampling (present, absent, and
  disagreeing), photometric RGB over a YCbCr stream, planar; 12-bit
  (None, as cv2); cuts and bit flips in the strips on one thread;
- the committed fixtures in ``testing/photo_fixtures/`` against their
  sha256 in ``cv2_sha256_tiff_color.json`` (null: cv2 gives no image;
  rewrite them with ``PYTHONPATH=.:tests python
  tests/test_torch_tiff_color.py --write-fixtures``)."""

import hashlib
import io
import json
import pathlib
import struct
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from slam_indoor_code_tpu_torch.io import photo, tiff
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg, photos
from test_torch_photos import no_native, scene_image  # noqa: F401

torch.set_num_threads(1)

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "slam_indoor_code_tpu_torch" / "testing" / "photo_fixtures")
DIGESTS = FIXTURES / "cv2_sha256_tiff_color.json"
HW = (37, 53)


def cv2_read(tmp_path, data: bytes):
    """``cv2.imread`` (colour) of ``data`` as RGB; None where it gives no
    image."""
    p = tmp_path / "x.tif"
    p.write_bytes(data)
    img = cv2.imread(str(p))
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def port_read(data: bytes):
    try:
        return photo.decode(data)
    except ValueError:
        return None


def same_as_cv2(tmp_path, data: bytes):
    want = cv2_read(tmp_path, data)
    got = port_read(data)
    assert (got is None) == (want is None), (got is None, want is None)
    if want is not None:
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    return got


def pil_tiff(rgb, mode: str, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(b, "TIFF", **kw)
    return b.getvalue()


def samples(hw, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (*hw, n),
                                                dtype=np.uint8)


def rational(*values, den=10000):
    return [int(round(v * den)) if i % 2 == 0 else den
            for v in values for i in (0, 1)]


# ------------------------------------------------------ None and refusals
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
@pytest.mark.parametrize("spp", [1, 3, 4])
@pytest.mark.parametrize("planar", [False, True])
def test_floating_point_tiff_gives_none_as_cv2(tmp_path, dtype, spp, planar):
    """Every float layout: cv2 gives no image (libtiff's RGBA reader takes
    no float samples), and neither does the port."""
    f = np.random.default_rng(spp).random((*HW, spp)).astype(dtype)
    data = photos.encode_tiff(f, photometric=2 if spp >= 3 else 1,
                              planar=planar)
    assert cv2_read(tmp_path, data) is None
    assert photo.decode(data) is None


def test_float_tiff_with_predictor_3_and_24_bits_give_none(tmp_path):
    f = np.random.default_rng(1).random((*HW, 3)).astype(np.float32)
    for data in (
            photos.encode_tiff(f, compression="deflate",
                               extra_tags=((317, 3, [3]),)),
            photos.encode_tiff(np.zeros((*HW, 3), np.uint8),
                               extra_tags=((258, 3, [24] * 3),
                                           (339, 3, [3] * 3)))):
        assert cv2_read(tmp_path, data) is None
        assert photo.decode(data) is None


@pytest.mark.parametrize("code", [34925, 50000, 50001, 34887])
def test_compressions_cv2_lacks_give_none(tmp_path, code):
    """LZMA, Zstandard, WebP and LERC: cv2's libtiff is built without them
    and gives no image."""
    data = photos.encode_tiff(samples(HW, 3, code),
                              extra_tags=((259, 3, [code]),))
    assert cv2_read(tmp_path, data) is None
    assert photo.decode(data) is None


@pytest.mark.parametrize("code,name", [
    (3, "CCITT Group 3"), (4, "CCITT Group 4"), (2, "CCITT RLE"),
    (6, "old-style JPEG"), (32809, "ThunderScan"),
    (34712, "compression 34712")])
def test_compressions_still_unread_are_refused_by_name(tmp_path, code,
                                                       name):
    """Old-style JPEG and ThunderScan (nothing here writes them) and JPEG
    2000 in TIFF, which cv2's libtiff does not know (it gives a black
    frame), are refused by name.  Pillow's CCITT files, which cv2 reads,
    were refused until native/fax3.cpp read them: they now equal cv2
    (tests/test_torch_fax.py holds every CCITT mode)."""
    if code in (2, 3, 4):
        data = pil_tiff(scene_image(*HW), "1", compression={
            2: "tiff_ccitt", 3: "group3", 4: "group4"}[code])
        want = cv2_read(tmp_path, data)
        assert want is not None
        np.testing.assert_array_equal(photo.decode(data), want)
        return
    else:
        data = photos.encode_tiff(samples(HW, 3, 1),
                                  extra_tags=((259, 3, [code]),))
    if code == 34712:
        assert cv2_read(tmp_path, data).max() == 0
    with pytest.raises(NotImplementedError, match=name):
        photo.decode(data)


@pytest.mark.parametrize("photometric", [9, 10, 32844, 32845, 4, 7])
def test_other_photometrics_give_none(tmp_path, photometric):
    """ICC Lab, ITU Lab, LogL, LogLuv and others: no image in cv2."""
    for spp in (1, 3):
        data = photos.encode_tiff(samples(HW, spp, 2),
                                  photometric=photometric)
        assert cv2_read(tmp_path, data) is None
        assert photo.decode(data) is None


# ------------------------------------------------------------------ YCbCr
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2),
                                 (4, 4), (1, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("compression", ["none", "deflate", "packbits"])
def test_ycbcr_data_units_equal_cv2(tmp_path, sub, compression):
    """The numpy writer's data units in strips (the last one short) and in
    tiles, at a size that cuts units; (1, 4) and (2, 4) give None, as in
    cv2."""
    ycc = samples(HW, 3, sub[0] * 8 + sub[1])
    for kw in ({"rows_per_strip": 8}, {"tile": (32, 16)}):
        same_as_cv2(tmp_path, photos.encode_tiff(
            ycc, photometric=6, subsampling=sub, compression=compression,
            **kw))


@pytest.mark.parametrize("compression", [None, "tiff_lzw",
                                         "tiff_adobe_deflate", "packbits"])
def test_pillow_ycbcr_equals_cv2(tmp_path, compression):
    same_as_cv2(tmp_path, pil_tiff(scene_image(*HW), "YCbCr",
                                   compression=compression))


@pytest.mark.parametrize("tags", [
    ((532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),),
    ((529, 5, rational(0.2126, 0.7152, 0.0722)),),
    ((532, 5, [0, 1, 0, 1, 128, 1, 128, 1, 128, 1, 128, 1]),),
    ((529, 5, rational(0.299, 0.0, 0.114)),),
    ((531, 3, [2]),)])
def test_ycbcr_reference_coefficients_and_positioning(tmp_path, tags):
    """Studio-range ReferenceBlackWhite, BT.709 coefficients, a reference
    of zero range, a green coefficient of zero (None), and centred
    positioning (which libtiff's reader ignores)."""
    same_as_cv2(tmp_path, photos.encode_tiff(
        samples(HW, 3, 5), photometric=6, subsampling=(2, 2),
        extra_tags=tags))


def test_ycbcr_planar_and_other_layouts(tmp_path):
    """Planar 1:1 is read; planar subsampled, four samples and 16 bits
    give None, as in cv2; predictor 2 under Deflate."""
    ycc = samples(HW, 3, 7)
    for data in (
            photos.encode_tiff(ycc, photometric=6, planar=True,
                               extra_tags=((530, 3, [1, 1]),)),
            photos.encode_tiff(ycc, photometric=6, planar=True),
            photos.encode_tiff(samples(HW, 4, 7), photometric=6,
                               extra_samples=(0,),
                               extra_tags=((530, 3, [1, 1]),)),
            photos.encode_tiff(ycc.astype(np.uint16) * 257, photometric=6,
                               extra_tags=((530, 3, [1, 1]),)),
            photos.encode_tiff(ycc, photometric=6, compression="deflate",
                               predictor=2, extra_tags=((530, 3, [1, 1]),))):
        same_as_cv2(tmp_path, data)


def _all_triples() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("photometric,tags", [
    (6, ((530, 3, [1, 1]),)),
    (6, ((530, 3, [1, 1]),
         (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),
         (529, 5, rational(0.2126, 0.7152, 0.0722)))),
    (8, ()),
    (8, ((318, 5, rational(0.3127, 0.3290)),))],
    ids=["ycbcr", "ycbcr-studio-709", "lab", "lab-d65"])
def test_every_triple_equals_cv2(tmp_path, photometric, tags):
    """One 4096x4096 TIFF holding each of the 2^24 triples once (Y, Cb,
    Cr or L, a, b): the port equals cv2 at every pixel, which holds
    libtiff's float tables and its order of operations."""
    data = photos.encode_tiff(_all_triples(), photometric=photometric,
                              rows_per_strip=256, extra_tags=tags)
    same_as_cv2(tmp_path, data)


# ------------------------------------------------------------------- CMYK
def test_cmyk_over_a_grid_of_inks_equals_cv2(tmp_path):
    """Every (C, M, Y, K) of 9 levels each, chunky and planar, in strips
    and tiles; K = 0 gives back 255 - C, M, Y exactly."""
    levels = np.array([0, 1, 31, 64, 127, 128, 200, 254, 255], np.uint8)
    grid = np.stack(np.meshgrid(levels, levels, levels, levels,
                                indexing="ij"), -1).reshape(81, 81, 4)
    for kw in ({}, {"planar": True}, {"tile": (32, 48)},
               {"compression": "deflate", "predictor": 2,
                "rows_per_strip": 5}):
        same_as_cv2(tmp_path, photos.encode_tiff(grid, photometric=5, **kw))
    rgb = scene_image(*HW)
    cmyk = np.concatenate([255 - rgb, np.zeros((*HW, 1), np.uint8)], -1)
    got = photo.decode(photos.encode_tiff(cmyk, photometric=5))
    np.testing.assert_array_equal(got, rgb)


def test_cmyk_layouts_cv2_does_not_read_give_none(tmp_path):
    """InkSet 2, 16-bit samples, a fifth (extra) sample, three samples:
    no image, as in cv2."""
    cmyk = samples(HW, 4, 3)
    for data in (
            photos.encode_tiff(cmyk, photometric=5,
                               extra_tags=((332, 3, [2]),)),
            photos.encode_tiff(cmyk.astype(np.uint16) * 257, photometric=5),
            photos.encode_tiff(samples(HW, 5, 3), photometric=5,
                               extra_samples=(0,)),
            photos.encode_tiff(samples(HW, 5, 3), photometric=5,
                               planar=True, extra_samples=(2,)),
            photos.encode_tiff(cmyk[..., :3], photometric=5)):
        assert cv2_read(tmp_path, data) is None
        assert port_read(data) is None


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "packbits"])
def test_pillow_cmyk_and_lab_equal_cv2(tmp_path, compression):
    rgb = scene_image(*HW)
    for mode in ("CMYK", "LAB"):
        same_as_cv2(tmp_path, pil_tiff(rgb, mode, compression=compression))


# -------------------------------------------------------------------- Lab
def test_lab_8_and_16_bit_and_layouts(tmp_path):
    """8-bit and 16-bit Lab in strips and tiles; planar and four samples
    give None, as in cv2."""
    rng = np.random.default_rng(4)
    lab8 = samples(HW, 3, 4)
    lab16 = rng.integers(0, 65536, (*HW, 3)).astype(np.uint16)
    for data in (photos.encode_tiff(lab8, photometric=8),
                 photos.encode_tiff(lab8, photometric=8, tile=(16, 16),
                                    compression="packbits"),
                 photos.encode_tiff(lab16, photometric=8, big_endian=True),
                 photos.encode_tiff(lab16, photometric=8,
                                    compression="deflate"),
                 photos.encode_tiff(lab8, photometric=8, planar=True),
                 photos.encode_tiff(samples(HW, 4, 4), photometric=8,
                                    extra_samples=(0,))):
        same_as_cv2(tmp_path, data)


# ------------------------------------------------------------------- JPEG
def cv2_jpeg(sampling, quality=90):
    def encode(rgb):
        return cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]), [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])[1].tobytes()
    return encode


SAMPLINGS = {"444": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, (1, 1)),
             "422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, (2, 1)),
             "420": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, (2, 2)),
             "411": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, (4, 1)),
             "440": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, (1, 2))}


@pytest.mark.parametrize("rows", [8, 16, 24, 40, 64])
def test_cv2_jpeg_tiff_equals_cv2(tmp_path, images, rows):
    """cv2's writer (photometric RGB, JPEGTables), RowsPerStrip a multiple
    of 8, the last strip short; and its grey one."""
    rgb = images
    for img in (rgb[..., ::-1], rgb[..., 0]):
        same_as_cv2(tmp_path, cv2.imencode(".tiff", np.ascontiguousarray(
            img), [cv2.IMWRITE_TIFF_COMPRESSION, 7,
                   cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows])[1].tobytes())


@pytest.fixture(scope="module")
def images():
    return scene_image(70, 90)


@pytest.mark.parametrize("mode", ["RGB", "L", "YCbCr"])
def test_pillow_jpeg_tiff_equals_cv2(tmp_path, images, mode):
    same_as_cv2(tmp_path, pil_tiff(images, mode, compression="jpeg"))


@pytest.mark.parametrize("layout", [{"rows_per_strip": 16},
                                    {"rows_per_strip": 48},
                                    {"rows_per_strip": 70},
                                    {"tile": (16, 16)}, {"tile": (32, 48)},
                                    {"tile": (64, 64)}])
@pytest.mark.parametrize("quality", [50, 95])
def test_numpy_jpeg_tiff_equals_cv2(tmp_path, images, layout, quality):
    """The numpy writer's YCbCr 4:2:0 JPEG TIFF: strips and tiles cut at
    the image's edges."""
    same_as_cv2(tmp_path, photos.encode_tiff(
        images, photometric=6, compression="jpeg",
        jpeg_encoder=lambda f: mjpeg.encode_jpeg(f, quality), **layout))


@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_jpeg_sampling_against_ycbcr_subsampling(tmp_path, images, name):
    """cv2's JPEG in each sampling: with the matching YCbCrSubsampling, in
    strips and tiles; without the tag (libtiff takes the JPEG's); with a
    disagreeing one (None); under photometric RGB (libtiff takes the
    components as stored: 1:1 only)."""
    flag, sub = SAMPLINGS[name]
    enc = cv2_jpeg(flag)
    wrong = [2, 2] if sub != (2, 2) else [1, 1]
    for data in (
            photos.encode_tiff(images, photometric=6, compression="jpeg",
                               rows_per_strip=32, jpeg_encoder=enc,
                               extra_tags=((530, 3, list(sub)),)),
            photos.encode_tiff(images, photometric=6, compression="jpeg",
                               tile=(32, 32), jpeg_encoder=enc,
                               extra_tags=((530, 3, list(sub)),)),
            photos.encode_tiff(images, photometric=6, compression="jpeg",
                               rows_per_strip=32, jpeg_encoder=enc,
                               extra_tags=((530, 3, wrong),)),
            photos.encode_tiff(images, photometric=2, compression="jpeg",
                               rows_per_strip=32, jpeg_encoder=enc)):
        same_as_cv2(tmp_path, data)
    tagged = photos.encode_tiff(images, photometric=6, compression="jpeg",
                                rows_per_strip=32, jpeg_encoder=enc)
    untagged = tagged.replace(struct.pack("<HHII", 530, 3, 2, 0x00020002),
                              struct.pack("<HHII", 531, 3, 1, 1))
    assert untagged != tagged
    same_as_cv2(tmp_path, untagged)


def test_jpeg_tiff_planar_12_bit_and_precision(tmp_path, images):
    """Planar YCbCr 1:1, each plane a one-component JPEG (read); 12-bit
    samples, and 8-bit samples over a 12-bit frame header: None, as in
    cv2."""
    same_as_cv2(tmp_path, photos.encode_tiff(
        images, photometric=6, compression="jpeg", planar=True,
        extra_tags=((530, 3, [1, 1]),),
        jpeg_encoder=lambda r: cv2.imencode(".jpg", r[..., 0])[1].tobytes()))
    data = photos.encode_tiff(images, photometric=6, compression="jpeg",
                              rows_per_strip=16)
    twelve = bytearray(photos.encode_tiff(
        images, photometric=6, compression="jpeg", rows_per_strip=16,
        extra_tags=((258, 3, [12] * 3),)))
    f, _ = tiff._directory(data)
    for o in f["strip_offsets"]:
        twelve[bytes(twelve).find(b"\xff\xc0", o) + 4] = 12
    same = bytearray(data)
    same[bytes(same).find(b"\xff\xc0", f["strip_offsets"][0]) + 4] = 12
    for d in (bytes(twelve), bytes(same)):
        assert cv2_read(tmp_path, d) is None
        assert port_read(d) is None


@pytest.mark.parametrize("counts", [(3,), (1, 3), (0, 0, 8),
                                    (0, 2, 4)])
def test_overfull_huffman_table_gives_none(tmp_path, images, counts):
    """JPEGTables with a DHT whose code counts run past their lengths (a
    code of all ones at (0, 2, 4), which libjpeg refuses too): None, as in
    cv2; the decoder once wrote past its lookup table here."""
    data = bytearray(photos.encode_tiff(images, photometric=6,
                                        compression="jpeg",
                                        rows_per_strip=16))
    at = bytes(data).find(b"\xff\xc4") + 5       # the first table's counts
    data[at:at + len(counts)] = bytes(counts)
    same_as_cv2(tmp_path, bytes(data))
    assert port_read(bytes(data)) is None


def damaged(data: bytes, start: int, end: int, seed: int, cuts: int = 30,
            flips: int = 90):
    """Cuts at evenly spaced lengths from ``start``, and single-bit flips
    between ``start`` and ``end`` (the strips)."""
    rng = np.random.default_rng(seed)
    step = max(1, (len(data) - start) // cuts)
    out = [data[:n] for n in range(start, len(data), step)]
    for _ in range(flips):
        b = bytearray(data)
        i = int(rng.integers(start, end))
        b[i] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("writer", ["numpy", "cv2", "tiles"])
def test_damaged_jpeg_strips_equal_cv2_on_one_thread(tmp_path, images,
                                                     writer):
    """Cut files and bit flips in the JPEG strips or tiles, cv2 on one
    thread: None where TIFFReadRGBAStrip fails (a frame header libjpeg
    refuses, a strip past the file's end), else libjpeg-turbo's reading of
    the damaged data (its SIMD IDCT's 16-bit arithmetic, what follows a
    complete scan ignored)."""
    data = {"numpy": lambda: photos.encode_tiff(
        images, photometric=6, compression="jpeg", rows_per_strip=16),
        "cv2": lambda: cv2.imencode(".tiff", images[..., ::-1].copy(), [
            cv2.IMWRITE_TIFF_COMPRESSION, 7,
            cv2.IMWRITE_TIFF_ROWSPERSTRIP, 16])[1].tobytes(),
        "tiles": lambda: photos.encode_tiff(
            images, photometric=6, compression="jpeg", tile=(32, 32))}[
        writer]()
    f, _ = tiff._directory(data)
    offsets = f.get("strip_offsets") or f.get("tile_offsets")
    counts = f.get("strip_counts") or f.get("tile_counts")
    end = max(o + c for o, c in zip(offsets, counts))
    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    try:
        results = [same_as_cv2(tmp_path, d) for d in damaged(
            data, min(offsets), end, seed=len(writer))]
    finally:
        cv2.setNumThreads(threads)
    assert any(r is None for r in results)
    assert any(r is not None for r in results)


# --------------------------------------------------------------- fixtures
def fixture_files() -> dict:
    """name -> bytes of the committed TIFF fixtures of this file."""
    rgb = scene_image(37, 53, seed=11)
    ycc = samples((37, 53), 3, 11)
    cmyk = np.concatenate([255 - rgb, samples((37, 53), 1, 12) // 3], -1)
    return {
        "tiff_jpeg_strips.tif": photos.encode_tiff(
            rgb, photometric=6, compression="jpeg", rows_per_strip=16),
        "tiff_jpeg_tiles.tif": photos.encode_tiff(
            rgb, photometric=6, compression="jpeg", tile=(32, 16),
            jpeg_encoder=lambda f: mjpeg.encode_jpeg(f, 80)),
        "tiff_jpeg_cv2_rgb.tif": cv2.imencode(".tiff", rgb[..., ::-1].copy(), [
            cv2.IMWRITE_TIFF_COMPRESSION, 7,
            cv2.IMWRITE_TIFF_ROWSPERSTRIP, 24])[1].tobytes(),
        "tiff_ycbcr_420_deflate.tif": photos.encode_tiff(
            ycc, photometric=6, subsampling=(2, 2), compression="deflate",
            rows_per_strip=8),
        "tiff_ycbcr_41_studio.tif": photos.encode_tiff(
            ycc, photometric=6, subsampling=(4, 1), tile=(32, 16),
            extra_tags=((532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1,
                                  240, 1]),)),
        "tiff_cmyk_planar.tif": photos.encode_tiff(cmyk, photometric=5,
                                                   planar=True),
        "tiff_lab8.tif": pil_tiff(rgb, "LAB", compression="packbits"),
        "tiff_lab16_mm.tif": photos.encode_tiff(
            samples((37, 53), 3, 13).astype(np.uint16) * 251,
            photometric=8, big_endian=True),
        "tiff_float32_none.tif": photos.encode_tiff(
            rgb.astype(np.float32) / 255),
    }


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
    assert sum(table[k] is None for k in table) == 1
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


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
