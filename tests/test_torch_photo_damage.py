"""Damaged and truncated photos through the port's readers (io/photo.py,
the native libjpeg/libpng reader off, as on the card) against
``cv2.imread`` of the same bytes written to a file, on one thread: the
frame or no frame, and then every pixel.

- JPEG, as libjpeg-turbo 3.1 recovers (native/jpeg.cpp's ``lenient``):
  baseline q95, restart interval 4 (jpeg_resync_to_restart) and
  progressive files (damaged and cut scans, the fake EOI, block smoothing
  by the progression as it stood before a scan that did not finish) at
  240x320 and 540x960, cut and bit-flipped from fixed seeds; 4:2:2, 4:4:4
  and grey files, and the numpy writers' (testing/mjpeg.py, with and
  without restart intervals, and progressive).
- TIFF, as libtiff 4.7 decodes a damaged strip for OpenCV (native/
  tiff.cpp): LZW (cv2's and Pillow's), Deflate (Pillow's, and the numpy
  writer's with the predictor, 8 and 16-bit), PackBits and uncompressed,
  flipped and cut.
- The formats that agreed before (PNG, BMP, PPM, lossy and lossless
  WebP, GIF, JPEG 2000), one regression case each.
- A glob holding a cut, a flipped and a progressive file cut mid-scan
  through the port's MediaSource and the JAX package's (its native reader
  and cv2): the same frame count, the same frames.
- The committed fixtures: the four damaged FHD frames of
  ``testing/jpeg_fixtures/damaged/`` and the small damaged photos of
  ``testing/photo_fixtures/`` (``cv2_sha256_damage.json``), whose cv2
  sha256 the card checks.  Rewrite them with ``PYTHONPATH=. python
  tests/test_torch_photo_damage.py --write-fixtures``.

``python scripts/photo_damage_fuzz.py --cases N`` draws more cases of the
same sets."""

import hashlib
import io
import json
import pathlib
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from slam_indoor_code_tpu.io import native as jnative
from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
from slam_indoor_code_tpu_torch.io import jpeg, native, photo
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg, photos

ROOT = pathlib.Path(__file__).resolve().parent.parent
PHOTO_FIXTURES = ROOT / "slam_indoor_code_tpu_torch" / "testing" / \
    "photo_fixtures"
DAMAGED = ROOT / "slam_indoor_code_tpu_torch" / "testing" / \
    "jpeg_fixtures" / "damaged"
TABLE = PHOTO_FIXTURES / "cv2_sha256_damage.json"
# the headline frames the card's damaged run replaces, and their damage
DAMAGED_FRAMES = {8: "cut60", 16: "flips", 24: "restart-flips",
                  31: "progressive-cut"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """cv2 on one thread: the reference for each case."""
    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' native libjpeg/libpng readers off, as on the card."""
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", "g++: jpeglib.h: No such file")


def noise_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Blurred RGB noise: every coefficient and code in use."""
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                            (0, 0), 2.0)


_SAMPLING = {"422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def jpeg_file(kind: str, h: int, w: int) -> bytes:
    """A q95 JPEG of ``noise_image``: cv2's "baseline" (4:2:0), "restart"
    (interval 4), "progressive", "422", "444", "gray" and their
    progressive twins ("prog422" ...); the numpy writers' "mjpeg",
    "mjpeg-rst" (interval 8) and "mjpeg-prog"."""
    img = noise_image(h, w)
    if kind.startswith("mjpeg"):
        rgb = img[..., ::-1]
        if kind == "mjpeg-prog":
            return mjpeg.encode_progressive_jpeg(rgb, 95)
        return mjpeg.encode_jpeg(rgb, 95,
                                 restart_interval=8 if kind == "mjpeg-rst"
                                 else 0)
    params = [cv2.IMWRITE_JPEG_QUALITY, 95]
    base = kind[4:] if kind.startswith("prog") and kind != "progressive" \
        else kind
    if kind.startswith("prog"):
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if base == "restart":
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 4]
    if base in _SAMPLING:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[base]]
    if base == "gray":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def _pil(rgb, fmt, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, fmt, **kw)
    return b.getvalue()


def tiff_file(kind: str) -> bytes:
    """A TIFF of ``noise_image``: cv2's LZW ("lzw-cv2"), Pillow's LZW,
    Deflate, PackBits and uncompressed in strips ("lzw-pil", ...), the
    numpy writer's Deflate with the predictor at 8 and 16 bits (big-endian)
    and planar PackBits."""
    img = noise_image(120, 160)
    rgb = np.ascontiguousarray(img[..., ::-1])
    if kind == "lzw-cv2":
        return cv2.imencode(".tiff", img)[1].tobytes()
    if kind.endswith("-pil"):
        comp = {"lzw-pil": "tiff_lzw", "deflate-pil": "tiff_adobe_deflate",
                "packbits-pil": "packbits", "none-pil": "raw"}[kind]
        return _pil(rgb, "TIFF", compression=comp, strip_size=8192)
    if kind == "deflate-pred":
        return photos.encode_tiff(rgb, compression="deflate", predictor=2,
                                  rows_per_strip=16)
    if kind == "deflate16-be":
        return photos.encode_tiff(rgb.astype(np.uint16) * 257,
                                  compression="deflate", predictor=2,
                                  big_endian=True, rows_per_strip=20)
    return photos.encode_tiff(rgb, compression="packbits", planar=True,
                              rows_per_strip=30)


def other_file(kind: str) -> bytes:
    """The formats that already agreed: cv2's PNG, BMP, PPM, lossy and
    lossless WebP, GIF and JPEG 2000 of ``noise_image``."""
    img = noise_image(120, 160)
    ext, params = {"png": (".png", []), "bmp": (".bmp", []),
                   "ppm": (".ppm", []),
                   "webp": (".webp", [cv2.IMWRITE_WEBP_QUALITY, 80]),
                   "webp-lossless": (".webp",
                                     [cv2.IMWRITE_WEBP_QUALITY, 101]),
                   "gif": (".gif", []), "jp2": (".jp2", [])}[kind]
    return cv2.imencode(ext, img, params)[1].tobytes()


def cv2_file(tmp_path, data: bytes):
    """``cv2.imread`` (colour) of ``data`` written to a file, as RGB."""
    p = tmp_path / "case.bin"
    p.write_bytes(data)
    img = cv2.imread(str(p), cv2.IMREAD_COLOR)
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def outcome(tmp_path, data: bytes):
    """None where the port and cv2 agree on ``data``, else what differs."""
    want = cv2_file(tmp_path, data)
    try:
        got = photo.decode(data)
    except (ValueError, NotImplementedError) as err:
        return f"the port raises {err!r}"
    if got is None or want is None:
        return None if got is None and want is None else (
            f"port {'None' if got is None else 'a frame'}, cv2 "
            f"{'None' if want is None else 'a frame'}")
    if got.shape != want.shape or not np.array_equal(got, want):
        return "pixels differ"
    return None


def differing(tmp_path, data: bytes, kind: str, seeds) -> dict:
    """seed -> what differs, over ``photos.damage(data, seed, kind)``."""
    out = {}
    for seed in seeds:
        what = outcome(tmp_path, photos.damage(data, seed, kind))
        if what:
            out[seed] = what
    return out


# ------------------------------------------------------------------- JPEG
_SETS = [(k, hw, d) for k in ("baseline", "restart", "progressive")
         for hw in ((240, 320), (540, 960)) for d in ("cut", "flip")]


@pytest.mark.parametrize("kind,hw,damage", _SETS, ids=[
    f"{k}-{h}x{w}-{d}" for k, (h, w), d in _SETS])
def test_jpeg_sets_equal_cv2(tmp_path, kind, hw, damage):
    """The three sets libjpeg-turbo recovers differently: cuts (its fake
    EOI, zero bits, and for a progressive file the whole-image buffer) and
    single-bit flips (bad codes, lost and misplaced restart markers)."""
    data = jpeg_file(kind, *hw)
    seeds = range(20) if hw == (540, 960) else range(
        100 if damage == "cut" else 200)
    assert not differing(tmp_path, data, damage, seeds)


_MODES = [(k, d) for k in ("422", "444", "gray", "prog422", "prog444",
                           "proggray", "mjpeg", "mjpeg-rst", "mjpeg-prog")
          for d in ("cut", "flips")]


@pytest.mark.parametrize("kind,damage", _MODES,
                         ids=[f"{k}-{d}" for k, d in _MODES])
def test_jpeg_samplings_and_writers_equal_cv2(tmp_path, kind, damage):
    """Other samplings and grey, baseline and progressive, and the numpy
    writers' files (chip_smoke.py's), cut or with three flips."""
    data = jpeg_file(kind, 240, 320)
    assert not differing(tmp_path, data, damage, range(40))


# ------------------------------------------------------------------- TIFF
_TIFFS = [(k, d) for k in ("lzw-cv2", "lzw-pil", "deflate-pil",
                           "packbits-pil", "none-pil", "deflate-pred",
                           "deflate16-be", "packbits-planar")
          for d in ("flip", "cut")]


@pytest.mark.parametrize("kind,damage", _TIFFS,
                         ids=[f"{k}-{d}" for k, d in _TIFFS])
def test_tiff_equal_cv2(tmp_path, kind, damage):
    """A strip libtiff fails (a code past the table, a Deflate stream
    that ends short or fails its check, data that runs out) keeps what it
    wrote and zeros, without the predictor: OpenCV's RGBA reader converts
    it; a strip past the file's end gives no image unless it is a later
    plane's."""
    data = tiff_file(kind)
    assert not differing(tmp_path, data, damage, range(
        80 if damage == "flip" else 30))


# ------------------------------------------------ the formats that agreed
@pytest.mark.parametrize("kind", ["png", "bmp", "ppm", "webp",
                                  "webp-lossless", "gif", "jp2"])
def test_formats_that_agreed_still_agree(tmp_path, kind):
    data = other_file(kind)
    for damage in ("cut", "flip"):
        assert not differing(tmp_path, data, damage, range(20)), damage


# ------------------------------------------------------------ MediaSource
def test_damaged_glob_media_source_equals_jax(tmp_path, no_native,
                                              monkeypatch):
    """Six photos of which one is cut, one flipped and one progressive and
    cut mid-scan: the port keeps every frame, as the JAX package does with
    its native reader and with cv2, and the frames equal cv2's bit for bit
    (the JAX package's native reader is the system's libjpeg-turbo, whose
    block smoothing of a cut progressive file can differ from 3.1's by a
    grey level: that frame is held within 1 of it)."""
    files = [jpeg_file("baseline", 240, 320), jpeg_file("baseline", 240, 320),
             jpeg_file("restart", 240, 320), jpeg_file("progressive",
                                                       240, 320),
             jpeg_file("mjpeg", 240, 320), jpeg_file("mjpeg-prog", 240, 320)]
    files[1] = files[1][:len(files[1]) * 3 // 5]
    files[2] = photos.damage(files[2], 2, "flips")
    prog = files[3]
    files[3] = prog[:prog.index(b"\xff\xda", len(prog) // 2) + 400]
    for i, data in enumerate(files):
        (tmp_path / f"p{i}.jpg").write_bytes(data)
    pattern = str(tmp_path / "p*.jpg")
    got = list(MediaSource(photos_pattern=pattern, threads=3))
    want_cv2 = [cv2_file(tmp_path, d) for d in files]
    assert len(got) == 6 and all(w is not None for w in want_cv2)
    for a, b in zip(got, want_cv2):
        np.testing.assert_array_equal(a, b)
    assert jnative.available()
    with_native = list(JMediaSource(photos_pattern=pattern, threads=3))
    monkeypatch.setattr(jnative, "available", lambda: False)
    with_cv2 = list(JMediaSource(photos_pattern=pattern, threads=3))
    assert len(with_native) == len(with_cv2) == 6
    for i, (a, b, c) in enumerate(zip(got, with_cv2, with_native)):
        np.testing.assert_array_equal(a, b)
        if i == 3:
            assert np.abs(a.astype(int) - c).max() <= 1
        else:
            np.testing.assert_array_equal(a, c)


# -------------------------------------------------------------- fixtures
def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def small_fixtures() -> dict:
    """name -> bytes: cut and flipped 540x960 baseline, restart and
    progressive JPEGs, and flipped LZW and Deflate TIFFs, from fixed
    seeds."""
    out = {}
    for kind in ("baseline", "restart", "progressive"):
        data = jpeg_file(kind, 540, 960)
        out[f"damage_{kind}_cut.jpg"] = photos.damage(data, 3, "cut")
        out[f"damage_{kind}_flips.jpg"] = photos.damage(data, 5, "flips")
    for kind in ("lzw-cv2", "deflate-pil", "deflate-pred"):
        out[f"damage_{kind}_flips.tif"] = photos.damage(tiff_file(kind), 7,
                                                        "flips")
    return out


def headline_damaged() -> dict:
    """The card's damaged run's four files: frames 8, 16, 24 and 31 of the
    headline render (tests/test_torch_jp2.headline_frames) from the numpy
    writer at q95, frame 8 cut at 60 %, frame 16 with three flips, frame
    24 written with a restart interval of 30 MCUs and flipped, frame 31
    progressive and cut mid-scan → name -> bytes."""
    from slam_indoor_code_tpu_torch.testing import make_scene

    sc = make_scene(n_points=1500, n_frames=32, image_size=(1080, 1920),
                    seed=7, baseline=0.25, kind="hallway")
    out = {}
    for i, how in DAMAGED_FRAMES.items():
        frame = sc.render(i)
        if how == "cut60":
            data = mjpeg.encode_jpeg(frame, 95)
            data = data[:len(data) * 3 // 5]
        elif how == "flips":
            data = photos.damage(mjpeg.encode_jpeg(frame, 95), i, "flips")
        elif how == "restart-flips":
            data = photos.damage(mjpeg.encode_jpeg(frame, 95,
                                                   restart_interval=30),
                                 i, "flips")
        else:
            data = mjpeg.encode_progressive_jpeg(frame, 95)
            data = data[:data.index(b"\xff\xda", len(data) // 2) + 5000]
        out[f"frame_{i:02d}.jpg"] = data
    return out


def write_fixtures() -> None:
    table = {}
    for name, data in small_fixtures().items():
        (PHOTO_FIXTURES / name).write_bytes(data)
        img = cv2.imread(str(PHOTO_FIXTURES / name))
        table[name] = None if img is None else {
            "shape": list(img.shape), "sha256": _sha(img[..., ::-1])}
    TABLE.write_text(json.dumps(table, indent=1) + "\n")
    DAMAGED.mkdir(exist_ok=True)
    table = {}
    for name, data in headline_damaged().items():
        (DAMAGED / name).write_bytes(data)
        table[name] = _sha(cv2.imread(str(DAMAGED / name))[..., ::-1])
    (DAMAGED / "cv2_sha256_damaged.json").write_text(
        json.dumps(table, indent=1) + "\n")


def test_small_fixtures_equal_cv2_and_their_recorded_sha256(tmp_path,
                                                             no_native):
    table = json.loads(TABLE.read_text())
    assert sorted(table) == sorted(small_fixtures())
    for name, want in table.items():
        path = PHOTO_FIXTURES / name
        assert path.read_bytes() == small_fixtures()[name], name
        img = cv2.imread(str(path))
        got = list(MediaSource(photos_pattern=str(path)))
        if want is None:
            assert img is None and got == [], name
            continue
        assert _sha(img[..., ::-1]) == want["sha256"], name
        assert len(got) == 1 and _sha(got[0]) == want["sha256"], name


def test_headline_damaged_fixtures_equal_cv2():
    """The four FHD files: 2.5 MB or less in all, each damaged as the
    card's run says, decoded by the port to cv2's recorded sha256."""
    table = json.loads((DAMAGED / "cv2_sha256_damaged.json").read_text())
    paths = sorted(DAMAGED.glob("frame_*.jpg"))
    assert [p.name for p in paths] == sorted(table) == [
        f"frame_{i:02d}.jpg" for i in DAMAGED_FRAMES]
    assert sum(p.stat().st_size for p in paths) <= 2_500_000
    for p in paths:
        data = p.read_bytes()
        assert _sha(cv2.imread(str(p))[..., ::-1]) == table[p.name], p.name
        assert _sha(photo.decode(data)) == table[p.name], p.name
        if p.name in ("frame_08.jpg", "frame_31.jpg"):     # cut
            assert not data.endswith(b"\xff\xd9"), p.name
            assert jpeg.decode(data) is None, p.name    # strict: refused


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    write_fixtures()
