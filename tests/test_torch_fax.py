"""CCITT bilevel TIFF (compressions 2, 3, 4 and 32771) through the port
(io/tiff.py over native/fax3.cpp) against ``cv2.imread`` (libtiff 4.7's
tif_fax3.c) bit for bit, on the CPU:

- every compression Pillow (libtiff) writes — CCITT RLE, Group 3 in 1D,
  in 2D and with EOLs ending on byte boundaries, Group 4, RLEW — in one
  strip and in several, FillOrder 2 among them;
- every mode of the numpy writer (testing/photos.encode_tiff over
  testing/ccitt.py): each compression, FillOrder 1 and 2, MinIsWhite and
  MinIsBlack, strips with a short last one, tiles, rows wider than the
  longest make-up code, blank pages, T4Options' uncompressed-mode bit
  (libtiff decodes such files as any other; the port reads them too);
- damage: flipped strip data (G3 resynchronises at the next EOL, a bad
  code word cuts the row, a line that runs long or short is cut or
  padded), strips whose data ends early (G3 read again without EOLs, as
  libtiff 4.7 does), cut files, and the state libtiff keeps from strip to
  strip (its run arrays, the without-EOL mode);
- the cases cv2 gives no image for (a sample of 8 bits, two samples in
  one plane): none from the port either.

The committed fax fixtures (Pillow's files and damaged ones) carry cv2's
sha256 in ``testing/photo_fixtures/cv2_sha256_fax.json``, which the card
checks; rewrite them with ``PYTHONPATH=. python tests/test_torch_fax.py
--write-fixtures``."""

import hashlib
import io
import json
import pathlib
import struct
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from slam_indoor_code_tpu_torch.io import native, photo, tiff
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import photos

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "slam_indoor_code_tpu_torch" / "testing" / "photo_fixtures")
TABLE = FIXTURES / "cv2_sha256_fax.json"
PIL_MODES = {"rle": "tiff_ccitt", "g3": "group3", "g4": "group4",
             "rlew": "tiff_raw_16"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


def page(kind: str, h: int = 96, w: int = 150, seed: int = 0) -> np.ndarray:
    """A bilevel page [h, w] of 0/1: "noise" (every short run), "blocks"
    (long runs, 2D vertical modes), "text" (rows of small marks, pass
    modes), "blank" or "black"."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return (rng.random((h, w)) < 0.45).astype(np.uint8)
    if kind == "blocks":
        b = (rng.random((-(-h // 8), -(-w // 12))) < 0.5).astype(np.uint8)
        return np.kron(b, np.ones((8, 12), np.uint8))[:h, :w]
    if kind == "text":
        out = np.zeros((h, w), np.uint8)
        for y in range(2, h - 6, 9):
            xs = np.cumsum(rng.integers(3, 11, w // 4))
            for x in xs[xs < w - 4]:
                out[y:y + int(rng.integers(3, 7)),
                    x:x + int(rng.integers(1, 4))] = 1
        return out
    return np.full((h, w), int(kind == "black"), np.uint8)


def cv2_read(tmp_path, data: bytes):
    p = tmp_path / "fax.tif"
    p.write_bytes(data)
    img = cv2.imread(str(p), cv2.IMREAD_COLOR)
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def equal_cv2(tmp_path, data: bytes):
    """The port's image of ``data`` equals cv2's (or both give none)."""
    want = cv2_read(tmp_path, data)
    got = photo.decode(data)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    return want


def pil_fax(bits: np.ndarray, mode: str, **kw) -> bytes:
    """Pillow's (libtiff's) CCITT file of a page (1 black)."""
    b = io.BytesIO()
    Image.fromarray((1 - bits) * 255).convert("1").save(
        b, "TIFF", compression=PIL_MODES[mode], **kw)
    return b.getvalue()


def shown(bits: np.ndarray, photometric: int = 0) -> np.ndarray:
    """The RGB cv2 gives for a page: 0/255 in three channels."""
    white = bits == (1 if photometric == 1 else 0)
    return np.repeat(np.where(white, 255, 0).astype(np.uint8)[..., None],
                     3, axis=2)


# ------------------------------------------------------------ Pillow's
_PIL = [(m, kind, kw) for m in ("rle", "g3", "g4", "rlew")
        for kind in ("noise", "blocks", "text")
        for kw in ({}, {"strip_size": 600})]
_PIL += [("g3", "text", {"tiffinfo": {292: opt}}) for opt in (1, 4, 5)]
_PIL += [(m, "blocks", {"tiffinfo": {266: 2}}) for m in ("g3", "g4", "rle")]


@pytest.mark.parametrize("mode,kind,kw", _PIL, ids=[
    f"{m}-{k}-{'-'.join(f'{a}{b}' for a, b in kw.items()) or 'one'}"
    for m, k, kw in _PIL])
def test_pillow_files_equal_cv2(tmp_path, mode, kind, kw):
    bits = page(kind)
    want = equal_cv2(tmp_path, pil_fax(bits, mode, **kw))
    if mode != "rlew":      # libtiff's RLEW rows start where its reader
        # happens to be: the page comes back only as cv2 reads it
        np.testing.assert_array_equal(want, shown(bits))


# ---------------------------------------------------------- numpy writer
_NP = [(comp, kw) for comp in ("ccitt_rle", "group3", "group4", "rlew")
       for kw in ({}, {"fill_order": 2}, {"photometric": 1},
                  {"rows_per_strip": 20}, {"tile": (64, 32)})]
_NP += [("group3", {"t4_options": opt}) for opt in (1, 2, 3, 4, 5, 7)]
_NP += [("group3", {"t4_options": 5, "fill_order": 2,
                    "rows_per_strip": 33})]


@pytest.mark.parametrize("comp,kw", _NP, ids=[
    f"{c}-{'-'.join(f'{a}{b}' for a, b in kw.items()) or 'plain'}"
    for c, kw in _NP])
def test_writer_modes_equal_cv2(tmp_path, comp, kw):
    """Each mode on noise, text and a blank page: the port equals cv2,
    and both give the page (RLEW: as libtiff's reader reads it)."""
    for kind in ("noise", "text", "blank"):
        bits = page(kind, seed=3)
        want = equal_cv2(tmp_path, photos.encode_tiff(
            bits, compression=comp, **kw))
        if comp != "rlew":
            np.testing.assert_array_equal(
                want, shown(bits, kw.get("photometric", 0)))


@pytest.mark.parametrize("comp", ["ccitt_rle", "group3", "group4"])
def test_runs_past_the_longest_make_up_code(tmp_path, comp):
    """Rows of 6000 pixels: runs of 2560 make-up codes, then the rest."""
    bits = np.zeros((6, 6000), np.uint8)
    bits[1, 100:5900] = 1
    bits[3, 2600:2700] = 1
    bits[4, :] = 1
    want = equal_cv2(tmp_path, photos.encode_tiff(bits, compression=comp,
                                                  t4_options=1))
    np.testing.assert_array_equal(want, shown(bits))


# ------------------------------------------------------------------ damage
def _strip_flips(data: bytes, seed: int, n: int) -> bytes:
    """``n`` bits flipped inside the strips' data."""
    f, _ = tiff._directory(data)
    rng = np.random.default_rng(seed)
    b = bytearray(data)
    for _ in range(n):
        s = int(rng.integers(0, len(f["strip_offsets"])))
        o, c = f["strip_offsets"][s], f["strip_counts"][s]
        b[o + int(rng.integers(0, c))] ^= 1 << int(rng.integers(0, 8))
    return bytes(b)


_DAMAGE = [(src, m) for src in ("pillow", "numpy")
           for m in ("rle", "g3", "g3-2d", "g4", "rlew")]


@pytest.mark.parametrize("src,mode", _DAMAGE,
                         ids=[f"{s}-{m}" for s, m in _DAMAGE])
def test_damaged_strips_equal_cv2(tmp_path, src, mode):
    """Flipped strip data, one bit and three, in one strip and in four,
    and cut files: the port gives cv2's image (or none) every time."""
    bits = page("text", 150, 240, seed=5)
    for rows in (None, 24):
        if src == "pillow":
            kw = {"strip_size": 24 * 30} if rows else {}
            if mode == "g3-2d":
                kw["tiffinfo"] = {292: 1}
            data = pil_fax(bits, mode.split("-")[0], **kw)
        else:
            comp = {"rle": "ccitt_rle", "g3": "group3", "g3-2d": "group3",
                    "g4": "group4", "rlew": "rlew"}[mode]
            data = photos.encode_tiff(bits, compression=comp,
                                      rows_per_strip=rows,
                                      t4_options=int(mode == "g3-2d"))
        for seed in range(80):
            equal_cv2(tmp_path, _strip_flips(data, seed, 1 + 2 * (seed % 2)))
        for seed in range(10):
            equal_cv2(tmp_path, photos.damage(data, seed, "cut"))


def _short_strips(data: bytes, frac: float) -> bytes:
    """``data`` with each StripByteCounts entry cut to ``frac`` of it (the
    strips' data ends early; the bytes stay in the file)."""
    b = bytearray(data)
    at = struct.unpack_from("<I", b, 4)[0]
    for k in range(struct.unpack_from("<H", b, at)[0]):
        tag, ftype, n, v = struct.unpack_from("<HHII", b, at + 2 + 12 * k)
        if tag == 279:
            code, size = ("<H", 2) if ftype == 3 else ("<I", 4)
            where = v if n * size > 4 else at + 2 + 12 * k + 8
            for i in range(n):
                c = struct.unpack_from(code, b, where + i * size)[0]
                struct.pack_into(code, b, where + i * size, int(c * frac))
    return bytes(b)


@pytest.mark.parametrize("comp,t4", [("group3", 0), ("group3", 1),
                                     ("group3", 5), ("group4", 0),
                                     ("ccitt_rle", 0), ("rlew", 0)])
def test_strips_that_end_early_equal_cv2(tmp_path, comp, t4):
    """Each strip's data cut to a fraction: Group 3 strips are read again
    without EOLs from their start, and the file's later strips are read
    in that mode too, as libtiff 4.7 reads them."""
    bits = page("blocks", seed=2)
    data = photos.encode_tiff(bits, compression=comp, rows_per_strip=32,
                              t4_options=t4)
    for frac in (0.05, 0.3, 0.5, 0.8, 0.97):
        equal_cv2(tmp_path, _short_strips(data, frac))


@pytest.mark.parametrize("comp,pred", [("none", 1), ("none", 2),
                                       ("deflate", 2), ("packbits", 1)])
def test_fill_order_2_reverses_the_byte_codecs(tmp_path, comp, pred):
    """FillOrder 2 on an 8-bit RGB file: libtiff reverses each strip's
    bits before its codec reads them (a Deflate stream then fails and its
    strips stay zero), and the port does too."""
    rgb = np.random.default_rng(4).integers(0, 256, (40, 60, 3), np.uint8)
    data = photos.encode_tiff(rgb, compression=comp, predictor=pred,
                              rows_per_strip=7,
                              extra_tags=((266, 3, [2]),))
    assert equal_cv2(tmp_path, data) is not None


def test_what_cv2_reads_as_no_image(tmp_path):
    """A CCITT strip of 8-bit samples, and two samples in one plane:
    libtiff's Fax3SetupState refuses them, and cv2 gives no image."""
    bits = page("noise")
    data = photos.encode_tiff(bits, compression="group4")
    eight = data.replace(struct.pack("<HHII", 258, 3, 1, 1),
                         struct.pack("<HHII", 258, 3, 1, 8))
    assert eight != data
    two = photos.encode_tiff(np.stack([bits, bits], -1),
                             compression="group4")
    for d in (eight, two):
        assert cv2_read(tmp_path, d) is None
        assert photo.decode(d) is None


# ---------------------------------------------------------------- fixtures
def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def fixture_files() -> dict:
    """name -> bytes: Pillow's G3 (1D and 2D), G4, RLE and RLEW files of a
    text page, and damaged ones (flipped strips, strips that end early)."""
    bits = page("text", 120, 200, seed=9)
    out = {"fax_pil_g3.tif": pil_fax(bits, "g3"),
           "fax_pil_g3_2d.tif": pil_fax(bits, "g3", tiffinfo={292: 5}),
           "fax_pil_g4.tif": pil_fax(bits, "g4", strip_size=25 * 30),
           "fax_pil_rle.tif": pil_fax(bits, "rle"),
           "fax_pil_rlew.tif": pil_fax(bits, "rlew")}
    out["fax_g3_flips.tif"] = _strip_flips(out["fax_pil_g3.tif"], 1, 3)
    out["fax_g4_flips.tif"] = _strip_flips(out["fax_pil_g4.tif"], 2, 3)
    out["fax_g3_2d_short.tif"] = _short_strips(photos.encode_tiff(
        bits, compression="group3", t4_options=1, rows_per_strip=40), 0.6)
    return out


def write_fixtures() -> None:
    table = {}
    for name, data in fixture_files().items():
        (FIXTURES / name).write_bytes(data)
        img = cv2.imread(str(FIXTURES / name))
        table[name] = None if img is None else {
            "shape": list(img.shape), "sha256": _sha(img[..., ::-1])}
    TABLE.write_text(json.dumps(table, indent=1) + "\n")


def test_fixtures_equal_cv2_and_their_recorded_sha256(monkeypatch):
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", "g++: jpeglib.h: No such file")
    table = json.loads(TABLE.read_text())
    files = fixture_files()
    assert sorted(table) == sorted(files)
    for name, want in table.items():
        path = FIXTURES / name
        assert path.read_bytes() == files[name], name
        got = list(MediaSource(photos_pattern=str(path)))
        img = cv2.imread(str(path))
        if want is None:
            assert img is None and got == [], name
            continue
        assert _sha(img[..., ::-1]) == want["sha256"], name
        assert len(got) == 1 and _sha(got[0]) == want["sha256"], name


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    write_fixtures()
