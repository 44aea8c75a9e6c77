"""The port's photo readers (io/photo.py and the readers it dispatches to:
io/png.py over native/png.cpp, io/pnm.py, io/bmp.py, io/tiff.py over
native/tiff.cpp, io/webp.py over native/vp8.cpp, io/exif.py) against
``cv2.imread`` bit for bit on the CPU, with the native libjpeg/libpng
reader off, as on the card: PNG at every bit depth and colour type, with
tRNS and Adam7; PBM/PGM/PPM/PAM binary and ASCII; BMP core/INFO/V5
headers, palettes, RLE4/RLE8 escapes, 555/565, 32-bit and top-down rows;
TIFF strips and tiles, chunky and planar, II/MM, BigTIFF, none/LZW/
Deflate/PackBits with the predictor, gray/MinIsWhite/RGB/palette at 1-16
bits, alpha, the Orientation tag; lossy WebP at several qualities, with
alpha and EXIF; EXIF orientation 1-8 in both byte orders on JPEG, PNG and
WebP; the formats still refused, by name; the numpy writers of
testing/photos.py; the committed fixtures in testing/photo_fixtures/
(their cv2 sha256, which the card checks; rewrite them with
``PYTHONPATH=. python tests/test_torch_photos.py --write-fixtures``); the
photo MediaSource against the JAX package's with both native readers off;
slam_main on a mixed-format glob against the JAX package's; and an FHD
all-Paeth PNG's decode time against cv2's."""

import hashlib
import io
import json
import pathlib
import struct
import sys
import time
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from slam_indoor_code_tpu import app as japp
from slam_indoor_code_tpu import config as jconfig
from slam_indoor_code_tpu.io import native as jnative
from slam_indoor_code_tpu.io.media import MediaSource as JMediaSource
from slam_indoor_code_tpu.testing import make_scene
from slam_indoor_code_tpu_torch import app as tapp
from slam_indoor_code_tpu_torch import config as tconfig
from slam_indoor_code_tpu_torch.io import exif, native, photo, png
from slam_indoor_code_tpu_torch.io.media import MediaSource
from slam_indoor_code_tpu_torch.testing import mjpeg, photos

torch.set_num_threads(1)

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "slam_indoor_code_tpu_torch" / "testing" / "photo_fixtures")
SIZES = ((37, 53), (540, 960))


def cv2_read(tmp_path, data: bytes, name: str = "x.bin"):
    """``cv2.imread`` (colour) of ``data`` written to a file, as RGB."""
    p = tmp_path / name
    p.write_bytes(data)
    img = cv2.imread(str(p))
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def same_as_cv2(tmp_path, data: bytes, name: str = "x.bin"):
    want = cv2_read(tmp_path, data, name)
    got = photo.decode(data)
    assert (got is None) == (want is None), (got is None, want is None)
    if want is not None:
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    return got


def scene_image(h, w, seed=7):
    img = make_scene(n_points=300, n_frames=1, seed=seed,
                     baseline=0.3).render(0)
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


@pytest.fixture(scope="module")
def images():
    return {hw: scene_image(*hw) for hw in SIZES}


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' native libjpeg/libpng readers off, as on the card."""
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", "g++: jpeglib.h: No such file")
    monkeypatch.setattr(jnative, "available", lambda: False)


def pil_bytes(im, fmt, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


# ------------------------------------------------------------------ PNG
_PNG_MODES = ("RGB", "RGBA", "L", "LA", "P", "P-trns", "1", "P2", "P4",
              "I;16")


def _pil_png(rgb, mode, interlace):
    im = Image.fromarray(rgb)
    kw = {"interlace": interlace}
    if mode == "P-trns":
        im, kw["transparency"] = im.quantize(40), 3
    elif mode in ("P", "P2", "P4"):
        colours = {"P": 200, "P2": 4, "P4": 16}[mode]
        im = im.quantize(colours)
        if mode != "P":
            kw["bits"] = int(mode[1])
    elif mode == "I;16":
        g = rgb[..., 0].astype(np.uint16) * 257 + rgb[..., 1]
        im = Image.fromarray(g)
    else:
        im = im.convert(mode)
    return pil_bytes(im, "PNG", **kw)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("mode", _PNG_MODES)
def test_png_written_by_pillow_equals_cv2(tmp_path, images, hw, interlace,
                                          mode):
    """Pillow's PNG writer: RGB, RGBA, gray, gray+alpha, palette (8, 4 and
    2-bit, and with a tRNS chunk), bilevel and 16-bit gray, plain and
    Adam7."""
    same_as_cv2(tmp_path, _pil_png(images[hw], mode, interlace))


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", ["rgb16", "gray16", "rgba16", "rgba8",
                                  "bilevel"])
def test_png_written_by_cv2_equals_cv2(tmp_path, images, hw, kind):
    """cv2's 16-bit RGB, gray and RGBA PNG (each sample's high byte, not
    rounded: 383 and 384 both give 1, 386 gives 1, 65535 gives 255), 8-bit
    RGBA and bilevel (1-bit) PNG."""
    rgb = images[hw]
    rng = np.random.default_rng(hw[0])
    if kind.endswith("16"):
        img = rgb.astype(np.uint16) * 257 + rng.integers(0, 257, rgb.shape)
        img = img.astype(np.uint16)
        img[0, :6, 0] = [255, 383, 384, 386, 65280, 65535]
        img = {"rgb16": img, "gray16": img[..., 0],
               "rgba16": np.dstack([img, img[..., :1]])}[kind]
        want_row = (img[0, :6, 0] if img.ndim == 3 else img[0, :6]) >> 8
    elif kind == "rgba8":
        img, want_row = np.dstack([rgb, rgb[..., :1]]), None
    else:
        img, want_row = (rgb[..., 1] > 100).astype(np.uint8) * 255, None
    params = [cv2.IMWRITE_PNG_BILEVEL, 1] if kind == "bilevel" else []
    ok, buf = cv2.imencode(".png", img, params)
    got = same_as_cv2(tmp_path, buf.tobytes())
    if want_row is not None:
        chan = 2 if img.ndim == 3 else 0          # cv2 wrote BGR(A)
        np.testing.assert_array_equal(got[0, :6, chan], want_row)


def _png_rows(raw_rows, w, h, depth, ctype, kinds, bpp, plte=b"",
              interlace=0):
    """A PNG of unfiltered scanlines ``raw_rows`` [h, stride] with row
    filters ``kinds`` cycled (testing/photos.paeth_filter's rules)."""
    out = []
    prior = np.zeros(raw_rows.shape[1], np.uint8)
    for y in range(len(raw_rows)):             # h rows, or fewer (cut)
        k = kinds[y % len(kinds)]
        r = raw_rows[y].astype(np.int16)
        p = prior.astype(np.int16)
        a = np.concatenate([np.zeros(bpp, np.int16), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int16), p[:-bpp]])
        if k == 4:
            f = photos.paeth_filter(np.stack([prior, raw_rows[y]]), bpp)[1]
        else:
            pred = (np.zeros_like(r), a, p, (a + p) // 2)[k]
            f = ((r - pred) % 256).astype(np.uint8)
        out.append(bytes([k]) + f.tobytes())
        prior = raw_rows[y]
    extra = photos._png_chunk(b"PLTE", plte) if plte else b""
    return (png.SIGNATURE
            + photos._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                     ctype, 0, 0, interlace))
            + extra + photos._png_chunk(b"IDAT", zlib.compress(b"".join(out)))
            + photos._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (8, 0),
                                         (16, 0), (8, 2), (16, 2), (1, 3),
                                         (2, 3), (4, 3), (8, 3), (8, 4),
                                         (16, 4), (8, 6), (16, 6)])
def test_png_every_depth_and_colour_type_with_every_filter(tmp_path, depth,
                                                           ctype):
    """Hand-filtered PNGs of every legal depth and colour type, the rows
    cycling through None, Sub, Up, Average and Paeth, a palette with fewer
    entries than the indices reach (black past its end, as libpng)."""
    rng = np.random.default_rng(depth * 10 + ctype)
    h, w = 19, 23
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    bpp = max(1, ch * depth // 8)
    plte = rng.integers(0, 256, 3 * min(200, 1 << depth), np.uint8).tobytes() \
        if ctype == 3 else b""
    data = _png_rows(raw, w, h, depth, ctype, [0, 1, 2, 3, 4], bpp, plte)
    same_as_cv2(tmp_path, data)


def test_png_damage_is_skipped_as_cv2_skips_it(tmp_path, images):
    """A bad IDAT CRC, image data cut short and a bad filter byte give
    None, as libpng refuses each; a bad CRC on an ancillary chunk is
    ignored."""
    good = _pil_png(images[SIZES[0]], "RGB", 0)
    i = good.index(b"IDAT")
    bad_crc = good[:i + 8] + bytes([good[i + 8] ^ 1]) + good[i + 9:]
    assert cv2_read(tmp_path, bad_crc) is None
    assert photo.decode(bad_crc) is None
    rows = np.zeros((4, 9), np.uint8)
    cut = _png_rows(rows, 3, 5, 8, 2, [0], 3)        # 4 rows of 5 given
    assert cv2_read(tmp_path, cut) is None and photo.decode(cut) is None
    text = photos._png_chunk(b"tEXt", b"a\0b")[:-1] + b"\0"
    j = good.index(b"IDAT") - 4
    same_as_cv2(tmp_path, good[:j] + text + good[j:])


# --------------------------------------------------------------- Netpbm
@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("ext,kind", [(".ppm", "rgb"), (".pgm", "gray"),
                                      (".pbm", "bits"), (".ppm", "rgb16"),
                                      (".pgm", "gray16"), (".pam", "rgb"),
                                      (".pam", "gray")])
@pytest.mark.parametrize("binary", [1, 0])
def test_pxm_written_by_cv2_equals_cv2(tmp_path, images, hw, ext, kind,
                                       binary):
    """cv2's binary and ASCII PPM, PGM and PBM writers at 8 and 16 bits,
    and its PAM writer (whose RGB cv2 reads back with red and blue
    traded, and so does the port)."""
    rgb = images[hw]
    img = {"rgb": rgb[..., ::-1], "gray": rgb[..., 0], "bits": rgb[..., 0],
           "rgb16": rgb[..., ::-1].astype(np.uint16) * 257 + 3,
           "gray16": rgb[..., 0].astype(np.uint16) * 300}[kind]
    ok, buf = cv2.imencode(ext, img, [cv2.IMWRITE_PXM_BINARY, binary])
    if not ok:
        pytest.skip("cv2 writes no such file")   # PAM has no ASCII form
    same_as_cv2(tmp_path, buf.tobytes())


_PNM_CASES = {
    "p6_maxval100": b"P6\n2 1\n100\n" + bytes([10, 50, 100, 200, 255, 0]),
    "p3_maxval100": b"P3\n2 1\n100\n10 50 100 200 255 0\n",
    "p2_comments": b"P2 # a comment\n3 1\n# another\n100\n10 50 100\n",
    "p2_16bit": b"P2\n3 1\n65535\n300 40000 70000\n",
    "p3_16bit_maxval1000": b"P3\n1 1\n1000\n300 999 1000\n",
    "p1_packed_digits": b"P1\n4 2\n0101\n1 1 0 0",
    "p4": b"P4\n10 2\n" + bytes([0b10110000, 0b11000000, 255, 0]),
    "p5_comment_in_size": b"P5\n#c\n2 1 # c\n255\n" + bytes([7, 9]),
    "p5_cr": b"P5\r2 1\r255\r" + bytes([7, 9]),
    "p5_16bit": b"P5\n2 1\n1000\n" + bytes([1, 2, 3, 255]),
    "p6_extra_bytes": b"P6\n1 1\n255\n" + bytes([1, 2, 3, 4, 5]),
    "p6_cut": b"P6\n2 2\n255\n" + bytes(7),
    "p3_last_number_at_eof": b"P3\n1 1\n255\n3 2 3",
    "p2_cut": b"P2\n3 1\n255\n1 2",
    "p5_bad_byte": b"P5\nx 1\n255\n" + bytes(3),
    "pam_rgb": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB"
                b"\nENDHDR\n" + bytes(range(18))),
    "pam_rgb_no_type": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\n"
                        b"ENDHDR\n" + bytes(range(18))),
    "pam_gray16": (b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 65535\nTUPLTYPE"
                   b" GRAYSCALE\nENDHDR\n" + bytes([1, 2, 255, 0])),
    "pam_bilevel": (b"P7\nWIDTH 10\nHEIGHT 2\nDEPTH 1\nMAXVAL 1\nTUPLTYPE "
                    b"BLACKANDWHITE\nENDHDR\n" + bytes([1, 1, 0, 0, 0, 0, 0,
                                                       0, 0, 1] + [1] * 10)),
    "pam_depth2_no_type": (b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 2\nMAXVAL 255\n"
                           b"ENDHDR\n" + bytes(2)),
}


@pytest.mark.parametrize("case", sorted(_PNM_CASES))
def test_pnm_forms_equal_cv2(tmp_path, case):
    """Hand-written Netpbm files: binary samples kept as stored at maxval
    100, ASCII ones scaled by it; 16-bit high bytes; comments; P1's run-
    together digits; the bytes OpenCV reads past the last number; cut and
    malformed files (None); PAM's RGB (red and blue traded, as cv2 reads
    it), 16-bit gray, maxval-1 bit quirk, and a depth without a type."""
    same_as_cv2(tmp_path, _PNM_CASES[case])


@pytest.mark.parametrize("tupl,depth", [("GRAYSCALE_ALPHA", 2),
                                        ("RGB_ALPHA", 4)])
def test_pam_with_alpha_gives_its_samples_alpha_dropped(tupl, depth):
    """PAM with alpha: OpenCV 5.0 converts only part of each row and
    leaves the rest of its buffer unwritten, so the port is held to the
    file's own samples (gray repeated, or RGB), alpha dropped."""
    rng = np.random.default_rng(depth)
    s = rng.integers(0, 256, (3, 7, depth), np.uint8)
    data = (f"P7\nWIDTH 7\nHEIGHT 3\nDEPTH {depth}\nMAXVAL 255\nTUPLTYPE "
            f"{tupl}\nENDHDR\n").encode() + s.tobytes()
    want = np.repeat(s[..., :1], 3, 2) if depth == 2 else s[..., :3]
    np.testing.assert_array_equal(photo.decode(data), want)


# ------------------------------------------------------------------ BMP
def _bmp(w, h, bpp, pixels: bytes, *, comp=0, palette=None, masks=None,
         header=40, clrused=0):
    """A BMP of ``pixels`` (rows as stored) with a ``header``-byte info
    header (12: core, 40: INFO, 124: V5), BGRA (or core BGR) ``palette``
    rows and BITFIELDS ``masks`` after the header."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
        pal = b"" if palette is None else palette[:, :3].tobytes()
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bpp, comp,
                           len(pixels), 2835, 2835, clrused, 0)
        info += bytes(header - 40)
        pal = b"" if palette is None else palette.tobytes()
    extra = b"" if masks is None else struct.pack("<III", *masks)
    off = 14 + len(info) + len(pal) + len(extra)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + pal + extra + pixels)


def _rows(idx_rows, bpp):
    """Pack palette indices [h, w] at ``bpp`` bits into rows padded to 4
    bytes."""
    h, w = idx_rows.shape
    if bpp < 8:
        bits = np.unpackbits(idx_rows[..., None], axis=2)[..., 8 - bpp:]
        packed = np.packbits(bits.reshape(h, -1), axis=1)
    else:
        packed = idx_rows
    pitch = (packed.shape[1] + 3) & ~3
    out = np.zeros((h, pitch), np.uint8)
    out[:, :packed.shape[1]] = packed
    return out.tobytes()


def _rle8(idx, delta_at=None, eob_row=None):
    """RLE8 of palette indices [h, w] (rows as stored): runs of equal
    indices as encoded runs, the rest as absolute runs (word aligned),
    EOL at each row's end, a delta escape at ``delta_at`` = (row, col,
    dx, dy) and an early EOB after row ``eob_row``."""
    out = bytearray()
    h, w = idx.shape
    y = 0
    while y < h:
        x, row = 0, idx[y]
        while x < w:
            if delta_at is not None and (y, x) == delta_at[:2]:
                out += bytes([0, 2, delta_at[2], delta_at[3]])
                x += delta_at[2]
                y += delta_at[3]
                row = idx[y]
                continue
            run = 1
            while x + run < w and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 2 or w - x < 3:
                out += bytes([run, row[x]])
                x += run
            else:
                n = min(w - x, 5 + (x % 7))
                out += bytes([0, n]) + bytes(row[x:x + n])
                out += b"\0" * (n & 1)
                x += n
        if eob_row is not None and y == eob_row:
            break
        out += b"\0\0"
        y += 1
    return bytes(out) + b"\0\1"


def _rle4(idx):
    """RLE4 of 4-bit indices [h, w]: encoded runs of an alternating pair,
    absolute runs of nibbles (word aligned), EOL and EOB."""
    out = bytearray()
    h, w = idx.shape
    for y in range(h):
        x, row = 0, idx[y]
        while x < w:
            if x % 3 == 0:
                n = min(w - x, 6)
                second = row[x + 1] if n > 1 else 0
                out += bytes([n, (row[x] << 4) | second])
                x += n
            else:
                n = min(w - x, 5)
                nib = list(row[x:x + n]) + [0]
                packed = bytes((nib[i] << 4) | nib[i + 1]
                               for i in range(0, n, 2))
                if n < 3:
                    out += bytes([n, (nib[0] << 4) | nib[1 % n]])
                    x += n
                    continue
                out += bytes([0, n]) + packed
                out += b"\0" * (len(packed) & 1)
                x += n
        out += b"\0\0"
    return bytes(out) + b"\0\1"


def _bmp_cases():
    rng = np.random.default_rng(11)
    h, w = 13, 21
    pal = rng.integers(0, 256, (256, 4), np.uint8)
    idx8 = rng.integers(0, 40, (h, w), np.uint8)
    idx8[2:5] = 7                                   # runs for RLE
    idx4 = rng.integers(0, 16, (h, w), np.uint8)
    idx1 = rng.integers(0, 2, (h, w), np.uint8)
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    t16 = rng.integers(0, 65536, (h, w), np.uint16)
    row16 = np.zeros((h, (2 * w + 3) & ~3), np.uint8)
    row16[:, :2 * w] = t16.view(np.uint8).reshape(h, 2 * w)
    row24 = np.zeros((h, (3 * w + 3) & ~3), np.uint8)
    row24[:, :3 * w] = rgb.reshape(h, -1)
    rgba = rng.integers(0, 256, (h, w, 4), np.uint8).tobytes()
    return {
        "pal1": _bmp(w, h, 1, _rows(idx1, 1), palette=pal[:2]),
        "pal4": _bmp(w, h, 4, _rows(idx4, 4), palette=pal[:16]),
        "pal8": _bmp(w, h, 8, _rows(idx8, 8), palette=pal[:40], clrused=40),
        "pal8_short_palette": _bmp(w, h, 8, _rows(idx8, 8), palette=pal[:20],
                                   clrused=20),
        "pal8_top_down": _bmp(w, -h, 8, _rows(idx8, 8), palette=pal),
        "core1": _bmp(w, h, 1, _rows(idx1, 1), palette=pal[:2], header=12),
        "core4": _bmp(w, h, 4, _rows(idx4, 4), palette=pal[:16], header=12),
        "core8": _bmp(w, h, 8, _rows(idx8, 8), palette=pal, header=12),
        "core24": _bmp(w, h, 24, row24.tobytes(), header=12),
        "v4_pal8": _bmp(w, h, 8, _rows(idx8, 8), palette=pal, header=108),
        "v4_565": _bmp(w, h, 16, row16.tobytes(), comp=3, header=108,
                       masks=(0xF800, 0x7E0, 0x1F)),
        "v5_pal8": _bmp(w, h, 8, _rows(idx8, 8), palette=pal, header=124),
        "v5_24": _bmp(w, h, 24, row24.tobytes(), header=124),
        "rle8": _bmp(w, h, 8, _rle8(idx8), comp=1, palette=pal[:40],
                     clrused=40),
        "rle8_delta": _bmp(w, h, 8, _rle8(idx8, delta_at=(3, 4, 5, 2)),
                           comp=1, palette=pal[:40], clrused=40),
        "rle8_early_eob": _bmp(w, h, 8, _rle8(idx8, eob_row=6), comp=1,
                               palette=pal[:40], clrused=40),
        "rle8_top_down": _bmp(w, -h, 8, _rle8(idx8), comp=1, palette=pal),
        "rle4": _bmp(w, h, 4, _rle4(idx4), comp=2, palette=pal[:16]),
        "rle8_cut": _bmp(w, h, 8, _rle8(idx8)[:40], comp=1, palette=pal),
        "555": _bmp(w, h, 16, row16.tobytes()),
        "555_bitfields": _bmp(w, h, 16, row16.tobytes(), comp=3,
                              masks=(0x7C00, 0x3E0, 0x1F)),
        "565": _bmp(w, h, 16, row16.tobytes(), comp=3,
                    masks=(0xF800, 0x7E0, 0x1F)),
        "16_other_masks": _bmp(w, h, 16, row16.tobytes(), comp=3,
                               masks=(0xF00, 0xF0, 0xF)),
        "24_top_down": _bmp(w, -h, 24, row24.tobytes()),
        "32": _bmp(w, h, 32, rgba),
        "32_bitfields": _bmp(w, h, 32, rgba, comp=3,
                             masks=(0xFF0000, 0xFF00, 0xFF)),
        "24_cut": _bmp(w, h, 24, row24.tobytes()[:-50]),
        "jpeg_compression": _bmp(w, h, 24, row24.tobytes(), comp=4),
    }


_BMP = _bmp_cases()


@pytest.mark.parametrize("case", sorted(_BMP))
def test_bmp_variants_equal_cv2(tmp_path, case):
    """Hand-written BMPs: 1/4/8-bit palettes (short ones too), core
    headers (3-byte palette entries), V4 and V5 headers, RLE8 with encoded,
    absolute, delta, EOL and early EOB codes (the pixels passed over take
    entry 0), RLE4, 555 and 565, 32-bit with and without BITFIELDS,
    top-down rows; cut files and refused masks or compressions give
    None."""
    same_as_cv2(tmp_path, _BMP[case])


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("mode", ["RGB", "L", "P", "P16", "1", "RGBA"])
def test_bmp_written_by_pillow_equals_cv2(tmp_path, images, hw, mode):
    """Pillow's BMP writer (24-bit, 8-bit gray palette, 8-bit palette,
    4-bit palette, 1-bit, 32-bit), and cv2's own at the same sizes."""
    im = Image.fromarray(images[hw])
    if mode in ("P", "P16"):
        im = im.quantize(16 if mode == "P16" else 200)
    else:
        im = im.convert(mode)
    same_as_cv2(tmp_path, pil_bytes(im, "BMP"))
    ok, buf = cv2.imencode(".bmp", images[hw][..., ::-1])
    same_as_cv2(tmp_path, buf.tobytes())


# ----------------------------------------------------------------- TIFF
@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("kind", ["rgb", "rgb16", "gray"])
def test_tiff_written_by_cv2_equals_cv2(tmp_path, images, hw, compression,
                                        predictor, kind):
    """cv2's TIFF writer: none, LZW, Deflate (8 and 32946) and PackBits,
    with and without the predictor, 5 rows per strip, 8 and 16-bit RGB
    (libtiff scales 16-bit RGB by (v + 128) // 257) and gray (the high
    byte)."""
    rgb = images[hw]
    img = {"rgb": rgb[..., ::-1], "gray": rgb[..., 1],
           "rgb16": rgb[..., ::-1].astype(np.uint16) * 257
           + np.arange(rgb.shape[1], dtype=np.uint16)[None, :, None] % 257
           }[kind]
    ok, buf = cv2.imencode(".tiff", img, [
        cv2.IMWRITE_TIFF_COMPRESSION, compression,
        cv2.IMWRITE_TIFF_PREDICTOR, predictor,
        cv2.IMWRITE_TIFF_ROWSPERSTRIP, 5])
    same_as_cv2(tmp_path, buf.tobytes())


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1",
                                  "I;16"])
@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits",
                                         "tiff_adobe_deflate"])
def test_tiff_written_by_pillow_equals_cv2(tmp_path, images, mode,
                                           compression):
    """Pillow's TIFF writer: RGB, RGBA (unassociated alpha: libtiff
    premultiplies), gray+alpha, palette (a 16-bit colour map), bilevel
    MinIsWhite and 16-bit gray."""
    rgb = images[SIZES[0]]
    im = Image.fromarray(rgb)
    if mode == "P":
        im = im.quantize(60)
    elif mode == "I;16":
        im = Image.fromarray(rgb[..., 0].astype(np.uint16) * 250)
    else:
        im = im.convert(mode)
    same_as_cv2(tmp_path, pil_bytes(im, "TIFF", compression=compression))


_TIFF_LAYOUTS = [dict(compression=c, predictor=p, tile=t, planar=pl,
                      big_endian=be, bigtiff=bt, rows_per_strip=7)
                 for c, p in (("none", 1), ("deflate", 1), ("deflate", 2),
                              ("packbits", 1), ("packbits", 2))
                 for t in (None, (16, 32))
                 for pl in (False, True)
                 for be, bt in ((False, False), (True, True))]


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("layout", _TIFF_LAYOUTS,
                         ids=lambda d: "-".join(f"{k}={v}" for k, v in
                                                d.items()))
def test_tiff_layouts_from_the_numpy_writer_equal_cv2(tmp_path, layout,
                                                      bits):
    """testing/photos.encode_tiff: strips and tiles (cut at the image's
    edge), chunky and planar, II and MM, classic and BigTIFF, none,
    Deflate and PackBits, with the predictor (which libtiff applies only
    after LZW and Deflate)."""
    rng = np.random.default_rng(bits)
    s = rng.integers(0, 256 if bits == 8 else 65536, (37, 53, 3))
    s = s.astype(np.uint8 if bits == 8 else np.uint16)
    same_as_cv2(tmp_path, photos.encode_tiff(s, **layout))


_TIFF_SAMPLES = {
    "gray8_miniswhite": dict(photometric=0),
    "gray16_miniswhite": dict(photometric=0, bits=16),
    "gray16": dict(photometric=1, bits=16),
    "rgba_unspecified": dict(extra_samples=(0,), spp=4),
    "rgba_associated": dict(extra_samples=(1,), spp=4),
    "rgba_unassociated": dict(extra_samples=(2,), spp=4),
    "rgba16_unassociated": dict(extra_samples=(2,), spp=4, bits=16),
    "gray_alpha": dict(photometric=1, extra_samples=(2,), spp=2),
    "palette_16bit_map": dict(photometric=3, cmap=65536),
    "palette_8bit_map": dict(photometric=3, cmap=256),
}


@pytest.mark.parametrize("case", sorted(_TIFF_SAMPLES))
def test_tiff_photometric_and_alpha_equal_cv2(tmp_path, case):
    """MinIsWhite at 8 and 16 bits, 16-bit gray, RGBA with unspecified,
    associated and unassociated alpha (premultiplied, also at 16 bits),
    gray+alpha, and palettes whose colour map is 16-bit or fits in 8."""
    spec = dict(_TIFF_SAMPLES[case])
    rng = np.random.default_rng(len(case))
    bits, spp = spec.pop("bits", 8), spec.pop("spp", 1)
    cmap = spec.pop("cmap", None)
    s = rng.integers(0, 1 << bits, (29, 41, spp))
    s = s.astype(np.uint16 if bits == 16 else np.uint8)
    if cmap is not None:
        spec["colormap"] = rng.integers(0, cmap, (3, 256))
    if spp == 1 and spec.get("photometric", 2) == 2:
        spec["photometric"] = 1
    same_as_cv2(tmp_path, photos.encode_tiff(s, **spec))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("tile", [None, (16, 16)])
def test_tiff_orientation_tag_equals_cv2_imread(tmp_path, orientation,
                                                tile):
    """The Orientation tag through ``cv2.imread`` (a file: its imdecode of
    bytes behaves otherwise): 2 and 3 mirror each tile within itself, 4
    and 3 flip the image; 5-8 give no image."""
    rng = np.random.default_rng(orientation)
    s = rng.integers(0, 256, (37, 40, 3), np.uint8)
    got = same_as_cv2(tmp_path, photos.encode_tiff(
        s, orientation=orientation, tile=tile), "x.tif")
    assert (got is None) == (orientation >= 5)


def test_tiff_first_page_of_a_multipage_file(tmp_path, images):
    frames = [Image.fromarray(images[SIZES[0]]),
              Image.fromarray(images[SIZES[0]][::-1].copy())]
    data = pil_bytes(frames[0], "TIFF", save_all=True,
                     append_images=frames[1:], compression="tiff_lzw")
    got = same_as_cv2(tmp_path, data)
    np.testing.assert_array_equal(got, images[SIZES[0]])


# ----------------------------------------------------------------- WebP
@pytest.mark.parametrize("hw", SIZES + ((1, 1), (2, 3), (17, 16), (19, 1)))
@pytest.mark.parametrize("quality", [5, 50, 90, 100])
def test_lossy_webp_equals_cv2(tmp_path, images, hw, quality):
    """cv2's lossy WebP writer at four qualities, odd and even sizes down
    to one pixel: the VP8 key frame by native/vp8.cpp, then libwebp's
    fancy upsampler and YUV->RGB, bit for bit."""
    img = images[hw] if hw in images else np.random.default_rng(
        hw[0] * 31 + hw[1]).integers(0, 256, hw + (3,), np.uint8)
    ok, buf = cv2.imencode(".webp", img[..., ::-1],
                           [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert buf[12:16].tobytes() == b"VP8 "
    same_as_cv2(tmp_path, buf.tobytes())


@pytest.mark.parametrize("kind", ["alpha", "exif", "alpha_exif"])
def test_extended_webp_equals_cv2(tmp_path, images, kind):
    """Pillow's WebP with an ALPH chunk (alpha dropped) and an EXIF chunk
    (orientation 6: cv2 turns the photo)."""
    rgb = images[SIZES[0]]
    im = Image.fromarray(np.dstack([rgb, rgb[..., :1]]) if "alpha" in kind
                         else rgb)
    kw = {"quality": 80}
    if "exif" in kind:
        ex = Image.Exif()
        ex[0x0112] = 6
        kw["exif"] = ex.tobytes()
    data = pil_bytes(im, "WEBP", **kw)
    assert data[12:16] == b"VP8X"
    got = same_as_cv2(tmp_path, data)
    assert got.shape[:2] == (rgb.shape[:2][::-1] if "exif" in kind
                             else rgb.shape[:2])


# ----------------------------------------------------------------- EXIF
@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("orientation", range(0, 10))
@pytest.mark.parametrize("where", ["first", "after_app0"])
def test_jpeg_exif_orientation_equals_cv2(tmp_path, images, orientation,
                                          big_endian, where):
    """An EXIF APP1 with Orientation 0-9 (0 and 9: as stored) in either
    byte order, before or after the JFIF APP0: cv2's shape and pixels."""
    ok, buf = cv2.imencode(".jpg", images[SIZES[0]][..., ::-1])
    data = buf.tobytes()
    if where == "first":
        data = photos.insert_exif(data, orientation, big_endian)
    else:
        n = 4 + int.from_bytes(data[4:6], "big")
        data = data[:n] + photos.insert_exif(data[n - 2:], orientation,
                                             big_endian)[2:]
    got = same_as_cv2(tmp_path, data)
    want = exif.apply(photo.decode(buf.tobytes()),
                      orientation if 1 <= orientation <= 8 else 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_and_webp_exif_orientation_equals_cv2(tmp_path, images,
                                                  orientation, big_endian):
    """A PNG ``eXIf`` chunk and a WebP ``EXIF`` chunk (the TIFF-structured
    block itself) with each orientation in each byte order."""
    rgb = images[SIZES[0]]
    block = photos.exif_block(orientation, big_endian)
    base = photos.encode_png_paeth(rgb)
    i = base.index(b"IDAT") - 4
    same_as_cv2(tmp_path, base[:i] + photos._png_chunk(b"eXIf", block)
                + base[i:])
    ok, buf = cv2.imencode(".webp", rgb[..., ::-1],
                           [cv2.IMWRITE_WEBP_QUALITY, 70])
    vp8 = buf.tobytes()[12:]
    w, h = rgb.shape[1], rgb.shape[0]
    vp8x = b"VP8X" + struct.pack("<I", 10) + bytes([0x08, 0, 0, 0]) + (
        w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    body = b"WEBP" + vp8x + vp8 + b"EXIF" + struct.pack("<I", len(block)) \
        + block
    same_as_cv2(tmp_path, b"RIFF" + struct.pack("<I", len(body)) + body)


def test_exif_orientation_values_and_malformed_blocks():
    assert exif.orientation(photos.exif_block(6, True)) == 6
    assert exif.orientation(photos.exif_block(8)) == 8
    assert exif.orientation(photos.exif_block(9)) == 1
    assert exif.orientation(b"Exif\0\0" + photos.exif_block(6)) == 1
    assert exif.orientation(photos.exif_block(6)[:12]) == 1
    assert exif.orientation(None) == 1
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    for k, fn in ((6, lambda a: np.rot90(a, -1)), (8, lambda a: np.rot90(a)),
                  (3, lambda a: np.rot90(a, 2))):
        np.testing.assert_array_equal(exif.apply(img, k), fn(img))


# ------------------------------------------------------------- refusals
def _refused_files(images):
    rgb = images[SIZES[0]]
    bgr = rgb[..., ::-1]
    enc = {ext: cv2.imencode(ext, src)[1].tobytes() for ext, src in (
        (".jp2", bgr), (".avif", bgr))}
    return {
        "JPEG 2000": enc[".jp2"],
        "AVIF": enc[".avif"],
        "JPEG-compressed TIFF": cv2.imencode(".tiff", bgr, [
            cv2.IMWRITE_TIFF_COMPRESSION, 7])[1].tobytes(),
        "YCbCr TIFF": pil_bytes(Image.fromarray(rgb).convert("YCbCr"),
                                "TIFF"),
        "CMYK TIFF": pil_bytes(Image.fromarray(rgb).convert("CMYK"), "TIFF"),
    }


def test_formats_cv2_reads_and_the_port_does_not_are_refused_by_name(
        tmp_path, images):
    """AVIF, the one format of these still unread, raises
    NotImplementedError naming itself; the five others (JPEG 2000, JPEG-
    compressed, YCbCr and CMYK TIFF) are now read, each equal to cv2's
    frame bit for bit.  cv2 reads every one of them."""
    for name, data in _refused_files(images).items():
        assert cv2_read(tmp_path, data) is not None, name
        if name == "AVIF":
            with pytest.raises(NotImplementedError, match=name):
                photo.decode(data)
        else:
            assert same_as_cv2(tmp_path, data) is not None, name


def test_floating_point_tiff_is_refused_by_name(tmp_path, images):
    """A float TIFF gives no frame, as cv2 5.0 gives no image for one read
    in colour (the JAX package skips it, and so does the port)."""
    f = images[SIZES[0]].astype(np.float32) / 255
    data = cv2.imencode(".tiff", f)[1].tobytes()
    assert cv2_read(tmp_path, data) is None
    assert photo.decode(data) is None


def test_headers_past_opencvs_size_limit_give_none(tmp_path):
    """Headers that claim more pixels than OpenCV decodes (2^30) give None
    before anything of that size is allocated; cv2.imread raises its
    size assertion for them, or gives None."""
    big_png = (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 999_999, 999_999, 8, 2, 0, 0, 0))
        + png._chunk(b"IDAT", zlib.compress(b"\0" * 64))
        + png._chunk(b"IEND", b""))
    big_rle = _bmp(60_000, 60_000, 8, b"\0\1", comp=1,
                   palette=np.zeros((256, 4), np.uint8))
    tiles = photos.encode_tiff(np.zeros((16, 16), np.uint8), photometric=1,
                               tile=(16, 16))
    big_tiles = tiles.replace(struct.pack("<HHII", 322, 3, 1, 16),
                              struct.pack("<HHII", 322, 4, 1, 1 << 20))
    big_tiles = big_tiles.replace(struct.pack("<HHII", 323, 3, 1, 16),
                                  struct.pack("<HHII", 323, 4, 1, 1 << 20))
    assert big_tiles != tiles
    for data in (big_png, big_rle, big_tiles):
        try:
            assert cv2_read(tmp_path, data) is None
        except cv2.error as e:
            assert "CV_IO_MAX_IMAGE" in str(e)
        assert photo.decode(data) is None


def test_unknown_bytes_and_damaged_files_give_none(tmp_path, images):
    for data in (b"", b"plain text", b"\x76\x2f\x31\x01" + bytes(60),
                 b"\xff\xd8\xff\xe0" + bytes(64),
                 photos.encode_bmp(images[SIZES[0]])[:70],
                 photos.encode_tiff(images[SIZES[0]], compression="deflate")
                 [:300]):
        assert cv2_read(tmp_path, data) is None
        assert photo.decode(data) is None


# ------------------------------------------------- the numpy writers
@pytest.mark.parametrize("hw", SIZES)
def test_numpy_writers_give_the_frame_and_equal_cv2(tmp_path, images, hw):
    """testing/photos.py's PPM, BMP, TIFF (tiled Deflate with the
    predictor, PackBits strips), 16-bit (x257) and all-Paeth PNG decode to
    the frame written, as cv2 reads them; an EXIF APP1 turns a JPEG."""
    rgb = images[hw]
    for data in (photos.encode_ppm(rgb), photos.encode_bmp(rgb),
                 photos.encode_tiff(rgb, compression="deflate", predictor=2,
                                    tile=(256, 256)),
                 photos.encode_tiff(rgb, compression="packbits",
                                    rows_per_strip=16),
                 photos.encode_png16(rgb.astype(np.uint16) * 257),
                 photos.encode_png_paeth(rgb)):
        got = same_as_cv2(tmp_path, data)
        np.testing.assert_array_equal(got, rgb)
    jpg = mjpeg.encode_jpeg(rgb, 95)
    np.testing.assert_array_equal(
        same_as_cv2(tmp_path, photos.insert_exif(jpg, 6)),
        np.rot90(photo.decode(jpg), -1))


# ------------------------------------------------------------ fixtures
def fixture_files() -> dict:
    """The committed fixtures' bytes by name: one per variant family and
    EXIF case, from cv2, Pillow and the numpy writers."""
    rgb = scene_image(61, 77, seed=3)
    bgr = rgb[..., ::-1]
    rng = np.random.default_rng(0)
    ex6 = Image.Exif()
    ex6[0x0112] = 6
    enc = lambda ext, img, p=(): cv2.imencode(ext, img, list(p))[1].tobytes()
    g16 = (bgr.astype(np.uint16) * 257 + rng.integers(0, 257, bgr.shape)
           ).astype(np.uint16)
    block = photos.exif_block(8, True)
    paeth = photos.encode_png_paeth(rgb)
    i = paeth.index(b"IDAT") - 4
    blur = cv2.GaussianBlur(rng.normal(0, 1, (48, 64, 3)), (0, 0), 4)
    smooth = (255 * (blur - blur.min()) / np.ptp(blur)).astype(np.uint8)
    border = np.full(rgb.shape[:2], 255, np.uint8)
    border[:10], border[:, :12] = 0, 0
    q256 = Image.fromarray(rgb).quantize(256)
    return {
        "png16_rgb.png": enc(".png", g16),
        "png_palette_trns_adam7.png": _pil_png(rgb, "P-trns", 1),
        "png_gray2.png": pil_bytes(Image.fromarray(rgb).quantize(4), "PNG",
                                   bits=2),
        "png_paeth_exif8_mm.png": paeth[:i] + photos._png_chunk(b"eXIf",
                                                                block)
        + paeth[i:],
        "p6_maxval100.ppm": b"P6\n77 61\n100\n" + (rgb // 3).tobytes(),
        "p2_ascii.pgm": enc(".pgm", bgr[..., 0], (cv2.IMWRITE_PXM_BINARY, 0)),
        "p4.pbm": enc(".pbm", bgr[..., 0]),
        "p5_16bit.pgm": enc(".pgm", g16[..., 0]),
        "rgb.pam": enc(".pam", bgr),
        "bmp_rle8.bmp": _BMP["rle8_delta"],
        "bmp_rle4.bmp": _BMP["rle4"],
        "bmp_565.bmp": _BMP["565"],
        "bmp_core8.bmp": _BMP["core8"],
        "bmp_pal4.bmp": pil_bytes(Image.fromarray(rgb).quantize(16), "BMP"),
        "bmp_32_top_down.bmp": _bmp(77, -61, 32, np.dstack(
            [bgr, rgb[..., :1]]).tobytes()),
        "tiff_lzw_predictor.tif": enc(".tiff", bgr, (
            cv2.IMWRITE_TIFF_COMPRESSION, 5, cv2.IMWRITE_TIFF_PREDICTOR, 2)),
        "tiff_tiles_deflate_mm.tif": photos.encode_tiff(
            rgb, compression="deflate", predictor=2, tile=(32, 16),
            big_endian=True),
        "tiff16_planar_bigtiff.tif": photos.encode_tiff(
            g16[..., ::-1], planar=True, bigtiff=True, compression="packbits"),
        "tiff_palette.tif": pil_bytes(Image.fromarray(rgb).quantize(50),
                                      "TIFF", compression="tiff_lzw"),
        "tiff_bilevel.tif": pil_bytes(Image.fromarray(rgb).convert("1"),
                                      "TIFF"),
        "tiff_rgba_unassociated.tif": pil_bytes(Image.fromarray(np.dstack(
            [rgb, rgb[..., 1:2]])), "TIFF", compression="tiff_adobe_deflate"),
        "tiff_orientation3_tiles.tif": photos.encode_tiff(
            rgb, orientation=3, tile=(32, 32)),
        "webp_q80.webp": enc(".webp", bgr, (cv2.IMWRITE_WEBP_QUALITY, 80)),
        "webp_alpha_exif6.webp": pil_bytes(Image.fromarray(np.dstack(
            [rgb, rgb[..., :1]])), "WEBP", quality=60, exif=ex6.tobytes()),
        "webp_lossless_cv2_cache.webp": enc(".webp", bgr, (
            cv2.IMWRITE_WEBP_QUALITY, 101)),
        "webp_lossless_pil_predictor.webp": pil_bytes(
            Image.fromarray(smooth), "WEBP", lossless=True, method=6,
            quality=100),
        "webp_lossless_palette4.webp": pil_bytes(
            Image.fromarray(rgb).quantize(4), "WEBP", lossless=True),
        "webp_lossless_exif6.webp": pil_bytes(Image.fromarray(rgb), "WEBP",
                                              lossless=True,
                                              exif=ex6.tobytes()),
        "webp_anim_lossy_offset.webp": pil_bytes(
            Image.fromarray(np.dstack([rgb, border])), "WEBP", save_all=True,
            append_images=[Image.fromarray(rgb[::-1].copy())], quality=70),
        "webp_anim_lossless_offset.webp": photos.encode_webp_animated(
            rgb, at=(6, 4), canvas=(71, 89)),
        "gif_interlaced.gif": pil_bytes(q256, "GIF", interlace=True),
        "gif_local_palette.gif": pil_bytes(q256, "GIF",
                                           include_color_table=True,
                                           interlace=False),
        "gif_transparent_bg.gif": pil_bytes(Image.fromarray(rgb).quantize(16),
                                            "GIF", transparency=1,
                                            background=3),
        "gif_code_size2.gif": pil_bytes(Image.fromarray(rgb).quantize(4),
                                        "GIF"),
        "gif_cv2.gif": enc(".gif", bgr),
        "jpeg_exif6_ii.jpg": photos.insert_exif(enc(".jpg", bgr), 6),
        "jpeg_exif5_mm.jpg": photos.insert_exif(enc(".jpg", bgr), 5, True),
    }


def write_fixtures() -> None:
    FIXTURES.mkdir(exist_ok=True)
    table = {}
    for name, data in sorted(fixture_files().items()):
        (FIXTURES / name).write_bytes(data)
        img = cv2.imread(str(FIXTURES / name))
        rgb = np.ascontiguousarray(img[..., ::-1])
        table[name] = {"shape": list(rgb.shape),
                       "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (FIXTURES / "cv2_sha256.json").write_text(json.dumps(table, indent=1)
                                              + "\n")


def test_committed_fixtures_equal_cv2_and_their_recorded_sha256(no_native):
    """Each committed fixture: cv2.imread's sha256 here is the recorded
    one, and the port's MediaSource (what the card checks) gives it."""
    table = json.loads((FIXTURES / "cv2_sha256.json").read_text())
    assert sorted(table) == sorted(fixture_files())
    total = 0
    for name, want in table.items():
        path = FIXTURES / name
        total += path.stat().st_size
        img = cv2.imread(str(path))
        assert hashlib.sha256(np.ascontiguousarray(
            img[..., ::-1]).tobytes()).hexdigest() == want["sha256"], name
        got = list(MediaSource(photos_pattern=str(path)))
        assert len(got) == 1, name
        assert hashlib.sha256(got[0].tobytes()).hexdigest() == \
            want["sha256"], name
    assert total < 1_000_000


# ------------------------------------------------------- media sources
def _mixed_glob(root, frames):
    """The frames cycled through PPM, BMP, tiled Deflate TIFF, PackBits
    TIFF, 16-bit PNG and all-Paeth PNG, names of one length (natural order
    is frame order) → the glob."""
    writers = (("ppm", photos.encode_ppm), ("bmp", photos.encode_bmp),
               ("tif", lambda f: photos.encode_tiff(
                   f, compression="deflate", predictor=2, tile=(64, 64))),
               ("tif", lambda f: photos.encode_tiff(
                   f, compression="packbits", rows_per_strip=32)),
               ("png", lambda f: photos.encode_png16(
                   f.astype(np.uint16) * 257)),
               ("png", photos.encode_png_paeth))
    for i, f in enumerate(frames):
        ext, enc = writers[i % len(writers)]
        (root / f"frame_{i:02d}.{ext}").write_bytes(enc(f))
    return str(root / "frame_*")


def test_bmp_glob_gives_the_jax_packages_frames(tmp_path, no_native):
    """Six cv2-written BMPs: 0 frames through the port's MediaSource
    before it read BMP; now the 6 of the JAX package's MediaSource (its
    native reader off too: cv2.imread)."""
    sc = make_scene(n_points=300, n_frames=6, seed=5, baseline=0.3)
    for i in range(6):
        cv2.imwrite(str(tmp_path / f"f{i}.bmp"),
                    cv2.cvtColor(sc.render(i), cv2.COLOR_RGB2BGR))
    pattern = str(tmp_path / "*.bmp")
    want = list(JMediaSource(photos_pattern=pattern, threads=3))
    got = list(MediaSource(photos_pattern=pattern, threads=3))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mixed_glob_equals_jax_and_refusal_reaches_the_caller(tmp_path,
                                                              no_native):
    """A mixed-format glob (the six writers, a cv2 WebP, a JPEG turned by
    EXIF) through both MediaSources with the native readers off: the same
    frames in the same order.  Then an AVIF at its end raises
    NotImplementedError from next_frame, where the JAX package (cv2)
    reads it; and a file that no reader decodes (a PNG signature and
    nothing else) in its place is skipped, as the JAX package's native
    reader and cv2 give it no image (its pure-Python reader stops at it
    instead).  A damaged file that cv2 still decodes is kept
    (tests/test_torch_photo_damage.py)."""
    sc = make_scene(n_points=300, n_frames=8, seed=5, baseline=0.3)
    frames = [sc.render(i) for i in range(8)]
    pattern = _mixed_glob(tmp_path, frames[:6])
    ok, buf = cv2.imencode(".webp", frames[6][..., ::-1],
                           [cv2.IMWRITE_WEBP_QUALITY, 90])
    (tmp_path / "frame_06.wbp").write_bytes(buf.tobytes())
    (tmp_path / "frame_07.jpg").write_bytes(
        photos.insert_exif(mjpeg.encode_jpeg(frames[7]), 6))
    want = list(JMediaSource(photos_pattern=pattern, threads=3))
    got = list(MediaSource(photos_pattern=pattern, threads=3, prefetch=4))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[:6], frames):
        np.testing.assert_array_equal(a, b)
    assert got[7].shape[:2] == frames[7].shape[:2][::-1]
    ras = tmp_path / "frame_08.avf"
    ras.write_bytes(cv2.imencode(".avif", frames[0][..., ::-1])[1].tobytes())
    assert len(list(JMediaSource(photos_pattern=pattern, threads=3))) == 9
    src = MediaSource(photos_pattern=pattern, threads=3)
    with pytest.raises(NotImplementedError, match="AVIF"):
        for _ in range(10):
            src.next_frame()
    ras.unlink()
    (tmp_path / "frame_05.png").write_bytes(png.SIGNATURE + b"broken")
    got = list(MediaSource(photos_pattern=pattern, threads=3))
    assert len(got) == 7
    for a, b in zip(got, want[:5] + want[6:]):
        np.testing.assert_array_equal(a, b)


def _photo_cfg(mod, pattern, out):
    tpu = mod.TpuConfig(max_keypoints=512, ransac_iters=256,
                        pnp_ransac_iters=128, window_points=4096,
                        ba_max_iters=12)
    return mod.Config(
        usePhotosCycle=True, photosPathPattern=str(pattern),
        outputDataDir=str(out), requiredExtractedPointsCount=80,
        featureExtractingThreshold=20, framesBatchSize=6,
        requiredMatchedPointsCount=30, knnMatcherDistance=0.8,
        RPDistanceThreshold=500.0, useBundleAdjustment=True,
        BAMaxFramesCnt=4, BAUseHuberLossFunction=True,
        BAHuberLossFunctionParameter=2.0, threadsCount=3, tpu=tpu)


def test_slam_main_on_mixed_format_photos_against_jax(tmp_path, no_native):
    """The hallway at 540x960, 14 frames as a mixed-format glob (PPM, BMP,
    two TIFFs, two PNGs, cycled): the port (its own readers) and the JAX
    package (cv2.imread) track the same frames, ATE within 0.02 of the
    extent."""
    from test_torch_video import _rel_ate

    scene = make_scene(n_points=700, n_frames=14, image_size=(540, 960),
                       seed=7, baseline=0.25, kind="hallway")
    pattern = _mixed_glob(tmp_path, [scene.render(i) for i in range(14)])
    for d in ("jax", "torch"):
        (tmp_path / d).mkdir()
    gd_j = japp.slam_main(_photo_cfg(jconfig, pattern, tmp_path / "jax"),
                          scene.K)
    gd_t = tapp.slam_main(_photo_cfg(tconfig, pattern, tmp_path / "torch"),
                          scene.K, device="cpu")
    assert [int(f) for f in gd_t.frame_ids] == \
        [int(f) for f in gd_j.frame_ids]
    assert len(gd_t.rotations) >= 10
    rel_t, rel_j = _rel_ate(scene, gd_t), _rel_ate(scene, gd_j)
    assert rel_t < 0.08 and abs(rel_t - rel_j) < 0.02, (rel_t, rel_j)


# ----------------------------------------------------------------- time
def test_fhd_paeth_png_decodes_within_3x_of_cv2(tmp_path):
    """An FHD frame with every row filtered Paeth: the port's decode
    (zlib + native/png.cpp) within 3x of cv2.imread's on the same file in
    this process (best of 3 each); both times are printed."""
    frame = make_scene(n_points=1500, n_frames=1, seed=7, baseline=0.3,
                       image_size=(1080, 1920)).render(0)
    path = tmp_path / "paeth.png"
    path.write_bytes(photos.encode_png_paeth(frame))
    np.testing.assert_array_equal(photo.imread_rgb(str(path)), frame)

    def best(fn):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            fn(str(path))
            times.append(time.perf_counter() - t)
        return min(times)

    port, ref = best(photo.imread_rgb), best(cv2.imread)
    print(f"FHD all-Paeth PNG: port {1e3 * port:.1f} ms, cv2.imread "
          f"{1e3 * ref:.1f} ms")
    assert port < 3 * ref, (port, ref)


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    write_fixtures()
