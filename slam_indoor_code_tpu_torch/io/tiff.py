"""TIFF photos without libtiff: the first image directory parsed here,
its strips or tiles decoded by ``native/tiff.cpp`` (LZW, Deflate,
PackBits, the horizontal predictor), by ``native/fax3.cpp`` (CCITT) or by
io/jpeg.py (JPEG, 7), and the samples converted to RGB as libtiff 4.7's
RGBA interface converts them for OpenCV's ``imread`` in colour:

- classic and BigTIFF, II and MM byte orders, strips and tiles, chunky
  and planar layout, compression none, LZW, Deflate, PackBits and JPEG,
  with or without Predictor 2;
- MinIsBlack and MinIsWhite at 1, 2, 4, 8 and 16 bits (16-bit: the high
  byte; MinIsWhite inverted), Palette at 1, 2, 4 and 8 bits (a colour map
  with an entry of 256 or more is taken as 16-bit and shifted down by 8),
  RGB at 8 and 16 bits (16-bit samples scaled by ``(v + 128) // 257``);
- YCbCr at 8 bits in the data units of YCbCrSubsampling 1x1, 1x2, 2x1,
  2x2, 4x1, 4x2 and 4x4 (chroma repeated over its unit, planar only at
  1x1; libtiff's 4x4 routine skips the units past a tile's right edge as
  4x2 ones, and so does this reader), through TIFFYCbCrToRGBInit's tables
  from ReferenceBlackWhite and YCbCrCoefficients, in float32 as libtiff
  computes them;
- CMYK (InkSet 1, four 8-bit samples, chunky or planar) as
  ``k * (255 - c) / 255``; CIE Lab at 8 and 16 bits through
  TIFFCIELab16ToXYZ and TIFFXYZToRGB with libtiff's default sRGB display
  and the WhitePoint tag (D50 by default), in float32;
- JPEG (7): JPEGTables before each abbreviated strip or tile stream,
  libjpeg's YCbCr to RGB for a chunky YCbCr image (JPEGCOLORMODE_RGB),
  the components as stored otherwise; the JPEG's sampling factors checked
  against YCbCrSubsampling (taken from the first strip where the tag is
  absent), a smaller JPEG left on libtiff's zeroed buffer, damaged
  entropy-coded data read as libjpeg-turbo reads it;
- extra samples dropped; RGB with unassociated alpha (ExtraSamples 2) is
  premultiplied by it, ``(v * a + 127) // 255``, as libtiff does;
- the Orientation tag: 2 mirrors each strip or tile left to right (a
  tile within itself, as libtiff's tile reader does), 4 mirrors the image
  top to bottom, 3 does both; at 5-8 OpenCV's ``imread`` gives no image,
  and neither does this reader.

No image (None), as OpenCV gives none: floating-point samples; the
compressions its libtiff is built without (LZMA, Zstandard, WebP, LERC);
photometrics its RGBA reader takes no routine for (ICC Lab, ITU Lab,
LogL, LogLuv, ...) and the layouts above it refuses (YCbCr 1x4 or 2x4,
CMYK of another ink set, 16 bits or a fifth sample, planar Lab, 12-bit
JPEG, sampling factors that disagree, a strip past the file's end).
Bilevel CCITT strips and tiles (RLE 2, Group 3 3 in 1D or 2D, Group 4 4,
RLEW 32771; FillOrder 1 and 2) decode as libtiff's tif_fax3.c decodes
them (native/fax3.cpp), damage included.  A strip or tile whose data
libtiff's decoder fails on (damaged or short LZW, Deflate, PackBits,
CCITT or uncompressed data) keeps what the decoder wrote and zeros, with
neither the predictor nor the byte swap, as libtiff's RGBA reader hands
it to OpenCV; one that lies past the file's end gives no image (zeros
where it is a later plane's); the directory's strip arrays, types and
counts are read by libtiff's rules.  Old-style JPEG, ThunderScan, NeXT,
SGILog and unknown compressions (JPEG 2000 in TIFF among them: cv2 gives
a black frame) raise ``NotImplementedError`` naming them; a file libtiff
would refuse raises ``ValueError``.  Only the first page of a multi-page
file is read.

The library is built at first use with ``g++ -O2 -fPIC -shared`` into
``_build/`` inside the package (ignored by git).  If the build fails,
every decode of a compressed file raises with the compiler's message.
The calls release the GIL.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional

import numpy as np

from . import jpeg
from .native import _PKG_DIR, load_shared
from .png import MAX_PIXELS

SOURCE = _PKG_DIR / "native" / "tiff.cpp"
LIBRARY = _PKG_DIR / "_build" / "libtiffdec.so"
FAX_SOURCE = _PKG_DIR / "native" / "fax3.cpp"
FAX_LIBRARY = _PKG_DIR / "_build" / "libfax3dec.so"
_state: dict = {"lib": None, "error": None}
_fax_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()

_NONE, _LZW, _JPEG, _DEFLATE, _DEFLATE_OLD, _PACKBITS = (1, 5, 7, 8, 32946,
                                                      32773)
# CCITT compression -> native/fax3.cpp's decoder (RLE, RLEW, Group 3 1D;
# Group 3 2D is 3 with T4Options bit 0; Group 4)
_FAX = {2: 0, 32771: 1, 3: 2, 4: 4}
# compressions OpenCV's libtiff reads that the port does not
_COMPRESSIONS = {6: "old-style JPEG", 32809: "ThunderScan", 32766: "NeXT",
                 34676: "SGILog", 34677: "SGILog24"}
# compressions OpenCV's libtiff is built without: imread gives no image
_UNCONFIGURED = {34925, 50000, 50001, 34887}
# photometrics the port converts (0-3 and these three)
_CMYK, _YCBCR, _CIELAB = 5, 6, 8
# YCbCrSubsampling (horizontal, vertical) pairs libtiff's RGBA reader has
# a routine for
_SUBSAMPLINGS = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}
# tag -> name
_TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
         262: "photometric", 266: "fill_order", 273: "strip_offsets",
         274: "orientation",
         277: "spp", 278: "rows_per_strip", 279: "strip_counts",
         284: "planar", 292: "t4_options", 293: "t6_options",
         317: "predictor", 318: "white_point",
         320: "colormap", 322: "tile_width", 323: "tile_height",
         324: "tile_offsets", 325: "tile_counts", 332: "ink_set",
         338: "extra", 339: "sample_format", 347: "jpeg_tables",
         529: "ycbcr_coefficients", 530: "ycbcr_subsampling",
         532: "reference_black_white"}
# integer field types, which libtiff reads an integer tag from, and the
# tags of real or byte-string values
_INTEGER_TYPES = {1, 3, 4, 6, 8, 9, 16, 17}
_REAL_TAGS = {318, 347, 529, 532}
# tags of one value; a directory whose entry of one of _FATAL is of another
# count or of no integer type fails to read (the others are ignored)
_SINGLE = {256, 257, 262, 266, 274, 277, 278, 284, 292, 293, 317, 322, 323,
           332}
_FATAL = {256, 257, 258, 259, 277, 278, 284, 322, 323, 339}
# each byte with its bits in the other order
_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                     np.uint8)
# the strip and tile offset and byte count tags
_STRILES = {273, 279, 324, 325}
# field type -> (struct code, size); rationals are read as pairs
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          10: ("i", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}


def load() -> ctypes.CDLL:
    """The codec library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def load_fax() -> ctypes.CDLL:
    """The CCITT decoder library (native/fax3.cpp), built on first use;
    raises with the compiler's message when it cannot be built."""
    return load_shared(_fax_state, _LOCK, FAX_SOURCE, FAX_LIBRARY, [],
                       _bind_fax)


def _bind_fax(lib: ctypes.CDLL) -> None:
    I, I64 = ctypes.c_int, ctypes.c_int64
    lib.fax_decode.argtypes = [ctypes.c_char_p, I64,
                               ctypes.POINTER(ctypes.c_uint8), I64,
                               ctypes.c_int32, I64, I, I, I64,
                               ctypes.POINTER(I),
                               ctypes.POINTER(ctypes.c_uint32)]
    lib.fax_decode.restype = I
    lib.fax_runs_size.argtypes = [ctypes.c_int32]
    lib.fax_runs_size.restype = I64


def _bind(lib: ctypes.CDLL) -> None:
    I, I64, U8 = ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    for name in ("tiff_inflate", "tiff_packbits"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, I64, U8, I64]
        fn.restype = I
    lib.tiff_lzw.argtypes = [ctypes.c_char_p, I64, U8, I64, I]
    lib.tiff_lzw.restype = I
    lib.tiff_predict.argtypes = [U8, I64, I64, I, I, I]
    lib.tiff_predict.restype = None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _directory(data: bytes) -> tuple[dict, str]:
    """The first image directory's fields (by name, each a tuple of
    values) and the byte order's struct prefix."""
    e = "<" if data[:2] == b"II" else ">"
    try:
        big = struct.unpack_from(e + "H", data, 2)[0] == 43
        if big:
            at = struct.unpack_from(e + "Q", data, 8)[0]
            count = struct.unpack_from(e + "Q", data, at)[0]
            at, entry, inline = at + 8, 20, 8
        else:
            at = struct.unpack_from(e + "I", data, 4)[0]
            count = struct.unpack_from(e + "H", data, at)[0]
            at, entry, inline = at + 2, 12, 4
        fields = {}
        for k in range(count):
            p = at + k * entry
            tag, ftype = struct.unpack_from(e + "HH", data, p)
            n = struct.unpack_from(e + ("Q" if big else "I"), data, p + 4)[0]
            if tag not in _TAGS:
                continue
            bad = ((tag not in _REAL_TAGS and ftype not in _INTEGER_TYPES)
                   or (tag in _SINGLE and n != 1) or ftype not in _TYPES)
            if bad and tag in _FATAL:   # TIFFReadDirectory fails
                raise ValueError(f"TIFF: tag {tag} of type {ftype} x {n}")
            if bad:
                continue     # libtiff: a warning, and the tag is ignored
            code, size = _TYPES[ftype]
            where = p + (12 if big else 8)
            if n * size > inline:
                where = struct.unpack_from(e + ("Q" if big else "I"), data,
                                           where)[0]
                if tag in _STRILES:
                    # libtiff reads a strip or tile array up to the count
                    # of strips or tiles: a count past the file reads what
                    # lies in it
                    n = min(n, max(len(data) - where, 0) // size)
            if ftype in (5, 10):     # as libtiff: (float)num / (float)den
                v = np.array(struct.unpack_from(f"{e}{2 * n}{code}", data,
                                                where), np.float32)
                num, den = v[0::2], v[1::2]
                fields[_TAGS[tag]] = tuple(np.where(
                    den == 0, np.float32(0),
                    num / np.where(den == 0, np.float32(1), den)))
            else:
                fields[_TAGS[tag]] = struct.unpack_from(f"{e}{n}{code}",
                                                        data, where)
    except struct.error as err:
        raise ValueError("TIFF: directory cut short") from err
    return fields, e


def _inflate(chunk: bytes, compression: int, size: int,
             compat: bool = False) -> tuple[np.ndarray, bool]:
    """A strip's or tile's ``size`` bytes and whether libtiff's decoder
    filled them.  Where it fails (damaged or short data), the bytes it
    wrote stay and the rest are zero, as libtiff's RGBA reader leaves its
    buffer for OpenCV.  ``compat``: LZW in the old-style codes."""
    raw = np.zeros(size, np.uint8)
    if compression == _NONE:     # DumpModeDecode: a short strip copies none
        ok = len(chunk) >= size
        if ok:
            raw[:] = np.frombuffer(chunk, np.uint8, size)
        return raw, ok
    lib = load()
    if compression == _LZW:
        ok = lib.tiff_lzw(chunk, len(chunk), _u8(raw), size, int(compat))
    elif compression in (_DEFLATE, _DEFLATE_OLD):
        ok = lib.tiff_inflate(chunk, len(chunk), _u8(raw), size)
    else:
        ok = lib.tiff_packbits(chunk, len(chunk), _u8(raw), size)
    return raw, bool(ok)


def _samples(raw: np.ndarray, rows: int, cols: int, spp: int, bits: int,
             e: str) -> np.ndarray:
    """[rows, cols, spp] samples (uint8, or uint16 at 16 bits) of ``rows``
    rows of whole bytes each."""
    if bits == 8:
        return raw.reshape(rows, -1)[:, :cols * spp].reshape(rows, cols, spp)
    if bits == 16:
        v = raw.view(e + "u2").reshape(rows, -1)[:, :cols * spp]
        return v.astype(np.uint16).reshape(rows, cols, spp)
    bitrows = np.unpackbits(raw.reshape(rows, -1), axis=1)
    bitrows = bitrows[:, :cols * spp * bits].reshape(rows, cols * spp, bits)
    weights = 1 << np.arange(bits - 1, -1, -1, dtype=np.uint8)
    v = (bitrows * weights).sum(axis=2, dtype=np.uint8)
    return v.reshape(rows, cols, spp)


def _ycbcr_tables(f: dict) -> tuple:
    """TIFFYCbCrToRGBInit's tables (Y, Cr->R, Cb->B, Cr->G, Cb->G, each
    256 int64) from YCbCrCoefficients and ReferenceBlackWhite, computed in
    float32 as libtiff 4.7 computes them."""
    f32 = np.float32
    luma = np.array(f.get("ycbcr_coefficients", (0.299, 0.587, 0.114)),
                    f32)[:3]
    rbw = np.array(f.get("reference_black_white",
                         (0, 255, 128, 255, 128, 255)), f32)[:6]
    if luma.size < 3 or rbw.size < 6 or not np.isfinite(luma).all() \
            or luma[1] == 0 or not np.isfinite(rbw).all():
        raise ValueError("TIFF: YCbCr coefficients or reference")

    def fix(x):                  # FIX(): x * 65536 + 0.5, truncated
        return int(np.float64(f32(x) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * luma[0]
    f2 = luma[0] * f1 / luma[1]
    f3 = f32(2) - f32(2) * luma[2]
    f4 = luma[2] * f3 / luma[1]
    d1, d2 = fix(np.clip(f1, 0, 2)), -fix(np.clip(f2, 0, 2))
    d3, d4 = fix(np.clip(f3, 0, 2)), -fix(np.clip(f4, 0, 2))

    def code2v(c, rb, rw, cr):
        den = rw - rb
        den = den if den != 0 else f32(1)
        v = (c - np.int64(np.trunc(rb))).astype(f32) * f32(cr) / den
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)

    x = np.arange(-128, 128, dtype=np.int64)
    cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    y = code2v(x + 128, rbw[0], rbw[1], 255)
    half = 1 << 15
    return (y, (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr,
            d4 * cb + half)


def _ycbcr_to_rgb(s: np.ndarray, f: dict) -> np.ndarray:
    """TIFFYCbCrtoRGB of 8-bit (Y, Cb, Cr) samples [H, W, 3]."""
    y_t, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(f)
    y, cb, cr = s[..., 0], s[..., 1], s[..., 2]
    yv = y_t[y]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# D50, libtiff's default WhitePoint
_D50 = (96.4250, 100.0, 82.4680)
# display_sRGB: the XYZ -> RGB matrix, Y of black and white, gamma
_SRGB = ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416),
         (0.0556, -0.2040, 1.0570))
_LAB_RANGE = 1500


def _lab_to_rgb(s: np.ndarray, f: dict, bits: int) -> np.ndarray:
    """libtiff's TIFFCIELab16ToXYZ and TIFFXYZToRGB with its default
    display (sRGB primaries, gamma 2.4, 1500 steps), in float32 as libtiff
    computes them, of (L, a, b) samples [H, W, 3] (8-bit: a and b signed,
    L scaled by 257 and a, b by 256; 16-bit: a and b signed)."""
    f32 = np.float32
    wp = f.get("white_point")
    if wp is None:
        x0, y0, z0 = (f32(v) for v in _D50)
        wp = (x0 / (x0 + y0 + z0), y0 / (x0 + y0 + z0))
    wp = [f32(v) for v in wp[:2]]
    if len(wp) < 2 or wp[1] == 0:
        raise ValueError("TIFF: white point")
    hundred = f32(100)
    X0 = wp[0] / wp[1] * hundred
    Y0 = hundred
    Z0 = (f32(1) - wp[0] - wp[1]) / wp[1] * hundred
    if bits == 8:
        ll = s[..., 0].astype(np.int64) * 257
        aa = s[..., 1].astype(np.int8).astype(np.int64) * 256
        bb = s[..., 2].astype(np.int8).astype(np.int64) * 256
    else:
        ll = s[..., 0].astype(np.int64)
        aa = s[..., 1].astype(np.int16).astype(np.int64)
        bb = s[..., 2].astype(np.int16).astype(np.int64)
    L = ll.astype(f32) * hundred / f32(65535)
    low = L < f32(8.856)
    Yl = (L * Y0) / f32(903.292)
    cby_l = f32(7.787) * (Yl / Y0) + f32(16) / f32(116)
    cby_h = (L + f32(16)) / f32(116)
    Yh = Y0 * cby_h * cby_h * cby_h
    Y = np.where(low, Yl, Yh)
    cby = np.where(low, cby_l, cby_h)

    def cube(t, w0):
        lin = w0 * (t - f32(0.13793)) / f32(7.787)
        return np.where(t < f32(0.2069), lin, w0 * t * t * t)

    X = cube(aa.astype(f32) / f32(256) / f32(500) + cby, X0)
    Z = cube(cby - bb.astype(f32) / f32(256) / f32(200), Z0)
    step = (hundred - f32(1)) / f32(_LAB_RANGE)
    table = (f32(255) * np.power(np.arange(_LAB_RANGE + 1) / _LAB_RANGE,
                                 1.0 / np.float64(f32(2.4))).astype(f32))
    rint = np.where(table > 0, table.astype(np.float64) + 0.5,
                    table.astype(np.float64) - 0.5).astype(np.int64)
    out = []
    for m in _SRGB:
        v = f32(m[0]) * X + f32(m[1]) * Y + f32(m[2]) * Z
        v = np.minimum(np.maximum(v, f32(1)), hundred)
        i = np.minimum(((v - f32(1)) / step).astype(np.int64), _LAB_RANGE)
        out.append(np.minimum(rint[i], 255))
    return np.stack(out, axis=-1).astype(np.uint8)


# putRGBcontig8bitCMYKtile's (255 - k) * (255 - c) / 255 by k << 8 | c
_K, _C = np.divmod(np.arange(1 << 16), 256)
_CMYK_TABLE = ((255 - _K) * (255 - _C) // 255).astype(np.uint8)


def _to_rgb(s: np.ndarray, f: dict, photometric: int, bits: int
            ) -> np.ndarray:
    """libtiff's RGBA conversion of the samples [H, W, spp], alpha
    dropped."""
    if photometric in (0, 1):
        if bits == 16:
            g = (s[..., 0] >> 8).astype(np.int32)
            top = 255
        else:
            g = s[..., 0].astype(np.int32)
            top = (1 << bits) - 1
        if photometric == 0:
            g = top - g
        g = (g * 255 // top).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=2)
    if photometric == 3:
        cmap = np.asarray(f.get("colormap", ()), np.int64)
        if cmap.size != 3 << bits:
            raise ValueError("TIFF: palette image without its colour map")
        cmap = cmap.reshape(3, -1).T
        if cmap.max(initial=0) >= 256:
            cmap >>= 8
        return cmap.astype(np.uint8)[s[..., 0]]
    if photometric == _YCBCR:
        return _ycbcr_to_rgb(s, f)
    if photometric == _CIELAB:
        return _lab_to_rgb(s, f, bits)
    if photometric == _CMYK:     # putRGBcontig8bitCMYKtile
        idx = (s[..., 3:4].astype(np.uint16) << 8) | s[..., :3]
        return _CMYK_TABLE[idx]
    extra = f.get("extra", ())
    alpha = s.shape[2] > 3 and extra[:1] == (2,)     # unassociated alpha
    if bits == 8 and not alpha:
        return s[..., :3]
    rgb = s[..., :3].astype(np.int32)
    if bits == 16:
        rgb = (rgb + 128) // 257
    if alpha:
        a = s[..., 3:4].astype(np.int32)
        if bits == 16:
            a = (a + 128) // 257
        rgb = (rgb * a + 127) // 255
    return rgb.astype(np.uint8)


def _jpeg_chunk(chunk: bytes, tables: bytes, colour: str, rows: int,
                cols: int, last_strip: bool) -> np.ndarray:
    """A JPEG strip or tile (an abbreviated stream after the tables of
    JPEGTables, as libtiff's JPEG codec reads it) as [rows, cols, 3]
    samples; ``ValueError`` where libtiff's JPEGPreDecode or libjpeg
    fails."""
    stream = chunk
    if tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9" \
            and chunk[:2] == b"\xff\xd8":
        stream = b"\xff\xd8" + tables[2:-2] + chunk[2:]
    try:
        img = jpeg.decode(stream, lenient=True, colour=colour)
    except ValueError as err:
        raise ValueError(f"TIFF: {err}") from err
    if img is None:
        raise ValueError("TIFF: a JPEG strip or tile does not decode")
    h, w = img.shape[:2]
    if w > cols or (h > rows and not last_strip):
        raise ValueError("TIFF: JPEG strip or tile size")
    # a smaller JPEG fills the top left of libtiff's zeroed strip buffer
    out = np.zeros((rows, cols, 3), np.uint8)
    out[:min(h, rows), :w] = img[:rows]
    return out


def _jpeg_layout(data: bytes, offsets, counts, f: dict,
                 photometric: int, spp: int, planar: int) -> str:
    """libtiff's checks of the first JPEG strip or tile against the
    directory (component count, precision, sampling factors), and the
    colour space its JPEG codec asks libjpeg for; ``ValueError`` where
    they fail.  In planar layout each strip or tile holds one component,
    which libjpeg gives as stored."""
    chunk = data[offsets[0]:offsets[0] + counts[0]]
    p = 2
    sof = None
    while p + 4 <= len(chunk):
        if chunk[p] != 0xFF:
            break
        m = chunk[p + 1]
        if m in (0xC0, 0xC1, 0xC2):
            sof = chunk[p + 4:p + 4 + 6 + 3 * chunk[p + 9]]
            break
        if m == 0xDA:
            break
        p += 2 + int.from_bytes(chunk[p + 2:p + 4], "big")
    if sof is None or len(sof) < 6:
        raise ValueError("TIFF: a JPEG strip without a frame header")
    precision, ncomp = sof[0], sof[5]
    factors = [(sof[7 + 3 * c] >> 4, sof[7 + 3 * c] & 15)
               for c in range(ncomp)]
    if precision != 8:
        raise ValueError("TIFF: improper JPEG data precision")
    if ncomp != (spp if planar == 1 else 1) or ncomp not in (1, 3):
        raise ValueError("TIFF: improper JPEG component count")
    want = (1, 1)
    if photometric == _YCBCR and planar == 1:
        want = tuple(f.get("ycbcr_subsampling", factors[0]))[:2]
    if factors[0] != want or any(fc != (1, 1) for fc in factors[1:]):
        raise ValueError("TIFF: improper JPEG sampling factors")
    return "ycbcr" if photometric == _YCBCR and planar == 1 else "none"


def _units(raw: np.ndarray, rows: int, cols: int, hs: int, vs: int,
           visible: int = 0) -> np.ndarray:
    """[rows, cols, 3] (Y, Cb, Cr) of subsampled YCbCr data units (hs*vs
    luma samples, then Cb and Cr), chroma repeated over its unit as
    libtiff's putcontig8bitYCbCr routines repeat it.  ``visible`` (a tile
    the image's right edge cuts to that many columns): libtiff's 4x4
    routine skips the units past the edge as 10-byte ones (its 4x2 size),
    so each unit row after the first starts where that skip lands."""
    unit = hs * vs + 2
    across, down = -(-cols // hs), -(-rows // vs)
    if (hs, vs) == (4, 4) and 0 < visible < cols:
        seen = -(-visible // hs)
        stride = seen * unit + (across - seen) * 10
        starts = np.arange(down) * stride
        u = raw[starts[:, None] + np.arange(seen * unit)].reshape(
            down, seen, unit)
        u = np.concatenate([u, np.zeros((down, across - seen, unit),
                                        np.uint8)], axis=1)
    else:
        u = raw[:across * down * unit].reshape(down, across, unit)
    y = u[..., :hs * vs].reshape(down, across, vs, hs)
    y = y.transpose(0, 2, 1, 3).reshape(down * vs, across * hs)
    cb = np.repeat(np.repeat(u[..., hs * vs], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(u[..., hs * vs + 1], vs, 0), hs, 1)
    return np.stack([y, cb, cr], axis=-1)[:rows, :cols]


def decode(data: bytes) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of the first page of the TIFF ``data``; None where
    OpenCV gives no image for a file it opens."""
    f, e = _directory(data)

    def one(name, default=None):
        v = f.get(name)
        return v[0] if v else default

    w, h = one("width", 0), one("height", 0)
    spp = one("spp", 1)
    for name in ("bits", "compression", "sample_format"):
        # one value, or one per sample (TIFFReadDirEntryPersampleShort:
        # at least SamplesPerPixel of them, those equal)
        v = f.get(name, (1,))
        if len(v) != 1 and (len(v) < spp or len(set(v[:spp])) != 1):
            raise ValueError(f"TIFF: {name} {v}")
        f[name] = v[:max(spp, 1)] if len(v) != 1 else v
    bits_all = f.get("bits", (1,))
    bits = bits_all[0]
    compression = one("compression", _NONE)
    photometric = one("photometric")
    planar = one("planar", 1)
    # libtiff's LZW and Deflate codecs undo the predictor; the others
    # ignore the tag
    predictor = (one("predictor", 1)
                 if compression in (_LZW, _DEFLATE, _DEFLATE_OLD) else 1)
    if one("sample_format", 1) == 3 or compression in _UNCONFIGURED:
        return None     # float samples, or a codec cv2's libtiff lacks
    if compression in _COMPRESSIONS:
        raise NotImplementedError(f"{_COMPRESSIONS[compression]}-compressed"
                                  " TIFF photos are not read by the port")
    if compression not in (_NONE, _LZW, _JPEG, _DEFLATE, _DEFLATE_OLD,
                           _PACKBITS) and compression not in _FAX:
        raise NotImplementedError(f"TIFF photos of compression {compression}"
                                  " are not read by the port")
    if compression in _FAX and (bits_all[0] != 1
                                or (spp != 1 and planar != 2)):
        return None     # Fax3SetupState refuses: 1 bit, one sample a plane
    if photometric is None:
        photometric = 2 if spp >= 3 else 1
    subsampling = (1, 1)
    if photometric == _YCBCR:
        tag = tuple(f.get("ycbcr_subsampling", (2, 2)))[:2]
        if spp != 3 or bits != 8 or (planar == 2 and tag != (1, 1)):
            return None
        if compression != _JPEG:
            subsampling = tag
            if subsampling not in _SUBSAMPLINGS:
                return None
    if photometric == _CMYK and (one("ink_set", 1) != 1 or bits != 8
                                 or spp != 4):
        return None
    if photometric == _CIELAB and (spp != 3 or bits not in (8, 16)
                                   or planar != 1):
        return None
    colour_ok = photometric in (0, 1, 2, 3, _CMYK, _YCBCR, _CIELAB)
    if not (0 < w * h <= MAX_PIXELS and colour_ok
            and len(set(bits_all)) == 1 and planar in (1, 2)
            and (bits in (8, 16) if photometric == 2
                 else bits in ((1, 2, 4, 8) if photometric == 3
                               else (8, 16) if photometric == _CIELAB
                               else (8,) if photometric in (_CMYK, _YCBCR)
                               else (1, 2, 4, 8, 16)))
            and spp >= (3 if photometric in (2, _YCBCR, _CIELAB)
                        else 4 if photometric == _CMYK else 1)
            and predictor in (1, 2)
            and (predictor == 1 or bits in (8, 16))
            and (compression != _JPEG or bits == 8)):
        raise ValueError(f"TIFF: {w}x{h}, {spp} x {bits_all}-bit samples, "
                         f"photometric {photometric}, planar {planar}, "
                         f"predictor {predictor}")
    orientation = one("orientation", 1)
    if orientation >= 5:
        return None
    tiled = "tile_offsets" in f
    if tiled:
        cw, ch = one("tile_width", 0), one("tile_height", 0)
        offsets, counts = f.get("tile_offsets"), f.get("tile_counts", ())
        if not (0 < cw * ch <= MAX_PIXELS and cw % 16 == 0
                and ch % 16 == 0):
            raise ValueError(f"TIFF: tiles of {cw}x{ch}")
        if cw * ch * 4 >= 1 << 30:       # OpenCV's bound on an RGBA tile
            return None
    else:
        rps = one("rows_per_strip", h)
        rps = h if rps in (0, 0xFFFFFFFF) else rps
        cw, ch = w, min(rps, h)
        # OpenCV's own bounds on a strip, which it reads as RGBA
        if rps > 1 << 24 or w * rps * 4 >= 1 << 30:
            return None
        offsets, counts = f.get("strip_offsets", ()), f.get("strip_counts",
                                                            ())
    across, down = -(-w // cw), -(-h // ch)
    planes = spp if planar == 2 else 1
    if (compression == _NONE and planar == 1 and not tiled
            and len(counts) > 2 and counts[0] != counts[1] and counts[0]
            and counts[1]):
        # TIFFReadDirectory: "Wrong StripByteCounts field, ignoring and
        # calculating from imagelength" (EstimateStripByteCounts)
        counts = ((w * spp * bits + 7) // 8 * (h // down),) * len(counts)
    cspp = 1 if planar == 2 else spp             # samples per chunk pixel
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise ValueError("TIFF: too few strips or tiles")
    hs, vs = subsampling
    if (hs, vs) != (1, 1):
        unit_bytes = -(-cw // hs) * (hs * vs + 2)
    row_bytes = (cw * cspp * bits + 7) // 8
    s = np.zeros((down * ch, across * cw, spp),
                 np.uint16 if bits == 16 else np.uint8)
    lib = load() if predictor == 2 else None
    if compression == _JPEG:
        tables = bytes(f.get("jpeg_tables", b""))
        colour = _jpeg_layout(data, offsets, counts, f, photometric, spp,
                              planar)
        if colour == "ycbcr":
            photometric = 2          # libjpeg gives RGB
    # FillOrder 2: TIFFFillStrip reverses each byte's bits for the codecs
    # that read bytes (the CCITT decoder reads the bits in either order)
    lsb_first = one("fill_order", 1) == 2
    reverse = lsb_first and compression in (_NONE, _LZW, _DEFLATE,
                                            _DEFLATE_OLD, _PACKBITS)
    # LZWPreDecode: old-style codes where the first chunk read begins with
    # 0x00 and an odd byte; libtiff keeps that decoder for the whole file
    first = data[offsets[0]:offsets[0] + 2] if offsets else b""
    if reverse:
        first = _REVERSED[np.frombuffer(first, np.uint8)].tobytes()
    if compression in _FAX:     # the codec's state, kept from chunk to chunk
        noeol = ctypes.c_int(0)              # Group 3 read without EOLs
        runs = np.zeros(load_fax().fax_runs_size(cw), np.uint32)
    compat = (compression == _LZW and len(first) == 2 and first[0] == 0
              and first[1] & 1 == 1)
    for plane in range(planes):
        for i in range(across * down):
            k = plane * across * down + i
            ty, tx = divmod(i, across)
            rows = ch if tiled else min(ch, h - ty * ch)
            chunk = data[offsets[k]:offsets[k] + counts[k]]
            # TIFFFillStrip fails on a chunk past the file's end or of no
            # bytes: no image where it is the first plane's (libtiff's RGBA
            # reader has no buffer yet), zeros where it is a later plane's
            lost = len(chunk) < counts[k] or (counts[k] == 0
                                               and compression != _JPEG)
            if lost and (plane == 0 or compression == _JPEG):
                raise ValueError("TIFF: a strip or tile past the file's end")
            if lost:
                chunk = b""
            if reverse:
                chunk = _REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
            if compression in _FAX:
                raw = np.zeros(rows * row_bytes, np.uint8)
                kind = _FAX[compression]
                if compression == 3 and one("t4_options", 0) & 1:
                    kind = 3                      # two-dimensional rows
                load_fax().fax_decode(chunk, len(chunk), _u8(raw), rows, cw,
                                      row_bytes, kind, int(lsb_first),
                                      offsets[k], ctypes.byref(noeol),
                                      runs.ctypes.data_as(
                                          ctypes.POINTER(ctypes.c_uint32)))
                block = _samples(raw, rows, cw, cspp, bits, e)
            elif compression == _JPEG:
                block = _jpeg_chunk(chunk, tables, colour, rows, cw,
                                    not tiled and ty == down - 1)[..., :cspp]
            elif (hs, vs) != (1, 1):
                raw, _ = _inflate(chunk, compression,
                                  -(-rows // vs) * unit_bytes, compat)
                block = _units(raw, rows, cw, hs, vs,
                               (w - tx * cw) if tiled else 0)
            else:
                raw, ok = _inflate(chunk, compression, rows * row_bytes,
                                   compat)
                # a chunk that failed gets neither the predictor nor the
                # byte swap (libtiff's post-decode step): its 16-bit
                # samples read in the host's order
                order = e if ok else "<"
                if lib is not None and ok:
                    lib.tiff_predict(_u8(raw), rows, cw * cspp, cspp, bits,
                                     int(e == ">"))
                block = _samples(raw, rows, cw, cspp, bits, order)
            sl = (slice(ty * ch, ty * ch + rows), slice(tx * cw, tx * cw + cw))
            if planar == 2:
                s[sl + (plane,)] = block[..., 0]
            else:
                s[sl] = block
    img = _to_rgb(s[:h, :w], f, photometric, bits)
    if orientation in (2, 3):
        # libtiff mirrors each tile's columns within the tile (a strip is
        # the image's width)
        img = np.concatenate([img[:, x:x + cw][:, ::-1]
                              for x in range(0, w, cw)], axis=1)
    if orientation in (3, 4):
        img = img[::-1]
    return np.ascontiguousarray(img)
