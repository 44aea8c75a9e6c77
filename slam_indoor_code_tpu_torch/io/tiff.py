"""TIFF photos without libtiff: the first image directory parsed here,
its strips or tiles inflated by Python's ``zlib`` (Deflate, 8 and 32946)
or decoded by ``native/tiff.cpp`` (LZW, PackBits, the horizontal
predictor), and the samples converted to RGB as libtiff 4.7's RGBA
interface converts them for OpenCV's ``imread`` in colour:

- classic and BigTIFF, II and MM byte orders, strips and tiles, chunky
  and planar layout, compression none, LZW, Deflate and PackBits, with or
  without Predictor 2;
- MinIsBlack and MinIsWhite at 1, 2, 4, 8 and 16 bits (16-bit: the high
  byte; MinIsWhite inverted), Palette at 1, 2, 4 and 8 bits (a colour map
  with an entry of 256 or more is taken as 16-bit and shifted down by 8),
  RGB at 8 and 16 bits (16-bit samples scaled by ``(v + 128) // 257``);
- extra samples dropped; RGB with unassociated alpha (ExtraSamples 2) is
  premultiplied by it, ``(v * a + 127) // 255``, as libtiff does;
- the Orientation tag: 2 mirrors each strip or tile left to right (a
  tile within itself, as libtiff's tile reader does), 4 mirrors the image
  top to bottom, 3 does both; at 5-8 OpenCV's ``imread`` gives no image,
  and neither does this reader.

JPEG-compressed TIFF (6, 7), other compressions (CCITT, ...), YCbCr, CMYK
and CIE Lab images and floating-point samples raise
``NotImplementedError`` naming them; a file libtiff would refuse raises
``ValueError``.  Only the first page of a multi-page file is read.

The library is built at first use with ``g++ -O2 -fPIC -shared`` into
``_build/`` inside the package (ignored by git).  If the build fails,
every decode of a compressed file raises with the compiler's message.
The calls release the GIL.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared
from .png import MAX_PIXELS

SOURCE = _PKG_DIR / "native" / "tiff.cpp"
LIBRARY = _PKG_DIR / "_build" / "libtiffdec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()

_NONE, _LZW, _DEFLATE, _DEFLATE_OLD, _PACKBITS = 1, 5, 8, 32946, 32773
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                 6: "old-style JPEG", 7: "JPEG", 32809: "ThunderScan",
                 34712: "JPEG 2000", 34925: "LZMA", 50000: "Zstandard",
                 50001: "WebP", 34887: "LERC"}
_PHOTOMETRICS = {5: "CMYK", 6: "YCbCr", 8: "CIE Lab", 9: "ICC Lab",
                 10: "ITU Lab", 32844: "LogL", 32845: "LogLuv"}
# tag -> name
_TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
         262: "photometric", 273: "strip_offsets", 274: "orientation",
         277: "spp", 278: "rows_per_strip", 279: "strip_counts",
         284: "planar", 317: "predictor", 320: "colormap",
         322: "tile_width", 323: "tile_height", 324: "tile_offsets",
         325: "tile_counts", 338: "extra", 339: "sample_format"}
# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 13: ("I", 4),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}


def load() -> ctypes.CDLL:
    """The codec library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def _bind(lib: ctypes.CDLL) -> None:
    I, I64, U8 = ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    for name in ("tiff_lzw", "tiff_packbits"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, I64, U8, I64]
        fn.restype = I64
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
            if tag not in _TAGS or ftype not in _TYPES:
                continue
            code, size = _TYPES[ftype]
            where = p + (12 if big else 8)
            if n * size > inline:
                where = struct.unpack_from(e + ("Q" if big else "I"), data,
                                           where)[0]
            fields[_TAGS[tag]] = struct.unpack_from(f"{e}{n}{code}", data,
                                                    where)
    except struct.error as err:
        raise ValueError("TIFF: directory cut short") from err
    return fields, e


def _inflate(chunk: bytes, compression: int, size: int) -> np.ndarray:
    """A strip's or tile's ``size`` bytes; ``ValueError`` if it gives
    fewer."""
    if compression == _NONE:
        raw = np.frombuffer(chunk, np.uint8)
    elif compression in (_DEFLATE, _DEFLATE_OLD):
        try:
            raw = np.frombuffer(zlib.decompressobj().decompress(chunk, size),
                                np.uint8)
        except zlib.error as err:
            raise ValueError(f"TIFF: {err}") from err
    else:
        raw = np.empty(size, np.uint8)
        fn = load().tiff_lzw if compression == _LZW else load().tiff_packbits
        got = fn(chunk, len(chunk), _u8(raw), size)
        raw = raw[:max(got, 0)]
    if raw.size < size:
        raise ValueError("TIFF: a strip or tile decodes short")
    return raw[:size]


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
    rgb = s[..., :3].astype(np.int32)
    if bits == 16:
        rgb = (rgb + 128) // 257
    extra = f.get("extra", ())
    if s.shape[2] > 3 and extra[:1] == (2,):     # unassociated alpha
        a = s[..., 3:4].astype(np.int32)
        if bits == 16:
            a = (a + 128) // 257
        rgb = (rgb * a + 127) // 255
    return rgb.astype(np.uint8)


def decode(data: bytes) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of the first page of the TIFF ``data``; None where
    OpenCV gives no image for a file it opens (Orientation 5-8)."""
    f, e = _directory(data)

    def one(name, default=None):
        v = f.get(name)
        return v[0] if v else default

    w, h = one("width", 0), one("height", 0)
    spp = one("spp", 1)
    bits_all = f.get("bits", (1,))
    bits = bits_all[0]
    compression = one("compression", _NONE)
    photometric = one("photometric")
    planar = one("planar", 1)
    # libtiff's LZW and Deflate codecs undo the predictor; the others
    # ignore the tag
    predictor = (one("predictor", 1)
                 if compression in (_LZW, _DEFLATE, _DEFLATE_OLD) else 1)
    if compression in _COMPRESSIONS:
        raise NotImplementedError(f"{_COMPRESSIONS[compression]}-compressed"
                                  " TIFF photos are not read by the port")
    if compression not in (_NONE, _LZW, _DEFLATE, _DEFLATE_OLD, _PACKBITS):
        raise NotImplementedError(f"TIFF photos of compression {compression}"
                                  " are not read by the port")
    if photometric in _PHOTOMETRICS:
        raise NotImplementedError(f"{_PHOTOMETRICS[photometric]} TIFF photos"
                                  " are not read by the port")
    if one("sample_format", 1) == 3:
        raise NotImplementedError("floating-point TIFF photos are not read "
                                  "by the port")
    if photometric is None:
        photometric = 2 if spp >= 3 else 1
    if not (0 < w * h <= MAX_PIXELS and photometric in (0, 1, 2, 3)
            and len(set(bits_all)) == 1 and planar in (1, 2)
            and (bits in (8, 16) if photometric == 2
                 else bits in ((1, 2, 4, 8) if photometric == 3
                               else (1, 2, 4, 8, 16)))
            and spp >= (3 if photometric == 2 else 1)
            and predictor in (1, 2)
            and (predictor == 1 or bits in (8, 16))):
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
    else:
        cw, ch = w, min(one("rows_per_strip", h) or h, h)
        offsets, counts = f.get("strip_offsets", ()), f.get("strip_counts",
                                                            ())
    across, down = -(-w // cw), -(-h // ch)
    planes = spp if planar == 2 else 1
    cspp = 1 if planar == 2 else spp             # samples per chunk pixel
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise ValueError("TIFF: too few strips or tiles")
    row_bytes = (cw * cspp * bits + 7) // 8
    s = np.zeros((down * ch, across * cw, spp),
                 np.uint16 if bits == 16 else np.uint8)
    lib = load() if predictor == 2 else None
    for plane in range(planes):
        for i in range(across * down):
            k = plane * across * down + i
            ty, tx = divmod(i, across)
            rows = ch if tiled else min(ch, h - ty * ch)
            chunk = data[offsets[k]:offsets[k] + counts[k]]
            raw = _inflate(chunk, compression, rows * row_bytes).copy()
            if lib is not None:
                lib.tiff_predict(_u8(raw), rows, cw * cspp, cspp, bits,
                                 int(e == ">"))
            block = _samples(raw, rows, cw, cspp, bits, e)
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
