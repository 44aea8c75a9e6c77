"""JPEG 2000 photos (a JP2 file or a raw J2K/J2C codestream) without
OpenJPEG or OpenCV: ``native/jp2.cpp`` decodes the components as OpenJPEG
2.5.3 decodes them, and this module turns them into 8-bit RGB as OpenCV
5.0's ``imread`` does (grfmt_jpeg2000_openjpeg.cpp):

- at the header (the codestream's SIZ components, before any palette):
  1 to 4 components, none signed, the widest at least 8 bits; the colour
  space from the JP2 ``colr`` box (sRGB, grey or sYCC; a raw codestream
  or an unknown space is taken as sRGB; eYCC and CMYK give no image);
- after the decode (palette and channel definitions applied): each
  component the image's full size with no subsampling or offset;
- each sample shifted right by the widest header precision less 8, its
  low byte kept; in the grey space the first component is grey, in sRGB
  (or an unknown space) three or more components are R, G, B (alpha
  dropped) and fewer give no image; sYCC's three go through OpenCV's
  8-bit YUV to BGR conversion.

Anything else gives None, as ``imread`` gives an empty image.  The
code-block styles other than 0 and HTJ2K raise ``NotImplementedError``
naming them (io/photo.py passes it on).

The library is built at first use with ``g++ -O2 -fPIC -shared`` into
``_build/`` inside the package (ignored by git).  If the build fails,
every decode raises with the compiler's message.  The calls release the
GIL; the decoder starts no threads of its own.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .native import _PKG_DIR, load_shared

MAGICS = (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \r\n\x87\n")
SOURCE = _PKG_DIR / "native" / "jp2.cpp"
LIBRARY = _PKG_DIR / "_build" / "libjp2dec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_MSG_LEN = 256
# OpenCV's YUV -> RGB coefficients (<< 14): R from V, G from V and U, B
# from U
_YUV_R, _YUV_GV, _YUV_GU, _YUV_B = 18678, -9519, -6472, 33292


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.POINTER, ctypes.c_int, ctypes.c_int64
    lib.jp2dec_decode.argtypes = [ctypes.c_char_p, I64, P(I),
                                  ctypes.c_char_p, I]
    lib.jp2dec_decode.restype = ctypes.c_void_p
    lib.jp2dec_info.argtypes = [ctypes.c_void_p, P(ctypes.c_int32), I]
    lib.jp2dec_info.restype = I
    lib.jp2dec_component.argtypes = [ctypes.c_void_p, I, P(ctypes.c_int32)]
    lib.jp2dec_component.restype = None
    lib.jp2dec_free.argtypes = [ctypes.c_void_p]
    lib.jp2dec_free.restype = None


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def components(data: bytes) -> Optional[tuple[int, list[dict]]]:
    """OpenJPEG's decode of ``data``: (colour space as OPJ_COLOR_SPACE, -1
    unknown .. 5 CMYK; the components, each a dict of ``data`` [h, w]
    int32, dx, dy, x0, y0, prec, sgnd, alpha); None where OpenJPEG fails.
    """
    lib = load()
    status = ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    handle = lib.jp2dec_decode(data, len(data), ctypes.byref(status), msg,
                               _MSG_LEN)
    if not handle:
        if status.value == 2:
            raise NotImplementedError(
                f"{msg.value.decode(errors='replace')} are not read by the "
                "port")
        return None
    try:
        need = -lib.jp2dec_info(handle, _i32(np.empty(1, np.int32)), 0)
        info = np.empty(need, np.int32)
        lib.jp2dec_info(handle, _i32(info), need)
        comps = []
        for c in range(int(info[0])):
            w, h, dx, dy, x0, y0, prec, sgnd, alpha = (
                int(v) for v in info[2 + 9 * c:11 + 9 * c])
            plane = np.empty((h, w), np.int32)
            lib.jp2dec_component(handle, c, _i32(plane))
            comps.append({"data": plane, "dx": dx, "dy": dy, "x0": x0,
                          "y0": y0, "prec": prec, "sgnd": sgnd,
                          "alpha": alpha})
        return int(info[1]), comps
    finally:
        lib.jp2dec_free(handle)


def _header(data: bytes) -> Optional[list[tuple[int, int]]]:
    """The (precision, signed) of each SIZ component, as OpenCV's
    ``readHeader`` sees them (before a palette is applied)."""
    at = data.find(b"\xff\x4f\xff\x51")
    if at < 0 or len(data) < at + 42:
        return None
    nc = int.from_bytes(data[at + 40:at + 42], "big")
    if len(data) < at + 42 + 3 * nc:
        return None
    return [((data[at + 42 + 3 * c] & 0x7f) + 1, data[at + 42 + 3 * c] >> 7)
            for c in range(nc)]


def _yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """OpenCV's COLOR_YUV2BGR on 8-bit samples, as RGB."""
    y, u, v = (yuv[..., k].astype(np.int32) for k in range(3))
    u, v = u - 128, v - 128
    half = 1 << 13
    r = y + ((v * _YUV_R + half) >> 14)
    g = y + ((v * _YUV_GV + u * _YUV_GU + half) >> 14)
    b = y + ((u * _YUV_B + half) >> 14)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> Optional[np.ndarray]:
    """HxWx3 uint8 RGB of the JPEG 2000 ``data`` as ``cv2.imread`` gives
    it; None where it gives no image; ``NotImplementedError`` naming a
    coding tool the port does not read."""
    head = _header(data)
    if head is None or not 1 <= len(head) <= 4 or any(s for _, s in head):
        return None
    max_prec = max(p for p, _ in head)
    if max_prec < 8:
        return None
    got = components(data)
    if got is None:
        return None
    space, comps = got
    if space not in (-1, 0, 1, 2, 3):
        return None
    h, w = comps[0]["data"].shape
    for c in comps:
        if (c["dx"], c["dy"], c["x0"], c["y0"]) != (1, 1, 0, 0) or \
                c["data"].shape != (h, w):
            return None
    shift = max_prec - 8

    def plane(k):    # OpenCV's cast to 8 bits keeps the low byte
        return (comps[k]["data"] >> shift).astype(np.uint8)

    if space == 2:
        return np.repeat(plane(0)[..., None], 3, axis=2)
    if len(comps) < 3:       # sRGB or sYCC from one or two components
        return None
    rgb = np.stack([plane(0), plane(1), plane(2)], axis=-1)
    return _yuv_to_rgb(rgb) if space == 3 else rgb
