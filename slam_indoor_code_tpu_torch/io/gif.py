"""GIF photos without giflib or OpenCV: a ctypes binding of
``native/gif.cpp``, which walks the file to its trailer and decodes its
first image as OpenCV 5.0's own GIF decoder gives it to ``imread`` in
colour: the logical screen filled with the global colour table's
background entry (black without a global table), the first image drawn at
its offset in its local or the global colours (without either, a gray
ramp whose index 1 is white), its rows in their four
passes when interlaced, and the pixels of its Graphic Control Extension's
transparency index left at the background.  LZW with minimum code sizes
2-11, clear and end codes and a table that stops at 4096 entries is read
as OpenCV reads it.  A damaged or truncated file raises ``ValueError``
(OpenCV gives no image).

The library is built at first use with ``g++ -O2 -fPIC -shared`` into
``_build/`` inside the package (ignored by git).  If the build fails,
every decode raises with the compiler's message.  The calls release the
GIL.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .native import _PKG_DIR, load_shared

MAGICS = (b"GIF87a", b"GIF89a")
SOURCE = _PKG_DIR / "native" / "gif.cpp"
LIBRARY = _PKG_DIR / "_build" / "libgifdec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.POINTER, ctypes.c_int, ctypes.c_int64
    lib.gif_info.argtypes = [ctypes.c_char_p, I64, P(I), P(I)]
    lib.gif_info.restype = I
    lib.gif_rgb.argtypes = [ctypes.c_char_p, I64,
                            ctypes.POINTER(ctypes.c_uint8)]
    lib.gif_rgb.restype = I


def decode(data: bytes) -> np.ndarray:
    """HxWx3 uint8 RGB of the GIF ``data``'s first image on its logical
    screen; ``ValueError`` where OpenCV gives no image."""
    lib = load()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.gif_info(data, len(data), ctypes.byref(w), ctypes.byref(h)):
        raise ValueError("GIF: damaged or truncated file")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.gif_rgb(data, len(data),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))):
        raise ValueError("GIF: the first image's data does not decode")
    return out
