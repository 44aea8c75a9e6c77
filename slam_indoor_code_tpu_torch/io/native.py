"""ctypes binding of the native host-IO decoder (``native/slamio.cpp``, a
copy of the repository's ``native/slamio.cpp``): libjpeg/libpng decode and
an N-worker prefetching, in-order sequence reader.

Built at first use with ``g++ -O2 -fPIC -shared … -ljpeg -lpng -lpthread``
into ``_build/libslamio.so`` inside the package (ignored by git).  Where the
build fails (a machine without the libjpeg or libpng headers), ``load``
raises with the compiler's message and ``available`` is False; media.py
then decodes PNG with its own reader (io/png.py) and refuses JPEG.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "native" / "slamio.cpp"
LIBRARY = _PKG_DIR / "_build" / "libslamio.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()     # threads of run_sequences_parallel build once


def _build() -> None:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f".libslamio.{os.getpid()}.so")
    cmd = ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", str(tmp),
           str(SOURCE), "-ljpeg", "-lpng", "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"(g++ rc={res.returncode}):\n"
                           f"{res.stderr.strip()}")
    os.replace(tmp, LIBRARY)


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    with _LOCK:
        return _load()


def _load() -> ctypes.CDLL:
    if _state["lib"] is not None:
        return _state["lib"]
    if _state["error"] is not None:
        raise RuntimeError(_state["error"])
    try:
        if (not LIBRARY.exists()
                or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime):
            _build()
        lib = ctypes.CDLL(str(LIBRARY))
    except (RuntimeError, OSError) as e:
        _state["error"] = str(e)
        raise RuntimeError(_state["error"]) from e
    P, I = ctypes.POINTER, ctypes.c_int
    lib.slamio_decode_dims.argtypes = [ctypes.c_char_p, P(I), P(I)]
    lib.slamio_decode_dims.restype = I
    lib.slamio_decode.argtypes = [ctypes.c_char_p, P(ctypes.c_uint8),
                                  ctypes.c_int64, P(I), P(I)]
    lib.slamio_decode.restype = I
    lib.slamio_open_sequence.argtypes = [P(ctypes.c_char_p), I, I, I]
    lib.slamio_open_sequence.restype = ctypes.c_void_p
    lib.slamio_next.argtypes = [ctypes.c_void_p, P(ctypes.c_uint8),
                                ctypes.c_int64, P(I), P(I)]
    lib.slamio_next.restype = I
    lib.slamio_close.argtypes = [ctypes.c_void_p]
    lib.slamio_close.restype = None
    _state["lib"] = lib
    return lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def build_error() -> Optional[str]:
    """The compiler's message of a failed build (None if it built)."""
    return None if available() else _state["error"]


def imread_rgb(path: str) -> Optional[np.ndarray]:
    """Decode one image to HxWx3 uint8 RGB; None if it does not decode."""
    lib = load()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.slamio_decode_dims(path.encode(), ctypes.byref(h),
                              ctypes.byref(w)) != 0:
        return None
    buf = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.slamio_decode(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.nbytes, ctypes.byref(h), ctypes.byref(w))
    return buf if rc == 0 else None


class NativeSequence:
    """Prefetching in-order photo-sequence reader (MediaSource-compatible):
    ``threads`` decode workers at most ``capacity`` frames ahead."""

    def __init__(self, paths: list[str], capacity: int = 8, threads: int = 2):
        lib = load()
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.slamio_open_sequence(arr, len(self._paths),
                                                capacity, threads)
        if not self._handle:
            raise RuntimeError("slamio_open_sequence failed")
        # the sequence's frames share the first one's size (as the
        # reference assumes)
        h, w = ctypes.c_int(), ctypes.c_int()
        if paths and lib.slamio_decode_dims(self._paths[0], ctypes.byref(h),
                                            ctypes.byref(w)) == 0:
            self._hw = (h.value, w.value)
        else:
            self._hw = (0, 0)

    def next_frame(self) -> Optional[np.ndarray]:
        if self._handle is None:
            return None
        h, w = ctypes.c_int(), ctypes.c_int()
        cap = max(self._hw[0] * self._hw[1] * 3, 1)
        buf = np.empty(cap, np.uint8)
        while True:
            rc = self._lib.slamio_next(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                ctypes.byref(h), ctypes.byref(w))
            if rc == 1:
                return buf[: h.value * w.value * 3].reshape(
                    h.value, w.value, 3).copy()
            if rc == -1:
                continue  # undecodable frame skipped
            if rc == -2:
                cap *= 4
                buf = np.empty(cap, np.uint8)
                continue
            return None  # end

    def close(self):
        if self._handle:
            self._lib.slamio_close(self._handle)
            self._handle = None

    def __iter__(self):
        while True:
            f = self.next_frame()
            if f is None:
                return
            yield f

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
