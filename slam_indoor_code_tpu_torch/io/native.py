"""ctypes binding of the native host-IO decoder (``native/slamio.cpp``, a
copy of the repository's ``native/slamio.cpp``): libjpeg/libpng decode and
an N-worker prefetching, in-order sequence reader.

Built at first use with ``g++ -O2 -fPIC -shared … -ljpeg -lpng -lpthread``
into ``_build/libslamio.so`` inside the package (ignored by git).  Where the
build fails (a machine without the libjpeg or libpng headers), ``load``
raises with the compiler's message and ``available`` is False; media.py
then decodes PNG and JPEG with the port's own readers (io/png.py,
io/jpeg.py).

``LosslessDecoder`` is the ctypes binding the two lossless video decoders
share (io/ffv1.py over ``native/ffv1.cpp``, io/huffyuv.py over
``native/huffyuv.cpp``): both libraries give the same C entry points.
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


def compile_shared(source: Path, library: Path, libs: list[str]) -> None:
    """``g++ -O2 -fPIC -shared`` of ``source`` into ``library`` through a
    temporary file (so that a reader never loads half a library); raises
    with the compiler's message when it fails."""
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f".{library.stem}.{os.getpid()}.so")
    cmd = ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", str(tmp),
           str(source), *libs]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"building {source.name}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"building {source.name} failed "
                           f"(g++ rc={res.returncode}):\n"
                           f"{res.stderr.strip()}")
    os.replace(tmp, library)


def load_shared(state: dict, lock: threading.Lock, source: Path,
                library: Path, libs: list[str], bind,
                headers: tuple[Path, ...] = ()) -> ctypes.CDLL:
    """The library ``source`` builds, built on first use (or when older
    than its source or one of the ``headers`` it includes) and bound by
    ``bind(lib)``; ``state`` caches it, or the compiler's message, which
    every later call raises again."""
    with lock:
        if state["lib"] is not None:
            return state["lib"]
        if state["error"] is not None:
            raise RuntimeError(state["error"])
        try:
            newest = max(p.stat().st_mtime for p in (source, *headers))
            if (not library.exists()
                    or library.stat().st_mtime < newest):
                compile_shared(source, library, libs)
            lib = ctypes.CDLL(str(library))
        except (RuntimeError, OSError) as e:
            state["error"] = str(e)
            raise RuntimeError(state["error"]) from e
        bind(lib)
        state["lib"] = lib
        return lib


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY,
                       ["-ljpeg", "-lpng", "-lpthread"], _bind)


def _bind(lib: ctypes.CDLL) -> None:
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


# ------------------------------------------------ lossless video decoders

_MSG_LEN = 256
_FRAME, _REFUSED, _FAILED = 0, 2, 3      # the decoders' return codes


def bind_lossless(lib: ctypes.CDLL, prefix: str, open_args=()) -> None:
    """The argument types of a lossless decoder library whose functions
    are ``<prefix>_open`` (extradata, its size, width, height,
    ``open_args``...), ``_decode``, ``_rgb``, ``_plane``, ``_stats`` and
    ``_close``."""
    P, I, I64, U8 = (ctypes.POINTER, ctypes.c_int, ctypes.c_int64,
                     ctypes.POINTER(ctypes.c_uint8))
    for name, args, res in (
            ("open", [ctypes.c_char_p, I64, I, I, *open_args,
                      P(ctypes.c_void_p), ctypes.c_char_p, I], I),
            ("decode", [ctypes.c_void_p, ctypes.c_char_p, I64, P(I), P(I),
                        ctypes.c_char_p, I], I),
            ("rgb", [ctypes.c_void_p, U8, I64, ctypes.c_char_p, I], I),
            ("plane", [ctypes.c_void_p, I, U8, I64, P(I), P(I)], I),
            ("stats", [ctypes.c_void_p, P(ctypes.c_int64), I], I),
            ("close", [ctypes.c_void_p], None)):
        fn = getattr(lib, f"{prefix}_{name}")
        fn.argtypes = args
        fn.restype = res


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _raise(rc: int, msg) -> None:
    text = msg.value.decode(errors="replace")
    if rc == _REFUSED:
        raise NotImplementedError(text)
    raise ValueError(text)


class LosslessDecoder:
    """A lossless stream of ``width`` x ``height`` frames (the container's
    size: neither codec codes it) with its ``extradata``, each packet a
    frame; ``failed`` tells whether the last packet gave no frame (and
    ``reason`` why).  Subclasses name the library (``_load``), its
    function prefix (``_prefix``) and its statistics (``_stats``)."""

    failed = False
    reason = ""
    _prefix = ""
    _stats: tuple = ()
    _handle = None

    def __init__(self, extradata: bytes, width: int, height: int,
                 *open_args):
        self._lib = self._load()
        self._fn = {k: getattr(self._lib, f"{self._prefix}_{k}")
                    for k in ("open", "decode", "rgb", "plane", "stats",
                              "close")}
        self._handle = ctypes.c_void_p()
        self._hw = None
        msg = ctypes.create_string_buffer(_MSG_LEN)
        rc = self._fn["open"](extradata, len(extradata), width, height,
                              *open_args, ctypes.byref(self._handle), msg,
                              _MSG_LEN)
        if rc != _FRAME:
            _raise(rc, msg)

    @staticmethod
    def _load() -> ctypes.CDLL:
        raise NotImplementedError

    def _call(self, sample: bytes) -> Optional[tuple[int, int]]:
        if not self._handle:
            raise ValueError("decoder is closed")
        w, h = ctypes.c_int(), ctypes.c_int()
        msg = ctypes.create_string_buffer(_MSG_LEN)
        rc = self._fn["decode"](self._handle, sample, len(sample),
                                ctypes.byref(w), ctypes.byref(h), msg,
                                _MSG_LEN)
        if rc == _REFUSED:
            _raise(rc, msg)
        self.failed = rc == _FAILED
        self.reason = msg.value.decode(errors="replace") if rc else ""
        if rc != _FRAME:
            self._hw = None
            return None
        self._hw = h.value, w.value
        return self._hw

    def decode(self, sample: bytes) -> Optional[np.ndarray]:
        """HxWx3 uint8 RGB of the frame ``sample`` holds; None when it
        gives none (``failed``)."""
        hw = self._call(sample)
        if hw is None:
            return None
        out = np.empty(hw + (3,), np.uint8)
        msg = ctypes.create_string_buffer(_MSG_LEN)
        rc = self._fn["rgb"](self._handle, _u8(out), out.nbytes, msg,
                             _MSG_LEN)
        if rc != _FRAME:
            _raise(rc, msg)
        return out

    def decode_planes(self, sample: bytes) -> Optional[list]:
        """The planes FFmpeg's decoder gives for ``sample``, each as rows of
        bytes (Y, U, V[, A] for YCbCr; Y, or Y and A interleaved, for gray;
        one B G R A/0 plane for RGB); None as ``decode``."""
        if self._call(sample) is None:
            return None
        h, w = self._hw
        out = []
        for k in range(4):
            buf = np.empty(4 * w * h + 64, np.uint8)
            rb, rows = ctypes.c_int(), ctypes.c_int()
            if self._fn["plane"](self._handle, k, _u8(buf), buf.nbytes,
                                 ctypes.byref(rb),
                                 ctypes.byref(rows)) != _FRAME:
                break
            out.append(buf[:rb.value * rows.value].reshape(
                rows.value, rb.value).copy())
        return out

    def flush(self) -> Optional[np.ndarray]:
        """None: a lossless intra codec holds no frame back."""
        return None

    def stats(self) -> dict:
        if not self._handle:
            raise ValueError("decoder is closed")
        out = (ctypes.c_int64 * len(self._stats))()
        self._fn["stats"](self._handle, out, len(self._stats))
        return dict(zip(self._stats, out))

    def close(self) -> None:
        if self._handle:
            self._fn["close"](self._handle)
            self._handle = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
