"""HuffYUV and FFVHuff video decoding without FFmpeg: a ctypes binding of
``native/huffyuv.cpp``, which needs nothing but the C++ standard library
(io/native.py's ``LosslessDecoder``).

The decoder gives FFmpeg's ``huffyuv``/``ffvhuff`` decode bit for bit:
the code-length tables of the extradata (HuffYUV 2.x and FFVHuff) and
FFVHuff's tables in every frame (context 1); version 2 streams in YUV
4:2:2 and 4:2:0 and in RGB24 and RGBA (coded bottom-up, green-based
decorrelation), each with left, gradient or median prediction (median not
for RGB) and the interlaced stride; version 3 (FFVHuff) planar gray and
YCbCr.  OpenCV's ``HFYU`` writer codes RGB24, its ``FFVH`` writer YUV
4:2:0.  The conversion to RGB is OpenCV's (native/lossless_frame.h).
What it does not decode raises ``NotImplementedError`` naming it:
HuffYUV 1.x's classic tables (a stream with no tables in its
extradata), more than 8 bits a sample, planar RGB, alpha planes, median
prediction of RGB, and the layouts whose conversion it does not
reproduce.  A packet FFmpeg's decoder refuses gives None and sets
``failed``.

Built at first use with ``g++ -O2 -fPIC -shared`` into ``_build/`` inside
the package (ignored by git); if the build fails, every decoder raises
with the compiler's message.  One decoder reads one stream on one thread
at a time.
"""

from __future__ import annotations

import ctypes
import threading

from .native import _PKG_DIR, LosslessDecoder, bind_lossless, load_shared

SOURCE = _PKG_DIR / "native" / "huffyuv.cpp"
HEADERS = tuple(_PKG_DIR / "native" / h
                for h in ("lossless_frame.h", "swscale_rgb.h"))
LIBRARY = _PKG_DIR / "_build" / "libhuffyuvdec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_STATS = ("version", "predictor", "decorrelate", "bitstream_bpp",
          "interlaced", "context", "yuv", "chroma", "chroma_h_shift",
          "chroma_v_shift", "frames", "table_frames", "plane_rows",
          "median_rows")


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind, HEADERS)


def _bind(lib: ctypes.CDLL) -> None:
    bind_lossless(lib, "huffyuvdec", (ctypes.c_int,))


class Decoder(LosslessDecoder):
    """One HuffYUV or FFVHuff stream: ``Decoder(extradata, width, height,
    bits_per_coded_sample)`` with the container's bits a pixel, which
    tells HuffYUV 1.x streams apart.  ``stats()`` gives the stream's
    parameters (version 2 or 3; predictor: 0 left, 1 gradient, 2 median;
    RGB decorrelation; bits a pixel of a version 2 stream; interlaced;
    tables in every frame; YUV, chroma planes and their shifts) and what
    it has read so far: frames, frames with their own tables, rows
    predicted by gradient and by median."""

    _prefix = "huffyuvdec"
    _stats = _STATS
    _load = staticmethod(load)
