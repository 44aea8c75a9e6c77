"""FFV1 video decoding without FFmpeg: a ctypes binding of
``native/ffv1.cpp``, which needs nothing but the C++ standard library
(io/native.py's ``LosslessDecoder``, which io/huffyuv.py shares).

The decoder gives FFmpeg's ``ffv1`` decode bit for bit (RFC 9043):
versions 0 and 1 (headers in the key frames), 2 and 3 (a configuration
record in the container's extradata, checked by its CRC-32 in version 3,
slices with headers, footers and CRCs), the range coder with the default
or a custom state-transition table and Golomb-Rice coding with run mode,
the small and large context models, key frames and the frames between
them.  8-bit YCbCr (gray, 4:2:0, 4:2:2 and the other subsamplings, with
or without alpha) and RGB (JPEG 2000's reversible colour transform, with
or without alpha: OpenCV's ``FFV1`` writer codes BGRA) are decoded; the
conversion to RGB is OpenCV's (native/lossless_frame.h), and a layout
whose conversion it does not reproduce raises ``NotImplementedError``
naming it, as do more than 8 bits a sample, colour spaces other than
YCbCr and RGB (Bayer) and version 4.  A frame FFmpeg's decoder refuses
gives None and sets ``failed``, which ends a stream where OpenCV's reader
ends it; a version 3 slice whose CRC or end does not check is replaced by
the previous frame's pixels, as FFmpeg replaces it.  Pixels FFmpeg leaves
unwritten (a slice whose data runs out, with no previous frame to take)
are zeros here, and ``Decoder.defined`` tells them.

Built at first use with ``g++ -O2 -fPIC -shared`` into ``_build/`` inside
the package (ignored by git).  If the build fails, every decoder raises
with the compiler's message.  The calls release the GIL.  A decoder keeps
each slice's contexts from one frame to the next, so one decoder reads one
stream, in order, on one thread at a time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .native import _PKG_DIR, LosslessDecoder, bind_lossless, load_shared

SOURCE = _PKG_DIR / "native" / "ffv1.cpp"
HEADERS = tuple(_PKG_DIR / "native" / h
                for h in ("lossless_frame.h", "swscale_rgb.h"))
LIBRARY = _PKG_DIR / "_build" / "libffv1dec.so"
_state: dict = {"lib": None, "error": None}
_LOCK = threading.Lock()
_STATS = ("version", "micro_version", "coder", "ec", "colorspace", "bits",
          "chroma_planes", "chroma_h_shift", "chroma_v_shift",
          "transparency", "large_context", "quant_tables", "frames",
          "key_frames", "slices", "crc_slices", "damaged_slices",
          "concealed_slices", "range_slices", "golomb_slices", "runs",
          "run_pixels")


def load() -> ctypes.CDLL:
    """The decoder library, built on first use; raises with the compiler's
    message when it cannot be built (and on every later call)."""
    return load_shared(_state, _LOCK, SOURCE, LIBRARY, [], _bind, HEADERS)


def _bind(lib: ctypes.CDLL) -> None:
    bind_lossless(lib, "ffv1dec")
    lib.ffv1dec_defined.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
    lib.ffv1dec_defined.restype = ctypes.c_int


class Decoder(LosslessDecoder):
    """One FFV1 stream: ``Decoder(extradata, width, height)`` with the
    configuration record as ``extradata`` (versions 2 and 3; none for 0
    and 1).  ``stats()`` gives the stream's parameters (version, micro
    version, coder: 0 Golomb-Rice, 1 range coder, 2 range coder with a
    custom table; ec: slice CRCs; colorspace: 0 YCbCr, 1 RGB; bits a
    sample; chroma planes and shifts; transparency; the large context
    model; the number of quantisation tables) and what it has read so far:
    frames, key frames, slices, slices checked by CRC, damaged slices,
    slices replaced by the previous frame's, range-coded and Golomb-Rice
    slices, runs and the pixels they covered."""

    _prefix = "ffv1dec"
    _stats = _STATS
    _load = staticmethod(load)

    def defined(self) -> Optional[np.ndarray]:
        """HxW bool: the pixels of the frame last given whose samples the
        decode wrote.  Where a slice's data runs out, its header does not
        parse, or a damaged slice has no frame before it to take, FFmpeg
        stops writing and leaves what its buffer held before (memory that
        other decodes of the process used): those pixels are False here,
        and the frame's RGB has zeros' conversion there.  None before the
        first frame."""
        if self._hw is None:
            return None
        mask = np.empty(self._hw, np.uint8)
        if self._lib.ffv1dec_defined(
                self._handle, mask.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)), mask.nbytes) != 0:
            return None
        return mask.astype(bool)
