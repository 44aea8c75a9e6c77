"""Media ingest (counterpart of the JAX package's io/media.py): a frame
source over a photo glob, and one over in-memory frames.

Photos are globbed, sorted naturally (shorter names first, then
lexicographic, as the reference's ``sortGlobs``, src/misc/IOmisc.cpp:36-51)
and decoded in order by ``threadsCount`` workers a bounded number of frames
ahead: by the native sequence reader (io/native.py, libjpeg/libpng) where
it builds, else by the port's own PNG reader (io/png.py) in a thread pool,
which refuses JPEG.  Video (``usePhotosCycle=false``) needs a video decoder
(the JAX package uses OpenCV's VideoCapture) and is not ported.
"""

from __future__ import annotations

import glob as _glob
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from . import native, png


def natural_sort_paths(paths: list[str]) -> list[str]:
    """Sort photo paths by length first, then lexicographically (which
    sorts ``img2.jpg`` before ``img10.jpg``), as the reference's
    ``sortGlobs`` does."""
    return sorted(paths, key=lambda p: (len(p), p))


def _imread_rgb(path: str) -> Optional[np.ndarray]:
    """Decode one image to HxWx3 uint8 RGB; None if it does not decode.
    Without the native decoder a JPEG raises, naming libjpeg."""
    if native.available():
        return native.imread_rgb(path)
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic == png.SIGNATURE:
        try:
            return png.read_png(path)
        except (ValueError, OSError):
            return None
    if magic[:2] == b"\xff\xd8":
        raise RuntimeError(
            f"{path}: decoding JPEG needs libjpeg, and the native decoder "
            f"did not build:\n{native.build_error()}")
    return None


class _PooledSequence:
    """In-order photo reader over ``_imread_rgb`` in a thread pool, at most
    ``capacity`` frames ahead; undecodable frames are skipped, as the
    native reader skips them."""

    def __init__(self, paths: list[str], capacity: int, threads: int):
        self._paths = deque(paths)
        self._pool = ThreadPoolExecutor(max_workers=threads)
        self._ahead: deque = deque()
        self._capacity = capacity
        self._top_up()

    def _top_up(self) -> None:
        while self._paths and len(self._ahead) < self._capacity:
            self._ahead.append(self._pool.submit(_imread_rgb,
                                                 self._paths.popleft()))

    def next_frame(self) -> Optional[np.ndarray]:
        while self._ahead:
            img = self._ahead.popleft().result()
            self._top_up()
            if img is not None:
                return img
        self.close()
        return None

    def close(self) -> None:
        for fut in self._ahead:
            fut.cancel()
        self._ahead.clear()
        self._pool.shutdown(wait=True)


class MediaSource:
    """Destructive frame iterator over a photo glob."""

    def __init__(self, *, photos_pattern: str = "", video_path: str = "",
                 use_photos: bool = True, prefetch: int = 8,
                 threads: int = 2):
        if not use_photos:
            raise NotImplementedError(
                f"video media ({video_path!r}, usePhotosCycle=false) needs a "
                "video decoder (OpenCV's VideoCapture in the JAX package), "
                "and none runs on the card: pass a photo glob")
        self._paths = natural_sort_paths(_glob.glob(photos_pattern))
        capacity, threads = max(1, prefetch), max(1, threads)
        if native.available() and self._paths:
            self._reader = native.NativeSequence(self._paths, capacity,
                                                 threads)
        else:
            self._reader = _PooledSequence(self._paths, capacity, threads)

    def next_frame(self) -> Optional[np.ndarray]:
        """Pop the next frame, or None when the sequence is over (the
        reference's ``getNextFrame`` returning false)."""
        return self._reader.next_frame()

    def close(self) -> None:
        self._reader.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.next_frame()
            if f is None:
                return
            yield f


class ArraySource:
    """A MediaSource-compatible frame source over an in-memory array/list of
    frames — used by tests, benchmarks, and synthetic scenes."""

    def __init__(self, frames):
        self._frames = list(frames)
        self._i = 0

    def next_frame(self) -> Optional[np.ndarray]:
        if self._i >= len(self._frames):
            return None
        f = self._frames[self._i]
        self._i += 1
        return np.asarray(f)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.next_frame()
            if f is None:
                return
            yield f
