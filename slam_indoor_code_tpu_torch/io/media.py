"""In-memory frame source (copy of ``ArraySource`` from the JAX package's
io/media.py).  File-path media (photo globs, video) needs the native decoder
and OpenCV and is not part of this port yet (ROADMAP)."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


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
