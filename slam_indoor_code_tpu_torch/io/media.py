"""Media ingest (counterpart of the JAX package's io/media.py): a frame
source over a photo glob or a video file, and one over in-memory frames.

Photos are globbed, sorted naturally (shorter names first, then
lexicographic, as the reference's ``sortGlobs``, src/misc/IOmisc.cpp:36-51)
and decoded in order by ``threadsCount`` workers a bounded number of frames
ahead: by the native sequence reader (io/native.py, libjpeg/libpng) where
it builds, else by the port's own photo readers (io/photo.py: JPEG, PNG,
BMP, PBM/PGM/PPM/PAM, TIFF (JPEG-compressed, YCbCr, CMYK and CIE Lab
too), JPEG 2000, WebP (lossy, lossless and animated), GIF, PFM, Radiance
HDR and Sun raster, EXIF orientation applied, as
``cv2.imread`` reads them) in a thread pool, which skips a file that does
not decode and passes on the ``NotImplementedError`` of a format it does
not read.  Video (``usePhotosCycle=false``) is opened
by io/avi.py (AVI; MP4 through io/mp4.py; Matroska/WebM through
io/matroska.py; MPEG program and transport streams through io/mpegps.py
and io/mpegts.py; MPEG-1/2 and raw H.263 elementary streams; Flash Video
through io/flv.py): Motion-JPEG, PNG and uncompressed frames are decoded
the same way as photos, each by io/jpeg.py, io/png.py or io/rawvideo.py
(no EXIF orientation, as OpenCV's video readers apply none); MPEG-4 Part
2 (io/mpeg4.py), MPEG-1/2 (io/mpeg12.py), H.263 and Sorenson Spark
(io/h263.py), VP8 (io/vp8.py) and VP9 (io/vp9.py)
frames, each of which
predicts from those before it, and FFV1 (io/ffv1.py) and HuffYUV
(io/huffyuv.py) frames, whose contexts or tables carry from one frame to
the next, in order on one producer thread a bounded number of frames
ahead.  A video ends at its first frame that fails to
decode, where OpenCV's reader stops; a damaged frame that FFmpeg still
gives (a frame whose data ends early) is given too.  The JAX package
reads any codec through OpenCV's VideoCapture, and any photo OpenCV reads
where its native reader does not.
"""

from __future__ import annotations

import glob as _glob
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Generator, Iterator, Optional

import numpy as np

from . import (avi, ffv1, h263, huffyuv, mpeg4, mpeg12, native, photo, vp8,
               vp9)


def natural_sort_paths(paths: list[str]) -> list[str]:
    """Sort photo paths by length first, then lexicographically (which
    sorts ``img2.jpg`` before ``img10.jpg``), as the reference's
    ``sortGlobs`` does."""
    return sorted(paths, key=lambda p: (len(p), p))


def _imread_rgb(path: str) -> Optional[np.ndarray]:
    """Decode one photo to HxWx3 uint8 RGB; None if it does not decode.
    Without the native decoder, io/photo.py reads it (and raises for a
    format it does not read, and when a decoder does not build)."""
    if native.available():
        return native.imread_rgb(path)
    return photo.imread_rgb(path)


class _PooledSequence:
    """In-order reader of ``decode(item)`` over ``items`` in a thread pool,
    at most ``capacity`` frames ahead; undecodable frames (None) are
    skipped, as the native reader and ``cv2.imread`` skip a photo that
    gives no image (a damaged one gives what they give), or, with
    ``stop_on_none``
    (a video), end the sequence, as OpenCV's reader stops at the first
    frame that fails.  An exception of ``decode`` closes the pool and is
    raised by the ``next_frame`` that reaches its frame.  ``on_close``
    runs once the pool has stopped."""

    def __init__(self, items: list, capacity: int, threads: int,
                 decode=_imread_rgb, on_close=None,
                 stop_on_none: bool = False):
        self._items = deque(items)
        self._decode = decode
        self._stop_on_none = stop_on_none
        self._on_close = on_close
        self._pool = ThreadPoolExecutor(max_workers=threads)
        self._ahead: deque = deque()
        self._capacity = capacity
        self._top_up()

    def _top_up(self) -> None:
        while self._items and len(self._ahead) < self._capacity:
            self._ahead.append(self._pool.submit(self._decode,
                                                 self._items.popleft()))

    def next_frame(self) -> Optional[np.ndarray]:
        while self._ahead:
            try:
                img = self._ahead.popleft().result()
            except BaseException:
                self.close()
                raise
            if img is not None:
                self._top_up()
                return img
            if self._stop_on_none:
                break
            self._top_up()
        self.close()
        return None

    def close(self) -> None:
        for fut in self._ahead:
            fut.cancel()
        self._ahead.clear()
        self._items.clear()
        self._pool.shutdown(wait=True)
        if self._on_close is not None:
            self._on_close()
            self._on_close = None


def _decoded(video, dec) -> Generator[np.ndarray, None, None]:
    """The shown frames of ``video`` in display order, each predicting from
    those before it in decode order, decoded by ``dec`` (which it closes).
    An MPEG-4 or MPEG-1/2 decoder gives each frame with the tag of the
    sample it was decoded from, whose container flag (an MP4 edit) tells
    whether it is shown, and holds the last reference of a stream with B
    pictures back until ``flush``; a VP8, VP9, H.263, FFV1 or HuffYUV
    frame is its own sample's.  A frame the
    decoder gives none for, or the container hides, is still decoded; the
    first sample that fails ends the sequence, as OpenCV's reader stops
    there."""
    delayed = isinstance(dec, (mpeg4.Decoder, mpeg12.Decoder))
    try:
        for i, frame in enumerate(video.frames):
            sample = video.read(frame)
            img = dec.decode(sample, i) if delayed else dec.decode(sample)
            if dec.failed:
                return
            if img is not None and video.frames[dec.tag if delayed
                                                else i][2]:
                yield img
        img = dec.flush() if delayed else None
        if img is not None and video.frames[dec.tag][2]:
            yield img
    finally:
        dec.close()


class _ThreadedSequence:
    """In-order reader of the generator ``frames`` on one producer thread, at
    most ``capacity`` frames ahead; an exception of the producer is raised
    by the ``next_frame`` that reaches it.  ``on_close`` runs once the
    producer has stopped."""

    def __init__(self, frames: Generator[np.ndarray, None, None],
                 capacity: int, on_close=None):
        self._queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._on_close = on_close
        self._thread = threading.Thread(target=self._produce, args=(frames,),
                                        daemon=True)
        self._thread.start()

    def _produce(self, frames: Generator[np.ndarray, None, None]) -> None:
        try:
            for img in frames:
                if not self._put(("frame", img)):
                    return
            self._put(("end", None))
        except Exception as e:          # raised by the consumer
            self._put(("error", e))
        finally:
            frames.close()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def next_frame(self) -> Optional[np.ndarray]:
        if self._stop.is_set():
            return None
        kind, value = self._queue.get()
        if kind == "frame":
            return value
        self.close()
        if kind == "error":
            raise value
        return None

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
        if self._on_close is not None:
            self._on_close()
            self._on_close = None


class MediaSource:
    """Destructive frame iterator over a photo glob or a video file (AVI
    and Matroska/WebM: Motion-JPEG, MPEG-4 Part 2, MPEG-1/2, VP8, VP9,
    H.263, Sorenson Spark, FFV1, HuffYUV or PNG, and in AVI uncompressed
    I420/IYUV/Y800; MP4/QuickTime/3GPP: MPEG-4 Part 2, MPEG-1/2, VP9,
    H.263, Sorenson Spark, FFV1, HuffYUV, PNG or Motion-JPEG; MPEG
    program, transport and elementary streams: MPEG-1/2; raw H.263
    streams; Flash Video: Sorenson Spark).  A video that does not open raises
    ``IOError``; another container or codec, or an FFV1 or HuffYUV layout
    or depth it does not read, ``NotImplementedError``; an MPEG-4,
    MPEG-1/2 or H.263 tool or VP8 or VP9 feature the decoder does not read
    ``ValueError``."""

    def __init__(self, *, photos_pattern: str = "", video_path: str = "",
                 use_photos: bool = True, prefetch: int = 8,
                 threads: int = 2):
        capacity, threads = max(1, prefetch), max(1, threads)
        if not use_photos:
            video = avi.open_video(video_path)
            if video.codec in ("mjpeg", "png", "raw"):
                self._reader = _PooledSequence(video.frames, capacity,
                                               threads,
                                               decode=video.decode_frame,
                                               on_close=video.close,
                                               stop_on_none=True)
                return
            try:    # made at once: a VOL tool it does not decode raises here
                dec = (vp8.Decoder() if video.codec == "vp8"
                       else vp9.Decoder() if video.codec == "vp9"
                       else mpeg12.Decoder(video.extradata, video.width,
                                           video.height)
                       if video.codec == "mpeg12"
                       else h263.Decoder(sorenson=video.codec == "flv1")
                       if video.codec in ("h263", "flv1")
                       else ffv1.Decoder(video.extradata, video.width,
                                         video.height)
                       if video.codec == "ffv1"
                       else huffyuv.Decoder(video.extradata, video.width,
                                            video.height,
                                            video.bits_per_coded_sample)
                       if video.codec == "huffyuv"
                       else mpeg4.Decoder(video.extradata, video.fourcc))
            except BaseException:
                video.close()
                raise
            self._reader = _ThreadedSequence(_decoded(video, dec), capacity,
                                             on_close=video.close)
            return
        self._paths = natural_sort_paths(_glob.glob(photos_pattern))
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
