"""Frame-batch scheduler (counterpart of the JAX package's
pipeline/batch.py): fill and good-frame selection with the reference's
semantics (src/mainModule/cycleProcessing/batch.cpp), minus its thread pool.

- ``fill``: decode frames, keep only those with ≥ requiredExtractedPointsCount
  FAST corners, until the batch holds framesBatchSize candidates or the media
  ends (fillVideoFrameBatch, batch.cpp:228-267).  Frames go to the device in
  chunks of ``_FILL_CHUNK``, the last frame repeated as padding.  The unused
  tail of the previous batch carries over.
- ``find_good_frame``: match the previous frame against every candidate in
  ONE ``match_against_batch`` (one ``top2_batch`` launch on the card, B =
  ``len(self.batch)``), then scan tail→head over indices ≥
  skipFramesFromBatchHead for the maximum match count ≥
  requiredMatchedPointsCount, head-most on ties, or the tail-most fit with
  useFirstFitInBatch (findGoodFramesFromBatchSingleThread,
  batch.cpp:101-160).  The head through the chosen index is consumed
  (batch.cpp:93-98).

Descriptors, keypoints and the match results stay on the device; a scan
reads ``num_matches`` and the chosen row of ``train_idx``/``is_match``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..models import frontend as fe
from .structures import BatchElement

EMPTY_BATCH = -1
FRAME_NOT_FOUND = -2

_FILL_CHUNK = 8  # frames decoded + gated per device call during fill


@dataclass
class GoodFrame:
    index: int
    element: BatchElement
    match_train: np.ndarray  # [K] int64
    match_mask: np.ndarray   # [K] bool
    num_matches: int


class BatchScheduler:
    def __init__(self, media, fcfg: fe.FrontendConfig, *,
                 batch_size: int,
                 required_extracted: int,
                 required_matched: int,
                 skip_from_head: int = 0,
                 use_first_fit: bool = False,
                 head_tie_tolerance: float = 0.0,
                 report=None,
                 K=None, dist=None, device=None):
        self.media = media
        self.fcfg = fcfg
        self.device = resolve_device(device)
        # useUndistortion: corrected at fill time, so matching and geometry
        # see undistorted pixels (K, dist: float32 tensors on the device)
        self.K = K
        self.dist = dist
        self.batch_size = batch_size
        self.required_extracted = required_extracted
        self.required_matched = required_matched
        self.skip_from_head = skip_from_head
        self.use_first_fit = use_first_fit
        self.head_tie_tolerance = head_tie_tolerance
        self.batch: list[BatchElement] = []
        self._pending: list[BatchElement] = []
        self._media_over = False
        self.report = report  # optional main.txt-style stream
        self.frames_pulled = 0  # source frames read from the media so far
        self.scans = 0        # match_against_batch calls (one launch each)

    def pull(self):
        """The next source frame and its index in the media, or (None, -1)
        when the media is over."""
        f = self.media.next_frame()
        if f is None:
            self._media_over = True
            return None, -1
        self.frames_pulled += 1
        return f, self.frames_pulled - 1

    # ------------------------------------------------------------------ fill
    @torch.profiler.record_function("pipeline.fill")
    def fill(self) -> int:
        """Top the batch up to ``batch_size``; returns number skipped
        (too-few-corners frames), mirroring fillVideoFrameBatch."""
        skipped = 0
        accepted_counts = []
        # admit previously decoded extras first (a chunk may overshoot)
        while self._pending and len(self.batch) < self.batch_size:
            el = self._pending.pop(0)
            accepted_counts.append(int(el.valid.sum()))
            self.batch.append(el)
        while len(self.batch) < self.batch_size and not self._media_over:
            chunk, fids = [], []
            while len(chunk) < _FILL_CHUNK:
                f, fid = self.pull()
                if f is None:
                    break
                chunk.append(f)
                fids.append(fid)
            if not chunk:
                break
            pad = _FILL_CHUNK - len(chunk)
            stacked = np.stack(chunk + [chunk[-1]] * pad)
            rgb = torch.from_numpy(stacked).to(self.device)
            res = fe.extract_and_describe_batch(self.fcfg, rgb)
            if self.dist is not None:
                from ..geometry.projection import undistort_points

                res = dict(res)
                res["xy"] = undistort_points(self.K, self.dist, res["xy"])
            counts = res["num_corners"].cpu().numpy()
            colors = res["colors"].cpu().numpy()
            for i in range(len(chunk)):
                if counts[i] < self.required_extracted:
                    skipped += 1
                    continue
                el = BatchElement(
                    frame=chunk[i],
                    xy=res["xy"][i],
                    valid=res["valid"][i],
                    score=res["score"][i],
                    desc=res["desc"][i],
                    colors=colors[i],
                    frame_id=fids[i],
                )
                if len(self.batch) < self.batch_size:
                    accepted_counts.append(int(counts[i]))
                    self.batch.append(el)
                else:
                    self._pending.append(el)
        if self.report is not None:
            self.report.write(
                "Features count in frames added to batch: "
                + " ".join(str(c) for c in accepted_counts) + "\n"
                f"Skipped frames while constructing batch: {skipped}\n"
                f"Batch size: {len(self.batch)}\n"
            )
        return skipped

    # ------------------------------------------------------- good-frame scan
    @torch.profiler.record_function("pipeline.find_good_frame")
    def find_good_frame(self, prev_desc, prev_valid) -> GoodFrame | int:
        """Fill, match the previous frame against the whole batch on the
        device, and apply the tail→head max-count selection rule."""
        self.fill()
        if not self.batch:
            return EMPTY_BATCH

        B = len(self.batch)
        desc_batch = torch.stack([el.desc for el in self.batch])
        valid_batch = torch.stack([el.valid for el in self.batch])
        frame_mask = torch.ones((B,), dtype=torch.bool, device=self.device)
        res = fe.match_against_batch(
            self.fcfg, prev_desc, prev_valid, desc_batch, valid_batch,
            frame_mask)
        self.scans += 1
        counts = res["num_matches"].cpu().numpy()
        if self.report is not None:
            for bi in range(B - 1, self.skip_from_head - 1, -1):
                self.report.write(
                    f"Batch index: {bi}; curr. extracted: "
                    f"{int(self.batch[bi].valid.sum())}; "
                    f"matched {int(counts[bi])}\n"
                )

        good = self._select(counts)
        if good == FRAME_NOT_FOUND:
            return FRAME_NOT_FOUND

        gf = GoodFrame(
            index=good,
            element=self.batch[good],
            match_train=res["train_idx"][good].cpu().numpy(),
            match_mask=res["is_match"][good].cpu().numpy(),
            num_matches=int(counts[good]),
        )
        # consume head..good; tail carries over (batch.cpp:93-98)
        self.batch = self.batch[good + 1:]
        return gf

    def _select(self, counts: np.ndarray) -> int:
        B = len(counts)
        lo = min(self.skip_from_head, B)
        eligible = np.flatnonzero(counts[lo:] >= self.required_matched) + lo
        if len(eligible) == 0:
            return FRAME_NOT_FOUND
        if self.use_first_fit:
            return int(eligible.max())  # tail-most fit (scan breaks at tail)
        best = counts[eligible].max()
        # head_tie_tolerance > 0: any eligible count within the tolerance of
        # the best competes, head-most wins (steps._select_good is the
        # device twin of this rule)
        cut = (int(np.ceil(best * (1.0 - self.head_tie_tolerance)))
               if self.head_tie_tolerance > 0.0 else best)
        return int(eligible[counts[eligible] >= cut].min())  # head-most max

    # ------------------------------------------------------------- bootstrap
    def pop_head(self) -> BatchElement:
        """Promote the batch head to a new first frame (first-pair fallback,
        mainCycle.cpp:299-315)."""
        el = self.batch[0]
        self.batch = self.batch[1:]
        return el

    @property
    def media_exhausted(self) -> bool:
        return self._media_over and not self.batch and not self._pending
