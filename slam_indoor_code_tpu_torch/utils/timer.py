"""Wall-clock stage timer (reference: ChronoTimer, src/misc/ChronoTimer.h:8-17).

Millisecond deltas since construction (``print_start_delta``) and since a
movable mark (``print_last_point_delta``), written to a stream — the same
instrumentation contract the reference uses to produce its time.txt baseline
logs (docs/cuda/*.txt), so our timing artifacts are directly comparable."""

from __future__ import annotations

import time


class ChronoTimer:
    def __init__(self):
        self._start = time.perf_counter()
        self._last = self._start

    def update_last_point(self) -> None:
        self._last = time.perf_counter()

    def start_delta_ms(self) -> float:
        return (time.perf_counter() - self._start) * 1000.0

    def last_point_delta_ms(self) -> float:
        return (time.perf_counter() - self._last) * 1000.0

    def print_start_delta(self, prefix: str, stream) -> None:
        stream.write(f"{prefix}{self.start_delta_ms():.0f}\n")
        stream.flush()

    def print_last_point_delta(self, prefix: str, stream) -> None:
        stream.write(f"{prefix}{self.last_point_delta_ms():.0f}\n")
        stream.flush()
