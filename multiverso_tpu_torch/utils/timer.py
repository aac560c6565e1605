"""High-resolution elapsed-time stopwatch (ref include/multiverso/util/timer.h:9-25)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self._start = time.perf_counter()

    def start(self) -> None:
        self._start = time.perf_counter()

    def elapse(self) -> float:
        """Elapsed milliseconds since start (ref semantics)."""
        return (time.perf_counter() - self._start) * 1000.0

    def elapse_seconds(self) -> float:
        return time.perf_counter() - self._start
