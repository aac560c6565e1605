"""Host times of points in the device's stream: when a token was ready.

The decode paths queue their work on the card and return before it runs,
so a host clock read at the launch says nothing about when a token was
computed. :class:`DeviceClock` marks a point in the stream with a timing
CUDA event and, once that event has completed, maps it onto
``time.monotonic()`` through one reference event recorded, with the
device idle, when the clock was made. On the CPU the work runs
synchronously and a mark is the host time itself. The serving plane
reads its first-token and per-token latencies this way
(``serve.latency.first_token``, ``serve.latency.per_token``).
"""

from __future__ import annotations

import time
from typing import Union

import torch

Mark = Union[float, "torch.cuda.Event"]


class DeviceClock:
    """Marks on ``device``'s current stream, read as host times."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            torch.cuda.synchronize(self.device)
            self._ref = torch.cuda.Event(enable_timing=True)
            self._ref.record()
            torch.cuda.synchronize(self.device)
            self._t_ref = time.monotonic()

    def mark(self) -> Mark:
        """A point in the stream after the work queued so far."""
        if not self.on_card:
            return time.monotonic()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def host_time(self, mark: Mark) -> float:
        """The ``time.monotonic()`` value at which ``mark`` completed
        (waits for it on the card)."""
        if not self.on_card:
            return float(mark)
        mark.synchronize()
        return self._t_ref + self._ref.elapsed_time(mark) / 1e3
