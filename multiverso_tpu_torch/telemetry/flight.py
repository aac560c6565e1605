"""Wedge-watchdog registration: the minimal contract of
``multiverso_tpu/telemetry/flight.py`` that the serving plane's daemon
loops call.

Every daemon loop registers a :class:`WatchdogHandle` through
:func:`watchdog_scope` and calls ``beat()`` once per iteration (one float
store). :func:`watchdog_handles` lists the live loops and their ages.
The monitor thread that trips a stale loop, the flight recorder and the
postmortem dumps are not ported yet (ROADMAP A11): here a handle only
records progress.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List

from multiverso_tpu_torch.telemetry.metrics import get_registry

__all__ = ["WatchdogHandle", "watchdog_register", "watchdog_scope",
           "watchdog_handles"]


class WatchdogHandle:
    """One daemon loop's progress beacon. ``beat()`` is a single float
    attribute store (GIL-atomic), no lock on the hot path."""

    __slots__ = ("name", "timeout_s", "last", "beats", "closed")

    def __init__(self, name: str, timeout_s: float):
        self.name = name
        self.timeout_s = max(0.05, float(timeout_s))
        self.last = time.monotonic()
        self.beats = 0
        self.closed = False

    def beat(self) -> None:
        self.last = time.monotonic()
        self.beats += 1

    def age_s(self) -> float:
        return time.monotonic() - self.last

    def close(self) -> None:
        self.closed = True
        with _handles_lock:
            if _handles.get(self.name) is self:
                del _handles[self.name]
            n = len(_handles)
        get_registry().gauge("telemetry.watchdog.loops").set(n)


_handles_lock = threading.Lock()
_handles: Dict[str, WatchdogHandle] = {}


def watchdog_register(name: str, timeout_s: float = 60.0) -> WatchdogHandle:
    """Register a daemon loop. Names are uniqued (``name#2`` ...) so two
    batchers in one process both show."""
    h = WatchdogHandle(name, timeout_s)
    with _handles_lock:
        key = name
        n = 1
        while key in _handles:
            n += 1
            key = f"{name}#{n}"
        h.name = key
        _handles[key] = h
        count = len(_handles)
    get_registry().gauge("telemetry.watchdog.loops").set(count)
    return h


@contextlib.contextmanager
def watchdog_scope(name: str, timeout_s: float = 60.0
                   ) -> Iterator[WatchdogHandle]:
    """The canonical daemon-loop shape: register on entry, deregister on
    exit, beat inside."""
    handle = watchdog_register(name, timeout_s)
    try:
        yield handle
    finally:
        handle.close()


def watchdog_handles() -> List[WatchdogHandle]:
    with _handles_lock:
        return list(_handles.values())
