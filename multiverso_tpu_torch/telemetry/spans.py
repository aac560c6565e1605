"""Host-side span API + Chrome trace-event buffer.

Port of the subset of ``multiverso_tpu/telemetry/spans.py`` this slice
calls. ``span(name, **attrs)`` records a begin/end pair as one Chrome
trace-event "complete" event (``ph: "X"``) and feeds the ``span.<name>``
histogram; the region is nested under ``torch.profiler.record_function``
so the same name shows up in a ``torch.profiler`` trace of the card.
:func:`emit_span` records a completed span of a distributed request trace
(``telemetry/context.py``) from explicit timestamps, for the serving
plane's stages that straddle threads.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from multiverso_tpu_torch.telemetry.context import TraceContext
from multiverso_tpu_torch.telemetry.metrics import get_registry

__all__ = ["span", "emit_span", "TraceBuffer", "get_trace_buffer",
           "current_identity"]


class TraceBuffer:
    """Bounded, thread-safe ring of Chrome trace events: when full, the
    oldest events are evicted (and counted as dropped)."""

    DEFAULT_CAPACITY = 10_000

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: "collections.deque[Dict]" = \
            collections.deque(maxlen=capacity)
        self.dropped = 0

    def record(self, event: Dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(event)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0


_buffer: Optional[TraceBuffer] = None
_buffer_lock = threading.Lock()


def get_trace_buffer() -> TraceBuffer:
    global _buffer
    with _buffer_lock:
        if _buffer is None:
            _buffer = TraceBuffer()
        return _buffer


def current_identity() -> Dict:
    """Best-effort worker identity for span attribution; never raises."""
    ident: Dict = {"pid": os.getpid(), "rank": 0}
    from multiverso_tpu_torch.core.zoo import Zoo
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        ident["rank"] = zoo.rank()
        ident["worker_id"] = zoo.worker_id()
    return ident


def _clean_attrs(attrs: Dict) -> Dict:
    return {k: (v if isinstance(v, (int, float, bool, str)) or v is None
                else str(v))
            for k, v in attrs.items()}


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Named host-side region: Chrome trace event + ``span.<name>``
    latency histogram + ``torch.profiler.record_function`` annotation."""
    ident = current_identity()
    ts_us = time.time() * 1e6
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dur_ms = (time.perf_counter() - t0) * 1e3
        args = _clean_attrs(attrs)
        args["rank"] = ident["rank"]
        get_trace_buffer().record({
            "name": name, "ph": "X", "ts": int(ts_us),
            "dur": max(int(dur_ms * 1e3), 0), "pid": ident["pid"],
            "tid": threading.get_ident() % (1 << 31),
            "cat": "multiverso_tpu_torch", "args": args})
        get_registry().histogram(f"span.{name}").observe(dur_ms)


def _trace_args(args: Dict, ctx: TraceContext) -> Dict:
    args["trace"] = ctx.trace_hex
    args["span"] = ctx.span_hex
    if ctx.parent_id:
        args["parent"] = f"{ctx.parent_id:016x}"
    if ctx.hedge:
        args["hedge"] = 1
        args["attempt"] = ctx.hedge
    return args


def emit_span(name: str, ctx: Optional[TraceContext], t0_mono: float,
              dur_ms: float, force: bool = False, **attrs) -> None:
    """Record a COMPLETED span from explicit timestamps, for stages whose
    begin and end straddle threads or callbacks (batcher admit-wait,
    device window, reply leg).

    ``ctx`` IS the span's identity (build one with ``child_of(parent)``);
    ``t0_mono`` is the ``time.monotonic()`` start. Skipped for an
    unsampled context unless ``force`` (tail exemplars: shed, error and
    slow requests). The ``span.<name>`` histogram observes only when the
    event records."""
    if ctx is None or not (ctx.sampled or force):
        return
    ident = current_identity()
    epoch_minus_mono = time.time() - time.monotonic()
    args = _clean_attrs(attrs)
    args["rank"] = ident["rank"]
    _trace_args(args, ctx)
    if force and not ctx.sampled:
        args["tail"] = 1
    dur_ms = max(float(dur_ms), 0.0)
    get_trace_buffer().record({
        "name": name, "ph": "X",
        "ts": int((epoch_minus_mono + t0_mono) * 1e6),
        "dur": max(int(dur_ms * 1e3), 0), "pid": ident["pid"],
        "tid": threading.get_ident() % (1 << 31),
        "cat": "multiverso_tpu_torch", "args": args})
    get_registry().histogram(f"span.{name}").observe(dur_ms)
