"""Named perf counters: Dashboard / Monitor.

Parity with ``include/multiverso/dashboard.h:16-74``: each Monitor tracks
{invocation count, total elapsed ms, average ms}; the Dashboard is a global
registry that can display all monitors. The ``MONITOR_BEGIN/END(name)`` macro
pair becomes the :func:`monitor` context manager / decorator.

Beyond the reference: every Monitor is backed by a fixed log-bucket
histogram in the telemetry registry (``multiverso_tpu_torch/telemetry``), so
``info_string`` reports p50/p95/p99/max alongside count/total/average and
the same numbers ship in telemetry snapshots. ``begin``/``end`` keep a
THREAD-LOCAL begin stack: concurrent use of one monitor from several
threads (two PS service threads in the same region) and nested regions on
one thread both time correctly — the reference's single shared begin
timestamp would be clobbered.

GPU note: wall-clock around a launch measures host time only; CUDA work is
asynchronous. Callers that want device-inclusive timing should synchronize
(``torch.cuda.synchronize``) inside the monitored region.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Callable, Dict, Iterator, TypeVar

from multiverso_tpu_torch.telemetry.metrics import Histogram, get_registry
from multiverso_tpu_torch.utils.log import log

F = TypeVar("F", bound=Callable)


class Monitor:
    __slots__ = ("name", "_hist", "_local")

    def __init__(self, name: str):
        self.name = name
        # The histogram IS the storage: Monitor numbers and telemetry
        # snapshots can never disagree about what was measured.
        self._hist: Histogram = get_registry().histogram(name)
        self._local = threading.local()

    def begin(self) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(time.perf_counter())

    def end(self) -> None:
        stack = getattr(self._local, "stack", None)
        if not stack:
            return
        elapsed = (time.perf_counter() - stack.pop()) * 1000.0
        self._hist.observe(elapsed)

    def add(self, elapsed_ms: float) -> None:
        self._hist.observe(elapsed_ms)

    @property
    def count(self) -> int:
        return self._hist.count

    @property
    def total_ms(self) -> float:
        return self._hist.sum

    @property
    def average_ms(self) -> float:
        snap = self._hist.snapshot()
        return snap["mean_ms"]

    def snapshot(self) -> Dict:
        """Consistent structured view (count/total/percentiles read under
        the histogram lock in one acquisition)."""
        return self._hist.snapshot()

    def info_string(self) -> str:
        s = self.snapshot()
        return (f"[{self.name}] count = {s['count']}, "
                f"total = {s['sum_ms']:.2f}ms, "
                f"average = {s['mean_ms']:.3f}ms, "
                f"p50 = {s['p50']:.3f}ms, p95 = {s['p95']:.3f}ms, "
                f"p99 = {s['p99']:.3f}ms, max = {s['max_ms']:.3f}ms")


class Dashboard:
    _monitors: Dict[str, Monitor] = {}
    _lock = threading.Lock()

    @classmethod
    def get(cls, name: str) -> Monitor:
        with cls._lock:
            monitor = cls._monitors.get(name)
            if monitor is None:
                monitor = cls._monitors[name] = Monitor(name)
            return monitor

    @classmethod
    def watch(cls, name: str) -> str:
        return cls.get(name).info_string()

    @classmethod
    def display(cls, echo: bool = False) -> str:
        """All monitors, one line each. Returns the report; ``echo=True``
        (the CLI path) additionally emits it via ``log.raw`` (stdout +
        the -log_file sink, so a persisted run log keeps its own
        performance summary)."""
        with cls._lock:
            monitors = list(cls._monitors.values())
        report = "\n".join(m.info_string() for m in monitors)
        if echo and report:
            log.raw(report)
        return report

    @classmethod
    def snapshot(cls) -> Dict[str, Dict]:
        """Structured {name: histogram snapshot} for every monitor."""
        with cls._lock:
            monitors = list(cls._monitors.values())
        return {m.name: m.snapshot() for m in monitors}

    @classmethod
    def reset(cls) -> None:
        """Clear every monitor AND its backing histogram — the
        zeroing contract: a re-created monitor of the same name must not
        resume the old counts."""
        with cls._lock:
            names = list(cls._monitors)
            cls._monitors.clear()
        registry = get_registry()
        for name in names:
            registry.drop(name)


@contextlib.contextmanager
def monitor(name: str) -> Iterator[Monitor]:
    """``MONITOR_BEGIN(name) ... MONITOR_END(name)`` as a context manager."""
    m = Dashboard.get(name)
    m.begin()
    try:
        yield m
    finally:
        m.end()


def monitored(name: str) -> Callable[[F], F]:
    """Decorator form for hot functions."""
    def wrap(fn: F) -> F:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with monitor(name):
                return fn(*args, **kwargs)
        return inner  # type: ignore[return-value]
    return wrap
