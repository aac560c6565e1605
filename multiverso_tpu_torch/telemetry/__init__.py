"""Telemetry subset of the port: histograms, counters, gauges, spans,
distributed trace contexts and the watchdog registration.

Port of the part of ``multiverso_tpu/telemetry`` that the table plane,
the word2vec trainer and the serving plane call. Snapshot export, alerts,
the flight recorder's monitor and postmortems, the phase-ledger
reservoir, sketches and the profiler wait (ROADMAP A11).
"""

from multiverso_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                                    MetricsRegistry, counter,
                                                    gauge, get_registry,
                                                    histogram)
from multiverso_tpu_torch.telemetry.context import (TraceContext, activate,
                                                    child_of,
                                                    current_context)
from multiverso_tpu_torch.telemetry.flight import (watchdog_handles,
                                                   watchdog_scope)
from multiverso_tpu_torch.telemetry.spans import (TraceBuffer,
                                                  current_identity,
                                                  emit_span,
                                                  get_trace_buffer, span)


def reset_telemetry() -> None:
    """Clear every metric and the span buffer (test isolation)."""
    get_registry().reset()
    get_trace_buffer().clear()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter", "gauge",
    "get_registry", "histogram", "TraceBuffer", "current_identity",
    "get_trace_buffer", "span", "emit_span", "reset_telemetry",
    "TraceContext", "activate", "child_of", "current_context",
    "watchdog_handles", "watchdog_scope",
]
