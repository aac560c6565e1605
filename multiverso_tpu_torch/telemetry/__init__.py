"""Telemetry subset of the port: histograms, counters, gauges and spans.

Port of the part of ``multiverso_tpu/telemetry`` that the table plane and
the word2vec trainer call. Snapshot export, alerts, the flight recorder,
sketches and the profiler wait (ROADMAP A11).
"""

from multiverso_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                                    MetricsRegistry, counter,
                                                    gauge, get_registry,
                                                    histogram)
from multiverso_tpu_torch.telemetry.spans import (TraceBuffer,
                                                  current_identity,
                                                  get_trace_buffer, span)


def reset_telemetry() -> None:
    """Clear every metric and the span buffer (test isolation)."""
    get_registry().reset()
    get_trace_buffer().clear()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter", "gauge",
    "get_registry", "histogram", "TraceBuffer", "current_identity",
    "get_trace_buffer", "span", "reset_telemetry",
]
