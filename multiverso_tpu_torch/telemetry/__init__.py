"""Telemetry of the port: histograms, counters, gauges, spans,
distributed trace contexts, the windowed timeseries, the alert engine and
the flight recorder.

Port of ``multiverso_tpu/telemetry``: what the table plane, the word2vec
trainer, the serving plane and the fleet call, with the streaming hot-key
sketches (``sketch.py``) the lookup plane records into, the timeseries
store that ticks them (``timeseries.py``), the alert rules over it
(``alerts.py``) and the flight recorder, wedge watchdog and postmortems
(``flight.py``). Snapshot export (``-telemetry_dir``), the phase-ledger
reservoir (critical_path), the roofline verdicts, the sampling profiler
and the lock witness wait (ROADMAP A11).
"""

from multiverso_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                                    MetricsRegistry, counter,
                                                    gauge, get_registry,
                                                    histogram)
from multiverso_tpu_torch.telemetry.context import (TraceContext, activate,
                                                    child_of,
                                                    current_context)
from multiverso_tpu_torch.telemetry.alerts import (
    AlertEngine, AlertManager, AlertRule, BurnRateRule, ImbalanceRule,
    SaturationRule, StragglerRule, ThresholdRule, active_alert_summaries,
    default_serving_rules, maybe_start_observability_from_flags,
    start_alert_engine, stop_alert_engine)
from multiverso_tpu_torch.telemetry.flight import (
    POSTMORTEM_SCHEMA, FlightRecorder, WatchdogHandle, build_postmortem,
    dump_postmortem, flight_recorder, install_crash_handlers, reset_flight,
    start_watchdog, stop_watchdog, validate_postmortem, watchdog_handles,
    watchdog_register, watchdog_scope)
from multiverso_tpu_torch.telemetry.sketch import (get_sketch_hub,
                                                   record_keys,
                                                   reset_sketches,
                                                   set_sketch_enabled)
from multiverso_tpu_torch.telemetry.spans import (TraceBuffer,
                                                  current_identity,
                                                  emit_span,
                                                  get_trace_buffer, span)
from multiverso_tpu_torch.telemetry.timeseries import TimeseriesStore


def reset_telemetry() -> None:
    """Test isolation: stop the alert engine and the watchdog, drop every
    metric, span, flight event and sketch."""
    stop_alert_engine()
    reset_flight()
    reset_sketches()
    get_registry().reset()
    get_trace_buffer().clear()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter", "gauge",
    "get_registry", "histogram", "TraceBuffer", "current_identity",
    "get_trace_buffer", "span", "emit_span", "reset_telemetry",
    "TraceContext", "activate", "child_of", "current_context",
    "AlertEngine", "AlertManager", "AlertRule", "BurnRateRule",
    "ImbalanceRule", "SaturationRule", "StragglerRule", "ThresholdRule",
    "active_alert_summaries", "default_serving_rules",
    "maybe_start_observability_from_flags", "start_alert_engine",
    "stop_alert_engine",
    "POSTMORTEM_SCHEMA", "FlightRecorder", "WatchdogHandle",
    "build_postmortem", "dump_postmortem", "flight_recorder",
    "install_crash_handlers", "reset_flight", "start_watchdog",
    "stop_watchdog", "validate_postmortem", "watchdog_handles",
    "watchdog_register", "watchdog_scope", "TimeseriesStore",
    "get_sketch_hub", "record_keys", "reset_sketches", "set_sketch_enabled",
]
