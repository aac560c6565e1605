"""Replica health scoring: turning ``serve.*`` gauges into routing weight.

Port of ``multiverso_tpu/fleet/health.py``: the same score and the same
heartbeat payload fields.

Each replica's heartbeat carries the load gauges its serving plane already
exports (``serve.queue_depth``, ``serve.inflight``, ``serve.replica_step``
— docs/OBSERVABILITY.md): no second measurement path, the fleet routes by
the same numbers an operator graphs. The router folds them into one scalar
in ``(0, 1]``:

    busy   = pipeline_inflight / pipeline_depth     (pipelined members)
           = inflight / max_batch                   (serialized members)
    load   = queue_depth / max_queue + busy
             + staleness_steps * STALENESS_WEIGHT
    health = 1 / (1 + load)          (0.0 when draining or dead)

Queue depth is the forward-looking signal (requests already committed to
this replica), inflight the instantaneous one, and staleness — how many
checkpoint steps the replica lags the freshest member — a soft penalty so
traffic drifts toward replicas serving newer parameters without starving
a refresh-lagged one outright. Draining or dead pins the score to 0.0,
which removes the replica from every candidate list.

``pipeline_inflight`` exists because the dispatch pipeline
(serving/pipeline.py) moved the place work queues: a pipelined replica
runs with a near-EMPTY admission queue while up to ``pipeline_depth``
whole batches ride the device window. Scoring only the queue would make
a saturated pipelined replica look idle to the router; window occupancy
over window depth is the same normalized load the queue term expresses,
one stage later.
"""

from __future__ import annotations

from typing import Dict, Mapping

STALENESS_WEIGHT = 0.25     # one checkpoint step behind ~ 25% extra load

#: Heartbeat stat fields. ``drains_completed`` is a per-member monotonic
#: count — the router's drain thread watches it instead of trying to
#: catch the (possibly sub-heartbeat) draining=1 window in flight.
#: ``pipeline_inflight``/``pipeline_depth`` carry the dispatch-window
#: occupancy (0/0 from pre-pipeline members: the score term vanishes).
STAT_FIELDS = ("queue_depth", "inflight", "replica_step", "draining",
               "max_queue", "max_batch", "drains_completed",
               "pipeline_inflight", "pipeline_depth")


def health_score(stats: Mapping[str, float], fleet_max_step: float) -> float:
    """One replica's score in ``[0, 1]``; 0.0 iff unroutable (draining)."""
    if stats.get("draining", 0.0):
        return 0.0
    q_bound = max(1.0, float(stats.get("max_queue", 1.0)))
    b_width = max(1.0, float(stats.get("max_batch", 1.0)))
    p_depth = float(stats.get("pipeline_depth", 0.0))
    # ONE device-busy term, not two: serve.inflight and the window
    # occupancy measure the SAME work in pipelined mode (the batcher
    # sets serve.inflight to the window's request count), so a pipelined
    # member uses occupancy/depth and a serialized member inflight/
    # max_batch — both normalize a saturated device to +1.0 load.
    # Summing both would score a saturated pipelined replica half the
    # health of an equally saturated serialized one and route the fleet
    # AWAY from its faster members.
    if p_depth > 0.0:
        busy = float(stats.get("pipeline_inflight", 0.0)) / p_depth
    else:
        busy = float(stats.get("inflight", 0.0)) / b_width
    load = float(stats.get("queue_depth", 0.0)) / q_bound + busy
    step = float(stats.get("replica_step", -1.0))
    if step >= 0.0 and fleet_max_step > step:
        load += (fleet_max_step - step) * STALENESS_WEIGHT
    return 1.0 / (1.0 + load)


def local_stats(max_queue: int, max_batch: int,
                pipeline_depth: int = 0) -> Dict[str, float]:
    """A replica's own heartbeat payload, read from the process-local
    telemetry registry — the exported gauges ARE the health feed. The
    member overlays its instance-local drain state on top (the registry
    is process-global; two members in one test process must not read
    each other's drain flag)."""
    from multiverso_tpu_torch.telemetry import gauge
    return {
        "queue_depth": float(gauge("serve.queue_depth").last),
        "inflight": float(gauge("serve.inflight").last),
        "replica_step": float(gauge("serve.replica_step").last),
        "draining": 0.0,
        "max_queue": float(max_queue),
        "max_batch": float(max_batch),
        "drains_completed": 0.0,
        "pipeline_inflight": float(gauge("serve.pipeline.inflight").last),
        "pipeline_depth": float(pipeline_depth),
    }


# Stage-latency histograms every replica already maintains (batcher +
# service; docs/OBSERVABILITY.md serve.* catalog) -> heartbeat snapshot
# keys. The fleet rollup merges these count-weighted across replicas.
STAGE_HISTOGRAMS = (
    ("admit", "serve.latency.admit"),
    ("batch", "serve.latency.batch"),
    ("device", "serve.latency.device"),
    ("reply", "serve.latency.reply"),
    ("total", "serve.latency.total"),
)


def slo_violations(hist, threshold_ms: float) -> int:
    """Observations above ``threshold_ms`` in a telemetry Histogram,
    counted from the fixed log-2 buckets: every bucket whose LOWER edge
    is >= the threshold counts whole (an under-count by at most the one
    straddling bucket — a stable burn counter beats an optimistic one)."""
    _, counts = hist.raw_counts()
    return hist.violations_from_counts(counts, threshold_ms)


def metrics_payload() -> Dict:
    """Compact per-replica metric snapshot shipped on every heartbeat —
    the raw material of the router's cluster-wide rollup (``Fleet_Stats``
    / ``fleet_top``). Counters are CUMULATIVE (the router differentiates
    them into rates over its own clock); stage latencies ship as
    p50/p95/p99 + count so the rollup can merge them count-weighted."""
    from multiverso_tpu_torch.telemetry import get_registry
    from multiverso_tpu_torch.utils.configure import get_flag
    reg = get_registry()
    try:
        slo_ms = float(get_flag("serve_slo_ms"))
    except Exception:  # noqa: BLE001 - flags not parsed (bare library use)
        slo_ms = 50.0
    # Literal three-member enum: bounded by construction.
    # graftlint: disable=unbounded-metric-name
    shed = sum(reg.counter(f"serve.shed.{r}").value
               for r in ("queue_full", "deadline", "oversize"))
    stages: Dict[str, Dict] = {}
    for key, name in STAGE_HISTOGRAMS:
        h = reg.histogram(name)
        snap = h.snapshot()
        stages[key] = {"count": snap["count"], "p50": round(snap["p50"], 4),
                       "p95": round(snap["p95"], 4),
                       "p99": round(snap["p99"], 4)}
    from multiverso_tpu_torch.telemetry import active_alert_summaries
    from multiverso_tpu_torch.telemetry.sketch import get_sketch_hub
    # Data-plane load: this replica's served-key stream (traffic sketch,
    # docs/OBSERVABILITY.md "Data-plane load"). flush() folds any
    # pending per-thread buffers first, so the heartbeat ships numbers
    # as fresh as the tick's; the router differentiates `keys` into a
    # per-replica rate and derives the fleet's shard-imbalance ratio.
    hub = get_sketch_hub()
    hub.flush()
    # Attribution layer: the slowest-request ledgers and the per-plane
    # bound verdict ride the same heartbeat in the JAX package. The
    # phase-ledger reservoir and the roofline verdicts are not ported yet
    # (ROADMAP A11): the values the JAX package ships when those modules
    # cannot be read.
    exemplars: list = []
    bound: dict = {}
    # topn must cover the hot-key replicator's confident-set cap
    # (HotKeyReplicator topk=16): a key the heartbeat never ships can
    # never promote, and all-or-nothing hot routing needs EVERY row of
    # a hot request replicated — a top-5 cap silently disabled it for
    # any hot set wider than 5 keys.
    traffic = hub.summary("serve.lookup", topn=16)
    return {
        "requests": reg.counter("serve.requests").value,
        "replies": reg.counter("serve.replies").value,
        "keys": int(traffic["keys"]),
        "key_bytes": int(traffic["bytes"]),
        "top1_share": float(traffic["top1_share"]),
        "hot_keys": [[k, c] for k, c, _ in traffic["topk"]],
        # Firing alerts from this replica's in-process engine
        # (telemetry/alerts.py; [] when no engine runs): the rollup's
        # ALERTS column rides the heartbeat, no new wire messages.
        "alerts": active_alert_summaries(),
        "shed": shed,
        "cancelled": reg.counter("serve.cancelled").value,
        "queue_depth": float(reg.gauge("serve.queue_depth").last),
        "inflight": float(reg.gauge("serve.inflight").last),
        "pipeline_inflight": float(
            reg.gauge("serve.pipeline.inflight").last),
        # Lifetime window-occupancy peak: the bench's "overlap actually
        # happened" witness (a last-value gauge almost always reads 0
        # between batches).
        "pipeline_inflight_max": float(
            reg.gauge("serve.pipeline.inflight").snapshot()["max"] or 0.0),
        "cache_hits": reg.counter("serve.cache.hit").value,
        # This replica's wedge-watchdog trips (telemetry/flight.py):
        # the fleet-wide "nothing wedged" witness lives in the processes
        # that actually run monitored daemon loops — the replicas — not
        # in whoever reads the rollup.
        "watchdog_trips": reg.counter("telemetry.watchdog.trips").value,
        "slo_ms": slo_ms,
        "slo_violations": slo_violations(
            reg.histogram("serve.latency.total"), slo_ms),
        "stages": stages,
        "exemplars": exemplars,
        "roofline": bound,
    }
