"""Streaming hot-key sketches: the data plane's traffic microscope.

Port of ``multiverso_tpu/telemetry/sketch.py``, numpy only and copied
here so that the port imports nothing of the JAX package. The hash
(``_mix64``), the counters and the heavy-hitter table are the JAX
package's, so the same key stream gives the same Count-Min rows and the
same top-k in both packages.

* :class:`CountMinSketch` — frequency estimates for ANY key:
  ``depth`` hash rows of ``width`` counters; an estimate is the min over
  rows, always an over-estimate, within ``2N/width`` of truth with
  probability ``1 - 2^-depth`` (N = stream length). Adds commute, so
  merge is elementwise sum — exact across threads and processes.
* :class:`SpaceSaving` — the top-K heavy hitters with per-key error
  bounds: ``capacity`` tracked keys; a new key evicts the current
  minimum and inherits its count as error. Every key with frequency
  above ``N/capacity`` is guaranteed tracked.

One :class:`TrafficSketch` per instrumented **surface** (``serve.lookup``
…) combines both plus total row/byte counters. The :class:`SketchHub`
keeps the hot path to ONE list-append: ``record()`` pushes the key array
onto a per-thread buffer; ``flush()`` drains every buffer into the
sketches and publishes ``sketch.<surface>.keys``/``.bytes`` counters and
``.top1_share``/``.topk_share`` skew gauges. The telemetry tick
(``timeseries.py``'s ``TimeseriesStore.tick``, driven by the alert
engine) runs ``flush()``; so does a reader that wants fresh numbers (the
fleet heartbeat), and a recording thread whose buffer outgrows
:data:`SketchHub.FLUSH_PENDING` folds its own (without publication). Surface cardinality is bounded
(:data:`SketchHub.MAX_SURFACES`, with the overflow counted) and every
sketch's memory is fixed by the ``-telemetry_sketch_*`` flags.

The **cache-headroom advisor** closes the loop for the hot-row cache:
:func:`coverage_at` turns the sketch's heavy-hitter counts into a
frequency CDF (fitted power-law tail beyond the tracked K) and predicts
the hit rate a cache of ``-serve_cache_rows`` rows could achieve on this
key stream; each flush publishes it next to the measured ``serve.cache``
hit rate (``serve.cache.advisor.*`` gauges) and hands it to a registered
autosizer (``serving/cache.py::CacheAutosizer``).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch.telemetry.metrics import counter, gauge
from multiverso_tpu_torch.utils.locks import make_lock

__all__ = ["CountMinSketch", "SpaceSaving", "TrafficSketch", "SketchHub",
           "get_sketch_hub", "record_keys", "set_sketch_enabled",
           "coverage_at", "load_ratio"]

_U64 = np.uint64


def _mix64(keys: np.ndarray, seed: int) -> np.ndarray:
    """Seeded splitmix64 finalizer, vectorized (the hashring's mix with a
    per-row tweak) — uniform enough for counter placement."""
    with np.errstate(over="ignore"):
        z = keys.astype(_U64) + _U64((0x9E3779B97F4A7C15 * (seed + 1))
                                     & 0xFFFFFFFFFFFFFFFF)
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        return z ^ (z >> _U64(31))


class CountMinSketch:
    """Count-Min frequency sketch over integer keys.

    Memory is exactly ``depth * width`` int64 counters, fixed at
    construction. Estimates never under-count; over-count is bounded by
    ``2 * total / width`` per row with probability ``1 - 2^-depth``."""

    def __init__(self, width: int = 1024, depth: int = 4, seed: int = 0):
        self.width = max(16, int(width))
        self.depth = max(1, int(depth))
        self.seed = int(seed)
        self.rows = np.zeros((self.depth, self.width), dtype=np.int64)
        self.total = 0

    def update(self, keys: np.ndarray, counts: Optional[np.ndarray] = None
               ) -> None:
        keys = np.asarray(keys).reshape(-1)
        if keys.size == 0:
            return
        if counts is None:
            counts = np.ones(keys.shape[0], dtype=np.int64)
        else:
            counts = np.asarray(counts, dtype=np.int64).reshape(-1)
        for d in range(self.depth):
            idx = _mix64(keys, self.seed + d) % _U64(self.width)
            np.add.at(self.rows[d], idx.astype(np.int64), counts)
        self.total += int(counts.sum())

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        """Frequency estimate per key (always >= truth)."""
        keys = np.asarray(keys).reshape(-1)
        if keys.size == 0:
            return np.zeros(0, dtype=np.int64)
        est = None
        for d in range(self.depth):
            idx = _mix64(keys, self.seed + d) % _U64(self.width)
            vals = self.rows[d][idx.astype(np.int64)]
            est = vals if est is None else np.minimum(est, vals)
        return est

    def merge(self, other: "CountMinSketch") -> None:
        """Elementwise-sum merge — exact (adds commute), hence
        associative across any thread/process split of one stream."""
        if (other.width, other.depth, other.seed) != (self.width,
                                                      self.depth,
                                                      self.seed):
            raise ValueError("cannot merge CountMinSketch with different "
                             "(width, depth, seed) geometry")
        self.rows += other.rows
        self.total += other.total

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes)

    def to_state(self) -> Dict:
        return {"width": self.width, "depth": self.depth,
                "seed": self.seed, "total": self.total,
                "rows": self.rows.reshape(-1).tolist()}

    @classmethod
    def from_state(cls, state: Dict) -> "CountMinSketch":
        out = cls(state["width"], state["depth"], state.get("seed", 0))
        out.rows = np.asarray(state["rows"], dtype=np.int64).reshape(
            out.depth, out.width)
        out.total = int(state.get("total", 0))
        return out


class SpaceSaving:
    """Space-Saving top-K heavy hitters (Metwally et al.).

    Tracks at most ``capacity`` keys as ``key -> (count, error)``; a new
    key evicts the minimum-count entry and inherits its count as the new
    entry's error, so for every tracked key
    ``count - error <= true frequency <= count`` and every key with true
    frequency above ``total/capacity`` is guaranteed present."""

    def __init__(self, capacity: int = 128):
        self.capacity = max(4, int(capacity))
        self._counts: Dict[int, int] = {}
        self._errors: Dict[int, int] = {}
        self.total = 0

    def update(self, keys: np.ndarray, counts: Optional[np.ndarray] = None
               ) -> None:
        keys = np.asarray(keys).reshape(-1)
        if keys.size == 0:
            return
        # Pre-aggregate the batch: one dict transaction per UNIQUE key.
        uniq, cnt = np.unique(keys, return_counts=True)
        if counts is not None:
            counts = np.asarray(counts, dtype=np.int64).reshape(-1)
            cnt = np.zeros(uniq.shape[0], dtype=np.int64)
            np.add.at(cnt, np.searchsorted(uniq, keys), counts)
        self.total += int(cnt.sum())
        tracked = self._counts
        errors = self._errors
        for k, c in zip(uniq.tolist(), cnt.tolist()):
            cur = tracked.get(k)
            if cur is not None:
                tracked[k] = cur + c
            elif len(tracked) < self.capacity:
                tracked[k] = c
                errors[k] = 0
            else:
                victim = min(tracked, key=tracked.get)
                floor = tracked.pop(victim)
                errors.pop(victim, None)
                tracked[k] = floor + c
                errors[k] = floor

    def topk(self, n: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """``(key, count, error)`` descending by count (count is an
        over-estimate by at most error)."""
        items = sorted(self._counts.items(), key=lambda kv: -kv[1])
        if n is not None:
            items = items[:n]
        return [(k, c, self._errors.get(k, 0)) for k, c in items]

    def reliable_counts(self) -> List[int]:
        """Error-corrected frequencies of the CONFIDENTLY-tracked keys
        (``error < count/2``), descending — the frequency-CDF input.
        Raw Space-Saving counts over-estimate by up to their error, and
        tail slots sit at the eviction floor (error ~ count); feeding
        those into a power-law fit flattens the tail and over-predicts
        coverage. ``count - error`` is a guaranteed lower bound that is
        near-exact for genuinely hot keys."""
        return sorted((c - e for _, c, e in self.topk() if e < c / 2),
                      reverse=True)

    def merge(self, other: "SpaceSaving") -> None:
        """Union-then-truncate merge: counts and errors sum per key, the
        merged set keeps the top ``capacity`` by count and the evicted
        minimum seeds the floor error — heavy hitters of the combined
        stream survive any split/merge order (order can perturb TAIL
        entries only, never a key above ``total/capacity``)."""
        merged: Dict[int, int] = dict(self._counts)
        errors: Dict[int, int] = dict(self._errors)
        for k, c in other._counts.items():
            merged[k] = merged.get(k, 0) + c
            errors[k] = errors.get(k, 0) + other._errors.get(k, 0)
        keep = sorted(merged.items(), key=lambda kv: -kv[1])
        floor = keep[self.capacity][1] if len(keep) > self.capacity else 0
        keep = keep[:self.capacity]
        self._counts = dict(keep)
        self._errors = {k: min(errors.get(k, 0) + floor, c)
                        for k, c in keep}
        self.total += other.total

    def __len__(self) -> int:
        return len(self._counts)

    @property
    def nbytes(self) -> int:
        # dict-entry bookkeeping estimate: two dict slots + ints per key.
        return len(self._counts) * 96

    def to_state(self) -> Dict:
        return {"capacity": self.capacity, "total": self.total,
                "items": [[k, c, self._errors.get(k, 0)]
                          for k, c in self._counts.items()]}

    @classmethod
    def from_state(cls, state: Dict) -> "SpaceSaving":
        out = cls(state["capacity"])
        for k, c, e in state.get("items", []):
            out._counts[int(k)] = int(c)
            out._errors[int(k)] = int(e)
        out.total = int(state.get("total", 0))
        return out


class TrafficSketch:
    """One surface's full traffic picture: Count-Min + Space-Saving +
    row/byte totals. NOT thread-safe — the hub serializes updates under
    its own lock."""

    def __init__(self, width: int = 1024, depth: int = 4,
                 topk: int = 128, seed: int = 0):
        self.cms = CountMinSketch(width, depth, seed)
        self.heavy = SpaceSaving(topk)
        self.keys = 0
        self.bytes = 0

    def update(self, keys: np.ndarray, nbytes: int = 0) -> None:
        keys = np.asarray(keys).reshape(-1)
        self.cms.update(keys)
        self.heavy.update(keys)
        self.keys += int(keys.size)
        self.bytes += int(nbytes)

    def merge(self, other: "TrafficSketch") -> None:
        self.cms.merge(other.cms)
        self.heavy.merge(other.heavy)
        self.keys += other.keys
        self.bytes += other.bytes

    @property
    def nbytes(self) -> int:
        return self.cms.nbytes + self.heavy.nbytes

    def share_of_top(self, n: int) -> float:
        """Fraction of the observed key stream absorbed by the top-n
        keys (0.0 on an empty stream)."""
        if self.keys <= 0:
            return 0.0
        top = self.heavy.topk(n)
        return min(sum(c for _, c, _ in top) / self.keys, 1.0)

    def summary(self, topn: int = 10) -> Dict:
        return {"keys": self.keys, "bytes": self.bytes,
                "top1_share": round(self.share_of_top(1), 4),
                "topk_share": round(self.share_of_top(
                    self.heavy.capacity), 4),
                "memory_bytes": self.nbytes,
                "topk": [[int(k), int(c), int(e)]
                         for k, c, e in self.heavy.topk(topn)]}

    def to_state(self) -> Dict:
        return {"cms": self.cms.to_state(),
                "heavy": self.heavy.to_state(),
                "keys": self.keys, "bytes": self.bytes}

    @classmethod
    def from_state(cls, state: Dict) -> "TrafficSketch":
        out = cls()
        out.cms = CountMinSketch.from_state(state["cms"])
        out.heavy = SpaceSaving.from_state(state["heavy"])
        out.keys = int(state.get("keys", 0))
        out.bytes = int(state.get("bytes", 0))
        return out


# ---------------------------------------------------------------------------
# Frequency-CDF math: what share of the stream do the top-n keys carry?
# ---------------------------------------------------------------------------
def coverage_at(counts_desc: Sequence[int], total: int, n: int) -> float:
    """Predicted fraction of the key stream covered by its ``n`` hottest
    keys, from the top-K heavy-hitter ``counts_desc`` (descending).

    Within the tracked K the CDF is read directly; beyond it the tail is
    extrapolated with a power law fitted to the tracked ranks
    (``c(r) ~ c1 * r^-alpha`` by log-log least squares) — the shape
    real key streams overwhelmingly follow, and the reason a bounded
    sketch can size an unbounded cache. Clamped to [0, 1]."""
    counts = [float(c) for c in counts_desc if c > 0]
    n = int(n)
    if total <= 0 or n <= 0 or not counts:
        return 0.0
    k = len(counts)
    head = sum(counts[:min(n, k)])
    if n <= k:
        return min(head / total, 1.0)
    if k < 4:
        return min(head / total, 1.0)   # too few ranks to fit a tail
    ranks = np.log(np.arange(1, k + 1, dtype=np.float64))
    vals = np.log(np.asarray(counts, dtype=np.float64))
    slope, intercept = np.polyfit(ranks, vals, 1)
    alpha = float(np.clip(-slope, 0.05, 4.0))
    c1 = math.exp(float(intercept))
    # Discrete tail sum k+1..n via the integral of c1*r^-alpha (exact
    # enough at these magnitudes; the fit dominates the error).
    if abs(alpha - 1.0) < 1e-6:
        tail = c1 * (math.log(n + 0.5) - math.log(k + 0.5))
    else:
        tail = c1 * ((k + 0.5) ** (1.0 - alpha)
                     - (n + 0.5) ** (1.0 - alpha)) / (alpha - 1.0)
    return float(min(max((head + max(tail, 0.0)) / total, 0.0), 1.0))


def load_ratio(values: Sequence[float], q: float = 0.99) -> float:
    """p99-to-mean load ratio across shards (1.0 = perfectly balanced;
    the alertable skew scalar). With few shards the q-quantile is the
    max — exactly the shard an operator would rebalance away from."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return 1.0
    mean = sum(vals) / len(vals)
    if mean <= 0.0:
        return 1.0
    # Ceiling-rank quantile: one hot shard out of 100 still lands AT or
    # ABOVE the q index — the hottest shard must never round out of its
    # own alert.
    idx = min(len(vals) - 1, max(0, int(math.floor(q * len(vals)))))
    return vals[idx] / mean


# ---------------------------------------------------------------------------
# Hub: per-thread buffers -> per-surface sketches -> registry metrics.
# ---------------------------------------------------------------------------
class SketchHub:
    """Process-global sketch registry with a one-append hot path.

    ``record(surface, keys)`` appends ``(surface, keys, nbytes)`` to a
    per-thread buffer (registered once per thread under the hub lock);
    ``flush()`` — driven by the telemetry tick or any reader that wants
    fresh numbers — drains every buffer into the
    per-surface :class:`TrafficSketch` and publishes the derived load
    metrics. A thread whose buffer outgrows :data:`FLUSH_PENDING`
    self-drains so unticked processes stay bounded too."""

    #: Surface-cardinality bound — the data-plane microscope must never
    #: become the registry explosion it helps the lint rule prevent.
    MAX_SURFACES = 64
    FLUSH_PENDING = 256

    def __init__(self, width: Optional[int] = None,
                 depth: Optional[int] = None,
                 topk: Optional[int] = None):
        from multiverso_tpu_torch.utils.configure import flag_or
        self.width = int(width if width is not None
                         else flag_or("telemetry_sketch_width", 1024))
        self.depth = int(depth if depth is not None
                         else flag_or("telemetry_sketch_depth", 4))
        self.topk = int(topk if topk is not None
                        else flag_or("telemetry_sketch_topk", 128))
        self.enabled = bool(flag_or("telemetry_sketch", True))
        self._lock = make_lock("telemetry.sketch")
        self._sketches: Dict[str, TrafficSketch] = {}
        #: (owner thread, buffer) pairs — the owner reference exists so
        #: dead threads' drained buffers can be pruned (see _drain).
        self._buffers: List[Tuple[threading.Thread, list]] = []
        self._tl = threading.local()
        self._advisors: Dict[str, Callable[[], Dict]] = {}
        self._autosizers: Dict[str, Callable[[Dict], None]] = {}
        #: Per-surface (keys, bytes) publication watermark: counters inc
        #: by sketch-total minus watermark at flush, so an overflow fold
        #: on a recording thread (no publication) is still counted
        #: exactly on the next tick.
        self._published: Dict[str, Tuple[int, int]] = {}
        self._dropped = counter("telemetry.sketch.surfaces_dropped")

    # -- hot path ------------------------------------------------------------
    def record(self, surface: str, keys, nbytes: int = 0) -> None:
        """ONE list-append on the caller's thread; hashing, heap
        maintenance and gauge publication happen at flush on the
        telemetry tick. If a tickless process lets the buffer outgrow
        :data:`FLUSH_PENDING` the caller folds its OWN buffer only
        (:meth:`_fold_own` — bounded memory, no publication)."""
        if not self.enabled:
            return
        buf = getattr(self._tl, "buf", None)
        if buf is None:
            buf = self._tl.buf = []
            with self._lock:
                self._buffers.append((threading.current_thread(), buf))
        buf.append((surface, keys, nbytes))
        if len(buf) >= self.FLUSH_PENDING:
            self._fold_own(buf)

    # -- flush / reads -------------------------------------------------------
    def _drain(self) -> Dict[str, Tuple[list, int]]:
        """Swap every thread buffer empty (GIL-atomic pops — records
        landing mid-drain just wait for the next tick) and group the
        pending items by surface. Buffers of DEAD threads are pruned
        once drained — per-connection reader threads churn, and their
        empty buffers must not accumulate over a week-long run."""
        with self._lock:
            self._buffers = [(t, b) for t, b in self._buffers
                             if b or t.is_alive()]
            buffers = [b for _, b in self._buffers]
        pending: Dict[str, Tuple[list, int]] = {}
        for buf in buffers:
            self._drain_buffer(buf, pending)
        return pending

    @staticmethod
    def _drain_buffer(buf: list, pending: Dict[str, Tuple[list, int]]
                      ) -> None:
        while buf:
            try:
                surface, keys, nbytes = buf.pop()
            except IndexError:      # racing drains
                break
            arrs, total = pending.get(surface, ([], 0))
            arrs.append(np.asarray(keys).reshape(-1))
            pending[surface] = (arrs, total + int(nbytes))

    def _fold_locked(self, pending: Dict[str, Tuple[list, int]]) -> int:
        """Fold grouped pending items into the per-surface sketches.
        Caller holds ``_lock``; returns the dropped-surface count."""
        dropped = 0
        for surface, (arrs, nbytes) in pending.items():
            sk = self._sketches.get(surface)
            if sk is None:
                if len(self._sketches) >= self.MAX_SURFACES:
                    dropped += 1
                    continue
                sk = self._sketches[surface] = TrafficSketch(
                    self.width, self.depth, self.topk)
            keys = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
            sk.update(keys, nbytes)
        return dropped

    def _fold_own(self, buf: list) -> None:
        """Overflow relief ON the recording thread: fold only this
        thread's buffer into the sketches — no registry publication, no
        advisor — so memory stays bounded in unticked processes while
        the overflow cost is hashing the thread's OWN pending keys, not
        a full hub flush on a request path."""
        pending: Dict[str, Tuple[list, int]] = {}
        self._drain_buffer(buf, pending)
        if not pending:
            return
        with self._lock:
            dropped = self._fold_locked(pending)
        if dropped:
            self._dropped.inc(dropped)

    def flush(self) -> None:
        """Fold pending key arrays into the sketches and publish the
        derived per-surface load metrics into the registry (the
        timeseries tick differentiates the counters into rows/sec and
        bytes/sec series). Publication is watermark-driven, so keys an
        overflowing thread folded between ticks are counted here too."""
        pending = self._drain()
        publish: List[Tuple[str, int, int, float, float]] = []
        with self._lock:
            dropped = self._fold_locked(pending)
            for surface, sk in self._sketches.items():
                pub_keys, pub_bytes = self._published.get(surface, (0, 0))
                if sk.keys == pub_keys and sk.bytes == pub_bytes:
                    continue
                publish.append((surface, sk.keys - pub_keys,
                                sk.bytes - pub_bytes, sk.share_of_top(1),
                                sk.share_of_top(sk.heavy.capacity)))
                self._published[surface] = (sk.keys, sk.bytes)
            advisors = dict(self._advisors) if publish else {}
        for surface, d_keys, d_bytes, top1, topk in publish:
            # Registry publication: cumulative counters + last-value
            # skew gauges per surface. Surface names come from the
            # bounded hub registry (MAX_SURFACES-capped), never from
            # raw runtime values.
            # graftlint: disable=unbounded-metric-name
            counter(f"sketch.{surface}.keys").inc(d_keys)
            # graftlint: disable=unbounded-metric-name
            counter(f"sketch.{surface}.bytes").inc(d_bytes)
            # graftlint: disable=unbounded-metric-name
            gauge(f"sketch.{surface}.top1_share").set(top1)
            # graftlint: disable=unbounded-metric-name
            gauge(f"sketch.{surface}.topk_share").set(topk)
        if dropped:
            self._dropped.inc(dropped)
        for surface, feed in advisors.items():
            self._publish_advice(surface, feed)

    # -- cache-headroom advisor ---------------------------------------------
    def register_advisor(self, surface: str,
                         feed: Callable[[], Dict]) -> None:
        """Attach a cache to a surface: ``feed()`` returns
        ``{"capacity", "hits", "misses", "stale"}`` (the cache's own
        counters). Each flush publishes the predicted-vs-measured hit
        rates as ``serve.cache.advisor.*`` gauges."""
        with self._lock:
            self._advisors[surface] = feed

    def register_autosizer(self, surface: str,
                           cb: Callable[[Dict], None]) -> None:
        """Attach an actuation callback to a surface's advisor: after
        each advice publication ``cb`` receives the advice dict (with
        ``measured_hit_rate`` merged in). The cache autosizer
        (``serving/cache.py``) closes the sense->act loop here."""
        with self._lock:
            self._autosizers[surface] = cb

    def advise(self, surface: str, capacity: int) -> Dict:
        """The advisor computation itself: the frequency CDF's predicted
        hit rate for a ``capacity``-row cache on this surface's stream."""
        with self._lock:
            sk = self._sketches.get(surface)
            if sk is None or sk.keys <= 0:
                return {"predicted_hit_rate": 0.0, "observed_keys": 0}
            counts = sk.heavy.reliable_counts()
            total = sk.keys
        return {"predicted_hit_rate": round(
                    coverage_at(counts, total, capacity), 4),
                "predicted_hit_rate_2x": round(
                    coverage_at(counts, total, 2 * capacity), 4),
                "observed_keys": total}

    def _publish_advice(self, surface: str, feed: Callable[[], Dict]
                        ) -> None:
        try:
            state = feed()
        except Exception:  # noqa: BLE001 - a dead cache must not kill flush
            return
        capacity = int(state.get("capacity", 0))
        if capacity <= 0:
            return
        advice = self.advise(surface, capacity)
        if not advice.get("observed_keys"):
            return
        hits = float(state.get("hits", 0))
        lookups = hits + float(state.get("misses", 0)) \
            + float(state.get("stale", 0))
        measured = hits / lookups if lookups > 0 else 0.0
        predicted = advice["predicted_hit_rate"]
        gauge("serve.cache.advisor.predicted_hit_rate").set(predicted)
        gauge("serve.cache.advisor.predicted_hit_rate_2x").set(
            advice["predicted_hit_rate_2x"])
        gauge("serve.cache.advisor.measured_hit_rate").set(measured)
        # gap > 0: the stream's CDF says this capacity could hit more
        # than the cache delivers (staleness churn, cold start); the
        # *_2x gauge says whether doubling -serve_cache_rows would buy
        # anything at all.
        gauge("serve.cache.advisor.gap").set(predicted - measured)
        with self._lock:
            autosizer = self._autosizers.get(surface)
        if autosizer is not None:
            try:
                autosizer({**advice, "measured_hit_rate": measured})
            except Exception:  # noqa: BLE001 - actuation must not kill flush
                counter("serve.cache.autosize.errors").inc()

    # -- views ---------------------------------------------------------------
    def surfaces(self) -> List[str]:
        with self._lock:
            return sorted(self._sketches)

    def sketch(self, surface: str) -> Optional[TrafficSketch]:
        with self._lock:
            return self._sketches.get(surface)

    def summary(self, surface: str, topn: int = 10) -> Dict:
        with self._lock:
            sk = self._sketches.get(surface)
            return sk.summary(topn) if sk is not None else {
                "keys": 0, "bytes": 0, "top1_share": 0.0,
                "topk_share": 0.0, "memory_bytes": 0, "topk": []}

    def memory_bytes(self) -> int:
        with self._lock:
            return sum(sk.nbytes for sk in self._sketches.values())

    def memory_bound(self) -> int:
        """Configured worst-case resident bytes: every surface slot at
        its fixed CMS geometry plus a full heavy-hitter table."""
        per = self.width * self.depth * 8 + self.topk * 96
        return self.MAX_SURFACES * per

    def snapshot(self, topn: int = 10) -> Dict:
        """Every surface's summary, as the JAX package's exporter embeds
        it (``sketches`` section of a snapshot)."""
        with self._lock:
            surfaces = {name: sk.summary(topn)
                        for name, sk in self._sketches.items()}
        return {"width": self.width, "depth": self.depth,
                "topk": self.topk, "surfaces": surfaces}

    def reset(self) -> None:
        with self._lock:
            self._sketches.clear()
            self._advisors.clear()
            self._autosizers.clear()
            self._published.clear()
            for _, buf in self._buffers:
                del buf[:]


_hub: Optional[SketchHub] = None
_hub_lock = make_lock("telemetry.sketch.hub")


def get_sketch_hub() -> SketchHub:
    global _hub
    with _hub_lock:
        if _hub is None:
            _hub = SketchHub()
        return _hub


def record_keys(surface: str, keys, nbytes: int = 0) -> None:
    """Module-level hot-path shim (one attribute load + the hub's one
    list-append) for instrumented sites."""
    hub = _hub
    if hub is None:
        hub = get_sketch_hub()
    hub.record(surface, keys, nbytes)


def set_sketch_enabled(on: bool) -> None:
    """Bench A/B hook: the plain leg turns recording off entirely so the
    measured overhead covers the append too, not just the tick."""
    get_sketch_hub().enabled = bool(on)


def reset_sketches() -> None:
    """Test isolation (wired into ``reset_telemetry``)."""
    global _hub
    with _hub_lock:
        if _hub is not None:
            _hub.reset()
        _hub = None
