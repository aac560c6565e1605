"""The online-learning loop: train -> checkpoint -> replica-publish ->
serve -> retrain, continuously, from one process.

Port of ``multiverso_tpu/recsys/online.py``. Three cooperating pieces:

* :class:`OnlineLoop` — the trainer driver. Each minibatch is scored
  *prequentially* (every lane predicts on the incoming batch BEFORE the
  trainer learns from it — honest online evaluation, no leakage), then
  trained on; every ``publish_every`` steps the whole model (PS
  embedding tables + the dense replica published to its table) is
  checkpointed through ``core.checkpoint.save_all`` and the follower
  replica hot-swaps to it.
* :class:`FreshnessTracker` — the freshness-vs-staleness quality
  metric. One :class:`~multiverso_tpu_torch.serving.CheckpointReplica`
  follows the checkpoint directory through the REAL load/encode/swap
  path; its per-publish snapshots are retained in a bounded history, so
  lane ``s`` serves predictions from the model as it was ``s``
  publishes ago (lane ``frozen`` = the step-0 snapshot, staleness
  infinity). Per-lane streaming AUC over the same impression stream is
  the published metric.
* :class:`ServeLoad` — the serving plane under load: a
  watchdog-registered thread driving zipf-distributed lookups through a
  live :class:`~multiverso_tpu_torch.serving.SparseLookupRunner` (hot-row
  cache at admission, device gather on miss) at a paced offered QPS
  while training continues.

The loop and the load each register with the watchdog
(``recsys.trainer`` / ``recsys.serve_load``) and beat per iteration.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.models.dlrm.metrics import StreamingAUC
from multiverso_tpu_torch.models.dlrm.model import (DLRMConfig, DLRMModel,
                                                    SnapshotScorer,
                                                    make_forward)
from multiverso_tpu_torch.models.dlrm.stream import (ImpressionStream,
                                                     zipf_ids)
from multiverso_tpu_torch.telemetry import (counter, gauge, histogram, span,
                                            watchdog_register)

__all__ = ["OnlineConfig", "OnlineLoop", "FreshnessTracker", "ServeLoad",
           "make_live_runner"]


@dataclasses.dataclass
class OnlineConfig:
    """Loop cadence. Staleness lanes are measured in *publishes*: lane
    ``s`` serves the checkpoint from ``s`` publishes ago."""
    steps: int = 400
    batch: int = 128
    publish_every: int = 40
    eval_every: int = 4
    lanes: Tuple[int, ...] = (1, 4)
    table_dtype: str = "f32"        # follower replica's storage dtype
    auc_bins: int = 512


class FreshnessTracker:
    """Per-staleness-lane prequential AUC over real replica snapshots."""

    def __init__(self, cfg: DLRMConfig, ckpt_dir: str,
                 lanes: Tuple[int, ...] = (1, 4),
                 table_dtype: str = "f32", auc_bins: int = 512,
                 device=None):
        self.cfg = cfg
        self.device = device
        self.ckpt_dir = ckpt_dir
        self.lanes = tuple(sorted({int(s) for s in lanes if int(s) > 0}))
        self.table_dtype = table_dtype
        self._replica = None
        self._frozen_snap = None
        self._history: collections.deque = collections.deque(
            maxlen=(max(self.lanes) if self.lanes else 0) + 1)
        self._forward = make_forward(cfg)
        self.auc: Dict[str, StreamingAUC] = {
            "fresh": StreamingAUC(auc_bins), "frozen": StreamingAUC(auc_bins)}
        for s in self.lanes:
            self.auc[f"s{s}"] = StreamingAUC(auc_bins)
        self.evals = 0

    def on_publish(self) -> None:
        """Follow the checkpoint the trainer just wrote: real replica
        load + encode + atomic snapshot swap, history retained so the
        stale lanes keep serving the delayed generations."""
        from multiverso_tpu_torch.serving.replica import CheckpointReplica
        if self._replica is None:
            self._replica = CheckpointReplica(self.ckpt_dir, load=True,
                                              table_dtype=self.table_dtype,
                                              device=self.device)
        else:
            self._replica.refresh()
        snap = self._replica.snapshot()
        if self._frozen_snap is None:
            self._frozen_snap = snap
        self._history.append(snap)

    def _snap_for_lane(self, s: int):
        if len(self._history) > s:
            return self._history[-1 - s]
        return self._history[0]

    def _scorer(self, snap) -> SnapshotScorer:
        return SnapshotScorer.from_snapshot(self.cfg, snap,
                                            forward=self._forward)

    def score(self, model: DLRMModel, ids: np.ndarray, dense_x: np.ndarray,
              labels: np.ndarray) -> Dict[str, float]:
        """Every lane predicts the incoming batch; per-lane streaming
        AUC accumulates. Returns this batch's raw scores per lane."""
        out: Dict[str, np.ndarray] = {}
        with span("recsys.score", lanes=len(self.lanes) + 2):
            out["fresh"] = model.predict(ids, dense_x)
            for s in self.lanes:
                out[f"s{s}"] = self._scorer(
                    self._snap_for_lane(s)).scores(ids, dense_x)
            out["frozen"] = self._scorer(self._frozen_snap).scores(
                ids, dense_x)
        for lane, scores in out.items():
            self.auc[lane].update(scores, labels)
            # Lane names are config-bounded (fresh/frozen + the small
            # fixed staleness set), not per-key.
            # graftlint: disable=unbounded-metric-name
            gauge(f"recsys.freshness.auc.{lane}").set(
                self.auc[lane].value())
        self.evals += 1
        return {lane: float(np.mean(s)) for lane, s in out.items()}

    def curve(self) -> List[Dict]:
        """The freshness-vs-staleness curve, fresh -> frozen, for the
        run summary: ``[{lane, staleness_publishes, auc, n}, ...]``."""
        rows = [{"lane": "fresh", "staleness_publishes": 0,
                 "auc": self.auc["fresh"].value(),
                 "n": self.auc["fresh"].positives
                 + self.auc["fresh"].negatives}]
        for s in self.lanes:
            rows.append({"lane": f"s{s}", "staleness_publishes": s,
                         "auc": self.auc[f"s{s}"].value(),
                         "n": self.auc[f"s{s}"].positives
                         + self.auc[f"s{s}"].negatives})
        rows.append({"lane": "frozen", "staleness_publishes": None,
                     "auc": self.auc["frozen"].value(),
                     "n": self.auc["frozen"].positives
                     + self.auc["frozen"].negatives})
        return rows


class OnlineLoop:
    """The trainer driver: prequential scoring, training, periodic
    publish. ``run()`` occupies the calling thread (a caller may run it on
    a worker thread while :class:`ServeLoad` serves concurrently)."""

    def __init__(self, model: DLRMModel, stream: ImpressionStream,
                 ckpt_dir: str, cfg: Optional[OnlineConfig] = None):
        self.model = model
        self.stream = stream
        self.ckpt_dir = ckpt_dir
        self.cfg = cfg or OnlineConfig()
        self.tracker = FreshnessTracker(
            model.cfg, ckpt_dir, lanes=self.cfg.lanes,
            table_dtype=self.cfg.table_dtype, auc_bins=self.cfg.auc_bins,
            device=model.device)
        self.train_auc = StreamingAUC(self.cfg.auc_bins)
        self.losses: List[float] = []
        self._c_updates = counter("recsys.train.updates")
        self._c_examples = counter("recsys.train.examples")
        self._c_publishes = counter("recsys.publishes")
        self._g_loss = gauge("recsys.train.loss")
        self._g_auc = gauge("recsys.train.auc")
        self._h_step = histogram("recsys.train.step_ms")
        self._h_publish = histogram("recsys.publish.latency_ms")
        self.updates_per_sec = 0.0

    def publish(self) -> None:
        """Checkpoint + replica hot-swap: the train->serve handoff."""
        from multiverso_tpu_torch.core.checkpoint import save_all
        t0 = time.perf_counter()
        with span("recsys.publish", step=self.model.steps):
            self.model.sync()
            save_all(self.ckpt_dir, step=self.model.steps)
            self.tracker.on_publish()
        self._c_publishes.inc()
        self._h_publish.observe((time.perf_counter() - t0) * 1e3)

    def run(self, on_step: Optional[Callable[[int], None]] = None) -> Dict:
        """Drive ``cfg.steps`` minibatches; returns the summary dict the
        run reports. ``on_step(i)`` is the test hook (e.g. asserting
        serve results mid-train)."""
        cfg = self.cfg
        wd = watchdog_register("recsys.trainer", timeout_s=120)
        t_start = time.perf_counter()
        try:
            # Step-0 publish anchors the frozen lane BEFORE any
            # training: "stale by infinity" means the init-time model.
            self.publish()
            for i in range(cfg.steps):
                wd.beat()
                batch = self.stream.batch(cfg.batch)
                if cfg.eval_every > 0 and i % cfg.eval_every == 0:
                    self.tracker.score(self.model, batch.ids, batch.dense,
                                       batch.labels)
                t0 = time.perf_counter()
                with span("recsys.step", i=i):
                    loss, scores = self.model.step(batch.ids, batch.dense,
                                                   batch.labels)
                self._h_step.observe((time.perf_counter() - t0) * 1e3)
                self.losses.append(loss)
                self.train_auc.update(scores, batch.labels)
                self._c_updates.inc()
                self._c_examples.inc(cfg.batch)
                self._g_loss.set(loss)
                self._g_auc.set(self.train_auc.value())
                if (i + 1) % cfg.publish_every == 0:
                    self.publish()
                if on_step is not None:
                    on_step(i)
        finally:
            wd.close()
        elapsed = time.perf_counter() - t_start
        self.updates_per_sec = cfg.steps / max(elapsed, 1e-9)
        gauge("recsys.train.updates_per_sec").set(self.updates_per_sec)
        return {
            "steps": cfg.steps,
            "batch": cfg.batch,
            "examples": cfg.steps * cfg.batch,
            "publishes": int(self._c_publishes.value),
            "elapsed_s": round(elapsed, 3),
            "updates_per_sec": round(self.updates_per_sec, 2),
            "examples_per_sec": round(
                cfg.steps * cfg.batch / max(elapsed, 1e-9), 1),
            "final_loss": self.losses[-1] if self.losses else None,
            "train_auc": self.train_auc.value(),
            "freshness": self.tracker.curve(),
            "impressions": self.stream.impressions,
            "drift_steps": self.stream.drifts,
        }


def make_live_runner(model: DLRMModel, field: int = 0, cache_rows: int = 0,
                     cache_staleness: int = 0):
    """A live-table :class:`SparseLookupRunner` over one field's
    embedding table. In sync mode the table's own BSP clock stamps every
    batch (``MatrixTable.serving_runner``); in async mode the trainer's
    step count is the honest stand-in version counter — it advances on
    every committed update, so the cache's staleness bound is measured
    in train steps instead of BSP ticks (same arithmetic, same
    invalidation-by-clock)."""
    from multiverso_tpu_torch.serving.cache import HotRowCache
    from multiverso_tpu_torch.serving.runners import SparseLookupRunner
    from multiverso_tpu_torch.utils.log import check

    check(model.mode == "ps", "live serving needs the PS-backed model")
    table = model.tables[field]
    cache = HotRowCache(cache_rows, staleness=cache_staleness) \
        if cache_rows > 0 else None
    if table._sync is not None:
        return table.serving_runner(cache=cache)
    return SparseLookupRunner(
        table.store, clock_fn=lambda: (float(model.steps), 0.0),
        cache=cache)


class ServeLoad:
    """Paced lookup load against a serving runner on its own thread.

    Mirrors the service admission path: each request first probes the
    hot-row cache (``try_cached``), misses batch onto the device gather
    (``run``). Offered rate is paced per batch; achieved rate, latency
    percentiles, cache hits, and errors are the stats dict."""

    def __init__(self, runner, vocab: int, zipf: float = 1.2,
                 qps: float = 200.0, keys_per_req: int = 16,
                 max_batch: int = 8, seed: int = 7,
                 name: str = "recsys.serve_load"):
        self.runner = runner
        self.vocab = int(vocab)
        self.zipf = float(zipf)
        self.qps = float(qps)
        self.keys_per_req = int(keys_per_req)
        self.max_batch = int(max_batch)
        self.name = name
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.requests = 0
        self.cache_hits = 0
        self.errors = 0
        self.latencies_ms: List[float] = []
        self._t0 = 0.0
        self._elapsed = 0.0
        self._c_lookups = counter("recsys.serve.lookups")
        self._c_errors = counter("recsys.serve.errors")
        self._h_latency = histogram("recsys.serve.latency_ms")

    def _loop(self) -> None:
        wd = watchdog_register(self.name, timeout_s=120)
        interval = self.max_batch / max(self.qps, 1e-9)
        next_t = time.perf_counter()
        try:
            while not self._stop.is_set():
                wd.beat()
                now = time.perf_counter()
                if now < next_t:
                    time.sleep(min(next_t - now, 0.05))
                    continue
                next_t += interval
                self._serve_batch()
        finally:
            wd.close()

    def _serve_batch(self) -> None:
        keys = zipf_ids(self._rng, self.zipf,
                        self.max_batch * self.keys_per_req, self.vocab
                        ).reshape(self.max_batch, self.keys_per_req)
        t0 = time.perf_counter()
        try:
            pending = []
            for i in range(self.max_batch):
                hit = self.runner.try_cached(keys[i]) \
                    if hasattr(self.runner, "try_cached") else None
                if hit is not None:
                    self.cache_hits += 1
                else:
                    pending.append(i)
            if pending:
                batch = keys[pending]
                lengths = np.full(len(pending), self.keys_per_req,
                                  dtype=np.int64)
                out = self.runner.run(batch, lengths)
                for j in range(len(pending)):
                    self.runner.slice_result(out, j, self.keys_per_req)
        except Exception:  # noqa: BLE001 - any serve failure is the metric
            self.errors += self.max_batch
            self._c_errors.inc(self.max_batch)
            return
        ms = (time.perf_counter() - t0) * 1e3
        self.requests += self.max_batch
        self._c_lookups.inc(self.max_batch)
        self._h_latency.observe(ms)
        self.latencies_ms.append(ms)

    def start(self) -> "ServeLoad":
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._loop,
                                        name=self.name, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> Dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        self._elapsed = time.perf_counter() - self._t0
        lat = np.asarray(self.latencies_ms, dtype=np.float64)
        achieved = self.requests / max(self._elapsed, 1e-9)
        gauge("recsys.serve.achieved_qps").set(achieved)
        return {
            "offered_qps": self.qps,
            "achieved_qps": round(achieved, 1),
            "requests": self.requests,
            "cache_hits": self.cache_hits,
            "errors": self.errors,
            "elapsed_s": round(self._elapsed, 3),
            "batch_latency_ms": {
                "p50": round(float(np.percentile(lat, 50)), 3),
                "p99": round(float(np.percentile(lat, 99)), 3),
                "mean": round(float(lat.mean()), 3),
            } if lat.size else None,
        }
