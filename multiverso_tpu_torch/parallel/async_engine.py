"""Async ASGD engine: host-staged delta aggregation + worker pool.

Port of ``multiverso_tpu/parallel/async_engine.py``. The reference's async
path is per-request: every worker Add is a message the server applies
immediately (``src/worker.cpp:53-76``, ``src/server.cpp:36-58``). Per-request
launches waste the card, so worker threads accumulate deltas into a
**native striped-lock host buffer** (``runtime/ffi.py::DeltaBuffer``: no
GIL, a C++ merge loop, the analog of the reference's OpenMP updater loop),
and a drain applies ONE merged Add to the card table through
``ServerStore.apply_rows`` / ``apply_dense``: the sorted scatter-add kernel
(B2) on a ``use_pallas`` sgd or default table, ``ops/rows.add_rows_sorted``
(B4 on a card) on a table without the row kernels. ASGD semantics are
preserved: workers never wait for each other, gets see whatever has been
applied, and the staging window is bounded by ``flush_pending`` / an
explicit flush (a get always flushes first, so a worker reads its own
writes).

Staging merges deltas by summation, which is exact for the accumulating
updaters (default add / SGD). For stateful updaters (momentum, adagrad) the
engine bypasses staging and applies per-request, matching reference behavior
exactly: their Adds take the fused stateful route on a ``use_pallas`` table
and the duplicate combine's fold otherwise.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

import numpy as np

from multiverso_tpu_torch.core.options import AddOption
from multiverso_tpu_torch.core.updater import SGDUpdater, Updater
from multiverso_tpu_torch.runtime.ffi import DeltaBuffer
from multiverso_tpu_torch.telemetry import gauge
from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.utils.log import check
from multiverso_tpu_torch.utils.locks import make_lock


def _stageable(updater: Updater) -> bool:
    return type(updater) in (Updater, SGDUpdater)


class AsyncTableEngine:
    """Wraps an ArrayTable or MatrixTable with staged async adds."""

    def __init__(self, table: Any, flush_pending: int = 64,
                 sparse_drain_max: int = 4096,
                 flush_interval: Optional[float] = None):
        from multiverso_tpu_torch.tables.sparse_matrix_table import \
            SparseMatrixTable

        self.table = table
        import torch

        store = table.store
        check(store.torch_dtype == torch.float32,
              "async staging supports float32 tables")
        check(not isinstance(table, SparseMatrixTable),
              "async staging bypasses per-worker staleness bookkeeping; "
              "use the SparseMatrixTable API directly")
        shape = store.logical_shape
        rows = shape[0]
        cols = shape[1] if len(shape) > 1 else 1
        self._is_matrix = len(shape) > 1
        self._buf = DeltaBuffer(rows, cols)
        self._staged = _stageable(store.updater)
        # SGD negates on the server; stage the raw delta and let the updater
        # negate the merged sum (both are linear).
        self.flush_pending = flush_pending
        self.sparse_drain_max = sparse_drain_max
        self._flush_lock = make_lock("ps.async.flush")
        # Telemetry: staged-delta depth, sampled at every stage/drain
        # (ASYNC_FLUSH latency rides the monitor below). Qualified by the
        # wrapped table's name so two engines don't share one stream —
        # model-declared table names, bounded by construction.
        # graftlint: disable=unbounded-metric-name
        self._g_depth = gauge(
            f"async_engine.queue_depth.{getattr(table, 'name', 'local')}")
        # Optional background flusher: bounds the staging window by TIME as
        # well as by count (ASGD staleness bound).
        self._stop_flusher = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if flush_interval and self._staged:
            def _loop():
                while not self._stop_flusher.wait(flush_interval):
                    self.flush()
            self._flusher = threading.Thread(target=_loop, daemon=True)
            self._flusher.start()

    def close(self) -> None:
        self._stop_flusher.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5)
        self.flush()

    # -- async ops ---------------------------------------------------------
    def add_async(self, delta, option: Optional[AddOption] = None) -> None:
        if not self._staged:
            self.table.add_async(delta, option)
            return
        with monitor("ASYNC_STAGE_ADD"):
            self._buf.add_dense(np.asarray(delta, dtype=np.float32))
        self._g_depth.set(self._buf.pending)
        if self._buf.pending >= self.flush_pending:
            self.flush()

    def add_rows_async(self, row_ids, deltas,
                       option: Optional[AddOption] = None) -> None:
        if not self._staged:
            self.table.add_rows_async(row_ids, deltas, option)
            return
        with monitor("ASYNC_STAGE_ADD"):
            self._buf.add_rows(np.asarray(row_ids, dtype=np.int32),
                               np.asarray(deltas, dtype=np.float32))
        self._g_depth.set(self._buf.pending)
        if self._buf.pending >= self.flush_pending:
            self.flush()

    # -- flush: one merged update on the card -------------------------------
    def flush(self) -> None:
        if not self._staged:
            return
        with self._flush_lock:
            if self._buf.pending == 0:
                return
            try:
                with monitor("ASYNC_FLUSH"):
                    if self._is_matrix:
                        sparse = self._buf.drain_rows(self.sparse_drain_max)
                        if sparse is not None:
                            ids, rows = sparse
                            if len(ids):
                                self.table.store.apply_rows(ids, rows,
                                                            AddOption())
                            return
                    merged, n = self._buf.drain_dense()
                    if n:
                        self.table.store.apply_dense(merged, AddOption())
            finally:
                self._g_depth.set(self._buf.pending)

    # -- reads (read-your-writes) ------------------------------------------
    def get(self, *args, **kwargs) -> np.ndarray:
        self.flush()
        return self.table.get(*args, **kwargs)

    def get_rows(self, row_ids) -> np.ndarray:
        self.flush()
        return self.table.get_rows(row_ids)

    @property
    def pending(self) -> int:
        return self._buf.pending


class WorkerPool:
    """Run ``fn(worker_id)`` on N threads — the analog of N worker ranks
    sharing one host (reference: ``mpirun -np N`` on one box, SURVEY.md §4)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    def run(self, fn: Callable[[int], Any]) -> List[Any]:
        results: List[Any] = [None] * self.num_workers
        errors: List[BaseException] = []

        def _runner(wid: int) -> None:
            try:
                results[wid] = fn(wid)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        threads = [threading.Thread(target=_runner, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
