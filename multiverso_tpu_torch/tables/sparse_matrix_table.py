"""Sparse (delta-tracking) matrix table.

Port of ``multiverso_tpu/tables/sparse_matrix_table.py``. Reference:
``src/table/sparse_matrix_table.cpp`` — the server keeps a per-worker
``up_to_date_[worker][row]`` bitmap (``:184-197``); Add invalidates the
touched rows for all *other* workers (``:200-223``); Get returns **only
rows stale for the requesting worker** (``UpdateGetState``, ``:226-258``),
so repeated whole-table Gets are incremental. Requests carry the worker id
via ``GetOption`` (``:36-43``).

Parameter rows live on the device (inherited from :class:`MatrixTable`);
the staleness bitmap is a small host bool matrix (branchy bookkeeping).
The reference's ``SparseFilter`` wire compression (``:148-153,261-309``) is
realized structurally: only stale rows are gathered on the device (the B1
kernel on a ``use_pallas`` table) and only those rows cross to the host.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.core.options import (AddOption, GetOption,
                                               MatrixTableOption)
from multiverso_tpu_torch.core.updater import Updater
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.tables.matrix_table import MatrixTable


class SparseMatrixTable(MatrixTable):
    def __init__(self, option: MatrixTableOption):
        super().__init__(option)
        zoo = Zoo.get()
        num_workers = max(1, zoo.num_workers())
        # Pipelined double-buffering doubles the logical worker slots
        # (ref sparse_matrix_table.cpp:184-197).
        slots = num_workers * 2 if option.is_pipeline else num_workers
        self._slots = slots
        self._stale = np.ones((slots, self.num_row), dtype=bool)
        self._caches: Dict[int, np.ndarray] = {}
        self._stale_lock = threading.Lock()
        # Bitmap semantics are ALWAYS the reference's loose UpdateAddState
        # (:199-223): touched rows go stale for every worker except the
        # writer, whose bits are left unchanged — forcing them fresh
        # would mask another worker's intervening write (and, with
        # random_init, never-pulled rows' init values). Plain-add tables
        # ADDITIONALLY mirror the writer's delta into its cache so rows
        # that were fresh stay both fresh and correct; every other
        # updater skips the mirror (stale rows re-pull server truth).
        # Decided from the RESOLVED updater instance.
        self._mirror = type(self.store.updater) is Updater

    def _cache_for(self, wid: int) -> np.ndarray:
        cache = self._caches.get(wid)
        if cache is None:
            cache = self._caches[wid] = np.zeros(
                (self.num_row, self.num_col), dtype=self.store.dtype)
        return cache

    def _on_write(self, wid: int, rows: Optional[np.ndarray],
                  deltas: np.ndarray) -> None:
        """Staleness + (plain-add) cache bookkeeping for one Add;
        ``rows=None`` means a dense whole-table write. Bits follow the
        loose reference rule for EVERY updater (see __init__)."""
        sel = slice(None) if rows is None else rows
        with self._stale_lock:
            if 0 <= wid < self._slots:
                keep = self._stale[wid, sel].copy()
                self._stale[:, sel] = True
                self._stale[wid, sel] = keep
                if self._mirror:
                    # Fresh rows stay correct; stale rows' cache entries
                    # are garbage either way (overwritten on next pull).
                    if rows is None:
                        self._cache_for(wid)[...] += deltas
                    else:
                        np.add.at(self._cache_for(wid), rows, deltas)
            else:               # unknown writer: everyone is stale
                self._stale[:, sel] = True

    # -- add: invalidate other workers' rows (ref :200-223) ----------------
    def add_rows_async(self, row_ids, deltas,
                       option: Optional[AddOption] = None) -> int:
        option = option or AddOption()
        msg_id = super().add_rows_async(row_ids, deltas, option)
        self._on_write(option.worker_id,
                       np.asarray(row_ids, dtype=np.int64),
                       np.asarray(deltas, dtype=self.store.dtype))
        return msg_id

    def add_async(self, delta, option: Optional[AddOption] = None) -> int:
        option = option or AddOption()
        msg_id = super().add_async(delta, option)
        self._on_write(option.worker_id, None,
                       np.asarray(delta, dtype=self.store.dtype)
                       .reshape(self.num_row, self.num_col))
        return msg_id

    # -- incremental get (ref UpdateGetState :226-258) ---------------------
    def stale_rows(self, worker_id: int) -> np.ndarray:
        with self._stale_lock:
            return np.flatnonzero(self._stale[worker_id]).astype(np.int32)

    def get_stale(self, option: GetOption) -> Tuple[np.ndarray, np.ndarray]:
        """Return (row_ids, values) for exactly the rows stale for this
        worker, and mark them fresh."""
        wid = option.worker_id
        rows = self.stale_rows(wid)
        if len(rows) == 0:
            return rows, np.zeros((0, self.num_col), dtype=self.store.dtype)
        values = self.get_rows(rows)
        with self._stale_lock:
            self._stale[wid, rows] = False
        return rows, values

    # -- checkpointing ------------------------------------------------------
    def load_state(self, payload: Dict[str, np.ndarray]) -> None:
        """Restore marks EVERYTHING stale — the reference-faithful choice
        (the sparse server initializes its bitmap to all-stale on
        construction). A fresh bit promises the worker's cache holds the
        current row, and worker caches are not part of the checkpoint."""
        self.store.load_state(payload)
        with self._stale_lock:
            self._stale[:] = True
            self._caches.clear()

    def get(self, option: Optional[GetOption] = None) -> np.ndarray:
        """Whole-table get. With a GetOption this is incremental: only stale
        rows cross to the host, scattered into a per-worker host cache."""
        if option is None:
            return super().get()
        wid = option.worker_id
        cache = self._cache_for(wid)
        rows, values = self.get_stale(option)
        if len(rows):
            cache[rows] = values
        return cache.copy()
