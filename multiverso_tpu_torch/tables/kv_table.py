"""Distributed key->value table (port of ``multiverso_tpu/tables/kv_table.py``).

Reference: ``include/multiverso/table/kv_table.h`` — worker keeps a local
cache (``raw()``); ``Partition`` hashes ``key % num_servers``
(``kv_table.h:48-50``); the server map does ``+=`` on Add and returns values
on Get (``kv_table.h:86-106``); Store/Load were unimplemented there
(``kv_table.h:108-114``) — implemented here.

Design note: the reference's KV tables hold small host-side metadata (e.g.
word counts for the WordEmbedding lr schedule); keys are arbitrary 64-bit
ints. A host-resident hash map with vectorized numpy batch ops is the faithful
equivalent; dense bounded-key workloads that belong in HBM should use
:class:`ArrayTable`/:class:`MatrixTable`. The map is thread-safe for the async
engine.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from multiverso_tpu_torch.core.options import KVTableOption
from multiverso_tpu_torch.core.zoo import Zoo
from multiverso_tpu_torch.parallel.device import check_comm_policy
from multiverso_tpu_torch.utils.log import check


class KVTable:
    def __init__(self, option: KVTableOption):
        zoo = Zoo.get()
        check(zoo.started, "call mv.init() before creating tables")
        self.name = option.name or f"kv_{len(zoo.tables)}"
        self.value_dtype = np.dtype(option.value_dtype)
        self.num_servers = zoo.num_servers()
        self._server_maps = [dict() for _ in range(self.num_servers)]
        self._cache: Dict[int, float] = {}
        self._lock = threading.Lock()
        self.table_id = zoo.register_table(self)
        # Per-table communication policy (a label and its counters).
        self.comm = check_comm_policy(option.comm_policy, self.name,
                                      (1,), self.value_dtype)
        self.comm_policy = self.comm.policy

    # -- worker cache (ref kv_table.h:30-40) -------------------------------
    def raw(self) -> Dict[int, float]:
        return self._cache

    # -- ops ---------------------------------------------------------------
    def get(self, keys) -> np.ndarray:
        """Pull values for keys into the local cache and return them."""
        keys = np.asarray(keys, dtype=np.int64).ravel()
        out = np.zeros(len(keys), dtype=self.value_dtype)
        with self._lock:
            for i, k in enumerate(keys.tolist()):
                sid = self._route(k)
                val = self._server_maps[sid].get(k, self.value_dtype.type(0))
                self._cache[k] = val
                out[i] = val
        self.comm.record_client_op(keys.nbytes + out.nbytes)
        return out

    def add(self, keys, values) -> None:
        """Server-side ``+=`` per key (ref kv_table.h:86-93)."""
        keys = np.asarray(keys, dtype=np.int64).ravel()
        values = np.asarray(values, dtype=self.value_dtype).ravel()
        check(len(keys) == len(values), "keys/values length mismatch")
        with self._lock:
            for k, v in zip(keys.tolist(), values.tolist()):
                sid = self._route(k)
                store = self._server_maps[sid]
                store[k] = store.get(k, 0) + v
        self.comm.record_client_op(keys.nbytes + values.nbytes)

    def _route(self, key: int) -> int:
        return int(key) % self.num_servers  # ref kv_table.h:48-50

    def partition(self, keys) -> Dict[int, np.ndarray]:
        keys = np.asarray(keys, dtype=np.int64).ravel()
        out: Dict[int, list] = {}
        for k in keys.tolist():
            out.setdefault(self._route(k), []).append(k)
        return {sid: np.asarray(ks, dtype=np.int64)
                for sid, ks in out.items()}

    # -- checkpointing (unimplemented in the reference) --------------------
    def store_state(self) -> Dict[str, np.ndarray]:
        all_keys, all_vals = [], []
        with self._lock:
            for server in self._server_maps:
                for k, v in server.items():
                    all_keys.append(k)
                    all_vals.append(v)
        return {"keys": np.asarray(all_keys, dtype=np.int64),
                "values": np.asarray(all_vals, dtype=self.value_dtype)}

    def load_state(self, payload: Dict[str, np.ndarray]) -> None:
        with self._lock:
            for server in self._server_maps:
                server.clear()
            for k, v in zip(payload["keys"].tolist(),
                            payload["values"].tolist()):
                self._server_maps[self._route(k)][k] = v

    def close(self) -> None:
        with self._lock:
            self._cache.clear()
