"""ctypes bindings for the native host runtime.

Port of ``multiverso_tpu/runtime/ffi.py``. The sources are the port's own
copies (``runtime/src/mv_runtime.cpp``: the MPMC queue, the waiter, the
allocator and the striped-lock ``DeltaBuffer``; ``mv_client.cpp``: the C
client of the PS wire). They are compiled with ``g++`` at first use into
``build/multiverso_tpu_torch/`` at the repository root (which
``.gitignore`` lists), never beside the sources, into a library named by
a hash of the sources and the flags, so an edited source is rebuilt and a
stale library is never loaded. Plain ctypes over a flat C ABI, like the
reference's ``binding/python`` over ``c_api``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "src" / "mv_runtime.cpp", _DIR / "src" / "mv_client.cpp")
BUILD_DIR = _DIR.parents[1] / "build" / "multiverso_tpu_torch"
# No -ffast-math: it links crtfastmath.o, which flips FTZ/DAZ for the
# whole process at dlopen and silently changes numpy/torch numerics.
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
             "-fno-math-errno", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class NativeRuntimeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmvtpu_host-{digest[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise NativeRuntimeUnavailable(
            f"native runtime build failed:\n{result.stderr}")
    os.replace(tmp, out)     # atomic: a concurrent loader never sees half


def load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            # _lib_lock held across the compile on purpose: one compile a
            # process; latecomers wait for the finished library.
            _build(out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except (NativeRuntimeUnavailable, OSError):
        return False


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    f32p = c.POINTER(c.c_float)
    i32p = c.POINTER(c.c_int32)

    lib.mvq_create.restype = c.c_void_p
    lib.mvq_destroy.argtypes = [c.c_void_p]
    lib.mvq_push.argtypes = [c.c_void_p, c.c_uint64]
    lib.mvq_pop.argtypes = [c.c_void_p, c.POINTER(c.c_uint64), c.c_long]
    lib.mvq_pop.restype = c.c_int
    lib.mvq_size.argtypes = [c.c_void_p]
    lib.mvq_size.restype = c.c_int64
    lib.mvq_exit.argtypes = [c.c_void_p]

    lib.mvw_create.argtypes = [c.c_int]
    lib.mvw_create.restype = c.c_void_p
    lib.mvw_destroy.argtypes = [c.c_void_p]
    lib.mvw_wait.argtypes = [c.c_void_p, c.c_long]
    lib.mvw_wait.restype = c.c_int
    lib.mvw_notify.argtypes = [c.c_void_p]
    lib.mvw_reset.argtypes = [c.c_void_p, c.c_int]

    lib.mva_create.argtypes = [c.c_long]
    lib.mva_create.restype = c.c_void_p
    lib.mva_destroy.argtypes = [c.c_void_p]
    lib.mva_alloc.argtypes = [c.c_void_p, c.c_long]
    lib.mva_alloc.restype = c.c_void_p
    lib.mva_free.argtypes = [c.c_void_p, c.c_void_p, c.c_long]
    lib.mva_pool_hits.argtypes = [c.c_void_p]
    lib.mva_pool_hits.restype = c.c_uint64

    lib.mvbuf_create.argtypes = [c.c_int64, c.c_int64]
    lib.mvbuf_create.restype = c.c_void_p
    lib.mvbuf_destroy.argtypes = [c.c_void_p]
    lib.mvbuf_add_dense.argtypes = [c.c_void_p, f32p, c.c_float]
    lib.mvbuf_add_rows.argtypes = [c.c_void_p, i32p, c.c_int64, f32p,
                                   c.c_float]
    lib.mvbuf_drain_dense.argtypes = [c.c_void_p, f32p]
    lib.mvbuf_drain_dense.restype = c.c_int64
    lib.mvbuf_drain_rows.argtypes = [c.c_void_p, i32p, f32p, c.c_int64]
    lib.mvbuf_drain_rows.restype = c.c_int64
    lib.mvbuf_pending.argtypes = [c.c_void_p]
    lib.mvbuf_pending.restype = c.c_int64

    # The C client of the PS wire (mv_client.cpp).
    vpp = c.POINTER(c.c_void_p)
    i64p = c.POINTER(c.c_longlong)
    lib.MV_ConnectClient.argtypes = [c.c_char_p, vpp]
    lib.MV_CloseClient.argtypes = [c.c_void_p]
    lib.MV_NumServers.argtypes = [c.c_void_p]
    lib.MV_NewArrayTable.argtypes = [c.c_void_p, c.c_int, c.c_longlong, vpp]
    lib.MV_AddArrayTable.argtypes = [c.c_void_p, f32p, c.c_longlong]
    lib.MV_GetArrayTable.argtypes = [c.c_void_p, f32p, c.c_longlong]
    lib.MV_NewMatrixTable.argtypes = [c.c_void_p, c.c_int, c.c_longlong,
                                      c.c_longlong, vpp]
    lib.MV_AddMatrixTableByRows.argtypes = [c.c_void_p, f32p, i32p,
                                            c.c_longlong]
    lib.MV_GetMatrixTableByRows.argtypes = [c.c_void_p, f32p, i32p,
                                            c.c_longlong]
    lib.MV_NewKVTable.argtypes = [c.c_void_p, c.c_int, vpp]
    lib.MV_AddKVTable.argtypes = [c.c_void_p, i64p, i64p, c.c_longlong]
    lib.MV_GetKVTable.argtypes = [c.c_void_p, i64p, i64p, c.c_longlong]
    lib.MV_FreeTable.argtypes = [c.c_void_p]


def _f32ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
# Pythonic wrappers
# ---------------------------------------------------------------------------
class MtQueue:
    """Blocking MPMC queue of u64 handles (ref mt_queue.h:18-145)."""

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.mvq_create()

    def push(self, item: int) -> None:
        self._lib.mvq_push(self._h, item)

    def pop(self, timeout_ms: int = -1) -> Optional[int]:
        out = ctypes.c_uint64()
        if self._lib.mvq_pop(self._h, ctypes.byref(out), timeout_ms):
            return out.value
        return None

    def __len__(self) -> int:
        return self._lib.mvq_size(self._h)

    def exit(self) -> None:
        self._lib.mvq_exit(self._h)

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.mvq_destroy(self._h)
            self._h = None


class Waiter:
    """Counted latch (ref waiter.h:9-33)."""

    def __init__(self, count: int = 1) -> None:
        self._lib = load()
        self._h = self._lib.mvw_create(count)

    def wait(self, timeout_ms: int = -1) -> bool:
        return bool(self._lib.mvw_wait(self._h, timeout_ms))

    def notify(self) -> None:
        self._lib.mvw_notify(self._h)

    def reset(self, count: int) -> None:
        self._lib.mvw_reset(self._h, count)

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.mvw_destroy(self._h)
            self._h = None


class DeltaBuffer:
    """Striped-lock float32 staging buffer; threads accumulate without the
    GIL, drain hands one merged delta to the device update."""

    def __init__(self, rows: int, cols: int = 1) -> None:
        self._lib = load()
        self.rows = int(rows)
        self.cols = int(cols)
        self._h = self._lib.mvbuf_create(self.rows, self.cols)

    def add_dense(self, delta: np.ndarray, alpha: float = 1.0) -> None:
        delta = np.ascontiguousarray(delta, dtype=np.float32)
        if delta.size != self.rows * self.cols:
            raise ValueError(f"delta of {delta.size} values for a "
                             f"{self.rows} x {self.cols} buffer")
        self._lib.mvbuf_add_dense(self._h, _f32ptr(delta), alpha)

    def add_rows(self, row_ids: np.ndarray, deltas: np.ndarray,
                 alpha: float = 1.0) -> None:
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int32)
        deltas = np.ascontiguousarray(deltas, dtype=np.float32)
        if deltas.shape != (len(row_ids), self.cols):
            raise ValueError(f"deltas {deltas.shape} for {len(row_ids)} "
                             f"rows of {self.cols}")
        self._lib.mvbuf_add_rows(self._h, _i32ptr(row_ids), len(row_ids),
                                 _f32ptr(deltas), alpha)

    def drain_dense(self) -> tuple[np.ndarray, int]:
        out = np.empty((self.rows, self.cols), dtype=np.float32)
        n = self._lib.mvbuf_drain_dense(self._h, _f32ptr(out))
        if self.cols == 1:
            out = out.reshape(self.rows)
        return out, int(n)

    def drain_rows(self, max_rows: int) -> Optional[tuple[np.ndarray,
                                                          np.ndarray]]:
        """Merged (row_ids, rows) of touched rows, or None if more than
        max_rows rows are dirty (fall back to drain_dense)."""
        ids = np.empty(max_rows, dtype=np.int32)
        rows = np.empty((max_rows, self.cols), dtype=np.float32)
        n = self._lib.mvbuf_drain_rows(self._h, _i32ptr(ids), _f32ptr(rows),
                                       max_rows)
        if n < 0:
            return None
        return ids[:n].copy(), rows[:n].copy()

    @property
    def pending(self) -> int:
        return int(self._lib.mvbuf_pending(self._h))

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.mvbuf_destroy(self._h)
            self._h = None


class CClient:
    """The C client of the PS wire (``mv_client.cpp``) through ctypes: a
    foreign host that owns no shard, connected to every server in rank
    order, with the reference's ``c_api`` table calls. Each call is one
    synchronous round trip per touched server; a failure raises."""

    def __init__(self, peers) -> None:
        self._lib = load()
        spec = ";".join(f"{h}:{p}" for h, p in peers).encode()
        h = ctypes.c_void_p()
        _ok(self._lib.MV_ConnectClient(spec, ctypes.byref(h)),
            "MV_ConnectClient")
        self._h = h
        self._tables: list = []

    def _new(self, fn, *args) -> ctypes.c_void_p:
        t = ctypes.c_void_p()
        _ok(fn(self._h, *args, ctypes.byref(t)), fn.__name__)
        self._tables.append(t)
        return t

    def array_table(self, table_id: int, size: int) -> "CArrayTable":
        return CArrayTable(self, self._new(self._lib.MV_NewArrayTable,
                                           table_id, size), size)

    def matrix_table(self, table_id: int, num_row: int,
                     num_col: int) -> "CMatrixTable":
        return CMatrixTable(self, self._new(self._lib.MV_NewMatrixTable,
                                            table_id, num_row, num_col),
                            num_col)

    def kv_table(self, table_id: int) -> "CKVTable":
        return CKVTable(self, self._new(self._lib.MV_NewKVTable, table_id))

    @property
    def num_servers(self) -> int:
        return int(self._lib.MV_NumServers(self._h))

    def close(self) -> None:
        if self._h:
            for t in self._tables:
                self._lib.MV_FreeTable(t)
            self._tables = []
            self._lib.MV_CloseClient(self._h)
            self._h = None


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise OSError(f"{what} failed with code {rc}")


class CArrayTable:
    def __init__(self, client: CClient, handle, size: int) -> None:
        self._lib, self._t, self.size = client._lib, handle, int(size)

    def add(self, delta) -> None:
        delta = np.ascontiguousarray(delta, dtype=np.float32)
        _ok(self._lib.MV_AddArrayTable(self._t, _f32ptr(delta), self.size),
            "MV_AddArrayTable")

    def get(self) -> np.ndarray:
        out = np.empty(self.size, dtype=np.float32)
        _ok(self._lib.MV_GetArrayTable(self._t, _f32ptr(out), self.size),
            "MV_GetArrayTable")
        return out


class CMatrixTable:
    def __init__(self, client: CClient, handle, num_col: int) -> None:
        self._lib, self._t, self.num_col = client._lib, handle, int(num_col)

    def add_rows(self, row_ids, deltas) -> None:
        ids = np.ascontiguousarray(row_ids, dtype=np.int32)
        deltas = np.ascontiguousarray(deltas, dtype=np.float32)
        if deltas.shape != (len(ids), self.num_col):
            raise ValueError(f"deltas {deltas.shape} for {len(ids)} rows "
                             f"of {self.num_col}")
        _ok(self._lib.MV_AddMatrixTableByRows(self._t, _f32ptr(deltas),
                                              _i32ptr(ids), len(ids)),
            "MV_AddMatrixTableByRows")

    def get_rows(self, row_ids) -> np.ndarray:
        ids = np.ascontiguousarray(row_ids, dtype=np.int32)
        out = np.empty((len(ids), self.num_col), dtype=np.float32)
        _ok(self._lib.MV_GetMatrixTableByRows(self._t, _f32ptr(out),
                                              _i32ptr(ids), len(ids)),
            "MV_GetMatrixTableByRows")
        return out


class CKVTable:
    def __init__(self, client: CClient, handle) -> None:
        self._lib, self._t = client._lib, handle

    def add(self, keys, values) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        values = np.ascontiguousarray(values, dtype=np.int64)
        p = ctypes.POINTER(ctypes.c_longlong)
        _ok(self._lib.MV_AddKVTable(self._t, keys.ctypes.data_as(p),
                                    values.ctypes.data_as(p), len(keys)),
            "MV_AddKVTable")

    def get(self, keys) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.zeros(len(keys), dtype=np.int64)
        p = ctypes.POINTER(ctypes.c_longlong)
        _ok(self._lib.MV_GetKVTable(self._t, keys.ctypes.data_as(p),
                                    out.ctypes.data_as(p), len(keys)),
            "MV_GetKVTable")
        return out

