"""Flat c_api-style surface (port of ``multiverso_tpu/binding/c_api.py``).

Parity with ``include/multiverso/c_api.h:14-54`` / ``src/c_api.cpp:10-92``:
handle-based flat functions over float Array/Matrix tables
(init/shutdown/barrier/id queries, New/Get/Add with async variants, by-rows
matrix ops). The reference exposed this as ``extern "C"`` for Python ctypes /
Lua FFI / C# CLR; here Python IS the host language, so the flat
module is the FFI boundary (the native C++ layer sits below it in
``runtime/``; a foreign host speaks the PS wire through
``runtime/src/mv_client.cpp``, ``runtime/ffi.py::CClient``), and table
handles are integer ids exactly like the CLR binding's table ids
(``binding/C#/MultiversoCLR``). Tables live on the Zoo's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import multiverso_tpu_torch as mv
_tables: Dict[int, object] = {}
_next_handle = [0]


def _new_handle(table) -> int:
    _next_handle[0] += 1
    _tables[_next_handle[0]] = table
    return _next_handle[0]


def _table(handle: int):
    return _tables[handle]


# -- lifecycle (ref c_api.h:16-24) ------------------------------------------
def MV_Init(argv: Optional[List[str]] = None) -> List[str]:
    return mv.init(argv)


def MV_ShutDown() -> None:
    _tables.clear()
    mv.shutdown()


def MV_Barrier() -> None:
    mv.barrier()


def MV_NumWorkers() -> int:
    return mv.num_workers()


def MV_NumServers() -> int:
    return mv.num_servers()


def MV_WorkerId() -> int:
    return mv.worker_id()


def MV_ServerId() -> int:
    return mv.server_id()


def MV_NetBind(host: str = "127.0.0.1", port: int = 0):
    return mv.net_bind(host, port)


def MV_NetConnect(peers) -> None:
    mv.net_connect(peers)


# -- array tables (ref c_api.h:26-38) ---------------------------------------
def MV_NewArrayTable(size: int, init_value: Optional[np.ndarray] = None
                     ) -> int:
    table = mv.create_table(mv.ArrayTableOption(size=size))
    if init_value is not None and mv.is_master_worker():
        # master-only init trick (binding/python/multiverso/tables.py:58-75)
        table.add(np.asarray(init_value, dtype=np.float32))
    return _new_handle(table)


def MV_GetArrayTable(handle: int, size: Optional[int] = None) -> np.ndarray:
    out = _table(handle).get()
    return out if size is None else out[:size]


def MV_AddArrayTable(handle: int, delta: np.ndarray) -> None:
    _table(handle).add(np.asarray(delta, dtype=np.float32))


def MV_AddAsyncArrayTable(handle: int, delta: np.ndarray) -> int:
    return _table(handle).add_async(np.asarray(delta, dtype=np.float32))


def MV_WaitArrayTable(handle: int, msg_id: int) -> None:
    _table(handle).wait(msg_id)


# -- matrix tables (ref c_api.h:40-54) --------------------------------------
def MV_NewMatrixTable(num_row: int, num_col: int,
                      init_value: Optional[np.ndarray] = None) -> int:
    table = mv.create_table(mv.MatrixTableOption(num_row=num_row,
                                                 num_col=num_col))
    if init_value is not None and mv.is_master_worker():
        table.add(np.asarray(init_value, dtype=np.float32)
                  .reshape(num_row, num_col))
    return _new_handle(table)


def MV_GetMatrixTableAll(handle: int) -> np.ndarray:
    return _table(handle).get()


def MV_AddMatrixTableAll(handle: int, delta: np.ndarray) -> None:
    t = _table(handle)
    t.add(np.asarray(delta, dtype=np.float32).reshape(t.num_row, t.num_col))


def MV_GetMatrixTableByRows(handle: int, row_ids) -> np.ndarray:
    return _table(handle).get_rows(row_ids)


def MV_AddMatrixTableByRows(handle: int, row_ids, delta: np.ndarray) -> None:
    t = _table(handle)
    t.add_rows(row_ids, np.asarray(delta, dtype=np.float32)
               .reshape(len(row_ids), t.num_col))


def MV_AddAsyncMatrixTableAll(handle: int, delta: np.ndarray) -> int:
    t = _table(handle)
    return t.add_async(np.asarray(delta, dtype=np.float32)
                       .reshape(t.num_row, t.num_col))


def MV_WaitMatrixTable(handle: int, msg_id: int) -> None:
    _table(handle).wait(msg_id)
