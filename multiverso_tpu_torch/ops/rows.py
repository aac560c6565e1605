"""Row kernels of the table plane: row gather (B1) and sorted scatter-add (B2).

Port of ``multiverso_tpu/ops/pallas_rows.py``: ``gather_rows`` and
``scatter_add_sorted_rows`` (with the argsort wrapper
``scatter_add_rows``). The kernels are CUDA C++ in ``csrc/rows.cu``; each
wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain PyTorch version beside it for a CPU tensor. Each wrapper counts its
kernel launches in ``LAUNCHES``.

The fused stateful gather-update-scatter (B3) and the tiled scatter-add
(B4) are not ported yet (ROADMAP B3, B4).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from multiverso_tpu_torch.ops import _build

GROUP = 8   # the TPU kernel's fold group for 4-byte rows

#: Kernel launches per wrapper, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"gather_rows": 0, "scatter_add_sorted_rows": 0}

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


def _lib():
    lib = _build.load("rows")
    if not getattr(lib, "_mv_typed", False):
        lib.mv_gather_rows.argtypes = [_c, _c, _c, _i64, _i64, ctypes.c_int,
                                       _c]
        lib.mv_gather_rows.restype = ctypes.c_int
        lib.mv_scatter_add_sorted_rows.argtypes = [
            _c, _c, _c, _i64, _i64, ctypes.c_int, ctypes.c_float, _c]
        lib.mv_scatter_add_sorted_rows.restype = ctypes.c_int
        lib._mv_typed = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_table(table: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32 or \
            not table.is_contiguous():
        raise ValueError("row kernels take a contiguous 2-D float32 table; "
                         f"got {tuple(table.shape)} {table.dtype}")


def _on_card(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"row kernels take tensors on one CUDA device or all "
                     f"on the CPU; got {[str(t.device) for t in tensors]}")


# ---------------------------------------------------------------------------
# B1: gather
# ---------------------------------------------------------------------------
def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain version: ``out[i] = table[ids[i]]``."""
    return table.index_select(0, ids.to(torch.int64))


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[ids[i]]`` for a 2-D float32 table (no clipping:
    callers pass in-range ids, as the store does after clipping)."""
    _check_table(table)
    if not _on_card(table, ids):
        return gather_rows_plain(table, ids)
    ids32 = ids.to(torch.int32).contiguous()
    n, d = ids32.shape[0], table.shape[1]
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    err = _lib().mv_gather_rows(table.data_ptr(), ids32.data_ptr(),
                                out.data_ptr(), n, table.shape[0], d,
                                _stream(table))
    _build.check_launch(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# B2: sorted scatter-add (in place)
# ---------------------------------------------------------------------------
def _check_sign(sign: float) -> float:
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign must be +-1.0 (a direction, not a scale); "
                         f"got {sign}")
    return float(sign)


def scatter_add_sorted_rows_plain(table: torch.Tensor, sorted_ids: torch.Tensor,
                                  sorted_deltas: torch.Tensor,
                                  sign: float = 1.0) -> torch.Tensor:
    """The plain version, in the TPU kernel's arithmetic order: pad to a
    multiple of 8 with the last id and zero deltas, fold each aligned
    group of 8 lanes (``acc[k] = delta[k] + acc[k-1]`` within a run), and
    add each run's group partial to its row group after group. Rounds of
    unique ids keep the adds deterministic on any device."""
    sign = _check_sign(sign)
    n = sorted_ids.shape[0]
    if n == 0:
        return table
    ids = sorted_ids.to(torch.int64)
    deltas = sorted_deltas.to(table.dtype)
    pad = (-n) % GROUP
    if pad:
        ids = torch.cat([ids, ids[-1:].expand(pad)])
        deltas = torch.cat([deltas, deltas.new_zeros((pad, deltas.shape[1]))])
    g = ids.view(-1, GROUP)
    dl = deltas.view(-1, GROUP, deltas.shape[1])
    acc = torch.empty_like(dl)
    acc[:, 0] = dl[:, 0]
    for k in range(1, GROUP):
        same = (g[:, k] == g[:, k - 1]).unsqueeze(-1)
        acc[:, k] = dl[:, k] + torch.where(same, acc[:, k - 1],
                                           torch.zeros_like(acc[:, k - 1]))
    flush = torch.ones_like(g, dtype=torch.bool)
    flush[:, :-1] = g[:, :-1] != g[:, 1:]
    f_ids = g[flush]                       # group-major order
    f_acc = acc[flush]
    if sign < 0:
        f_acc = -f_acc
    keep = (f_ids >= 0) & (f_ids < table.shape[0])
    f_ids, f_acc = f_ids[keep], f_acc[keep]
    if f_ids.numel() == 0:
        return table
    # Rank of each flush among the flushes of its id: round r applies
    # every id's r-th group partial, so each round's ids are unique.
    new = torch.ones_like(f_ids, dtype=torch.bool)
    new[1:] = f_ids[1:] != f_ids[:-1]
    pos = torch.arange(f_ids.numel(), device=f_ids.device)
    first = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)), 0)[0]
    rank = pos - first
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        table.index_add_(0, f_ids[sel], f_acc[sel])
    return table


def scatter_add_sorted_rows(table: torch.Tensor, sorted_ids: torch.Tensor,
                            sorted_deltas: torch.Tensor,
                            sign: float = 1.0) -> torch.Tensor:
    """``table[ids[i]] += sign*deltas[i]`` for SORTED ids, in place;
    ``sign=-1`` gives the SGD updater's ``data -= delta``."""
    sign = _check_sign(sign)
    _check_table(table)
    if not _on_card(table, sorted_ids, sorted_deltas):
        return scatter_add_sorted_rows_plain(table, sorted_ids,
                                             sorted_deltas, sign)
    n, d = sorted_ids.shape[0], table.shape[1]
    if sorted_deltas.shape != (n, d):
        raise ValueError(f"deltas {tuple(sorted_deltas.shape)} != ({n}, {d})")
    ids32 = sorted_ids.to(torch.int32).contiguous()
    deltas = sorted_deltas.to(table.dtype).contiguous()
    err = _lib().mv_scatter_add_sorted_rows(
        table.data_ptr(), ids32.data_ptr(), deltas.data_ptr(), n,
        table.shape[0], d, sign, _stream(table))
    _build.check_launch(err, "scatter_add_sorted_rows")
    LAUNCHES["scatter_add_sorted_rows"] += 1
    return table


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     deltas: torch.Tensor, sign: float = 1.0) -> torch.Tensor:
    """Unsorted wrapper: a stable sort (glue, as XLA's argsort is in the
    JAX package), then the sorted kernel. In place."""
    sorted_ids, order = torch.sort(ids.to(torch.int64), stable=True)
    return scatter_add_sorted_rows(table, sorted_ids,
                                   deltas.index_select(0, order), sign=sign)
