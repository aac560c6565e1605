"""Row kernels of the table plane: row gather (B1), sorted scatter-add (B2),
the fused stateful gather-update-scatter (B3) and the tiled scatter-add
(B4).

Port of ``multiverso_tpu/ops/pallas_rows.py``: ``gather_rows``,
``scatter_add_sorted_rows`` (with the argsort wrapper
``scatter_add_rows``), ``fused_stateful_rows`` and
``tiled_scatter_add_sorted_rows`` (with ``tiled_scatter_add_rows`` and
``tiled_scatter_eligible``), plus ``fold_sorted_runs``, the fold of the
stateful updaters' duplicate combine, ``fused_stateful_sorted_rows``, the
combine and B3 in one pass over sorted runs (the table plane's stateful
row Add), and ``add_rows_sorted``, a row Add whose duplicates fold in lane
order on any device. The kernels are CUDA C++ in ``csrc/rows.cu`` (B1,
B2, B4) and ``csrc/stateful_rows.cu`` (B3, the fused route and the fold);
each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch twin, defined beside it, for CPU tensors. Each wrapper
counts its kernel launches in ``LAUNCHES``. B2 and B4 read int32 or int64
sorted ids as they are given.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.ops import _build

GROUP = 8   # the TPU kernel's fold group for 4-byte rows

#: Kernel launches per wrapper, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"gather_rows": 0, "scatter_add_sorted_rows": 0,
                             "tiled_scatter_add_sorted_rows": 0,
                             "fold_sorted_runs": 0, "fused_stateful_rows": 0,
                             "fused_stateful_sorted_rows": 0}

_c = ctypes.c_void_p
_i64 = ctypes.c_int64


#: The sorted scatters' C entry points, by kernel and id type.
_SCATTER = {("scatter_add_sorted_rows", torch.int32):
            "mv_scatter_add_sorted_rows",
            ("scatter_add_sorted_rows", torch.int64):
            "mv_scatter_add_sorted_rows_i64",
            ("tiled_scatter_add_sorted_rows", torch.int32):
            "mv_tiled_scatter_add_sorted_rows",
            ("tiled_scatter_add_sorted_rows", torch.int64):
            "mv_tiled_scatter_add_sorted_rows_i64"}


def _lib():
    lib = _build.load("rows")
    if not getattr(lib, "_mv_typed", False):
        lib.mv_gather_rows.argtypes = [_c, _c, _c, _i64, _i64, ctypes.c_int,
                                       _c]
        lib.mv_gather_rows.restype = ctypes.c_int
        for name in _SCATTER.values():
            fn = getattr(lib, name)
            fn.argtypes = [_c, _c, _c, _i64, _i64, ctypes.c_int,
                           ctypes.c_float, _c]
            fn.restype = ctypes.c_int
        lib._mv_typed = True
    return lib


#: The fused route's C entry points, by the type of the sorted ids.
_FUSED_SORTED = {torch.int32: "mv_fused_stateful_sorted_rows",
                 torch.int64: "mv_fused_stateful_sorted_rows_i64"}


def _stateful_lib():
    lib = _build.load("stateful_rows")
    if not getattr(lib, "_mv_typed", False):
        scalars = [ctypes.c_float] * 4
        lib.mv_fused_stateful_rows.argtypes = [
            ctypes.c_int, _c, _c, _c, _c, _c, _i64, _i64, ctypes.c_int, _i64,
            *scalars, _c]
        lib.mv_fused_stateful_rows.restype = ctypes.c_int
        for name in _FUSED_SORTED.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int, _c, _c, _c, _c, _c, _c, _i64, _i64,
                           ctypes.c_int, _i64, *scalars, _c]
            fn.restype = ctypes.c_int
        lib.mv_fold_sorted_runs_f32.argtypes = [_c, _c, _c, _i64,
                                                ctypes.c_int, _c]
        lib.mv_fold_sorted_runs_f32.restype = ctypes.c_int
        lib.mv_fold_sorted_runs_f64.argtypes = \
            lib.mv_fold_sorted_runs_f32.argtypes
        lib.mv_fold_sorted_runs_f64.restype = ctypes.c_int
        lib._mv_typed = True
    return lib


def _check_table(table: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32 or \
            not table.is_contiguous():
        raise ValueError("row kernels take a contiguous 2-D float32 table; "
                         f"got {tuple(table.shape)} {table.dtype}")


def _on_card(first: torch.Tensor, *rest: torch.Tensor) -> bool:
    if first.is_cuda:
        dev = first.device
        for t in rest:
            if t.device != dev:
                break
        else:
            return True
    elif first.device.type == "cpu" and \
            all(t.device.type == "cpu" for t in rest):
        return False
    raise ValueError(f"row kernels take tensors on one CUDA device or all "
                     f"on the CPU; got "
                     f"{[str(t.device) for t in (first, *rest)]}")


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
                                _build.stream(table))
    _build.check_launch(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# B2: sorted scatter-add (in place)
# ---------------------------------------------------------------------------
def add_rows_lane_order(table: torch.Tensor, ids: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """``table.at[ids].add(values.astype(table.dtype), mode="drop")`` of
    the JAX package, in place and deterministic on any device: each value
    is rounded to the table's dtype, and each row takes its values one at
    a time in lane order, rounded to the table's dtype after every add,
    which is what XLA's scatter does. For a bfloat16 table ``index_add_``
    does not: on the CPU it differs in most elements, and on the card it
    adds by atomics in no fixed order. Ids outside ``[0, rows)`` are
    dropped. Vectorised by rounds: a stable sort by id gives each lane its
    rank within its run, and round r adds every run's r-th lane (unique
    rows) in float32 (or the table's wider dtype) and rounds back; the
    rounds number the longest run."""
    ids = ids.to(torch.int64).reshape(-1)
    if ids.numel() == 0:
        return table
    keep = (ids >= 0) & (ids < table.shape[0])
    ids, values = ids[keep], values.reshape(ids.shape[0], -1)[keep]
    if ids.numel() == 0:
        return table
    sorted_ids, order = torch.sort(ids, stable=True)
    vals = values.index_select(0, order).to(table.dtype)
    new = torch.ones_like(sorted_ids, dtype=torch.bool)
    new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    pos = torch.arange(sorted_ids.numel(), device=sorted_ids.device)
    rank = pos - torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                              0)[0]
    # Lanes grouped by rank (stable: ascending ids within a round).
    by_rank = torch.sort(rank, stable=True)[1]
    sizes = torch.bincount(rank).tolist()
    flat = table.view(table.shape[0], -1)
    wide = torch.promote_types(table.dtype, torch.float32)
    start = 0
    for size in sizes:
        sel = by_rank[start:start + size]
        start += size
        rows = sorted_ids.index_select(0, sel)
        summed = flat.index_select(0, rows).to(wide) + \
            vals.index_select(0, sel).reshape(size, -1).to(wide)
        flat.index_copy_(0, rows, summed.to(table.dtype))
    return table


def _check_sign(sign: float) -> float:
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign must be +-1.0 (a direction, not a scale); "
                         f"got {sign}")
    return float(sign)


def sort_rows(ids: torch.Tensor, num_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stable sort before the sorted kernels: ``(sorted keys,
    permutation)``. Where ``num_rows`` fits int32, the keys are int32: ids
    below 0 become -1 and ids at or past ``num_rows`` become ``num_rows``
    first, so no int64 id wraps into range, and CUB's radix sort makes half
    the passes. The in-range lanes then keep the int64 sort's positions and
    order (its permutation there, exactly), and the kernels drop the others
    as they drop them from an int64 sort."""
    ids = ids.reshape(-1)
    if num_rows < 2 ** 31:
        keys = ids.clamp(-1, num_rows)
        if keys.dtype != torch.int32:
            keys = keys.to(torch.int32)
    else:
        keys = ids.to(torch.int64)
    return torch.sort(keys, stable=True)


def wrap_row_ids(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Ids in ``[-num_rows, 0)`` wrapped to ``id + num_rows``, every other
    id as it is: how JAX's ``.at[ids]`` reads a negative index before
    ``mode="drop"`` drops what is still out of range."""
    return torch.where(ids < 0, ids + num_rows, ids)


def add_rows_sorted(table: torch.Tensor, ids: torch.Tensor,
                    values: torch.Tensor, sign: float = 1.0,
                    sort: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """``table.at[ids].add(sign * values, mode="drop")`` of the JAX package,
    in place, with the CPU's bits on any device: ids in ``[-rows, 0)``
    wrap to the table's end (:func:`wrap_row_ids`), each row takes its
    values one at a time in lane order, and ids still outside ``[0,
    rows)`` are dropped. On the CPU, and for integer tables anywhere
    (exact in any order), that is ``index_add_`` over the kept lanes. On
    the card, a float32 table takes a stable sort and B4's kernel, which
    adds one delta at a time in sorted order (``row + sign*delta``, the
    bits of ``row + (-delta)``); never ``index_add_``, which adds floats
    by atomics there. bfloat16 tables (anywhere) and other float tables on
    the card go through :func:`add_rows_lane_order`. ``sort`` is
    :func:`sort_rows` of the wrapped ids, made already by a caller that
    adds them to two tables."""
    sign = _check_sign(sign)
    ids = ids.reshape(-1)
    if ids.numel() == 0:
        return table
    rows = table.shape[0]
    ids = wrap_row_ids(ids, rows)
    values = values.reshape(ids.shape[0], -1)
    signed = values if sign > 0 else -values
    if table.dtype == torch.bfloat16:
        return add_rows_lane_order(table, ids, signed)
    if not table.is_cuda or not table.is_floating_point():
        keep = (ids >= 0) & (ids < rows)
        table.view(rows, -1).index_add_(0, ids[keep].to(torch.int64),
                                        signed[keep].to(table.dtype))
        return table
    if table.dtype != torch.float32:
        return add_rows_lane_order(table, ids, signed)
    keys, order = sort if sort is not None else sort_rows(ids, rows)
    tiled_scatter_add_sorted_rows(table.view(rows, -1), keys,
                                  values.index_select(0, order), sign)
    return table


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
    return add_rows_lane_order(table, f_ids, f_acc)


def _launch_sorted(kernel: str, table: torch.Tensor, sorted_ids: torch.Tensor,
                   sorted_deltas: torch.Tensor, sign: float) -> None:
    """Launch B2 or B4 (``kernel``) on the card (no launch for no ids).
    int32 and int64 ids are read where they lie; other integer types are
    cast to int32. A tensor that already has the kernel's type and layout
    is passed as it is."""
    n = sorted_ids.shape[0]
    num_rows, d = table.shape
    if sorted_ids.dim() != 1 or sorted_deltas.shape != (n, d):
        raise ValueError(f"{kernel} takes ids [n] and deltas [n, {d}]; got "
                         f"{tuple(sorted_ids.shape)} and "
                         f"{tuple(sorted_deltas.shape)}")
    if n == 0:
        return
    ids = sorted_ids
    if ids.dtype != torch.int32 and ids.dtype != torch.int64:
        ids = ids.to(torch.int32)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    deltas = sorted_deltas
    if deltas.dtype != torch.float32:
        deltas = deltas.to(torch.float32)
    if not deltas.is_contiguous():
        deltas = deltas.contiguous()
    err = getattr(_lib(), _SCATTER[kernel, ids.dtype])(
        table.data_ptr(), ids.data_ptr(), deltas.data_ptr(), n, num_rows, d,
        sign, _build.stream(table))
    _build.check_launch(err, kernel)
    LAUNCHES[kernel] += 1


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
    _launch_sorted("scatter_add_sorted_rows", table, sorted_ids,
                   sorted_deltas, sign)
    return table


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     deltas: torch.Tensor, sign: float = 1.0) -> torch.Tensor:
    """Unsorted wrapper: a stable sort (glue, as XLA's argsort is in the
    JAX package; :func:`sort_rows`), then the sorted kernel. In place."""
    sorted_ids, order = sort_rows(ids, table.shape[0])
    return scatter_add_sorted_rows(table, sorted_ids,
                                   deltas.index_select(0, order), sign=sign)


# ---------------------------------------------------------------------------
# B4: tiled scatter-add (in place)
# ---------------------------------------------------------------------------
#: The JAX package's eligibility budget: its TPU kernel holds the whole
#: delta block in 8 MiB of VMEM.
TILED_DELTA_LIMIT = 8 << 20


def tiled_scatter_eligible(n_deltas: int, n_cols: int, dtype) -> bool:
    """The JAX package's answer (the delta block fits 8 MiB), so callers of
    both packages decide alike. The CUDA kernel takes any size."""
    itemsize = (dtype.itemsize if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    return n_deltas * n_cols * itemsize <= TILED_DELTA_LIMIT


def tiled_scatter_add_sorted_rows_plain(table: torch.Tensor,
                                        sorted_ids: torch.Tensor,
                                        sorted_deltas: torch.Tensor,
                                        sign: float = 1.0) -> torch.Tensor:
    """The plain version, in the TPU kernel's arithmetic order: each row
    takes its deltas one at a time in sorted order, ``row = row +
    sign*delta`` (the sign applied to each delta before its add); ids out
    of range are dropped."""
    sign = _check_sign(sign)
    deltas = sorted_deltas.to(table.dtype)
    return add_rows_lane_order(table, sorted_ids,
                               deltas if sign > 0 else -deltas)


def tiled_scatter_add_sorted_rows(table: torch.Tensor,
                                  sorted_ids: torch.Tensor,
                                  sorted_deltas: torch.Tensor,
                                  sign: float = 1.0) -> torch.Tensor:
    """``table[ids[i]] += sign*deltas[i]`` for SORTED ids, in place, each
    row folding its deltas into itself one by one (B2 sums a group's
    deltas first: another rounding)."""
    sign = _check_sign(sign)
    _check_table(table)
    if not _on_card(table, sorted_ids, sorted_deltas):
        return tiled_scatter_add_sorted_rows_plain(table, sorted_ids,
                                                   sorted_deltas, sign)
    _launch_sorted("tiled_scatter_add_sorted_rows", table, sorted_ids,
                   sorted_deltas, sign)
    return table


def tiled_scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                           deltas: torch.Tensor,
                           sign: float = 1.0) -> torch.Tensor:
    """Unsorted wrapper: a stable sort (glue, as ``jnp.argsort`` is in the
    JAX package; :func:`sort_rows`), then the tiled kernel. In place."""
    sorted_ids, order = sort_rows(ids, table.shape[0])
    return tiled_scatter_add_sorted_rows(
        table, sorted_ids, deltas.index_select(0, order), sign=sign)


# ---------------------------------------------------------------------------
# The fold of the stateful updaters' duplicate combine
# ---------------------------------------------------------------------------
def fold_runs_lane_order(sorted_ids: torch.Tensor,
                         sorted_deltas: torch.Tensor) -> torch.Tensor:
    """Each lane's run total, every run folded from 0 in lane order with a
    rounding to the deltas' dtype after every add: XLA's ``segment_sum``
    of bfloat16 deltas. Plain PyTorch on any device, deterministic
    (:func:`add_rows_lane_order` over the runs); no kernel. A new
    tensor."""
    if sorted_ids.numel() == 0:
        return sorted_deltas.clone()
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    totals = torch.zeros_like(sorted_deltas)
    add_rows_lane_order(totals, seg, sorted_deltas)
    return totals.index_select(0, seg)


def fold_sorted_runs_plain(sorted_ids: torch.Tensor,
                           sorted_deltas: torch.Tensor) -> torch.Tensor:
    """The plain version: each run of equal sorted ids sums its deltas with
    ``index_add_`` and every lane gets its run's total. On the CPU that
    adds in lane order (``0 + d0 + d1 + ...``); on the card ``index_add_``
    adds with atomics in no fixed order."""
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    totals = torch.zeros_like(sorted_deltas).index_add_(0, seg,
                                                        sorted_deltas)
    return totals.index_select(0, seg)


def fold_sorted_runs(sorted_ids: torch.Tensor,
                     sorted_deltas: torch.Tensor) -> torch.Tensor:
    """Each lane's run total, every run folded in lane order (the CPU's
    bits on the card too, with no float atomics). A new tensor."""
    if not _on_card(sorted_ids, sorted_deltas):
        return fold_sorted_runs_plain(sorted_ids, sorted_deltas)
    n = sorted_ids.shape[0]
    if sorted_deltas.dim() != 2 or sorted_deltas.shape[0] != n:
        raise ValueError(f"deltas {tuple(sorted_deltas.shape)} are not "
                         f"({n}, D)")
    fn = {torch.float32: "mv_fold_sorted_runs_f32",
          torch.float64: "mv_fold_sorted_runs_f64"}.get(sorted_deltas.dtype)
    if fn is None:
        raise ValueError("fold_sorted_runs takes float32 or float64 deltas "
                         f"on the card; got {sorted_deltas.dtype}")
    if n == 0:
        return sorted_deltas.clone()
    ids64 = sorted_ids.to(torch.int64).contiguous()
    deltas = sorted_deltas.contiguous()
    out = torch.empty_like(deltas)
    err = getattr(_stateful_lib(), fn)(ids64.data_ptr(), deltas.data_ptr(),
                                       out.data_ptr(), n, deltas.shape[1],
                                       _build.stream(deltas))
    _build.check_launch(err, "fold_sorted_runs")
    LAUNCHES["fold_sorted_runs"] += 1
    return out


# ---------------------------------------------------------------------------
# B3: fused stateful gather-update-scatter (in place)
# ---------------------------------------------------------------------------
#: The kernel's updaters, by the code of their math in
#: ``csrc/stateful_rows.cu``.
STATEFUL_KINDS = {"momentum_sgd": 0, "adagrad": 1, "ftrl": 2}


def fused_stateful_rows_plain(table: torch.Tensor,
                              state: Dict[str, torch.Tensor],
                              ids: torch.Tensor, deltas: torch.Tensor, opt,
                              updater) -> Tuple[torch.Tensor, Dict]:
    """The plain version: gather the lanes' rows of the table and of every
    state leaf (ids clamped, per-worker leaves at plane ``opt[0]``), apply
    ``updater.rows_math``, and write the in-range lanes back in place."""
    if ids.shape[0] == 0:
        return table, state
    wid = int(opt[0])
    num_rows = table.shape[0]
    ids = ids.to(torch.int64)
    clipped = ids.clamp(0, num_rows - 1)
    planes = {key: leaf[wid] if key in updater.per_worker_state else leaf
              for key, leaf in state.items()}
    new_d, new_st = updater.rows_math(
        table.index_select(0, clipped),
        {key: p.index_select(0, clipped) for key, p in planes.items()},
        deltas, opt)
    keep = (ids >= 0) & (ids < num_rows)
    idx = ids[keep]
    table.index_copy_(0, idx, new_d[keep])
    for key, plane in planes.items():
        plane.index_copy_(0, idx, new_st[key][keep])
    return table, state


def _stateful_args(updater, opt, state):
    """(kind, leaf_a, leaf_b, four float32 scalars) of the kernel."""
    kind = STATEFUL_KINDS[updater.name]
    f = [float(np.float32(x)) for x in opt[1:5]]
    if updater.name == "momentum_sgd":
        return kind, state["smooth"], None, (f[0], 0.0, 0.0, 0.0)
    if updater.name == "adagrad":
        eps = float(np.float32(updater.eps))
        return kind, state["g2"], None, (f[1], f[2], eps, 0.0)
    return kind, state["z"], state["n"], (f[0], f[1], f[2], f[3])


def _check_stateful(table, state, ids, deltas, opt, updater) -> None:
    """Raise on what the fused kernel does not take (card tensors only)."""
    from multiverso_tpu_torch.core.updater import pallas_row_capability
    if updater.name not in STATEFUL_KINDS or \
            pallas_row_capability(updater) != "fused_stateful":
        raise ValueError(f"the fused stateful kernel serves "
                         f"{sorted(STATEFUL_KINDS)} only; got "
                         f"{type(updater).__name__} '{updater.name}'")
    n, d = ids.shape[0], table.shape[1]
    if ids.dim() != 1 or deltas.shape != (n, d):
        raise ValueError(f"ids {tuple(ids.shape)} and deltas "
                         f"{tuple(deltas.shape)} are not [n] and [n, {d}]")
    wid = int(opt[0])
    for key, leaf in state.items():
        lead = ((leaf.shape[0],) if key in updater.per_worker_state else ())
        if leaf.shape != lead + tuple(table.shape) or \
                leaf.dtype != torch.float32 or not leaf.is_contiguous():
            raise ValueError(f"state leaf '{key}' {tuple(leaf.shape)} "
                             f"{leaf.dtype} does not match the table")
        if lead and not 0 <= wid < lead[0]:
            raise ValueError(f"worker id {wid} outside the {lead[0]} "
                             f"planes of state leaf '{key}'")


def _launch_stateful(entry: str, table, state, ids, order, deltas, opt,
                     updater) -> None:
    """Launch the fused kernel through the C entry point ``entry``
    (``order`` None: B3's combined lanes, the fold off)."""
    kind, leaf_a, leaf_b, p = _stateful_args(updater, opt, state)
    deltas = deltas.to(torch.float32).contiguous()
    lead = [] if order is None else [order.data_ptr()]
    err = getattr(_stateful_lib(), entry)(
        kind, table.data_ptr(), leaf_a.data_ptr(),
        None if leaf_b is None else leaf_b.data_ptr(), ids.data_ptr(),
        *lead, deltas.data_ptr(), ids.shape[0], table.shape[0],
        table.shape[1], int(opt[0]), *p, _build.stream(table))
    _build.check_launch(err, entry)


def fused_stateful_rows(table: torch.Tensor, state: Dict[str, torch.Tensor],
                        ids: torch.Tensor, deltas: torch.Tensor, opt,
                        updater) -> Tuple[torch.Tensor, Dict]:
    """One in-place gather-update-scatter over the table and every state
    leaf of a momentum_sgd, adagrad or ftrl updater.

    ``ids``/``deltas`` must already be duplicate-combined
    (:func:`multiverso_tpu_torch.core.updater.combine_duplicate_rows`):
    unique ids, dropped lanes remapped to the sentinel ``table.shape[0]``,
    which write nothing. ``opt`` is ``AddOption.scalars()``. Returns
    ``(table, state)``, both updated in place. The kernel is the fused
    route's with the fold off: each lane its own run, its delta as it
    is."""
    _check_table(table)
    if not state:
        raise ValueError("fused_stateful_rows needs at least one state "
                         "leaf; stateless updaters use scatter_add_rows")
    if not _on_card(table, ids, deltas, *state.values()):
        return fused_stateful_rows_plain(table, state, ids, deltas, opt,
                                         updater)
    _check_stateful(table, state, ids, deltas, opt, updater)
    if ids.shape[0] == 0:
        return table, state
    _launch_stateful("mv_fused_stateful_rows", table, state,
                     ids.to(torch.int64).contiguous(), None, deltas, opt,
                     updater)
    LAUNCHES["fused_stateful_rows"] += 1
    return table, state


def fused_stateful_sorted_rows_plain(table: torch.Tensor,
                                     state: Dict[str, torch.Tensor],
                                     ids: torch.Tensor, deltas: torch.Tensor,
                                     opt, updater
                                     ) -> Tuple[torch.Tensor, Dict]:
    """The plain version of the fused route: the duplicate combine
    (``core/updater.combine_duplicate_rows``), then
    :func:`fused_stateful_rows_plain`."""
    from multiverso_tpu_torch.core.updater import combine_duplicate_rows
    ids, deltas = combine_duplicate_rows(ids.to(torch.int64).reshape(-1),
                                         deltas, table.shape[0])
    return fused_stateful_rows_plain(table, state, ids, deltas, opt, updater)


def fused_stateful_sorted_rows(table: torch.Tensor,
                               state: Dict[str, torch.Tensor],
                               ids: torch.Tensor, deltas: torch.Tensor, opt,
                               updater,
                               sort: Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]] = None
                               ) -> Tuple[torch.Tensor, Dict]:
    """A stateful row Add in one stable sort and one kernel: what
    ``combine_duplicate_rows`` followed by :func:`fused_stateful_rows`
    computes, bit for bit, with no sorted or folded copy of the deltas.

    ``ids`` are raw row ids (any order, duplicates, ids outside ``[0,
    rows)`` dropped), ``deltas`` ``[n, D]`` in the ids' order. The kernel
    folds each run of equal sorted ids from 0 in lane order, reading the
    deltas through the sort's permutation, and updates each touched row
    of the table and of every state leaf once. No host reads. ``sort`` is
    :func:`sort_rows` of these ids, made already. Returns ``(table,
    state)``, both updated in place."""
    _check_table(table)
    if not state:
        raise ValueError("fused_stateful_sorted_rows needs at least one "
                         "state leaf; stateless updaters use "
                         "scatter_add_rows")
    ids = ids.reshape(-1)
    if not _on_card(table, ids, deltas, *state.values()):
        return fused_stateful_sorted_rows_plain(table, state, ids, deltas,
                                                opt, updater)
    _check_stateful(table, state, ids, deltas, opt, updater)
    if ids.shape[0] == 0:
        return table, state
    keys, order = sort if sort is not None else sort_rows(ids,
                                                          table.shape[0])
    _launch_stateful(_FUSED_SORTED[keys.dtype], table, state, keys, order,
                     deltas, opt, updater)
    LAUNCHES["fused_stateful_sorted_rows"] += 1
    return table, state
