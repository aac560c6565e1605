"""Server-side pluggable updaters as plain torch math.

Port of ``multiverso_tpu/core/updater.py`` (ref
``include/multiverso/updater/updater.h:113-140``,
``src/updater/updater.cpp:45-57``): a factory keyed on the
``updater_type`` flag producing one of {default add, sgd, momentum_sgd,
adagrad, ftrl, dcasgd, dcasgda}; integer tables always use the plain adder.

An updater is a set of functions over ``(data, state, delta, opt)``:
``update_dense`` for whole-table Adds, ``update_rows`` for row Adds and
``rows_math`` for the per-row math on gathered row blocks. ``opt`` is the
``AddOption.scalars()`` tuple ``(worker_id, momentum, learning_rate, rho,
lambda_, staleness)``; every float scalar enters the math as a float32
tensor, as in the JAX package, so each op rounds the same way. Torch eager
rounds per op, so the JAX package's ``exact_elementwise`` valve (which
stops XLA:CPU from contracting mul+add to fma) has no counterpart here.

Per-worker AdaGrad accumulators are a ``[num_workers, ...]`` leading-axis
state tensor indexed by ``worker_id``. Row Adds of the stateful updaters
write the table and its state in place (the JAX package donates them).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.ops import rows as _rows
from multiverso_tpu_torch.utils.configure import get_flag

State = Dict[str, torch.Tensor]
# scalars: (worker_id, momentum, learning_rate, rho, lambda_, staleness)
Scalars = Tuple[Any, ...]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device (an option scalar)."""
    return torch.as_tensor(np.float32(x), dtype=torch.float32,
                           device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root. torch's float32 ``sqrt`` on the
    CPU is not: on tensors of more than a few hundred elements it is one
    ulp off for ~0.7% of them (torch 2.13's CPU build), while the card,
    numpy and XLA round exactly. A float64 square root rounded to float32
    is exact (a 53-bit root rounds to 24 bits without double-rounding
    error), so the CPU and the card agree bit for bit."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _opt_staleness(opt: Scalars):
    """Measured clock lag, or -1 when the caller passes a 5-tuple."""
    return opt[5] if len(opt) > 5 else np.float32(-1.0)


def combine_duplicate_rows(rows: torch.Tensor, delta: torch.Tensor,
                           num_rows: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold duplicate row ids into one combined delta per id.

    Stateful updaters gather-compute-set, so duplicates must combine
    rather than race. Stable sort by id, sum each run in lane order
    (``0 + d0 + d1 + ...``: ``index_add_`` on the CPU, the fold kernel of
    ``ops/rows.fold_sorted_runs`` on the card, with the same bits;
    bfloat16 deltas round after every add, as XLA's ``segment_sum`` does,
    through ``ops/rows.fold_runs_lane_order`` on any device), give every
    lane its run's total, and remap all but the run's first lane to the
    out-of-range sentinel ``num_rows`` so the write-back drops them.
    Returns ``(rows_eff, delta_combined)`` in sorted order, both the shapes
    of the inputs."""
    if rows.shape[0] == 0:
        return rows, delta
    r, order = torch.sort(rows, stable=True)
    fold = (_rows.fold_runs_lane_order if delta.dtype == torch.bfloat16
            else _rows.fold_sorted_runs)
    d_comb = fold(r, delta.index_select(0, order))
    is_start = torch.ones_like(r, dtype=torch.bool)
    is_start[1:] = r[1:] != r[:-1]
    r_eff = torch.where(is_start, r, torch.full_like(r, num_rows))
    return r_eff, d_comb


class Updater:
    """Base: plain accumulate — ``data += delta`` (ref updater.cpp:19-29).

    ``per_worker_state`` names the state leaves with a leading
    ``[num_workers]`` axis; ``staleness_aware`` is True when ``opt``'s
    staleness scalar changes the math (DC-ASGD family)."""

    name = "default"
    per_worker_state: Tuple[str, ...] = ()
    staleness_aware = False

    def init_state(self, shape: Tuple[int, ...], dtype: torch.dtype,
                   num_workers: int, device: torch.device) -> State:
        del shape, dtype, num_workers, device
        return {}

    def update_dense(self, data, state, delta, opt):
        del opt
        return data + delta, state

    def _row_add(self, data, rows, delta, sign=1.0):
        """``data.at[rows].add(sign * delta, mode="drop")``, in place, each
        row's duplicates folded in lane order on any device, as XLA does
        (``ops/rows.add_rows_sorted``: ``index_add_`` on the CPU, a stable
        sort and B4's kernel for a float32 table on the card, with the
        CPU's bits; a bfloat16 table rounds after every add)."""
        return _rows.add_rows_sorted(data, rows, delta, sign=sign)

    def update_rows(self, data, state, rows, delta, opt):
        del opt
        return self._row_add(data, rows, delta), state

    # -- shared row-block machinery (stateful subclasses) -------------------
    def rows_math(self, d_rows, state_rows, delta, opt):
        raise NotImplementedError(f"{self.name} has no row-block math")

    def _rows_update_via_math(self, data, state, rows, delta, opt):
        """Combine duplicates, then gather the touched rows of data AND
        state (``mode="clip"``), apply :meth:`rows_math` and write both
        back in place (``mode="drop"`` discards the duplicate-run
        sentinels): ``ops/rows.fused_stateful_rows_plain``, the plain
        version of the fused kernel. The JAX package's donated jit becomes
        these in-place writes; the store holds its lock around them."""
        rows, delta = combine_duplicate_rows(rows.to(torch.int64), delta,
                                             data.shape[0])
        return _rows.fused_stateful_rows_plain(data, state, rows, delta,
                                               opt, self)


class SGDUpdater(Updater):
    """``data -= delta``; client pre-scales by lr (ref sgd_updater.h:8-27)."""

    name = "sgd"

    def update_dense(self, data, state, delta, opt):
        del opt
        return data - delta, state

    def update_rows(self, data, state, rows, delta, opt):
        del opt
        return self._row_add(data, rows, delta, sign=-1.0), state


class MomentumUpdater(Updater):
    """``smooth = m*smooth + (1-m)*delta; data -= smooth``
    (ref momentum_updater.h:9-31)."""

    name = "momentum_sgd"

    def init_state(self, shape, dtype, num_workers, device):
        del num_workers
        return {"smooth": torch.zeros(shape, dtype=dtype, device=device)}

    def update_dense(self, data, state, delta, opt):
        m = _f32(opt[1], data).to(data.dtype)
        smooth = m * state["smooth"] + (1 - m) * delta
        return data - smooth, {"smooth": smooth}

    def rows_math(self, d_rows, state_rows, delta, opt):
        m = _f32(opt[1], d_rows).to(d_rows.dtype)
        smooth_rows = m * state_rows["smooth"] + (1 - m) * delta
        return d_rows - smooth_rows, {"smooth": smooth_rows}

    def update_rows(self, data, state, rows, delta, opt):
        return self._rows_update_via_math(data, state, rows, delta, opt)


class AdaGradUpdater(Updater):
    """Per-worker squared-gradient accumulators (ref adagrad_updater.h):
    ``G[w] += (delta/lr)^2; data -= rho / sqrt(G[w] + eps) * delta / lr``.
    lr==0 is guarded to a no-op scale."""

    name = "adagrad"
    eps = 1e-6
    per_worker_state = ("g2",)

    def init_state(self, shape, dtype, num_workers, device):
        del dtype
        return {"g2": torch.zeros((max(num_workers, 1),) + tuple(shape),
                                  dtype=torch.float32, device=device)}

    @staticmethod
    def _grad(d32, lr):
        lr_safe = torch.where(lr > 0, lr, torch.ones_like(lr))
        return d32 / lr_safe

    def update_dense(self, data, state, delta, opt):
        wid = int(opt[0])
        lr, rho = _f32(opt[2], data), _f32(opt[3], data)
        g = self._grad(delta.to(torch.float32), lr)
        g2_w = state["g2"][wid] + torch.square(g)
        g2 = state["g2"].clone()
        g2[wid] = g2_w
        step = rho / _sqrt(g2_w + self.eps) * g
        return data - step.to(data.dtype), {"g2": g2}

    def rows_math(self, d_rows, state_rows, delta, opt):
        lr, rho = _f32(opt[2], d_rows), _f32(opt[3], d_rows)
        g = self._grad(delta.to(torch.float32), lr)
        g2_rows = state_rows["g2"] + torch.square(g)
        step = rho / _sqrt(g2_rows + self.eps) * g
        return d_rows - step.to(d_rows.dtype), {"g2": g2_rows}

    def update_rows(self, data, state, rows, delta, opt):
        return self._rows_update_via_math(data, state, rows, delta, opt)


class DCASGDUpdater(Updater):
    """Delay-compensated ASGD: ``data -= lr * (g + lambda * g*g * (data -
    backup[w]))``, then the worker's backup is refreshed. A measured
    staleness tau >= 0 scales lambda to ``lambda * tau``."""

    name = "dcasgd"
    per_worker_state = ("backup",)
    staleness_aware = True

    @staticmethod
    def _lam_eff(lam, opt, like):
        stale = _f32(_opt_staleness(opt), like)
        return lam * torch.where(stale >= 0.0, stale, torch.ones_like(stale))

    def init_state(self, shape, dtype, num_workers, device):
        del dtype
        return {"backup": torch.zeros((max(num_workers, 1),) + tuple(shape),
                                      dtype=torch.float32, device=device)}

    def update_dense(self, data, state, delta, opt):
        wid = int(opt[0])
        lr = _f32(opt[2], data)
        lam = self._lam_eff(_f32(opt[4], data), opt, data)
        g = delta.to(torch.float32)
        d32 = data.to(torch.float32)
        backup_w = state["backup"][wid]
        step = lr * (g + lam * g * g * (d32 - backup_w))
        new_data = d32 - step
        backup = state["backup"].clone()
        backup[wid] = new_data
        return new_data.to(data.dtype), {"backup": backup}

    def rows_math(self, d_rows, state_rows, delta, opt):
        lr = _f32(opt[2], d_rows)
        lam = self._lam_eff(_f32(opt[4], d_rows), opt, d_rows)
        g = delta.to(torch.float32)
        d32 = d_rows.to(torch.float32)
        step = lr * (g + lam * g * g * (d32 - state_rows["backup"]))
        new_rows = d32 - step
        return new_rows.to(d_rows.dtype), {"backup": new_rows}

    def update_rows(self, data, state, rows, delta, opt):
        return self._rows_update_via_math(data, state, rows, delta, opt)


class DCASGDAUpdater(DCASGDUpdater):
    """Adaptive-lambda DC-ASGD: ``m = eps_m*m + (1-eps_m)*g*g`` and the
    effective lambda is ``lam / sqrt(m + eps)`` elementwise."""

    name = "dcasgda"
    eps_m = 0.95
    eps = 1e-7

    def init_state(self, shape, dtype, num_workers, device):
        st = super().init_state(shape, dtype, num_workers, device)
        st["m"] = torch.zeros(tuple(shape), dtype=torch.float32,
                              device=device)
        return st

    def update_dense(self, data, state, delta, opt):
        wid = int(opt[0])
        lr = _f32(opt[2], data)
        lam = self._lam_eff(_f32(opt[4], data), opt, data)
        g = delta.to(torch.float32)
        d32 = data.to(torch.float32)
        m = self.eps_m * state["m"] + (1.0 - self.eps_m) * g * g
        lam_eff = lam / _sqrt(m + self.eps)
        backup_w = state["backup"][wid]
        step = lr * (g + lam_eff * g * g * (d32 - backup_w))
        new_data = d32 - step
        backup = state["backup"].clone()
        backup[wid] = new_data
        return new_data.to(data.dtype), {"backup": backup, "m": m}

    def rows_math(self, d_rows, state_rows, delta, opt):
        lr = _f32(opt[2], d_rows)
        lam = self._lam_eff(_f32(opt[4], d_rows), opt, d_rows)
        g = delta.to(torch.float32)
        m_rows = self.eps_m * state_rows["m"] + (1.0 - self.eps_m) * g * g
        lam_eff = lam / _sqrt(m_rows + self.eps)
        d32 = d_rows.to(torch.float32)
        step = lr * (g + lam_eff * g * g * (d32 - state_rows["backup"]))
        new_rows = d32 - step
        return (new_rows.to(d_rows.dtype),
                {"backup": new_rows, "m": m_rows})


class FTRLUpdater(Updater):
    """FTRL-proximal with server-resident {z, n} state. Option mapping:
    ``learning_rate`` -> alpha, ``rho`` -> beta, ``lambda_`` -> l1,
    ``momentum`` -> l2. Delta is the raw gradient."""

    name = "ftrl"

    def init_state(self, shape, dtype, num_workers, device):
        del dtype, num_workers
        return {"z": torch.zeros(shape, dtype=torch.float32, device=device),
                "n": torch.zeros(shape, dtype=torch.float32, device=device)}

    @staticmethod
    def _step(w, z, n, g, opt):
        l2, alpha, beta, l1 = (_f32(opt[1], w), _f32(opt[2], w),
                               _f32(opt[3], w), _f32(opt[4], w))
        g32 = g.to(torch.float32)
        n_new = n + torch.square(g32)
        sigma = (_sqrt(n_new) - _sqrt(n)) / alpha
        z_new = z + g32 - sigma * w.to(torch.float32)
        w_new = torch.where(
            torch.abs(z_new) > l1,
            -(z_new - torch.sign(z_new) * l1) /
            ((beta + _sqrt(n_new)) / alpha + l2),
            torch.zeros_like(z_new))
        return w_new.to(w.dtype), z_new, n_new

    def update_dense(self, data, state, delta, opt):
        w, z, n = self._step(data, state["z"], state["n"], delta, opt)
        return w, {"z": z, "n": n}

    def rows_math(self, d_rows, state_rows, delta, opt):
        w_new, z_new, n_new = self._step(d_rows, state_rows["z"],
                                         state_rows["n"], delta, opt)
        return w_new, {"z": z_new, "n": n_new}

    def update_rows(self, data, state, rows, delta, opt):
        return self._rows_update_via_math(data, state, rows, delta, opt)


_REGISTRY: Dict[str, Callable[[], Updater]] = {
    "default": Updater,
    "sgd": SGDUpdater,
    "momentum_sgd": MomentumUpdater,
    "adagrad": AdaGradUpdater,
    "ftrl": FTRLUpdater,
    "dcasgd": DCASGDUpdater,
    "dcasgda": DCASGDAUpdater,
}

# Per-updater row-kernel capability: how an opt-in ``use_pallas`` table's
# row updates lower (the same registry as the JAX package, so both make
# the same dispatch decision).
#   "scatter_add"/"scatter_sub" — the sorted-run scatter kernel
#       (ops/rows.scatter_add_rows, sign +/-1);
#   "fused_stateful"            — duplicates combined and the fused
#       gather-update-scatter applied in one stable sort and one kernel
#       (ops/rows.fused_stateful_sorted_rows).
PALLAS_ROW_CAPABILITY: Dict[str, str] = {
    "default": "scatter_add",
    "sgd": "scatter_sub",
    "momentum_sgd": "fused_stateful",
    "adagrad": "fused_stateful",
    "ftrl": "fused_stateful",
}


def register_updater(name: str, factory: Callable[[], Updater],
                     pallas_capability: Optional[str] = None) -> None:
    if pallas_capability is not None and not (
            isinstance(factory, type) and issubclass(factory, Updater)):
        raise ValueError(
            f"register_updater({name!r}): pallas_capability requires the "
            "factory to be the Updater class itself, not a callable")
    _REGISTRY[name] = factory
    if pallas_capability is not None:
        PALLAS_ROW_CAPABILITY[name] = pallas_capability


def pallas_row_capability(updater: Updater) -> Optional[str]:
    """The row-kernel capability that applies to THIS instance, or None.
    It transfers only when the instance's class IS the registered class."""
    cap = PALLAS_ROW_CAPABILITY.get(updater.name)
    if cap is None or _REGISTRY.get(updater.name) is not type(updater):
        return None
    return cap


def get_updater(dtype: Any, updater_type: Optional[str] = None) -> Updater:
    """Factory (ref src/updater/updater.cpp:45-57). Integer tables always
    get the plain adder (ref updater.cpp:40-43)."""
    try:
        integer = np.issubdtype(np.dtype(dtype), np.integer)
    except TypeError:       # "bfloat16", which numpy knows via ml_dtypes
        integer = False
    if integer:
        return Updater()
    if updater_type is None:
        updater_type = get_flag("updater_type")
    factory = _REGISTRY.get(updater_type)
    if factory is None:
        factory = Updater
    return factory()
