"""Per-table communication policy: PS push/pull vs collectives.

Port of ``multiverso_tpu/parallel/comm_policy.py``. Three policies,
selected per table at construction:

* ``ps`` — push/pull through the table clients (the only plane with
  row-granular sparse access);
* ``allreduce`` — gradients merged by a collective inside the training
  step (an all-reduce over a rank mesh axis, ``parallel/collectives.py``);
  the PS table stays the publish/checkpoint surface, written at sync
  points;
* ``model_average`` — the reference's "ma" mode: replicas trained apart
  and averaged periodically over the collective plane
  (:func:`model_average_arrays`).

``auto`` applies :func:`resolve_comm_policy`'s decision table: an explicit
override wins; sparse or HBM-scale tables -> ``ps``; small dense tables ->
whichever plane a cached one-shot probe (:func:`measured_policy_latency_ms`)
measures faster for the table's byte size on this process's device and
world. The probe is the port's own measurement; no decision is copied from
the JAX package's TPU readings. ``model_average`` is never chosen by AUTO:
it changes training semantics.

In a world of more than one rank the probe's all-reduce leg is a real
collective, and its readings are averaged over the world so that every
rank takes the same decision: every rank must resolve the same tables in
the same order, as it must create them.

Telemetry: ``comm.<policy>.bytes``/``.ops`` counters and
``comm.<policy>.latency_ms`` histograms per plane, ``comm.policy.resolve.
<policy>`` decision counters, ``comm.policy.ps_fallback`` for client row
ops against a non-ps table.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.parallel import collectives
from multiverso_tpu_torch.parallel.mesh import SERVER_AXIS
from multiverso_tpu_torch.telemetry import counter, histogram
from multiverso_tpu_torch.utils.log import check, log

PS = "ps"
ALLREDUCE = "allreduce"
MODEL_AVERAGE = "model_average"
AUTO = "auto"
COMM_POLICIES = (PS, ALLREDUCE, MODEL_AVERAGE)

# Decision-table thresholds (the JAX package's). A table larger than
# ALLREDUCE_BYTES_MAX is "HBM-scale": densifying its gradient for an
# all-reduce would move the whole table every step where the PS row plane
# moves only the touched rows.
ALLREDUCE_BYTES_MAX = 16 << 20
# Row-granular tables at/above this row count are sparse-access
# (embedding-shaped): the dense collective loses by construction.
SPARSE_ROWS_MIN = 4096

# One measurement per log2 byte bucket and device/world signature.
_PROBE_CACHE: Dict[Tuple[int, str], Dict[str, float]] = {}
_PROBE_LOCK = threading.Lock()

# Bounded decision log: the evidence a bench record embeds.
_DECISIONS: List[Dict[str, Any]] = []
_DECISIONS_MAX = 256


def _probe_device() -> torch.device:
    """The device the probe runs on: the started Zoo's, else the
    ``-platform`` flag's (the card unless ``cpu``)."""
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.parallel.device import resolve_device
    from multiverso_tpu_torch.utils.configure import get_flag
    zoo = Zoo._instance
    if zoo is not None and zoo.started:
        return zoo.device
    return resolve_device(get_flag("platform"))


def _mesh_signature(device: torch.device, mesh, world: int) -> str:
    base = f"{device.type}/w{world}"
    if mesh is None:
        return base
    return base + ":" + ",".join(f"{k}={v}" for k, v in mesh.shape.items())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measured_policy_latency_ms(nbytes: int, mesh=None, world: int = 1,
                               iters: int = 5,
                               device: Optional[torch.device] = None
                               ) -> Dict[str, float]:
    """Measured per-op latency of both planes for a buffer of ``nbytes``
    on ``device`` (default: the Zoo's).

    ``ps``: the client round trip — a host-to-device upload of a delta,
    the server's add on the device, and the pull's device-to-host read.
    ``allreduce``: the merge as the policy would run it for ``world``
    contributors — an all-reduce over the mesh's server axis, divided by
    its size, when there is more than one contributor and more than one
    rank on that axis; else the one-contributor case, one dispatch on the
    device with no host transfer.

    Cached per log2-byte bucket per process; both legs time the median of
    ``iters`` runs after a warm-up, synchronized with the device. With a
    process group the two medians are averaged over the world, so every
    rank reads (and decides on) the same numbers."""
    dev = torch.device(device) if device is not None else _probe_device()
    n = max(int(nbytes) // 4, 1)
    key = (n.bit_length(), _mesh_signature(dev, mesh, world))
    with _PROBE_LOCK:
        hit = _PROBE_CACHE.get(key)
    if hit is not None:
        return hit

    data = torch.zeros(n, dtype=torch.float32, device=dev)
    delta_host = np.ones(n, np.float32)
    data = data + torch.as_tensor(delta_host, device=dev)   # warm-up
    data.cpu()
    ps_times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        data = data + torch.as_tensor(delta_host, device=dev)
        data.cpu().numpy()          # the pull's read (synchronizes)
        ps_times.append((time.perf_counter() - t0) * 1e3)

    n_axis, group = collectives.axis_group(mesh, SERVER_AXIS)
    if world > 1 and n_axis > 1:
        def merge(v):
            return collectives.allreduce_sum(v, group) / n_axis
    else:
        def merge(v):
            return v + 0.0
    buf = merge(torch.zeros(n, dtype=torch.float32, device=dev))
    _sync(dev)
    ar_times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        buf = merge(buf)
        _sync(dev)
        ar_times.append((time.perf_counter() - t0) * 1e3)

    ps_ms, ar_ms = float(np.median(ps_times)), float(np.median(ar_times))
    agreed = collectives.world_size()
    if agreed > 1:
        both = collectives.allreduce_sum(
            torch.tensor([ps_ms, ar_ms], dtype=torch.float64)) / agreed
        ps_ms, ar_ms = float(both[0]), float(both[1])
    out = {PS: ps_ms, ALLREDUCE: ar_ms, "nbytes": int(nbytes),
           "world": int(world), "device": dev.type}
    with _PROBE_LOCK:
        _PROBE_CACHE[key] = out
    return out


def _log_decision(table: str, policy: str, reason: str,
                  probe: Optional[Dict[str, float]] = None) -> None:
    counter(f"comm.policy.resolve.{policy}").inc()
    entry = {"table": table, "policy": policy, "reason": reason}
    if probe is not None:
        entry["probe_ms"] = {PS: probe[PS], ALLREDUCE: probe[ALLREDUCE]}
    if len(_DECISIONS) < _DECISIONS_MAX:
        _DECISIONS.append(entry)
    log.info("comm policy[%s]: %s (%s)", table or "?", policy, reason)


def _nbytes(shape: Sequence[int], dtype: Any) -> int:
    from multiverso_tpu_torch.core.table import torch_dtype
    if not len(tuple(shape)):
        return 0
    return int(np.prod([int(s) for s in shape])) * \
        torch_dtype(dtype).itemsize


def resolve_comm_policy(shape: Sequence[int], dtype: Any, *,
                        sparse: bool = False,
                        explicit: Optional[str] = None,
                        mesh=None, world: int = 0, probe: bool = True,
                        table: str = "") -> str:
    """AUTO decision table (per table):

    1. an explicit policy (anything but None/""/"auto") wins, validated;
    2. ``sparse`` (row-granular access) -> ``ps``;
    3. table bytes > ``ALLREDUCE_BYTES_MAX`` (HBM-scale) -> ``ps``;
    4. otherwise small dense: the cached probe picks whichever of {ps
       round trip, all-reduce at this ``world`` width} it measured faster
       for this byte size (``probe=False`` skips the measurement and
       takes ``allreduce``).

    ``world`` is the number of contributors the all-reduce would reduce
    over; 0 means this process's world size."""
    if explicit not in (None, "", AUTO):
        check(explicit in COMM_POLICIES,
              f"comm_policy must be one of {COMM_POLICIES} or '{AUTO}'; "
              f"got {explicit!r}")
        _log_decision(table, explicit, "explicit override")
        return explicit
    nbytes = _nbytes(shape, dtype)
    if sparse:
        _log_decision(table, PS, "sparse row-granular access")
        return PS
    if nbytes > ALLREDUCE_BYTES_MAX:
        _log_decision(table, PS,
                      f"hbm-scale ({nbytes} B > {ALLREDUCE_BYTES_MAX} B)")
        return PS
    if not probe:
        _log_decision(table, ALLREDUCE, "small dense (unprobed)")
        return ALLREDUCE
    world = world or collectives.world_size()
    lat = measured_policy_latency_ms(nbytes, mesh, world=world)
    policy = PS if lat[PS] < lat[ALLREDUCE] else ALLREDUCE
    _log_decision(table, policy,
                  f"probe {lat[PS]:.3f}ms ps vs {lat[ALLREDUCE]:.3f}ms "
                  f"allreduce @ {nbytes} B, world {world}", probe=lat)
    return policy


def decision_evidence() -> Dict[str, Any]:
    """Every resolution this process made (bounded) and the probe
    cache."""
    with _PROBE_LOCK:
        cache = {f"2^{k[0]}B@{k[1]}": dict(v)
                 for k, v in _PROBE_CACHE.items()}
    return {"decisions": list(_DECISIONS), "probe_cache": cache}


def reset_decisions() -> None:
    """Test isolation: clear the decision log (the probe cache survives:
    it is a physical measurement, not state under test)."""
    del _DECISIONS[:]


# -- per-plane telemetry -----------------------------------------------------
def record(plane: str, nbytes: int, ms: Optional[float] = None) -> None:
    """Count one communication op on ``plane`` (bytes moved + optional
    latency). Factories are looked up per call so telemetry resets between
    tests never detach the counters."""
    counter(f"comm.{plane}.bytes").inc(int(nbytes))
    counter(f"comm.{plane}.ops").inc()
    if ms is not None:
        histogram(f"comm.{plane}.latency_ms").observe(float(ms))


class CommPolicy:
    """Per-table policy record: the resolved plane plus the routed-op
    telemetry hooks the table clients call."""

    __slots__ = ("policy", "table")

    def __init__(self, policy: str, table: str = ""):
        check(policy in COMM_POLICIES,
              f"comm policy must be one of {COMM_POLICIES}; got {policy!r}")
        self.policy = policy
        self.table = table

    def record_client_op(self, nbytes: int,
                         ms: Optional[float] = None) -> None:
        """A push/pull through the table client API — always the PS plane
        physically; on a non-ps table it is also counted as a fallback
        (the model bypassed its own policy)."""
        record(PS, nbytes, ms)
        if self.policy != PS:
            counter("comm.policy.ps_fallback").inc()

    def record_publish(self, nbytes: int,
                       ms: Optional[float] = None) -> None:
        """A whole-replica publish at a sync point (allreduce /
        model-average tables write the store this way)."""
        record(self.policy, nbytes, ms)


def policy_for_option(explicit: Optional[str], shape: Sequence[int] = (),
                      dtype: Any = np.float32, *, sparse: bool = False,
                      mesh=None, table: str = "") -> CommPolicy:
    """The table constructors' entry point: ``None`` (or ``""``) -> ps
    (no probe); a concrete policy -> taken as resolved (models resolve
    before construction, so the decision logs once, with its reason);
    ``"auto"`` -> the decision table on ``shape``/``dtype``."""
    if explicit in (None, ""):
        return CommPolicy(PS, table=table)
    if explicit in COMM_POLICIES:
        return CommPolicy(explicit, table=table)
    if explicit != AUTO:
        raise ValueError(f"comm_policy must be one of {COMM_POLICIES} or "
                         f"'{AUTO}'; got {explicit!r}")
    return CommPolicy(resolve_comm_policy(shape, dtype, sparse=sparse,
                                          explicit=explicit, mesh=mesh,
                                          table=table), table=table)


# -- plane helpers -----------------------------------------------------------
def build_dense_sync(mesh=None, axis: Optional[str] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The hybrid step's dense-plane merge of a small tensor: an
    all-reduce over ``axis`` (default the server axis) divided by the
    axis size, the mean of the ranks' contributions (for identical
    contributions and a power-of-two size, the value itself, bitwise). On
    a one-rank axis, or without a mesh, it is ``x + 0.0``: the identity,
    bitwise what the JAX package's ``psum`` / size gives over identical
    replicas."""
    n, group = collectives.axis_group(mesh, axis or SERVER_AXIS)
    if n <= 1:
        return lambda x: x + 0.0

    def sync(x: torch.Tensor) -> torch.Tensor:
        return collectives.allreduce_sum(x, group) / n

    return sync


def model_average_arrays(arrays: Sequence) -> List:
    """The reference "ma" merge: the elementwise mean of each array across
    every rank of the world, through :func:`collectives.aggregate` (the
    identity at one rank, bitwise). Tensors stay tensors on their device,
    in their dtype; anything else comes back as numpy in its dtype.
    Counted per array under ``comm.model_average.*``."""
    world = collectives.world_size()
    out: List = []
    for a in arrays:
        tensor = isinstance(a, torch.Tensor)
        if not tensor:
            a = np.asarray(a)
        t0 = time.perf_counter()
        merged = collectives.aggregate(a)
        if world > 1:
            merged = (merged / world) if tensor else \
                (merged / world).astype(a.dtype)
        nbytes = a.numel() * a.element_size() if tensor else a.nbytes
        record(MODEL_AVERAGE, nbytes, (time.perf_counter() - t0) * 1e3)
        out.append(merged)
    return out
