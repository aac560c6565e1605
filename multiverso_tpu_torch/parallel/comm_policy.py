"""Per-table communication policy: PS push/pull vs collectives.

Port of the one-rank part of ``multiverso_tpu/parallel/comm_policy.py``.
A table's policy is a label plus telemetry counters:

* ``ps`` — push/pull through the table clients (the only plane with
  row-granular sparse access);
* ``allreduce`` — gradients merged by a collective inside the training
  step; the PS table stays the publish/checkpoint surface, written at
  sync points (DLRM's dense table);
* ``model_average`` — the reference's "ma" mode: replicas averaged
  periodically by the collective plane.

Ported here: the policy constants, :class:`CommPolicy` with its
``comm.<policy>.*`` counters, :func:`record`, :func:`policy_for_option`
for ``None`` or a concrete policy, and :func:`build_dense_sync` for one
rank, where the dense merge is the identity ``x + 0.0``. ``"auto"`` (the
JAX package's measured latency probe), a data-parallel mesh and more than
one rank need the collective plane over ``torch.distributed``: ROADMAP A7.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from multiverso_tpu_torch.telemetry import counter, histogram
from multiverso_tpu_torch.utils.log import check

PS = "ps"
ALLREDUCE = "allreduce"
MODEL_AVERAGE = "model_average"
AUTO = "auto"
COMM_POLICIES = (PS, ALLREDUCE, MODEL_AVERAGE)


def _needs_a7(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the collective plane over several ranks "
        "(torch.distributed): ROADMAP A7")


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


def policy_for_option(explicit: Optional[str], table: str = ""
                      ) -> CommPolicy:
    """The table constructors' entry point: ``None`` (or ``""``) -> ps; a
    concrete policy -> taken as resolved. ``"auto"`` runs the JAX
    package's measured probe, which waits for the collective plane."""
    if explicit in (None, ""):
        return CommPolicy(PS, table=table)
    if explicit in COMM_POLICIES:
        return CommPolicy(explicit, table=table)
    if explicit == AUTO:
        raise _needs_a7(f"comm_policy='auto' for table '{table}' (the "
                        "latency probe between the planes)")
    raise ValueError(f"comm_policy must be one of {COMM_POLICIES} or "
                     f"'{AUTO}'; got {explicit!r}")


def build_dense_sync(mesh=None, axis: Optional[str] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The hybrid step's dense-plane merge for one rank: ``x + 0.0``, an
    identity that keeps the JAX package's op (its one-device jit). A
    data-parallel mesh raises (ROADMAP A7)."""
    del axis
    if mesh is not None:
        raise _needs_a7("a data-parallel mesh for the dense merge")
    return lambda x: x + 0.0
