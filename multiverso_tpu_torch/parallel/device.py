"""Device resolution and the server-shard layout of one card.

The device half of ``multiverso_tpu/parallel/mesh.py`` (the rank half is
``parallel/mesh.py``). The JAX package lays tables out over a
``jax.sharding.Mesh`` whose ``"server"`` axis enumerates device shards.
Each rank of the port runs on ONE card, so the server set is one shard:
every table lives whole on one ``torch.device`` and ``num_servers == 1``.
Sharding tables over several cards is ROADMAP A10.

The device is the CUDA card (``cuda:0``) unless the caller asks for the
CPU with ``-platform=cpu``. There is no silent fallback: with no flag and
no CUDA device, :func:`resolve_device` raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multiverso_tpu_torch.utils.log import log

_CPU_NAMES = ("cpu",)
_CUDA_NAMES = ("", "cuda", "gpu")


def resolve_device(platform: str = "",
                   device: Optional[torch.device] = None) -> torch.device:
    """The device every table and step of this process runs on.

    ``device`` (an explicit ``torch.device``) wins; otherwise ``platform``
    (the ``-platform`` flag): ``cpu`` -> the host CPU, empty/``cuda``/
    ``gpu`` -> ``cuda:0``, which must exist."""
    if device is not None:
        return torch.device(device)
    name = (platform or "").strip().lower()
    if name in _CPU_NAMES:
        return torch.device("cpu")
    if name not in _CUDA_NAMES:
        log.fatal("unknown -platform=%s (want cpu, cuda or empty)", platform)
    if not torch.cuda.is_available():
        log.fatal("no CUDA device is available; pass -platform=cpu to run "
                  "on the host CPU")
    return torch.device("cuda", 0)


def reference_server_offsets(size: int, num_servers: int) -> Tuple[int, ...]:
    """The reference's contiguous partition: even split, last server takes
    the remainder (``src/table/array_table.cpp:98-108``). Returned offsets
    have length num_servers + 1."""
    each = size // num_servers if num_servers else size
    offsets = [min(i * each, size) for i in range(num_servers)]
    offsets.append(size)
    return tuple(offsets)


def check_comm_policy(policy: Optional[str], table: str,
                      shape: Tuple[int, ...] = (), dtype=None,
                      sparse: bool = False):
    """Per-table communication policy, as the JAX tables resolve it: a
    :class:`~multiverso_tpu_torch.parallel.comm_policy.CommPolicy` for
    ``None``/``"ps"`` or a concrete ``allreduce``/``model_average``;
    ``"auto"`` runs the decision table on the table's ``shape`` and
    ``dtype`` (``sparse`` for row-granular tables), over the Zoo's rank
    mesh."""
    from multiverso_tpu_torch.core.zoo import Zoo
    from multiverso_tpu_torch.parallel.comm_policy import policy_for_option
    zoo = Zoo._instance
    mesh = zoo.mesh if zoo is not None and zoo.started else None
    return policy_for_option(policy, shape,
                             dtype if dtype is not None else "float32",
                             sparse=sparse, mesh=mesh, table=table)
