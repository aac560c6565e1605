"""Fleet layer: a multi-replica serving fabric over the serving plane.

Port of ``multiverso_tpu/fleet``, host-only Python over the port's
serving plane: one serving process serves one table; this package makes
N of them a single logical service. Each lookup replica serves a
``ServerStore`` on the card (its float32 reads take the row gather
kernel), and each ``ps_fleet`` seat applies its Adds with the row
kernels. Layers:

* ``hashring``   — virtual-node consistent hashing: row -> replica
  ownership with minimal key movement on membership change;
* ``health``     — replica health scores computed from the ``serve.*``
  gauges each replica already exports;
* ``membership`` — ``ReplicaGroup`` (router-side join/leave/heartbeat
  authority) + ``FleetMember`` (replica-side agent with the
  drain -> hot-swap -> re-warm -> rejoin lifecycle);
* ``hedge``      — adaptive-delay hedged requests (tail-latency
  mitigation, Dean & Barroso);
* ``router``     — ``FleetRouter``: the control-plane service, an
  optional data-plane proxy, and the rolling-drain coordinator;
* ``client``     — ``FleetClient``: ring-routed lookups, health-balanced
  decode, hedging + typed-failover;
* ``rebalance``  — skew actuators (docs/DESIGN.md "Skew actuation"):
  ``HotKeyReplicator`` (confident hot keys replicated to R extra ring
  owners, reads freshness-gated by the HotRowCache clock rule) and
  ``FleetRebalancer`` (vnode drain-and-handoff migration of hot ranges
  to the coldest member);
* ``supervisor`` — ``ReplicaSupervisor``: the actuation half of the
  self-healing fleet — alert-driven replacement of dead members and
  spawn/drain autoscaling with hysteresis + cooldown
  (docs/DURABILITY.md "Supervisor");
* ``ps_fleet``   — ``PSShardFleet``: supervised multi-shard PS topology
  — N durable WAL'd parameter-server seats of one table, each
  respawned through the checkpoint+WAL-replay recovery path
  (docs/DURABILITY.md "Fleet topology & fault matrix");
* ``chaos``      — ``ChaosEngine``: seeded, composable fault injection
  (kill/pause/net-drop/slow-fsync) for convergence drills.

The wire protocol (the ``Fleet_*`` message types) is the JAX package's,
so routers, members and clients of the two packages interoperate.
"""

from multiverso_tpu_torch.fleet.chaos import ChaosEngine, Fault
from multiverso_tpu_torch.fleet.client import (FleetClient, RoutingTable,
                                               fetch_fleet_stats,
                                               request_drain)
from multiverso_tpu_torch.fleet.hashring import HashRing
from multiverso_tpu_torch.fleet.ps_fleet import PSShardFleet
from multiverso_tpu_torch.fleet.health import (STAT_FIELDS, health_score,
                                               local_stats, metrics_payload)
from multiverso_tpu_torch.fleet.hedge import (AdaptiveDelay, HedgedCall,
                                              HedgeScheduler)
from multiverso_tpu_torch.fleet.membership import (FleetMember, MemberInfo,
                                                   ReplicaGroup)
from multiverso_tpu_torch.fleet.rebalance import (FleetRebalancer,
                                                  HotKeyReplicator)
from multiverso_tpu_torch.fleet.router import FleetRouter
from multiverso_tpu_torch.fleet.supervisor import (LocalFleetView,
                                                   RemoteFleetView,
                                                   ReplicaSupervisor)

__all__ = [
    "AdaptiveDelay", "ChaosEngine", "Fault", "FleetClient", "FleetMember",
    "FleetRebalancer", "FleetRouter", "HashRing", "HedgeScheduler",
    "HedgedCall", "HotKeyReplicator", "LocalFleetView", "MemberInfo",
    "PSShardFleet", "RemoteFleetView",
    "ReplicaGroup", "ReplicaSupervisor", "RoutingTable", "STAT_FIELDS",
    "fetch_fleet_stats", "health_score", "local_stats", "metrics_payload",
    "request_drain",
]
