"""Fleet CLI: stand up a multi-replica serving fabric.

Port of ``multiverso_tpu/apps/fleet_main.py``: the same roles, flags and
wire protocol. A replica serves its table from the card unless
``-serve_device=cpu``; the ``local`` role spawns its replicas on the CPU
unless ``-serve_device=default`` is given (N local replicas would
otherwise share one card). Every process stops cleanly on SIGTERM (the
local role stops its replicas first). A replica prints
``FLEET_REPLICA_SERVING {json}`` once it serves (its member id, pid,
address and store's device) and ``FLEET_REPLICA_LAUNCHES {json}`` when
it exits (its member id, pid, device and row kernels' launch counts,
``ops/rows.LAUNCHES``), each in one write: the local role's replicas
share one stdout.

Roles (``-fleet_role``):

* ``router``  — the membership/routing front end (``FleetRouter``).
  Writes its bound control address to ``-fleet_addr_file``; with
  ``-fleet_proxy`` (default) it also answers plain ``Serve_Request``
  traffic by proxying into the fleet.
* ``replica`` — one serving process: loads a checkpoint replica
  (``-checkpoint_dir``, hot-swap on drain) or a seeded synthetic table
  (``-fleet_synthetic=ROWSxCOLS@SEED``: ``numpy.random.default_rng(SEED)
  .normal(size=(ROWS, COLS))`` in float32, the same on every replica),
  warms every
  bucket executable, then joins the router and heartbeats.
* ``local``   — dev topology in one command: an in-process router
  plus ``-fleet_replicas`` spawned replica processes (each pinned to the
  CPU unless ``-serve_device=default``). With ``-fleet_supervise`` the
  spawned fleet is SELF-HEALING: a dead or heartbeat-lost replica
  is respawned through the same spawn path, firing SLO-burn /
  queue-saturation alerts grow the fleet (to ``-fleet_max_replicas``),
  and a long quiet period drains supervisor-grown replicas back down.

* ``drain``   — operator command against a RUNNING fleet: sends
  ``Fleet_Drain`` to the router and waits for the rolling cycle (each
  replica in turn finishes in-flight batches, hot-swaps to the newest
  checkpoint, re-warms, rejoins; the ring never loses more than one
  member and no request is dropped).

* ``ps_fleet`` — supervised multi-shard PS topology
  (``fleet/ps_fleet.py``): ``-ps_fleet_shards`` durable WAL'd
  parameter-server seats of one table (``-ps_tables`` of them, as
  ``ps_shard_main`` takes it), each journaled, periodically
  checkpointed, and respawned through the checkpoint+WAL-replay
  recovery path when it dies; the seats run on the card unless
  ``-serve_device=cpu``.

    python -m multiverso_tpu_torch.apps.fleet_main -fleet_role=local \\
        -checkpoint_dir=/ckpts -fleet_replicas=3 -serve_duration=600
    # ...training lands a new checkpoint...
    python -m multiverso_tpu_torch.apps.fleet_main -fleet_role=drain \\
        -fleet_router=127.0.0.1:7071
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import List

from multiverso_tpu_torch.apps._runner import (fleet_config,
                                               pin_device_if_requested,
                                               run_app, serve_config)
from multiverso_tpu_torch.utils.configure import (define_double, define_int,
                                                  define_string, get_flag)
from multiverso_tpu_torch.utils.log import check, log

# Shared with serve_main (flag registration is idempotent per type).
define_string("checkpoint_dir", "", "checkpoint directory to serve from "
              "(latest complete ckpt_* is loaded; drains hot-swap to it)")
define_string("serve_table", "", "table name to serve rows from (empty = "
              "the checkpoint's first table)")
define_string("serve_device", "default", "default|cpu: the card unless "
              "-serve_device=cpu")
# The ps_fleet role's seat flags, as ps_shard_main defines them.
define_int("ps_table_id", 900, "distributed table id to serve (the first "
           "of -ps_tables)")
define_int("ps_table_size", 10000, "distributed table rows (array: length)")
define_string("ps_tables", "", "comma list of UPDATER[:pallas], one table "
              "each with ids from -ps_table_id up; empty = one default "
              "table")
define_double("ps_checkpoint_every_s", 0.0, "checkpoint this rank's "
              "shard (and truncate the WAL) every N seconds; 0 = never "
              "(the ps_fleet role's seats: every second)")

#: Set by SIGTERM/SIGINT: the role's body returns and shuts down.
_STOP = threading.Event()


def _print_line(tag: str, obj: dict) -> None:
    """``TAG {json}`` in a single write after whatever this process has
    buffered: replicas that share one stdout cannot then split the line
    with their own output."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), f"{tag} {json.dumps(obj)}\n".encode())


def _write_addr_file(path: str, address) -> None:
    if not path:
        return
    with open(path + ".tmp", "w") as f:
        f.write(f"{address[0]}:{address[1]}")
    os.replace(path + ".tmp", path)


def _wait_duration() -> None:
    """Park the main thread while daemons serve, until -serve_duration
    elapses or SIGTERM/SIGINT arrives."""
    duration = float(get_flag("serve_duration"))
    deadline = time.monotonic() + duration if duration > 0 else None
    # Constant cadence on purpose: 0.2s bounds the stop latency.
    while not _STOP.wait(0.2) and (deadline is None
                                   or time.monotonic() < deadline):
        pass
    if _STOP.is_set():
        log.info("fleet_main: stop signal, shutting down")


def _build_synthetic_runner(rows: int, cols: int, seed: int):
    """Seeded synthetic lookup table: every replica spawned with the same
    -fleet_synthetic value serves bitwise-identical rows (what a client's
    parity check against ``numpy`` relies on), from a ``ServerStore`` on
    the process's device (the card unless -platform=cpu)."""
    import numpy as np

    from multiverso_tpu_torch.core.table import ServerStore
    from multiverso_tpu_torch.core.updater import get_updater
    from multiverso_tpu_torch.parallel.device import resolve_device
    from multiverso_tpu_torch.serving import SparseLookupRunner
    from multiverso_tpu_torch.utils.configure import flag_or

    rng = np.random.default_rng(seed)
    device = resolve_device(str(flag_or("platform", "")))
    store = ServerStore(
        "fleet_synthetic", (rows, cols), np.float32,
        get_updater(np.float32, "default"), device, num_workers=1,
        init_array=rng.normal(size=(rows, cols)).astype(np.float32))
    from multiverso_tpu_torch.serving.cache import cache_from_flags
    # The synthetic table is immutable: a constant clock is its honest
    # version (live tables without a real clock refuse to cache —
    # runners.try_cached).
    return SparseLookupRunner(store, clock_fn=lambda: (0.0, 0.0),
                              cache=cache_from_flags()), None


def _build_checkpoint_runner(ckpt_dir: str):
    from multiverso_tpu_torch.serving import (CheckpointReplica,
                                              ReplicaLookupRunner)
    from multiverso_tpu_torch.serving.cache import cache_from_flags

    replica = CheckpointReplica(ckpt_dir)
    snap = replica.snapshot()
    table = str(get_flag("serve_table")) or snap.names[0]
    check(table in snap.names,
          f"-serve_table={table!r} not in checkpoint (has {snap.names})")
    return ReplicaLookupRunner(replica, table,
                               cache=cache_from_flags()), replica


def _replica_body(cfg: dict) -> int:
    from multiverso_tpu_torch.fleet import FleetMember
    from multiverso_tpu_torch.serving import ServingService

    check(cfg["router"] is not None,
          "-fleet_router=host:port is required for the replica role")
    scfg = serve_config()
    ckpt_dir = str(get_flag("checkpoint_dir"))
    if cfg["synthetic"] is not None:
        runner, replica = _build_synthetic_runner(*cfg["synthetic"])
    else:
        check(bool(ckpt_dir), "replica role needs -checkpoint_dir or "
              "-fleet_synthetic")
        runner, replica = _build_checkpoint_runner(ckpt_dir)

    service = ServingService(host=scfg["host"], port=scfg["port"])
    service.register_runner(runner, buckets=scfg["buckets"],
                            max_batch=scfg["max_batch"],
                            max_wait_ms=scfg["max_wait_ms"],
                            max_queue=scfg["max_queue"],
                            pipeline_depth=scfg["pipeline_depth"],
                            continuous=scfg["continuous"],
                            paged=scfg["paged"],
                            kv_dtype=scfg["kv_dtype"],
                            kv_page=scfg["kv_page"],
                            kv_pages=scfg["kv_pages"],
                            prefix_entries=scfg["prefix_entries"])
    # Warm BEFORE joining the ring: the first routed request must never
    # pay a trace.
    warmed = service.warmup()
    swap_fn = replica.refresh if replica is not None else None
    member = FleetMember(cfg["router"], service,
                         member_id=cfg["member_id"] or None,
                         swap_fn=swap_fn,
                         drain_timeout_s=cfg["drain_timeout_s"]).start()
    host, port = service.address
    device = _runner_device(runner)
    log.info("fleet replica %s serving at %s:%d on %s (%d buckets warm)",
             member.member_id, host, port, device, warmed)
    _print_line("FLEET_REPLICA_SERVING", {
        "member": member.member_id, "pid": os.getpid(), "host": host,
        "port": port, "device": device})
    _write_addr_file(str(get_flag("serve_addr_file")), service.address)
    try:
        _wait_duration()
    finally:
        member.close()
        service.close()
        if replica is not None:
            replica.close()
        from multiverso_tpu_torch.ops import rows
        _print_line("FLEET_REPLICA_LAUNCHES", {
            "member": member.member_id, "pid": os.getpid(),
            "device": device, "launches": dict(rows.LAUNCHES)})
    return 0


def _runner_device(runner) -> str:
    """The device the replica's rows live on, as ``torch.device`` names
    it."""
    store = getattr(runner, "store", None)
    if store is not None:
        return str(store.device)
    return str(getattr(getattr(runner, "replica", None), "device", "?"))


def _drain_body(cfg: dict) -> int:
    """Operator command: trigger a rolling drain on a RUNNING fleet and
    wait for every member's drain cycle to complete (observed through
    the routing table's monotonic per-member drains_completed)."""
    from multiverso_tpu_torch.fleet import FleetClient, request_drain

    check(cfg["router"] is not None,
          "-fleet_router=host:port is required for the drain role")
    target = cfg["member_id"] or None
    cli = FleetClient(cfg["router"], hedge="off",
                      rpc_timeout_ms=cfg["rpc_timeout_ms"] or None)
    try:
        before = {m["id"]: int(m.get("drains_completed", 0))
                  for m in cli.routing().members}
        check(bool(before), "fleet has no members to drain")
        ack = request_drain(cfg["router"], member_id=target,
                            timeout_s=cfg["drain_timeout_s"])
        check(bool(ack.get("started")),
              f"router refused drain: {ack.get('reason', '?')}")
        want = [target] if target else sorted(before)
        log.info("drain started for %s; waiting for cycles", want)
        deadline = time.monotonic() + \
            cfg["drain_timeout_s"] * (len(want) + 1)
        pending = list(want)    # reported if the loop never iterates
        delay = 0.05
        while time.monotonic() < deadline:
            table = {m["id"]: m for m in cli.refresh().members}
            pending = [mid for mid in want
                       if mid in table
                       and (int(table[mid].get("drains_completed", 0))
                            <= before.get(mid, 0)
                            or table[mid].get("draining"))]
            if not pending:
                log.info("drain complete: %s", want)
                return 0
            time.sleep(delay)
            delay = min(delay * 2.0, 0.5)
        log.error("drain timed out; still pending: %s", pending)
        return 1
    finally:
        cli.close()


def _ps_fleet_body(cfg: dict) -> int:
    """Supervised multi-shard PS topology: N durable WAL'd ps_shard seats
    under one ReplicaSupervisor, with the client seat (rank 0) held by
    this process. Runs until -serve_duration elapses; a killed shard is
    respawned through the recovery path the whole time."""
    from multiverso_tpu_torch.fleet import PSShardFleet
    from multiverso_tpu_torch.utils.configure import flag_or

    # Seats must outlive the owning window (they exit via close(), not
    # their own timer): pad a bounded window, cap an unbounded one.
    duration = float(flag_or("serve_duration", 0.0))
    seat_duration = duration + 120.0 if duration > 0 else 86400.0
    tables = [t.strip() for t in str(flag_or("ps_tables", "")).split(",")
              if t.strip()]
    fleet = PSShardFleet(
        shards=cfg["ps_shards"],
        table_id=int(flag_or("ps_table_id", 900)),
        table_size=int(flag_or("ps_table_size", 10000)),
        table_kind=str(flag_or("ps_table_kind", "array")),
        table_cols=int(flag_or("ps_table_cols", 8)), tables=tables,
        device="cpu" if str(flag_or("serve_device", "default")) == "cpu"
        else "default",
        workdir=cfg["ps_dir"] or None,
        sync_acks=bool(flag_or("wal_sync_acks", True)),
        wal_flush_ms=float(flag_or("wal_flush_ms", 25.0)),
        checkpoint_every_s=float(flag_or("ps_checkpoint_every_s", 0.0))
        or 1.0,
        serve_duration=seat_duration,
        supervise=True).start()
    log.info("ps fleet serving: %d shard(s), workdir %s",
             fleet.shards, fleet.workdir)
    try:
        _wait_duration()
    finally:
        fleet.close()
    return 0


def _actuator_kwargs(cfg: dict) -> dict:
    """Skew-actuator knobs (``-fleet_hotkey_replicas`` /
    ``-fleet_rebalance*``) in FleetRouter kwarg shape."""
    return {
        "hotkey_replicas": cfg["hotkey_replicas"],
        "rebalance": cfg["rebalance"],
        "rebalance_ratio": cfg["rebalance_ratio"],
        "rebalance_windows": cfg["rebalance_windows"],
        "rebalance_cooldown_s": cfg["rebalance_cooldown_s"],
        "rebalance_vnodes": cfg["rebalance_vnodes"],
    }


def _router_body(cfg: dict) -> int:
    from multiverso_tpu_torch.fleet import FleetRouter

    router = FleetRouter(host=str(get_flag("serve_host")),
                         port=cfg["port"], vnodes=cfg["vnodes"],
                         heartbeat_ms=cfg["heartbeat_ms"],
                         liveness_misses=cfg["liveness_misses"],
                         proxy=cfg["proxy"],
                         **_actuator_kwargs(cfg))
    _write_addr_file(cfg["addr_file"], router.address)
    try:
        _wait_duration()
    finally:
        router.close()
    return 0


def _spawn_replicas(cfg: dict, router_addr, args: List[str],
                    count: int, first_slot: int = 0) -> List:
    """Re-exec this module once per replica, pointed at the router. Each
    child defaults to the CPU (N local replicas would otherwise share one
    card) unless -serve_device is given. ``first_slot`` numbers the
    member ids — the supervisor respawns/scales individual slots through
    the same path."""
    import subprocess

    base = [a for a in args
            if not a.lstrip("-").startswith(("fleet_role=", "fleet_router=",
                                             "fleet_replicas=",
                                             "fleet_port=",
                                             "fleet_addr_file=",
                                             "fleet_supervise=",
                                             "serve_addr_file=",
                                             "serve_port="))]
    if not any(a.lstrip("-").startswith("serve_device=") for a in base):
        base.append("-serve_device=cpu")
    procs = []
    for r in range(first_slot, first_slot + count):
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.apps.fleet_main",
               "-fleet_role=replica",
               f"-fleet_router={router_addr[0]}:{router_addr[1]}",
               f"-fleet_member_id=replica-{r}", *base]
        procs.append(subprocess.Popen(cmd))
    return procs


def _local_body(cfg: dict, remaining_args: List[str]) -> int:
    from multiverso_tpu_torch.fleet import FleetRouter

    router = FleetRouter(host=str(get_flag("serve_host")),
                         port=cfg["port"], vnodes=cfg["vnodes"],
                         heartbeat_ms=cfg["heartbeat_ms"],
                         liveness_misses=cfg["liveness_misses"],
                         proxy=cfg["proxy"],
                         **_actuator_kwargs(cfg))
    _write_addr_file(cfg["addr_file"], router.address)
    procs = _spawn_replicas(cfg, router.address, remaining_args,
                            cfg["replicas"])
    supervisor = None
    try:
        deadline = time.monotonic() + 120
        delay = 0.01
        while len(router.group.member_ids()) < cfg["replicas"]:
            check(time.monotonic() < deadline,
                  "fleet replicas never joined the router")
            if any(p.poll() is not None for p in procs):
                check(False, "a fleet replica exited during bring-up")
            time.sleep(delay)
            delay = min(delay * 2.0, 0.25)
        log.info("fleet up: %d replicas behind %s:%d",
                 cfg["replicas"], *router.address)
        if cfg["supervise"]:
            # Self-healing (-fleet_supervise; docs/DURABILITY.md): the
            # supervisor owns the replica processes from here — a dead
            # or heartbeat-lost member is RESPAWNED through the same
            # spawn path, and firing SLO-burn/queue-saturation alerts
            # grow the fleet (quiet periods shrink it back).
            from multiverso_tpu_torch.fleet import (LocalFleetView,
                                                    ReplicaSupervisor)

            def spawn_one(slot: int):
                return _spawn_replicas(cfg, router.address,
                                       remaining_args, 1,
                                       first_slot=slot)[0]

            supervisor = ReplicaSupervisor(
                LocalFleetView(router), spawn_one,
                min_replicas=cfg["min_replicas"],
                max_replicas=cfg["max_replicas"],
                cooldown_s=cfg["supervisor_cooldown_s"],
                scale_quiet_s=cfg["scale_quiet_s"])
            for i, p in enumerate(procs):
                supervisor.adopt(i, p)
            supervisor.start()
            log.info("fleet supervisor armed (min=%d max=%d cooldown=%.1fs)",
                     cfg["min_replicas"], cfg["max_replicas"],
                     cfg["supervisor_cooldown_s"])
        _wait_duration()
    finally:
        if supervisor is not None:
            supervisor.stop()
            procs = list(supervisor.slots().values())
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except Exception:  # noqa: BLE001 - last resort on shutdown
                p.kill()
        router.close()
    return 0


def _on_stop(signum, frame) -> None:  # noqa: ARG001 - signal ABI
    _STOP.set()


def main(argv=None) -> int:
    # Serving processes juggle many short GIL slices (conn readers,
    # batcher, heartbeat); the default 5ms switch interval convoys them
    # and inflates request p50 toward the switch interval on small hosts.
    sys.setswitchinterval(5e-4)
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_stop)
    _STOP.clear()
    args = list(argv if argv is not None else sys.argv[1:])
    pin_device_if_requested(args, "serve_device")
    raw_args = list(args)

    def _body(remaining: List[str]) -> int:
        del remaining
        cfg = fleet_config()
        role = cfg["role"]
        if role == "replica":
            return _replica_body(cfg)
        if role == "router":
            return _router_body(cfg)
        if role == "drain":
            return _drain_body(cfg)
        if role == "ps_fleet":
            return _ps_fleet_body(cfg)
        check(role == "local",
              f"-fleet_role must be local|router|replica|drain|ps_fleet, "
              f"got '{role}'")
        return _local_body(cfg, raw_args)

    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
