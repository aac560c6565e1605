"""Durable PS shard CLI: one recoverable parameter-server seat.

Port of ``multiverso_tpu/apps/ps_shard_main.py``. A process that owns one
rank's shard of a distributed table on the card (``-serve_device=cpu`` for
the CPU), journals every accepted add to the write-ahead delta log
(``-wal``), periodically checkpoints it (and truncates the log), and
RECOVERS on restart: attach the WAL -> restore the newest shard checkpoint
-> replay the log tail -> only then announce to the membership directory,
so a killed seat comes back with state bitwise-equal to one that never
died (the port's row Adds are deterministic: lane order, no float
atomics).

    # seat 1 of a 2-process world, journaled + periodically checkpointed
    python -m multiverso_tpu_torch.apps.ps_shard_main -rank=1 \\
        -ps_peers=10.0.0.1:55555,10.0.0.2:0 -ps_table_size=100000 \\
        -wal=true -wal_dir=/data/wal -checkpoint_dir=/data/ckpt \\
        -ps_checkpoint_every_s=30 -ps_addr_file=/tmp/seat1.addr

    # kill -9 it; rerun the same command: it recovers and re-registers.

A seat always binds an ephemeral port (its own ``-ps_peers`` entry is
replaced by the bound address) and announces it in ``-ps_addr_file``:
a restarted seat comes back at a new address, which it registers with
its peers (``fleet/ps_fleet.py`` spawns seats so). Beyond the JAX CLI,
``-ps_tables=UPDATER[:pallas],...`` serves one table per entry (ids from
``-ps_table_id`` up; ``:pallas`` gives the shard the hand-written row
kernels), each of ``-ps_table_kind``, ``-ps_table_size`` and
``-ps_table_cols``. With ``-wal`` the seat prints ``PS_SHARD_RECOVERY
{json}`` once the log tail is replayed (records applied and skipped,
seconds of restore and replay). On exit (SIGTERM, SIGINT or
``-serve_duration``) it prints ``PS_SHARD_LAUNCHES {json}``: its row
kernels' launch counts (``ops/rows.LAUNCHES``). It exits 1 if a device
error failed a request (``PSService.fatal``).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import List

from multiverso_tpu_torch.apps._runner import run_app
from multiverso_tpu_torch.utils.configure import (define_double, define_int,
                                                  define_string, get_flag)
from multiverso_tpu_torch.utils.log import check, log

define_string("ps_peers", "", "comma host:port list, one per rank (this "
              "rank's own entry is replaced by its bound address)")
define_int("ps_table_id", 900, "distributed table id to serve (the first "
           "of -ps_tables)")
define_int("ps_table_size", 10000, "distributed table rows (array: length)")
define_string("ps_tables", "", "comma list of UPDATER[:pallas], one table "
              "each with ids from -ps_table_id up; empty = one default "
              "table")
define_string("ps_addr_file", "", "write this seat's bound host:port "
              "here once it is ANNOUNCED (recovery complete)")
define_double("ps_checkpoint_every_s", 0.0, "checkpoint this rank's "
              "shard (and truncate the WAL) every N seconds; 0 = never")
define_string("checkpoint_dir", "", "shard checkpoint directory "
              "(restored on start when a shard file exists)")
define_string("serve_device", "default", "default|cpu: the card unless "
              "-serve_device=cpu")


def _shard_uri(ckpt_dir: str, rank: int, index: int, table_id: int) -> str:
    """The JAX seat's file name for the first table, one per id after it."""
    name = (f"ps_shard{rank}.npz" if index == 0
            else f"ps_shard{rank}_t{table_id}.npz")
    return f"file://{os.path.join(ckpt_dir, name)}"


def _table_specs() -> List[tuple]:
    """``(updater, use_pallas)`` per table of ``-ps_tables``."""
    raw = str(get_flag("ps_tables")).strip()
    specs = []
    for part in (raw.split(",") if raw else ["default"]):
        updater, _, kernels = part.strip().partition(":")
        check(kernels in ("", "pallas"),
              f"bad -ps_tables entry '{part}' (want UPDATER[:pallas])")
        specs.append((updater or "default", kernels == "pallas"))
    return specs


def _body(remaining: List[str]) -> int:
    from multiverso_tpu_torch.core import checkpoint as ckpt
    from multiverso_tpu_torch.ops import rows
    from multiverso_tpu_torch.parallel.ps_service import (
        DistributedArrayTable, DistributedMatrixTable, PSService)
    from multiverso_tpu_torch.utils.configure import flag_or
    from multiverso_tpu_torch.utils.stream import exists

    del remaining
    rank = int(get_flag("rank"))
    peers_raw = str(get_flag("ps_peers"))
    check(bool(peers_raw), "-ps_peers=host:port,... is required")
    peers = []
    for part in peers_raw.split(","):
        host, _, port = part.strip().rpartition(":")
        peers.append((host, int(port)))
    check(0 <= rank < len(peers), f"-rank={rank} outside the peer list")

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    # An ephemeral port: a port picked before the bind could be taken in
    # between by another process, and a restarted seat's old one too.
    svc = PSService()
    if bool(flag_or("wal", False)):
        wal_dir = str(get_flag("wal_dir"))
        check(bool(wal_dir), "-wal=true requires -wal_dir=DIR")
        svc.attach_wal(os.path.join(wal_dir, f"rank{rank}"),
                       flush_interval_ms=float(get_flag("wal_flush_ms")),
                       sync_acks=bool(get_flag("wal_sync_acks")))
        fsync_delay_ms = float(flag_or("wal_fsync_delay_ms", 0.0))
        if fsync_delay_ms > 0:
            from multiverso_tpu_torch.core import wal as wal_mod
            wal_mod.set_fsync_delay(fsync_delay_ms / 1e3)
            log.info("ps_shard: CHAOS slow disk armed (%.0fms/fsync)",
                     fsync_delay_ms)
    peers[rank] = svc.address
    # Recovery protocol: the tables register their shards but do NOT
    # announce until state is restored — an early announce lets a peer's
    # retried add land on the fresh shard and be overwritten by the
    # restore (an acked write lost).
    kind = str(flag_or("ps_table_kind", "array"))
    check(kind in ("array", "matrix"),
          f"-ps_table_kind={kind} (want array|matrix)")
    size = int(get_flag("ps_table_size"))
    tables = []
    for i, (updater, use_pallas) in enumerate(_table_specs()):
        tid = int(get_flag("ps_table_id")) + i
        if kind == "matrix":
            tables.append(DistributedMatrixTable(
                tid, size, int(flag_or("ps_table_cols", 8)), svc, peers,
                rank=rank, updater=updater, announce=False,
                use_pallas=use_pallas))
        else:
            tables.append(DistributedArrayTable(
                tid, size, svc, peers, rank=rank, updater=updater,
                announce=False, use_pallas=use_pallas))
    ckpt_dir = str(get_flag("checkpoint_dir"))
    uris = [_shard_uri(ckpt_dir, rank, i, t.table_id) if ckpt_dir else ""
            for i, t in enumerate(tables)]
    t0 = time.perf_counter()
    for table, uri in zip(tables, uris):
        if uri and exists(uri):
            ckpt.load_table(table, uri)
            log.info("ps_shard: restored shard from %s", uri)
    if svc.wal_active:
        report = svc.replay_wal()
        for table in tables:
            table.local_store.block()
        print("PS_SHARD_RECOVERY " + json.dumps(
            dict(report, seconds=time.perf_counter() - t0)), flush=True)
    svc.enable_directory(rank, peers)

    addr_file = str(get_flag("ps_addr_file"))
    if addr_file:
        with open(addr_file + ".tmp", "w") as f:
            f.write(f"{svc.address[0]}:{svc.address[1]}")
        os.replace(addr_file + ".tmp", addr_file)
    log.info("ps_shard: rank %d serving %d table(s) at %s:%d on %s "
             "(wal=%s)", rank, len(tables), svc.address[0],
             svc.address[1], tables[0].local_store.device, svc.wal_active)

    every = float(get_flag("ps_checkpoint_every_s"))
    duration = float(flag_or("serve_duration", 0.0))
    deadline = time.monotonic() + duration if duration > 0 else None
    next_ckpt = time.monotonic() + every if every > 0 and ckpt_dir else None
    try:
        # Constant cadence on purpose: the checkpoint ticker's clock, and
        # the watch for a device error on the dispatcher.
        while not stop.wait(0.1) and svc.fatal is None and (
                deadline is None or time.monotonic() < deadline):
            if next_ckpt is not None and time.monotonic() >= next_ckpt:
                # The snapshot is dispatcher-atomic (ps_service); the
                # stream write is atomic-rename (utils/stream); the
                # rotate+prune afterwards is pure space reclamation.
                for table, uri in zip(tables, uris):
                    ckpt.save_table(table, uri)
                svc.wal_checkpoint()
                next_ckpt = time.monotonic() + every
    finally:
        for table in tables:
            table.close()
        svc.close()
        print("PS_SHARD_LAUNCHES " + json.dumps(dict(rows.LAUNCHES)),
              flush=True)
    svc.check_fatal()
    return 0


def main(argv=None) -> int:
    from multiverso_tpu_torch.apps._runner import pin_device_if_requested
    args = list(argv if argv is not None else sys.argv[1:])
    pin_device_if_requested(args, "serve_device")
    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
