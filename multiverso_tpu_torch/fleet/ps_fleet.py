"""Supervised multi-shard PS topology: one supervisor, N durable seats.

Port of ``multiverso_tpu/fleet/ps_fleet.py``. One supervisor owns N
shard seats of one distributed table (``apps/ps_shard_main.py``), each
journaled to its write-ahead log and periodically checkpointed, each
respawned through the recovery path (checkpoint restore -> WAL replay ->
announce LAST) when it dies. By default the owning process holds rank 0
and a client seat (``table``), the seats ranks 1..N; with
``client_seat=False`` the seats are ranks 0..N-1 and the clients come
from outside (the C client over :meth:`PSShardFleet.addresses`).

Re-routing on shard loss is the PS plane's analog of the serving
router: the membership DIRECTORY is replicated on every seat
(``PSService.enable_directory``), a restarting seat registers its new
address with every live peer before serving, and the client's retry
loop parks with jittered exponential backoff against the directory
until the replacement announces, then resumes into the exactly-once
reply cache, so a retry spanning the outage dedups instead of
double-applying. ``-wal_sync_acks`` makes every acked add durable,
recovery replays the tail, and the dedup cache absorbs the retransmits.

Every seat binds an ephemeral port and announces it through its addr
file (``-ps_addr_file``), written ONLY after recovery completes, so the
supervisor and any client see a seat exactly when it can be reached, and
no port is picked before the seat binds it. A respawned seat binds a
fresh port; it is given its siblings' CURRENT addresses
(:func:`seat_peers`) and registers with each. A SIGKILLed seat leaves a
stale addr file behind; the view cross-checks process liveness so a
corpse with a fresh-looking announce still reads as down.

Seats run on the card (each shard applies its Adds with the row kernels
where its table asks for them) unless ``device="cpu"``. With
``log_dir``, each run of a seat writes its output to
``<log_dir>/seat<rank>.<run>.log`` (its ``PS_SHARD_RECOVERY`` and
``PS_SHARD_LAUNCHES`` lines among it).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from multiverso_tpu_torch.utils.log import check, log

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The -ps_peers entry of a seat that has not announced yet: its
#: siblings' directory registrations with it retry in the background and
#: correct themselves the moment it registers its real address.
PLACEHOLDER = ("127.0.0.1", 1)


def read_addr(path: str) -> Optional[Tuple[str, int]]:
    """The ``host:port`` a seat announced in its addr file, or None."""
    try:
        with open(path) as f:
            host, port = f.read().split(":")
        return (host, int(port))
    except (OSError, ValueError):
        return None


def seat_peers(rank: int, known: Sequence[Optional[Tuple[str, int]]]
               ) -> str:
    """The ``-ps_peers`` list for seat ``rank`` from the addresses
    ``known`` (one entry a rank, None where not announced): its own entry
    asks for an ephemeral port, a rank not announced yet gets
    :data:`PLACEHOLDER`."""
    entries = []
    for r, addr in enumerate(known):
        if r == rank:
            addr = ("127.0.0.1", 0)
        elif addr is None:
            addr = PLACEHOLDER
        entries.append(f"{addr[0]}:{addr[1]}")
    return ",".join(entries)


class _SeatMembershipView:
    """Fleet-view adapter over the fleet's addr files + process handles:
    a seat is a member iff its addr file exists (announce = recovery
    complete) AND its process is alive."""

    def __init__(self, fleet: "PSShardFleet"):
        self._fleet = fleet

    def stats(self) -> Dict:
        return self._fleet.membership_stats()

    def drain(self, member_id: str, timeout_s: float = 30.0) -> bool:
        return False            # fixed-size shard fleet: never scaled down


class PSShardFleet:
    """One supervisor over N durable WAL'd PS shard seats.

    ``start()`` spawns the seats, waits for every announce, builds the
    rank-0 client tables in THIS process (unless ``client_seat=False``),
    and arms a :class:`ReplicaSupervisor` (member ids ``ps-<rank>``)
    whose ``spawn_fn`` re-runs the seat through the recovery path with
    the CURRENT addresses of its siblings. ``tables`` is the seats'
    ``-ps_tables`` list (``UPDATER[:pallas]`` each, ids from
    ``table_id`` up; empty = one default table); ``table`` is the client
    seat of the first, ``client_tables`` one a table."""

    def __init__(self, shards: int = 4, *, table_id: int = 912,
                 table_size: int = 256, table_kind: str = "array",
                 table_cols: int = 8, tables: Sequence[str] = (),
                 workdir: Optional[str] = None, sync_acks: bool = True,
                 wal_flush_ms: float = 25.0,
                 checkpoint_every_s: float = 1.0,
                 serve_duration: float = 600.0,
                 supervise: bool = True, join_grace_s: float = 60.0,
                 poll_s: float = 0.1, cooldown_s: float = 0.5,
                 extra_seat_args: Optional[Dict[int, List[str]]] = None,
                 device: str = "default", client_seat: bool = True,
                 log_dir: Optional[str] = None):
        check(shards >= 1, "a PS fleet needs at least one shard")
        check(table_kind in ("array", "matrix"),
              f"table_kind={table_kind!r} (want array|matrix)")
        check(device in ("default", "cpu"),
              f"device={device!r} (want default|cpu)")
        self.shards = int(shards)
        self.table_id = int(table_id)
        self.table_size = int(table_size)
        self.table_kind = table_kind
        self.table_cols = int(table_cols)
        self.tables = [str(t) for t in tables]
        self.workdir = workdir or tempfile.mkdtemp(prefix="ps_fleet_")
        self.sync_acks = bool(sync_acks)
        self.wal_flush_ms = float(wal_flush_ms)
        self.checkpoint_every_s = float(checkpoint_every_s)
        self.serve_duration = float(serve_duration)
        self.device = device
        self.client_seat = bool(client_seat)
        self.log_dir = log_dir
        self._supervise = bool(supervise)
        self._join_grace_s = float(join_grace_s)
        self._poll_s = float(poll_s)
        self._cooldown_s = float(cooldown_s)
        #: per-rank extra CLI args, applied on every (re)spawn (e.g. a
        #: slow-disk seat: ``{2: ["-wal_fsync_delay_ms=40"]}``).
        self.extra_seat_args = dict(extra_seat_args or {})
        self._svc = None
        self.table = None
        self.client_tables: List = []
        self.peers: List[Tuple[str, int]] = []
        self._handles: Dict[int, subprocess.Popen] = {}
        self._runs: Dict[int, List[str]] = {}
        self._sup = None
        os.makedirs(os.path.join(self.workdir, "wal"), exist_ok=True)
        os.makedirs(os.path.join(self.workdir, "ckpt"), exist_ok=True)

    # -- seat plumbing -------------------------------------------------------
    @property
    def ranks(self) -> List[int]:
        """The seats' ranks: 1..N under a client seat, else 0..N-1."""
        first = 1 if self.client_seat else 0
        return list(range(first, first + self.shards))

    def addr_file(self, rank: int) -> str:
        return os.path.join(self.workdir, f"seat{rank}.addr")

    def addresses(self) -> List[Optional[Tuple[str, int]]]:
        """Every rank's current address (rank 0 the client seat's when
        there is one), None for a seat not announced."""
        out: List[Optional[Tuple[str, int]]] = []
        if self.client_seat:
            out.append(self.peers[0] if self.peers else None)
        out += [read_addr(self.addr_file(r)) for r in self.ranks]
        return out

    def spawn_seat(self, rank: int) -> subprocess.Popen:
        """(Re)spawn one shard seat through the recovery path. Removes
        the stale announce first: a replacement must not count as
        recovered until ITS restore+replay completes."""
        check(rank in self.ranks, f"rank {rank} outside the fleet")
        try:
            os.remove(self.addr_file(rank))
        except OSError:
            pass
        cmd = [sys.executable, "-m",
               "multiverso_tpu_torch.apps.ps_shard_main",
               f"-rank={rank}",
               f"-ps_peers={seat_peers(rank, self.addresses())}",
               f"-ps_table_id={self.table_id}",
               f"-ps_table_size={self.table_size}",
               f"-ps_table_kind={self.table_kind}",
               f"-ps_table_cols={self.table_cols}",
               "-wal=true", f"-wal_dir={self.workdir}/wal",
               f"-wal_flush_ms={self.wal_flush_ms}",
               f"-wal_sync_acks={'true' if self.sync_acks else 'false'}",
               f"-checkpoint_dir={self.workdir}/ckpt",
               f"-ps_checkpoint_every_s={self.checkpoint_every_s}",
               f"-ps_addr_file={self.addr_file(rank)}",
               f"-serve_device={self.device}",
               f"-serve_duration={self.serve_duration}",
               "-telemetry_alerts=false", "-telemetry_flight=false"]
        if self.tables:
            cmd.append("-ps_tables=" + ",".join(self.tables))
        cmd += self.extra_seat_args.get(rank, [])
        out = None
        if self.log_dir is not None:
            runs = self._runs.setdefault(rank, [])
            path = os.path.join(self.log_dir, f"seat{rank}.{len(runs)}.log")
            runs.append(path)
            out = open(path, "w")
        try:
            proc = subprocess.Popen(cmd, cwd=_REPO, stdout=out,
                                    stderr=subprocess.STDOUT
                                    if out is not None else None)
        finally:
            if out is not None:
                out.close()         # the child holds its own descriptor
        self._handles[rank] = proc
        return proc

    def seat_alive(self, rank: int) -> bool:
        h = self._handles.get(rank)
        return h is not None and h.poll() is None

    def seat_announced(self, rank: int) -> bool:
        return os.path.exists(self.addr_file(rank))

    def seat_runs(self, rank: int) -> int:
        """Runs of seat ``rank`` with a log (``log_dir`` only)."""
        return len(self._runs.get(rank, []))

    def seat_log(self, rank: int, run: int = -1) -> str:
        """The output of one run of a seat (``log_dir`` only)."""
        with open(self._runs[rank][run]) as f:
            return f.read()

    def seat_line(self, rank: int, tag: str, run: int = -1
                  ) -> Optional[Dict]:
        """The JSON a seat's run printed after ``tag`` (its
        ``PS_SHARD_RECOVERY`` or ``PS_SHARD_LAUNCHES`` line), or None."""
        for text in self.seat_log(rank, run).splitlines():
            if text.startswith(tag + " "):
                return json.loads(text[len(tag) + 1:])
        return None

    def wait_announced(self, rank: int, timeout_s: float = 240.0) -> float:
        """Block until seat ``rank`` announces; returns the seconds
        waited. Raises if the seat exits first or never announces (with
        the tail of its log where there is one)."""
        t0 = time.monotonic()
        delay = 0.01
        while not self.seat_announced(rank):
            tail = (self.seat_log(rank)[-3000:]
                    if self.seat_runs(rank) else "")
            check(self.seat_alive(rank),
                  f"ps shard {rank} exited during bring-up\n{tail}")
            check(time.monotonic() - t0 < timeout_s,
                  f"ps shard {rank} never announced\n{tail}")
            # bring-up convergence wait: serving hasn't started
            # graftlint: disable=unattributed-wait
            time.sleep(delay)
            delay = min(delay * 2.0, 0.25)
        return time.monotonic() - t0

    def membership_stats(self) -> Dict:
        rows = {f"ps-{r}": {"alerts": []} for r in self.ranks
                if self.seat_announced(r) and self.seat_alive(r)}
        return {"replicas": rows, "router_alerts": []}

    # -- lifecycle -----------------------------------------------------------
    def start(self, bringup_timeout_s: float = 240.0) -> "PSShardFleet":
        from multiverso_tpu_torch.fleet.supervisor import ReplicaSupervisor

        check(self._svc is None and not self._handles,
              "fleet already started")
        if self.client_seat:
            from multiverso_tpu_torch.parallel.ps_service import PSService
            self._svc = PSService()
            self.peers = [self._svc.address] + [PLACEHOLDER] * self.shards
        for r in self.ranks:
            self.spawn_seat(r)
        deadline = time.monotonic() + bringup_timeout_s
        for r in self.ranks:
            self.wait_announced(r, max(deadline - time.monotonic(), 0.0))
        if self.client_seat:
            self.peers = self.addresses()
            self._build_client_tables()
        if self._supervise:
            self._sup = ReplicaSupervisor(
                _SeatMembershipView(self), self.spawn_seat,
                member_prefix="ps-", min_replicas=self.shards,
                max_replicas=self.shards, cooldown_s=self._cooldown_s,
                poll_s=self._poll_s, join_grace_s=self._join_grace_s)
            for r in self.ranks:
                self._sup.adopt(r, self._handles[r])
            self._sup.start()
        log.info("ps fleet up: %d shard(s) of table %d under %s",
                 self.shards, self.table_id, self.workdir)
        return self

    def _build_client_tables(self) -> None:
        from multiverso_tpu_torch.parallel.ps_service import (
            DistributedArrayTable, DistributedMatrixTable)

        for i, spec in enumerate(self.tables or ["default"]):
            updater, _, kernels = spec.partition(":")
            kw = dict(rank=0, updater=updater or "default",
                      use_pallas=kernels == "pallas")
            tid = self.table_id + i
            if self.table_kind == "matrix":
                t = DistributedMatrixTable(
                    tid, self.table_size, self.table_cols, self._svc,
                    self.peers, **kw)
            else:
                t = DistributedArrayTable(
                    tid, self.table_size, self._svc, self.peers, **kw)
            self.client_tables.append(t)
        self.table = self.client_tables[0]

    def kill(self, rank: int, sig: int = signal.SIGKILL) -> None:
        """Deliver ``sig`` to one seat (the chaos engine's kill/pause
        primitive). The stale announce is LEFT on disk on purpose: a real
        crash doesn't tidy up; the membership view cross-checks process
        liveness instead."""
        h = self._handles.get(rank)
        check(h is not None, f"no seat handle for rank {rank}")
        h.send_signal(sig)

    def handle(self, rank: int) -> Optional[subprocess.Popen]:
        """The current process of seat ``rank`` (the supervisor's after a
        respawn)."""
        if self._sup is not None:
            h = self._sup.slots().get(rank)
            if isinstance(h, subprocess.Popen):
                self._handles[rank] = h
        return self._handles.get(rank)

    def wait_converged(self, timeout_s: float = 240.0) -> bool:
        """Block until EVERY seat is announced + alive (full
        membership)."""
        deadline = time.monotonic() + timeout_s
        delay = 0.01
        while time.monotonic() < deadline:
            if len(self.membership_stats()["replicas"]) == self.shards:
                return True
            # membership convergence gate, control plane
            # graftlint: disable=unattributed-wait
            time.sleep(delay)
            delay = min(delay * 2.0, 0.25)
        return False

    def status(self) -> Dict:
        out = {"shards": self.shards,
               "live": sorted(r for r in self.ranks if self.seat_alive(r)),
               "announced": sorted(r for r in self.ranks
                                   if self.seat_announced(r))}
        if self._sup is not None:
            sup = self._sup.status()
            out["supervisor"] = {k: sup[k] for k in
                                 ("respawns", "scale_ups", "scale_downs")}
            out["events"] = sup["events"]
        return out

    def stop_seats(self, timeout_s: float = 120.0) -> Dict[int, int]:
        """Stop the supervisor, SIGTERM every live seat and wait for it:
        a seat closes its service and prints its launch counts. Returns
        {rank: exit code}."""
        if self._sup is not None:
            self._sup.stop()
            for rank, h in self._sup.slots().items():
                if isinstance(h, subprocess.Popen):
                    self._handles[rank] = h
            self._sup = None
        for h in self._handles.values():
            if h.poll() is None:
                try:
                    h.send_signal(signal.SIGCONT)   # a paused seat must
                except OSError:                     # see the terminate
                    pass
                h.terminate()
        codes = {}
        for rank, h in self._handles.items():
            try:
                # teardown join on child exit, after serving stopped
                # graftlint: disable=unattributed-wait
                codes[rank] = h.wait(timeout=timeout_s)
            except Exception:  # noqa: BLE001 - last resort on teardown
                h.kill()
                codes[rank] = h.wait()
        self._handles.clear()
        return codes

    def close(self) -> None:
        self.stop_seats(timeout_s=15.0)
        for t in self.client_tables:
            t.close()
        self.client_tables = []
        self.table = None
        if self._svc is not None:
            self._svc.close()
            self._svc = None
