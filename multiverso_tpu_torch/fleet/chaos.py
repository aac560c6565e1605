"""Seeded, composable fault injection for the recoverable fleet.

Port of ``multiverso_tpu/fleet/chaos.py``. A drill builds a
:class:`ChaosEngine`, registers the fleet's kill/pause targets, and lets
a seeded schedule SIGKILL/SIGSTOP any subset of shards, drop packets on
the client link, and slow the WAL disk — then asserts after every round
that the fleet converges back to full membership with zero acked-write
loss.

Everything is driven by ONE ``random.Random(seed)``: the same seed
replays the same schedule (targets, kinds, offsets, durations), so a
failing round is reproducible by seed alone. Faults are *composable*:
a round may pause one shard while killing another under a lossy link —
each fault is an independent apply/revert pair and the engine holds the
reverts until each fault's window elapses.

Fault kinds:

* ``kill``     — SIGKILL a registered target (no revert; recovery is the
  supervisor's job and the drill's convergence assertion).
* ``pause``    — SIGSTOP for the fault's window, then SIGCONT: a wedged-
  but-alive seat, the shape heartbeat-loss detection exists for.
* ``net_drop`` — process-wide link fault (``parallel.net`` hook): each
  framed send/recv raises ``OSError`` with the fault's probability, so
  client RPCs fail mid-flight and must ride the jittered retry path.
* ``wal_slow`` — injected per-commit fsync delay (``core.wal`` hook) in
  THIS process; subprocess seats arm the same fault at spawn through
  ``-wal_fsync_delay_ms`` (``PSShardFleet.extra_seat_args``).
"""

from __future__ import annotations

import random
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from multiverso_tpu_torch.utils.log import check, log

KINDS = ("kill", "pause", "net_drop", "wal_slow")


class Fault:
    """One scheduled fault: ``kind`` on ``target`` at ``at_s`` seconds
    into the round, reverted (where revertible) after ``duration_s``.
    ``param`` is kind-specific: drop probability for ``net_drop``,
    fsync delay seconds for ``wal_slow``."""

    __slots__ = ("kind", "target", "at_s", "duration_s", "param")

    def __init__(self, kind: str, target: Optional[str] = None,
                 at_s: float = 0.0, duration_s: float = 0.0,
                 param: float = 0.0):
        check(kind in KINDS, f"unknown fault kind {kind!r}")
        self.kind = kind
        self.target = target
        self.at_s = float(at_s)
        self.duration_s = float(duration_s)
        self.param = float(param)

    def as_dict(self) -> Dict:
        return {"kind": self.kind, "target": self.target,
                "at_s": round(self.at_s, 3),
                "duration_s": round(self.duration_s, 3),
                "param": round(self.param, 4)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Fault({self.as_dict()})"


class ChaosEngine:
    """Seeded schedule generator + applicator over registered targets.

    ``register_kill(name, fn)`` registers a signal-deliverable target
    (``fn(signum)`` — a fleet seat, a serving replica, a worker
    process); ``plan_round`` draws a random subset of them and a fault
    kind each; ``run_round`` applies the faults on their offsets and
    blocks until every revert has run. ``events`` accumulates the
    applied schedule for the bench record."""

    def __init__(self, seed: int = 0,
                 kinds: Sequence[str] = KINDS,
                 max_pause_s: float = 2.0,
                 max_drop_rate: float = 0.4,
                 max_fsync_delay_s: float = 0.05):
        for k in kinds:
            check(k in KINDS, f"unknown fault kind {k!r}")
        self.rng = random.Random(seed)
        self.seed = int(seed)
        self.kinds = tuple(kinds)
        self.max_pause_s = float(max_pause_s)
        self.max_drop_rate = float(max_drop_rate)
        self.max_fsync_delay_s = float(max_fsync_delay_s)
        self._kills: Dict[str, Callable[[int], None]] = {}
        self._target_kinds: Dict[str, tuple] = {}
        self.events: List[Dict] = []

    def register_kill(self, name: str, deliver: Callable[[int], None],
                      kinds: Sequence[str] = ("kill", "pause")) -> None:
        """Register a signal target: ``deliver(signum)`` must send the
        signal to the named member's process. ``kinds`` restricts what
        may hit THIS target (e.g. a serving replica whose supervisor
        heals on heartbeat loss takes ``kill`` only — SIGSTOP would race
        the healer's replacement against the SIGCONT'd original)."""
        self._kills[str(name)] = deliver
        self._target_kinds[str(name)] = tuple(
            k for k in kinds if k in ("kill", "pause")) or ("kill",)

    # -- schedule generation -------------------------------------------------
    def plan_round(self, window_s: float = 2.0,
                   max_targets: Optional[int] = None) -> List[Fault]:
        """Draw one round: a non-empty random subset of the registered
        targets ("kills any subset" — up to ALL of them), each assigned
        a seeded kind/offset, plus at most one link fault and one disk
        fault when those kinds are enabled. Deterministic per (seed,
        call sequence)."""
        check(bool(self._kills), "no kill targets registered")
        names = sorted(self._kills)
        ceil = min(len(names), max_targets or len(names))
        n = self.rng.randint(1, ceil)
        victims = self.rng.sample(names, n)
        faults = []
        for v in victims:
            allowed = [k for k in self._target_kinds[v]
                       if k in self.kinds] or ["kill"]
            faults.append(Fault(self.rng.choice(allowed), target=v,
                                at_s=self.rng.uniform(0, window_s),
                                duration_s=self.rng.uniform(
                                    0.2, self.max_pause_s)))
        if "net_drop" in self.kinds and self.rng.random() < 0.5:
            faults.append(Fault(
                "net_drop", at_s=self.rng.uniform(0, window_s),
                duration_s=self.rng.uniform(0.3, self.max_pause_s),
                param=self.rng.uniform(0.05, self.max_drop_rate)))
        if "wal_slow" in self.kinds and self.rng.random() < 0.5:
            faults.append(Fault(
                "wal_slow", at_s=self.rng.uniform(0, window_s),
                duration_s=self.rng.uniform(0.3, self.max_pause_s),
                param=self.rng.uniform(0.005, self.max_fsync_delay_s)))
        faults.sort(key=lambda f: f.at_s)
        return faults

    # -- application ---------------------------------------------------------
    def _apply(self, fault: Fault) -> Optional[Callable[[], None]]:
        """Apply one fault NOW; return its revert (None = one-shot)."""
        if fault.kind == "kill":
            self._kills[fault.target](signal.SIGKILL)
            return None
        if fault.kind == "pause":
            deliver = self._kills[fault.target]
            deliver(signal.SIGSTOP)
            return lambda: deliver(signal.SIGCONT)
        if fault.kind == "net_drop":
            from multiverso_tpu_torch.parallel import net
            # Dedicated rng: the hook fires from many client threads and
            # must not perturb the SCHEDULE stream's determinism.
            drop_rng = random.Random(self.rng.getrandbits(32))
            rate = fault.param

            def hook(direction, sock):
                if drop_rng.random() < rate:
                    raise OSError(
                        f"chaos: injected {direction} drop")

            net.set_fault_hook(hook)
            return lambda: net.set_fault_hook(None)
        if fault.kind == "wal_slow":
            from multiverso_tpu_torch.core import wal
            wal.set_fsync_delay(fault.param)
            return lambda: wal.set_fsync_delay(0.0)
        raise AssertionError(fault.kind)   # unreachable: ctor validated

    def run_round(self, faults: Sequence[Fault]) -> List[Dict]:
        """Apply ``faults`` on their offsets (relative to now) and block
        until every revertible fault's window has elapsed and been
        reverted. Returns (and records) the applied schedule."""
        t0 = time.monotonic()
        timers: List[threading.Timer] = []
        applied: List[Dict] = []
        try:
            for f in sorted(faults, key=lambda f: f.at_s):
                delay = t0 + f.at_s - time.monotonic()
                if delay > 0:
                    # drill scheduler pacing: no request crosses it
                    # graftlint: disable=unattributed-wait
                    time.sleep(delay)
                try:
                    revert = self._apply(f)
                except (KeyError, OSError, ProcessLookupError) as e:
                    # A kill target that already died this round is a
                    # legitimate race under composed faults: log + skip.
                    log.info("chaos: fault %s skipped (%s)",
                             f.as_dict(), e)
                    continue
                applied.append(f.as_dict())
                log.info("chaos: applied %s", f.as_dict())
                if revert is not None:
                    def safe(revert=revert, f=f):
                        try:
                            revert()
                        except OSError as e:   # e.g. SIGCONT to a seat a
                            # composed kill took down first
                            log.info("chaos: revert of %s skipped (%s)",
                                     f.as_dict(), e)
                    t = threading.Timer(f.duration_s, safe)
                    t.daemon = True
                    t.start()
                    timers.append(t)
        finally:
            for t in timers:
                t.join()
        self.events.extend(applied)
        return applied
