"""Always-on flight recorder + wedge watchdog + postmortem dumps.

Port of ``multiverso_tpu/telemetry/flight.py``, host-only. A fleet masks
a dead replica, but the dead replica itself leaves nothing behind, and a
*wedged* (alive but stuck) daemon loop is worse: it fails no health
check and writes no log. This module is the black box:

* **Flight recorder**: a bounded ring of recent notable events (alert
  transitions, watchdog trips, caller ``note()``\\ s). Recent spans come
  from the trace buffer (already a ring) and recent log lines from the
  logger's ring, so the recorder adds no second copy of either.
* **Wedge watchdog**: every daemon loop registers a
  :class:`WatchdogHandle` and calls ``beat()`` once per iteration (one
  lock-free float store, cheap enough for the PS dispatcher's per-
  message loop). A monitor thread trips any loop whose last beat is
  older than its timeout: counter + flight event + ONE postmortem dump
  per trip (re-armed by the next beat, rate-limited so a wedged fleet
  cannot spam the disk).
* **Postmortem dump**: all live threads' stacks
  (``sys._current_frames``), the flight ring, the log tail, recent
  spans, watchdog ages, active alerts, and a registry snapshot, written
  atomically to ``<telemetry_dir>/postmortem-<pid>.json``. A fatal
  signal (SIGABRT/SIGQUIT via :func:`install_crash_handlers`) writes the
  same dump before the process dies, so even an abrupt kill leaves an
  artifact.

The postmortem's ``exemplars`` section is ``[]`` and it has no
``profile`` section: the tail-exemplar reservoir and the sampling
profiler are not ported yet (ROADMAP A11). Nothing here imports torch.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from multiverso_tpu_torch.telemetry.metrics import get_registry
from multiverso_tpu_torch.utils.log import log

__all__ = ["FlightRecorder", "flight_recorder", "WatchdogHandle",
           "watchdog_register", "watchdog_scope", "watchdog_handles",
           "start_watchdog", "stop_watchdog", "build_postmortem",
           "dump_postmortem", "validate_postmortem",
           "install_crash_handlers", "reset_flight", "POSTMORTEM_SCHEMA"]

POSTMORTEM_SCHEMA = "multiverso_tpu.telemetry.postmortem/v1"

#: Tail sizes folded into a postmortem — bounded so the dump stays a
#: readable artifact, not a second trace file.
_SPAN_TAIL = 200
_LOG_TAIL = 120
_EVENT_RING = 512

#: Minimum seconds between watchdog-triggered dumps (a wedged fleet of
#: loops must not turn the postmortem path into a disk flood).
_DUMP_COOLDOWN_S = 5.0


class FlightRecorder:
    """Bounded ring of notable events (alert transitions, trips, caller
    notes). Thread-safe; ``snapshot()`` folds in the span and log tails
    from their own rings."""

    def __init__(self, capacity: int = _EVENT_RING):
        self._lock = threading.Lock()
        self._events: "collections.deque[Dict]" = collections.deque(
            maxlen=max(16, int(capacity)))

    def note(self, kind: str, **payload) -> None:
        ev = {"kind": str(kind), "time_unix": time.time()}
        for k, v in payload.items():
            ev[k] = v if isinstance(v, (int, float, bool, str, list,
                                        dict)) or v is None else str(v)
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def snapshot(self) -> Dict:
        from multiverso_tpu_torch.telemetry.spans import get_trace_buffer
        spans = get_trace_buffer().events()[-_SPAN_TAIL:]
        return {"events": self.events(),
                "spans": spans,
                "logs": log.recent(_LOG_TAIL)}


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


# ---------------------------------------------------------------------------
# Wedge watchdog
# ---------------------------------------------------------------------------
class WatchdogHandle:
    """One daemon loop's progress beacon. ``beat()`` is a single float
    attribute store (GIL-atomic) — no lock on the hot path; the monitor
    reads it racily, which can only ever DELAY a trip by one poll."""

    __slots__ = ("name", "timeout_s", "last", "tripped", "beats", "closed")

    def __init__(self, name: str, timeout_s: float):
        self.name = name
        self.timeout_s = max(0.05, float(timeout_s))
        self.last = time.monotonic()
        self.tripped = False
        self.beats = 0
        self.closed = False

    def beat(self) -> None:
        self.last = time.monotonic()
        self.beats += 1
        self.tripped = False        # re-arm: progress resumed

    def age_s(self) -> float:
        return time.monotonic() - self.last

    def close(self) -> None:
        self.closed = True
        _deregister(self)


_handles_lock = threading.Lock()
_handles: Dict[str, WatchdogHandle] = {}
_monitor: Optional["_WatchdogMonitor"] = None
_monitor_lock = threading.Lock()
#: Monotonic stamp of the last watchdog-triggered dump (only the single
#: monitor thread and test-reset rebind it).
_last_dump_at = 0.0


def watchdog_register(name: str, timeout_s: float = 60.0) -> WatchdogHandle:
    """Register a daemon loop with the wedge watchdog. Names are
    uniqued (``name#2`` ...) so two batchers in one process both show in
    the postmortem. Always cheap and always available — whether trips
    are ever *checked* depends on :func:`start_watchdog`."""
    h = WatchdogHandle(name, timeout_s)
    with _handles_lock:
        key = name
        n = 1
        while key in _handles:
            n += 1
            key = f"{name}#{n}"
        h.name = key
        _handles[key] = h
    get_registry().gauge("telemetry.watchdog.loops").set(len(_handles))
    return h


@contextlib.contextmanager
def watchdog_scope(name: str, timeout_s: float = 60.0):
    """The canonical daemon-loop shape: register on entry, deregister on
    exit, beat inside —

        def _loop(self):
            with watchdog_scope("serve-batcher", 60.0) as wd:
                while self._running:
                    wd.beat()
                    ...
    """
    handle = watchdog_register(name, timeout_s)
    try:
        yield handle
    finally:
        handle.close()


def _deregister(handle: WatchdogHandle) -> None:
    with _handles_lock:
        if _handles.get(handle.name) is handle:
            del _handles[handle.name]
    get_registry().gauge("telemetry.watchdog.loops").set(len(_handles))


def watchdog_handles() -> List[WatchdogHandle]:
    with _handles_lock:
        return list(_handles.values())


class _WatchdogMonitor:
    def __init__(self, poll_s: Optional[float], out_dir: Optional[str]):
        self._poll_s = poll_s
        self.out_dir = out_dir
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-watchdog")
        self._thread.start()

    def _interval(self) -> float:
        if self._poll_s is not None:
            return self._poll_s
        handles = watchdog_handles()
        if not handles:
            return 1.0
        return min(max(min(h.timeout_s for h in handles) / 4.0, 0.02), 2.0)

    def _loop(self) -> None:
        # The monitor IS the watchdog; registering it with itself would
        # only ever report its own poll cadence.
        while not self._stop.wait(self._interval()):
            self.check_once()

    def check_once(self) -> List[str]:
        """One sweep; returns the names tripped this pass (tests drive
        this directly for determinism)."""
        global _last_dump_at
        tripped: List[str] = []
        for h in watchdog_handles():
            if h.closed or h.tripped:
                continue
            age = h.age_s()
            if age <= h.timeout_s:
                continue
            h.tripped = True        # one trip per wedge; beat re-arms
            tripped.append(h.name)
            get_registry().counter("telemetry.watchdog.trips").inc()
            log.error("watchdog: loop '%s' has made no progress for "
                      "%.2fs (timeout %.2fs) — dumping postmortem",
                      h.name, age, h.timeout_s)
            flight_recorder().note("watchdog_trip", loop=h.name,
                                   age_s=round(age, 3),
                                   timeout_s=h.timeout_s)
            now = time.monotonic()
            if now - _last_dump_at >= _DUMP_COOLDOWN_S:
                _last_dump_at = now
                # Detached with a bounded join: if the WEDGED thread is
                # stuck holding a lock the dump needs (logger,
                # registry), the monitor must not wedge behind it —
                # the dump thread keeps trying in the background and
                # the monitor keeps watching the other loops.
                _dump_detached({"kind": "watchdog", "loop": h.name,
                                "age_s": round(age, 3),
                                "timeout_s": h.timeout_s},
                               self.out_dir, join_s=2.0)
        return tripped

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def start_watchdog(poll_s: Optional[float] = None,
                   out_dir: Optional[str] = None) -> None:
    """Start (idempotently) the monitor thread that checks registered
    loops. ``poll_s`` None = adaptive (quarter of the tightest timeout);
    ``out_dir`` None = the ``-telemetry_dir`` flag at dump time."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = _WatchdogMonitor(poll_s, out_dir)


def stop_watchdog() -> None:
    global _monitor
    with _monitor_lock:
        if _monitor is not None:
            _monitor.stop()
            _monitor = None


# ---------------------------------------------------------------------------
# Postmortem dumps
# ---------------------------------------------------------------------------
_dump_seq = itertools.count()


def _dump_detached(reason: Dict, out_dir: Optional[str],
                   join_s: float) -> None:
    """Run :func:`dump_postmortem` on a sacrificial daemon thread with a
    bounded join — callers that must stay live (signal handler, watchdog
    monitor) cannot afford to block on a lock a wedged/interrupted
    thread holds."""
    t = threading.Thread(target=dump_postmortem, args=(reason,),
                         kwargs={"out_dir": out_dir}, daemon=True)
    t.start()
    t.join(timeout=join_s)


def _thread_stacks() -> List[Dict]:
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        out.append({
            "name": t.name if t is not None else f"ident-{ident}",
            "ident": int(ident),
            "daemon": bool(t.daemon) if t is not None else None,
            "alive": bool(t.is_alive()) if t is not None else None,
            "stack": [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)],
        })
    return sorted(out, key=lambda d: d["name"])


def build_postmortem(reason: Dict) -> Dict:
    """The full black-box payload — every section best-effort, so a
    half-broken process still dumps what it can."""
    from multiverso_tpu_torch.telemetry.spans import current_identity
    ident = current_identity()
    payload: Dict = {
        "schema": POSTMORTEM_SCHEMA,
        "pid": ident["pid"],
        "rank": ident.get("rank", 0),
        "time_unix": time.time(),
        "reason": dict(reason),
    }
    try:
        payload["threads"] = _thread_stacks()
    except Exception as e:  # noqa: BLE001 - a dump must never half-crash
        payload["threads"] = []
        payload.setdefault("dump_errors", []).append(f"threads: {e}")
    try:
        payload["watchdogs"] = {
            h.name: {"age_s": round(h.age_s(), 3),
                     "timeout_s": h.timeout_s,
                     "beats": h.beats,
                     "tripped": bool(h.tripped)}
            for h in watchdog_handles()}
    except Exception as e:  # noqa: BLE001
        payload["watchdogs"] = {}
        payload.setdefault("dump_errors", []).append(f"watchdogs: {e}")
    try:
        payload["flight"] = flight_recorder().snapshot()
    except Exception as e:  # noqa: BLE001
        payload["flight"] = {"events": [], "spans": [], "logs": []}
        payload.setdefault("dump_errors", []).append(f"flight: {e}")
    try:
        from multiverso_tpu_torch.telemetry import alerts as _alerts
        payload["alerts"] = _alerts.active_alert_summaries()
    except Exception as e:  # noqa: BLE001
        payload["alerts"] = []
        payload.setdefault("dump_errors", []).append(f"alerts: {e}")
    try:
        payload["metrics"] = get_registry().snapshot(buckets=False)
    except Exception as e:  # noqa: BLE001
        payload["metrics"] = {}
        payload.setdefault("dump_errors", []).append(f"metrics: {e}")
    # The tail-exemplar reservoir and the sampling profiler are not
    # ported yet (ROADMAP A11): the section the JAX package writes when
    # the reservoir cannot be read, and no profile section.
    payload["exemplars"] = []
    return payload


def _flag_out_dir() -> Optional[str]:
    from multiverso_tpu_torch.utils.configure import flag_or
    return str(flag_or("telemetry_dir", "")) or None


def dump_postmortem(reason: Dict,
                    out_dir: Optional[str] = None) -> Optional[str]:
    """Build + atomically write ``postmortem-<pid>.json``; returns the
    path, or None when no directory is configured (the payload is still
    recorded as a flight event so an attached debugger can find it)."""
    payload = build_postmortem(reason)
    get_registry().counter("telemetry.postmortem.dumps").inc()
    out_dir = out_dir or _flag_out_dir()
    if not out_dir:
        log.warning("postmortem (%s) built but -telemetry_dir is unset; "
                    "not written", reason.get("kind", "?"))
        return None
    path = os.path.join(out_dir, f"postmortem-{payload['pid']}.json")
    try:
        os.makedirs(out_dir, exist_ok=True)
        # Counter-qualified tmp: a watchdog-trip dump and a fatal-signal
        # dump can run CONCURRENTLY in one process (both detached) —
        # sharing one tmp path would interleave their writes into a
        # corrupt artifact at exactly the moment it matters most.
        tmp = f"{path}.tmp.{payload['pid']}.{next(_dump_seq)}"
        with open(tmp, "w") as f:
            # default=str: flight notes and metric snapshots can carry
            # leaves json can't encode (a numpy scalar, a deque repr) —
            # a TypeError here would silently lose the whole artifact
            # at exactly the crash/wedge moment this module exists for.
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError) as e:
        log.error("postmortem write to %s failed: %s", path, e)
        return None
    log.info("postmortem written: %s (%s)", path,
             reason.get("kind", "?"))
    return path


def validate_postmortem(payload: Dict) -> None:
    """Raise ``ValueError`` unless ``payload`` matches the postmortem
    schema (the JAX package's schema, so its readers take the port's
    dumps)."""
    if not isinstance(payload, dict) or \
            payload.get("schema") != POSTMORTEM_SCHEMA:
        raise ValueError(
            f"bad postmortem schema {payload.get('schema')!r}"
            if isinstance(payload, dict) else "postmortem must be an object")
    for key in ("pid", "rank"):
        if not isinstance(payload.get(key), int):
            raise ValueError(f"postmortem missing integer '{key}'")
    if not isinstance(payload.get("reason"), dict) or \
            "kind" not in payload["reason"]:
        raise ValueError("postmortem missing reason.kind")
    threads = payload.get("threads")
    if not isinstance(threads, list) or not threads:
        raise ValueError("postmortem carries no thread stacks")
    for i, t in enumerate(threads):
        if not isinstance(t.get("name"), str):
            raise ValueError(f"threads[{i}] missing name")
        stack = t.get("stack")
        if not isinstance(stack, list):
            raise ValueError(f"threads[{i}] missing stack")
    flight = payload.get("flight")
    if not isinstance(flight, dict):
        raise ValueError("postmortem missing flight section")
    for section in ("events", "spans", "logs"):
        if not isinstance(flight.get(section), list):
            raise ValueError(f"flight.{section} must be a list")
    if not isinstance(payload.get("watchdogs"), dict):
        raise ValueError("postmortem missing watchdogs section")
    if not isinstance(payload.get("metrics"), dict):
        raise ValueError("postmortem missing metrics section")


# ---------------------------------------------------------------------------
# Fatal-signal hook
# ---------------------------------------------------------------------------
_handlers_installed = False

#: SIGABRT (the drill's "abrupt death that still leaves an artifact")
#: and SIGQUIT (operator asking a stuck process to explain itself).
#: SIGTERM is deliberately NOT hooked: it is the normal shutdown path
#: and a postmortem per clean stop would bury the real ones.
CRASH_SIGNALS = (signal.SIGABRT, signal.SIGQUIT)


def install_crash_handlers(out_dir: Optional[str] = None) -> bool:
    """Install fatal-signal handlers (main thread only — CPython's
    rule) that dump a postmortem and then die by the ORIGINAL signal
    semantics: the handler restores ``SIG_DFL`` and re-raises, so exit
    codes, core dumps, and the abruptness the fault drill relies on all
    stay exactly as without the hook."""
    global _handlers_installed
    if threading.current_thread() is not threading.main_thread():
        return False
    if _handlers_installed:
        return True

    def _handler(signum, frame):  # noqa: ARG001 - signal ABI
        try:
            # The dump runs on a SACRIFICIAL thread with a bounded
            # join: the handler interrupts the main thread mid-
            # bytecode, possibly while it HOLDS one of the non-
            # reentrant locks the dump needs (logger, registry, flight
            # ring). Dumping inline would deadlock the handler and the
            # process would hang alive instead of dying — the worst
            # outcome for a fault drill. With the bounded join, a held
            # lock can cost the artifact, never the death.
            _dump_detached({"kind": "signal", "signal": int(signum),
                            "signal_name": signal.Signals(signum).name},
                           out_dir, join_s=5.0)
        finally:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    for sig in CRASH_SIGNALS:
        signal.signal(sig, _handler)
    _handlers_installed = True
    return True


def reset_flight() -> None:
    """Test isolation: stop the monitor, drop handles and events."""
    global _last_dump_at
    stop_watchdog()
    with _handles_lock:
        _handles.clear()
    flight_recorder().clear()
    _last_dump_at = 0.0
