"""Shared CLI app runner: init -> body -> shutdown with clean exits.

Port of the part of ``multiverso_tpu/apps/_runner.py`` the CLIs use, with
the multi-process launch helpers (``spawn_ranks``, ``rendezvous``,
``wait_all_done``) and the flag parses (``serve_config``,
``comm_config``, ``fleet_config``). User-facing errors (bad flag values,
fatal checks, IO) log one line and return exit code 1 instead of a
traceback. The alert engine and the wedge watchdog run for the body
(``-telemetry_alerts``, ``-telemetry_flight``); telemetry export
(``-telemetry_dir``) waits (ROADMAP A11).
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.utils.configure import FlagError
from multiverso_tpu_torch.utils.log import FatalError, log

_USER_ERRORS = (FlagError, FatalError, OSError)


def run_app(body: Callable[[List[str]], int],
            argv: Optional[List[str]] = None) -> int:
    """Parse flags + start the runtime, run ``body(remaining_argv)``,
    always shut down. Returns a process exit code. The alert engine,
    the wedge watchdog and the fatal-signal postmortems run for the body
    and stop after shutdown."""
    from multiverso_tpu_torch.telemetry import (
        maybe_start_observability_from_flags, stop_alert_engine,
        stop_watchdog)
    try:
        remaining = mv.init(argv if argv is not None else sys.argv[1:])
    except _USER_ERRORS as e:
        log.error("%s", e)
        return 1
    observability_on = False
    try:
        if configure.get_flag("telemetry_dir"):
            raise NotImplementedError(
                "telemetry export (-telemetry_dir) is not ported yet: "
                "ROADMAP A11")
        # Alert engine + wedge watchdog + fatal-signal postmortems
        # (-telemetry_alerts / -telemetry_flight, both default-on).
        observability_on = maybe_start_observability_from_flags()
        return body(remaining)
    except _USER_ERRORS as e:
        log.error("%s", e)
        return 1
    finally:
        try:
            mv.shutdown()
        finally:
            if observability_on:
                stop_alert_engine()
                stop_watchdog()


def serve_config() -> dict:
    """Resolve the ``-serve_*`` flags into the kwargs
    :meth:`ServingService.register_runner` takes, plus the listener
    address (the JAX package's ``apps/_runner.py::serve_config``)."""
    from multiverso_tpu_torch.serving.quant import STORAGE_DTYPES
    from multiverso_tpu_torch.utils.log import FatalError

    get_flag = configure.get_flag
    raw = str(get_flag("serve_buckets"))
    try:
        buckets = tuple(int(b) for b in raw.split(",") if b.strip())
    except ValueError:
        raise FatalError(f"bad -serve_buckets value '{raw}' "
                         "(want e.g. '8,16,32,64')") from None
    if not buckets:
        raise FatalError("-serve_buckets must name at least one bucket")
    depth_raw = str(get_flag("serve_pipeline_depth")).strip().lower()
    if depth_raw not in ("", "auto"):
        try:
            int(depth_raw)
        except ValueError:
            raise FatalError(f"bad -serve_pipeline_depth value "
                             f"'{depth_raw}' (want an int or 'auto')") \
                from None
    kv_dtype = str(get_flag("serve_kv_dtype")).strip().lower() or "f32"
    table_dtype = str(get_flag("serve_table_dtype")).strip().lower() \
        or "f32"
    for name, val in (("-serve_kv_dtype", kv_dtype),
                      ("-serve_table_dtype", table_dtype)):
        if val not in STORAGE_DTYPES:
            raise FatalError(f"bad {name} value '{val}' "
                             f"(want one of {', '.join(STORAGE_DTYPES)})")
    return {
        "host": str(get_flag("serve_host")),
        "port": int(get_flag("serve_port")),
        "buckets": buckets,
        "max_batch": int(get_flag("serve_max_batch")),
        "max_wait_ms": float(get_flag("serve_max_wait_ms")),
        "max_queue": int(get_flag("serve_admission")),
        "pipeline_depth": depth_raw or "auto",
        "cache_rows": int(get_flag("serve_cache_rows")),
        "cache_staleness": int(get_flag("serve_cache_staleness")),
        "cache_mem_budget": int(get_flag("serve_cache_mem_budget")),
        "continuous": bool(get_flag("serve_continuous")),
        "paged": bool(get_flag("serve_paged_kv")),
        "kv_page": int(get_flag("serve_kv_page")),
        "kv_pages": int(get_flag("serve_kv_pages")),
        "kv_dtype": kv_dtype,
        "table_dtype": table_dtype,
        "prefix_entries": int(get_flag("serve_prefix_cache")),
    }


def fleet_config() -> dict:
    """Resolve the ``-fleet_*`` flags into router/member/client kwargs
    (one parse, like :func:`serve_config`; the JAX package's
    ``apps/_runner.py::fleet_config``)."""
    from multiverso_tpu_torch.utils.log import FatalError

    get_flag = configure.get_flag
    hedge: object = str(get_flag("fleet_hedge"))
    if hedge not in ("adaptive", "off"):
        try:
            hedge = float(hedge)
        except ValueError:
            raise FatalError(f"bad -fleet_hedge value '{hedge}' "
                             "(want adaptive|off|<ms>)") from None
    router_raw = str(get_flag("fleet_router"))
    router = None
    if router_raw:
        try:
            host, port = router_raw.rsplit(":", 1)
            router = (host, int(port))
        except ValueError:
            raise FatalError(f"bad -fleet_router value '{router_raw}' "
                             "(want host:port)") from None
    synthetic_raw = str(get_flag("fleet_synthetic"))
    synthetic = None
    if synthetic_raw:
        try:
            dims, seed = synthetic_raw.split("@") \
                if "@" in synthetic_raw else (synthetic_raw, "0")
            rows, cols = dims.lower().split("x")
            synthetic = (int(rows), int(cols), int(seed))
        except ValueError:
            raise FatalError(f"bad -fleet_synthetic value "
                             f"'{synthetic_raw}' (want ROWSxCOLS@SEED)") \
                from None
    return {
        "role": str(get_flag("fleet_role")),
        "router": router,
        "port": int(get_flag("fleet_port")),
        "replicas": int(get_flag("fleet_replicas")),
        "vnodes": int(get_flag("fleet_vnodes")),
        "heartbeat_ms": float(get_flag("fleet_heartbeat_ms")),
        "liveness_misses": int(get_flag("fleet_liveness_misses")),
        "hedge": hedge,
        "member_id": str(get_flag("fleet_member_id")),
        "addr_file": str(get_flag("fleet_addr_file")),
        "synthetic": synthetic,
        "proxy": bool(get_flag("fleet_proxy")),
        "drain_timeout_s": float(get_flag("fleet_drain_timeout_s")),
        "supervise": bool(get_flag("fleet_supervise")),
        "min_replicas": int(get_flag("fleet_min_replicas")),
        "max_replicas": int(get_flag("fleet_max_replicas")),
        "supervisor_cooldown_s":
            float(get_flag("fleet_supervisor_cooldown_s")),
        "scale_quiet_s": float(get_flag("fleet_scale_quiet_s")),
        "rpc_timeout_ms": float(get_flag("rpc_timeout_ms")),
        "ps_shards": int(get_flag("ps_fleet_shards")),
        "ps_dir": str(get_flag("ps_fleet_dir")),
        "hotkey_replicas": int(get_flag("fleet_hotkey_replicas")),
        "rebalance": bool(get_flag("fleet_rebalance")),
        "rebalance_ratio": float(get_flag("fleet_rebalance_ratio")),
        "rebalance_windows": int(get_flag("fleet_rebalance_windows")),
        "rebalance_cooldown_s":
            float(get_flag("fleet_rebalance_cooldown_s")),
        "rebalance_vnodes": int(get_flag("fleet_rebalance_vnodes")),
    }


def comm_config() -> dict:
    """Resolve the ``-comm_policy`` / ``-comm_policy_overrides`` flags into
    the model-config fields — one parse shared by word2vec_main and
    logreg_main (the JAX package's ``apps/_runner.py::comm_config``)."""
    from multiverso_tpu_torch.utils.log import FatalError

    policy = str(configure.get_flag("comm_policy")).strip().lower()
    valid = ("", "auto", "hybrid", "ps", "allreduce", "model_average")
    if policy not in valid:
        raise FatalError(f"bad -comm_policy value '{policy}' "
                         f"(want one of {'|'.join(v for v in valid if v)})")
    raw = str(configure.get_flag("comm_policy_overrides")).strip()
    overrides = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        table, sep, pol = part.partition("=")
        pol = pol.strip().lower()
        if not sep or not table.strip() or pol not in (
                "ps", "allreduce", "model_average"):
            raise FatalError(
                f"bad -comm_policy_overrides entry '{part}' (want "
                "'table=ps|allreduce|model_average')")
        overrides[table.strip()] = pol
    return {"comm_policy": policy or None, "comm_policy_overrides":
            overrides or None}


def spawn_ranks(module: str, args: List[str], world: int,
                rank_flag: str) -> int:
    """Launcher: re-exec ``python -m <module>`` once per rank with a shared
    rendezvous dir (the single-host ``mpirun -np N`` analog of the
    reference's deployment). Runs BEFORE any runtime init: the launcher
    only forks and waits. The ranks inherit the device flags, so local
    ranks share the one card unless told otherwise."""
    import shutil
    import subprocess
    import tempfile

    rdv = next((a.split("=", 1)[1] for a in args
                if a.startswith("-rendezvous_dir=")), "")
    given = bool(rdv)
    if rdv:
        # Namespace each run: stale addr/done files from a previous run in
        # the same dir would poison the address exchange and the shutdown
        # barrier.
        rdv = tempfile.mkdtemp(prefix="run_", dir=rdv)
    else:
        rdv = tempfile.mkdtemp(prefix="mvapp_")
    base = [a for a in args
            if not a.startswith(("-world_size", f"-{rank_flag}",
                                 "-rendezvous_dir"))]
    procs = []
    for r in range(world):
        cmd = [sys.executable, "-m", module, *base,
               f"-world_size={world}", f"-{rank_flag}={r}",
               f"-rendezvous_dir={rdv}"]
        procs.append(subprocess.Popen(cmd))
    rc = 0
    for p in procs:
        p.wait()
        rc |= p.returncode
    if not given:
        shutil.rmtree(rdv, ignore_errors=True)   # the launcher's own dir
    return rc


def _flag_value(args: List[str], name: str) -> Optional[str]:
    """Raw-argv value of ``-name=v`` (or ``--name=v``); last one wins."""
    for a in reversed(args):
        stripped = a.lstrip("-")
        if stripped.startswith(f"{name}="):
            return stripped.split("=", 1)[1]
    return None


def pin_device_if_requested(args: List[str], device_flag: str) -> None:
    """Single-process mode runs on the card unless the user explicitly
    passes ``-<device_flag>=cpu``, which selects ``-platform=cpu``."""
    if _flag_value(args, device_flag) == "cpu":
        configure.set_flag("platform", "cpu")


def rendezvous(rdv: str, rank: int, world: int, address,
               timeout_s: float = 120.0) -> List:
    """File-based address exchange (the Controller registration analog for
    externally-spawned ranks, ref src/controller.cpp:38-72)."""
    import os
    import time

    with open(os.path.join(rdv, f"addr{rank}.tmp"), "w") as f:
        f.write(f"{address[0]}:{address[1]}")
    os.replace(os.path.join(rdv, f"addr{rank}.tmp"),
               os.path.join(rdv, f"addr{rank}"))
    peers: List = [None] * world
    deadline = time.time() + timeout_s
    for r in range(world):
        path = os.path.join(rdv, f"addr{r}")
        delay = 0.01
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(f"rank {r} never registered in {rdv}")
            time.sleep(delay)
            delay = min(delay * 2.0, 0.25)
        host, port = open(path).read().split(":")
        peers[r] = (host, int(port))
    return peers


def wait_all_done(rdv: str, rank: int, world: int,
                  timeout_s: float = 600.0, tag: str = "done") -> None:
    """Hold this rank's table shards up until every peer finished (the
    MV_Barrier before shutdown, ref distributed_wordembedding.cpp:232).
    ``tag`` names the barrier, so a run can pass more than one."""
    import os
    import time

    with open(os.path.join(rdv, f"{tag}{rank}"), "w") as f:
        f.write("ok")
    deadline = time.time() + timeout_s
    for r in range(world):
        delay = 0.01
        while not os.path.exists(os.path.join(rdv, f"{tag}{r}")):
            if time.time() > deadline:
                raise TimeoutError(f"rank {r} never finished")
            time.sleep(delay)
            delay = min(delay * 2.0, 0.25)
