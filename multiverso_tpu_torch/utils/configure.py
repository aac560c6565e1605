"""Typed flag registry with ``-key=value`` CLI parsing.

Capability parity with the reference flag system
(``include/multiverso/util/configure.h:13-114``,
``src/util/configure.cpp:9-54``): typed registration (int/bool/string/double),
command-line parsing that *consumes* matched ``-key=value`` args, and
programmatic override (``MV_SetFlag``, ``src/multiverso.cpp:48-51``).

Port notes: one process-global registry (no per-type template
stores needed in Python), thread-safe, and values are plain Python objects.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

_TRUE_STRINGS = frozenset({"true", "1", "yes", "on"})
_FALSE_STRINGS = frozenset({"false", "0", "no", "off"})


class FlagError(KeyError):
    """Unknown flag or bad flag value."""


class _Flag:
    __slots__ = ("name", "type", "value", "default", "description")

    def __init__(self, name: str, typ: type, default: Any, description: str):
        self.name = name
        self.type = typ
        self.value = default
        self.default = default
        self.description = description


class FlagRegistry:
    """Process-global typed flag store."""

    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}
        self._lock = threading.RLock()

    def define(self, name: str, typ: type, default: Any, description: str = "") -> None:
        with self._lock:
            existing = self._flags.get(name)
            if existing is not None:
                # Re-definition with identical type keeps first default
                # (mirrors static-init registration being idempotent).
                if existing.type is not typ:
                    raise FlagError(
                        f"flag '{name}' already defined with type {existing.type.__name__}"
                    )
                return
            self._flags[name] = _Flag(name, typ, typ(default), description)

    def is_defined(self, name: str) -> bool:
        with self._lock:
            return name in self._flags

    def get(self, name: str) -> Any:
        with self._lock:
            try:
                return self._flags[name].value
            except KeyError:
                raise FlagError(f"flag '{name}' is not defined") from None

    def set(self, name: str, value: Any) -> None:
        """Programmatic override (``MV_SetFlag`` analog)."""
        with self._lock:
            try:
                flag = self._flags[name]
            except KeyError:
                raise FlagError(f"flag '{name}' is not defined") from None
            flag.value = self._coerce(flag, value)

    def reset(self) -> None:
        """Restore every flag to its registered default (test isolation)."""
        with self._lock:
            for flag in self._flags.values():
                flag.value = flag.default

    def parse_cmd_flags(self, argv: Optional[List[str]]) -> List[str]:
        """Parse ``-key=value`` args; return argv with matched args *removed*.

        Mirrors the reference's consuming parse (``src/util/configure.cpp:24-54``):
        unmatched args are left for the application's own parser.
        """
        if not argv:
            return []
        remaining: List[str] = []
        with self._lock:
            for arg in argv:
                body = None
                if arg.startswith("--"):
                    body = arg[2:]
                elif arg.startswith("-"):
                    body = arg[1:]
                if body and "=" in body:
                    key, _, raw = body.partition("=")
                    flag = self._flags.get(key)
                    if flag is not None:
                        flag.value = self._coerce(flag, raw)
                        continue
                remaining.append(arg)
        return remaining

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            return {name: f.value for name, f in sorted(self._flags.items())}

    @staticmethod
    def _coerce(flag: _Flag, value: Any) -> Any:
        if flag.type is bool:
            if isinstance(value, str):
                lowered = value.strip().lower()
                if lowered in _TRUE_STRINGS:
                    return True
                if lowered in _FALSE_STRINGS:
                    return False
                raise FlagError(f"bad bool value '{value}' for flag '{flag.name}'")
            return bool(value)
        try:
            return flag.type(value)
        except (TypeError, ValueError) as e:
            raise FlagError(
                f"bad {flag.type.__name__} value '{value}' for flag '{flag.name}'"
            ) from e


_registry = FlagRegistry()


def define_int(name: str, default: int, description: str = "") -> None:
    _registry.define(name, int, default, description)


def define_bool(name: str, default: bool, description: str = "") -> None:
    _registry.define(name, bool, default, description)


def define_string(name: str, default: str, description: str = "") -> None:
    _registry.define(name, str, default, description)


def define_double(name: str, default: float, description: str = "") -> None:
    _registry.define(name, float, default, description)


def get_flag(name: str) -> Any:
    return _registry.get(name)


def set_flag(name: str, value: Any) -> None:
    _registry.set(name, value)


def flag_or(name: str, default: Any) -> Any:
    """Flag value, or ``default`` when the flag registry is unparsed /
    the flag unknown — for bare library use (unit tests construct
    services and telemetry without ``mv.init``). THE one shared
    fallback helper; sites must not grow their own."""
    try:
        return _registry.get(name)
    except Exception:  # noqa: BLE001 - unparsed registry IS the signal
        return default


def parse_cmd_flags(argv: Optional[List[str]]) -> List[str]:
    return _registry.parse_cmd_flags(argv)


def reset_flags() -> None:
    _registry.reset()


def describe_flags() -> Dict[str, Any]:
    return _registry.describe()


# ---------------------------------------------------------------------------
# Core framework flags — names preserved from the reference for config parity.
# ---------------------------------------------------------------------------
define_bool("sync", False, "BSP (synchronous) mode; async ASGD otherwise "
            "(ref src/server.cpp:20)")
define_bool("ma", False, "model-average mode: skip the table service, use "
            "allreduce aggregate only (ref src/zoo.cpp:24)")
define_string("ps_role", "default", "none|worker|server|default "
              "(ref src/zoo.cpp:23)")
define_string("updater_type", "default", "default|sgd|adagrad|momentum_sgd "
              "(ref src/updater/updater.cpp:18)")
define_string("state_sharding", "auto", "updater-state sharding across the "
              "mesh's replica ('worker') axis per arXiv 2004.13336: each "
              "replica holds 1/k of every state leaf instead of a full "
              "copy (params stay bitwise-equal; docs/DESIGN.md 'Sharded "
              "updater state'). auto = shard whenever the mesh has a "
              "worker axis > 1 and the leaf divides evenly; on = require "
              "it; off = keep state replicated")
define_bool("staleness_adaptive", False, "scale DC-ASGD's variance-control "
            "term by the MEASURED per-worker clock lag (sync mode: the "
            "SyncCoordinator's add-clock lag; DCN: the PS service's "
            "per-worker add-lag gauges) instead of a fixed lambda — "
            "lambda_eff = lambda * lag (docs/DESIGN.md)")
define_int("omp_threads", 4, "host-side update parallelism hint "
           "(ref src/updater/updater.cpp:19)")
define_double("backup_worker_ratio", 0.0, "straggler over-provision ratio "
              "(ref src/server.cpp:21; unused there too)")
define_int("allocator_alignment", 16, "host buffer alignment "
           "(ref src/util/allocator.cpp:10)")
define_string("machine_file", "", "host list for externally-orchestrated "
              "clusters (ref zmq_net.h:20)")
define_int("port", 55555, "transport port (ref zmq_net.h:21)")
# Wire compression for the DCN table service (ref runs all sparse-table
# traffic through SparseFilter, sparse_matrix_table.cpp:148-153; OneBits is
# a stub there, quantization_util.h:160-161 — real here, behind the flag).
define_string("wire_compression", "sparse", "none|sparse|onebit|bf16: "
              "filter for DCN table payloads (ref quantization_util.h:"
              "10-164; bf16 halves bytes both legs)")
define_double("wire_compression_clip", 0.0, "SparseFilter clip threshold "
              "(entries with |x|<=clip drop; ref FilterIn)")
# Additions beyond the reference's flags.
define_string("mesh_shape", "", "comma 'axis:size' list, e.g. 'server:8'; "
              "empty = one axis over all devices")
define_bool("deterministic", False, "force deterministic reductions")
define_bool("flash_attention", False, "route the local block step of ring "
            "and Ulysses attention through the flash block kernel (B6, "
            "csrc/attention.cu; forward only: train with it off)")
# Multi-controller bring-up (the Controller/RegisterNode analog,
# ref src/controller.cpp:38-80 -> a torch.distributed process group;
# parallel/mesh.py, core/zoo.py).
define_string("coordinator", "", "host:port of the process-group "
              "coordinator; empty = single-process")
define_int("world_size", 1, "number of processes (ranks)")
define_int("rank", 0, "this process's rank")
define_string("platform", "", "device platform: empty = the CUDA card "
              "(cuda:0; init raises without one), 'cpu' = run on the host "
              "CPU (tests, hosts without a card)")
# Serving plane (multiverso_tpu_torch/serving; docs/SERVING.md).
define_string("serve_host", "127.0.0.1", "serving listener bind address "
              "(0.0.0.0 to accept remote clients; the advertised address "
              "in -serve_addr_file is the bound one)")
define_int("serve_port", 0, "serving service TCP port (0 = ephemeral; "
           "the bound address is logged and written to -serve_addr_file)")
define_string("serve_buckets", "8,16,32,64", "comma-separated pad-to "
              "bucket ladder for serve payload lengths; fixed ladder = "
              "one compiled executable per bucket, no retraces")
define_double("serve_max_wait_ms", 2.0, "how long the head request may "
              "wait for batch company before the batcher flushes")
define_int("serve_max_batch", 8, "dynamic batch width (also the padded "
           "batch dimension — part of the compiled shape)")
define_int("serve_admission", 64, "admission bound: queued-but-unbatched "
           "requests; beyond it the nearest-deadline request is shed")
define_string("serve_wire_dtype", "f32", "f32|bf16: SERVE_REPLY value "
              "payload encoding (bf16 halves reply bytes at bfloat16 "
              "read precision; ids/token payloads always ship raw)")
define_string("serve_addr_file", "", "write 'host:port' here once the "
              "serving listener is bound (rendezvous for clients/tests)")
define_double("serve_duration", 0.0, "serve for N seconds then exit "
              "(0 = until killed) — CI and smoke hooks")
define_string("serve_pipeline_depth", "auto", "device dispatch pipeline "
              "depth: batch k+1 is gathered/launched while batch k is on "
              "device, up to N in flight (bounded backpressure beyond). "
              "auto = measured-dispatch-latency decision table "
              "(docs/SERVING.md); 0/1 = serialized dispatch")
define_int("serve_cache_rows", 0, "hot-row LRU cache capacity in rows "
           "(0 = off): a lookup whose every key is cached within the "
           "staleness bound answers host-side with no device dispatch")
define_int("serve_cache_staleness", 0, "max BSP-clock-tick age a cached "
           "row may serve (0 = current tick only — bitwise-fresh under "
           "BSP; replica tables age by checkpoint step)")
define_bool("serve_continuous", False, "iteration-level continuous "
            "batching for LM decode: new requests claim free KV-cache "
            "slots at step boundaries instead of waiting for the "
            "running batch to drain (tokens bit-identical either way)")
# Decode memory hierarchy (docs/SERVING.md "Decode memory hierarchy").
define_bool("serve_paged_kv", False, "paged KV cache for LM decode: "
            "fixed-size pages from one shared pool via per-slot page "
            "tables, so HBM held scales with ACTUAL context lengths "
            "(f32 tokens stay bitwise-equal to the preallocated path)")
define_int("serve_kv_page", 16, "KV page size in token positions "
           "(paged mode); smaller pages track lengths tighter at more "
           "page-table overhead")
define_int("serve_kv_pages", 0, "page pool capacity (paged mode; 0 = "
           "auto: full backing for every bucket engine). Set LOWER to "
           "enforce an HBM budget — pool exhaustion queues decode "
           "admissions at step boundaries instead of crashing")
define_string("serve_kv_dtype", "f32", "f32|bf16|int8: KV page storage "
              "dtype (paged mode) with dequant-on-read fused into the "
              "decode step; int8 carries a per-row absmax scale")
define_string("serve_table_dtype", "f32", "f32|bf16|int8: frozen replica "
              "table STORAGE dtype with dequant fused into the lookup "
              "gather (f32 stays bitwise-equal to direct table rows; "
              "quantized trades bounded read error for table bytes)")
define_int("serve_prefix_cache", 0, "prefix-cache entries (0 = off; "
           "needs -serve_paged_kv): requests sharing a prompt share "
           "prefill output and prompt KV pages (copy-on-extend), "
           "probed at step-boundary admission")
# Fleet layer (multiverso_tpu_torch/fleet; docs/SERVING.md "Fleet").
define_string("fleet_role", "local", "local|router|replica|drain|"
              "ps_fleet: local spawns a router + -fleet_replicas replica "
              "processes; router/replica run one role (production: one "
              "per host); drain triggers a rolling checkpoint drain on a "
              "running fleet (-fleet_router; -fleet_member_id to drain "
              "one); ps_fleet supervises -ps_fleet_shards durable WAL'd "
              "PS shards (docs/DURABILITY.md 'Fleet topology')")
define_string("fleet_router", "", "host:port of the fleet router's "
              "control listener (replica role + fleet clients)")
define_int("fleet_port", 0, "router control/proxy listener port "
           "(0 = ephemeral; written to -fleet_addr_file)")
define_int("fleet_replicas", 2, "local role: replica processes to spawn")
define_int("fleet_vnodes", 64, "virtual nodes per member on the "
           "consistent-hash ring (balance vs rebuild cost)")
define_double("fleet_heartbeat_ms", 100.0, "member heartbeat cadence; "
              "the router assigns it at join")
define_int("fleet_liveness_misses", 5, "missed heartbeats before the "
           "router declares a member dead and drops it from the ring")
define_string("fleet_hedge", "adaptive", "adaptive|off|<ms>: client hedge "
              "delay — adaptive tracks ~1.25x p95 of recent latency")
define_string("fleet_member_id", "", "replica id on the ring (default "
              "host:port#pid — stable ids give stable ring arcs)")
define_string("fleet_addr_file", "", "router writes 'host:port' of the "
              "bound control listener here (rendezvous for replicas)")
define_string("fleet_synthetic", "", "ROWSxCOLS@SEED: serve a seeded "
              "synthetic lookup table instead of -checkpoint_dir "
              "(benches + smokes; replicas with equal seeds serve "
              "bitwise-identical rows)")
define_bool("fleet_proxy", True, "router also proxies plain Serve_Request "
            "traffic (clients that don't speak the routing protocol)")
define_double("fleet_drain_timeout_s", 30.0, "drain barrier: max wait for "
              "in-flight batches before the checkpoint swap proceeds")
# PS-shard durability: write-ahead delta log + crash recovery
# (core/wal.py, parallel/ps_service.py; docs/DURABILITY.md).
define_bool("wal", False, "arm the PS shard write-ahead delta log: every "
            "accepted Request_Add appends a CRC-framed record; recovery = "
            "latest checkpoint + replay the log tail (docs/DURABILITY.md)")
define_string("wal_dir", "", "WAL segment directory (per process — a "
              "rank<k> subdirectory is appended when the CLI knows its "
              "rank); required when -wal=true")
define_double("wal_flush_ms", 25.0, "group-commit interval: staged records "
              "are written+fsynced together every this many ms (an abrupt "
              "kill loses at most this window of ACKED adds; -wal_sync_acks "
              "closes the window entirely at per-record fsync cost)")
define_bool("wal_sync_acks", False, "fsync each add's record BEFORE its "
            "reply: no acked-write-loss window, at per-record fsync cost "
            "on the dispatch thread (the recovery drill's mode)")
define_double("wal_fsync_delay_ms", 0.0, "CHAOS: inject this many ms of "
              "sleep before every WAL commit fsync (a slow/contended "
              "disk fault; 0 = off — the chaos drill arms it on a "
              "seeded subset of shard seats)")
# Fleet supervisor: the ACTUATION half of the self-healing fleet
# (fleet/supervisor.py; docs/DURABILITY.md "Supervisor").
define_bool("fleet_supervise", False, "local fleet role: watch spawned "
            "replicas and respawn on death/heartbeat loss; scale up on "
            "firing serve.slo_burn / serve.queue_saturation alerts and "
            "back down after a quiet period (hysteresis + cooldown)")
define_int("fleet_min_replicas", 1, "supervisor floor: scale-down never "
           "goes below this many replicas")
define_int("fleet_max_replicas", 8, "supervisor ceiling: scale-up never "
           "goes above this many replicas")
define_double("fleet_supervisor_cooldown_s", 10.0, "minimum seconds "
              "between ANY two supervisor scaling actions (anti-flap)")
define_double("fleet_scale_quiet_s", 30.0, "how long every scale alert "
              "must stay resolved before the supervisor drains a "
              "scale-up replica back down")
# Recoverable fleet: multi-shard PS topology + per-RPC deadlines
# (fleet/ps_fleet.py, fleet/client.py; docs/DURABILITY.md).
define_double("rpc_timeout_ms", 0.0, "per-attempt RPC deadline on fleet "
              "client calls (0 = off): an attempt that outlives "
              "deadline + jittered slack is abandoned, the member is "
              "briefly suspected, and the request retries against the "
              "next ring owner — half-dead shards become failovers, "
              "not hangs")
define_int("ps_fleet_shards", 4, "ps_fleet role: durable WAL'd PS shard "
           "processes to spawn and supervise (each through the "
           "checkpoint+WAL-replay recovery path)")
define_string("ps_fleet_dir", "", "ps_fleet role: working directory for "
              "per-shard WAL/checkpoint/addr state (empty = a fresh "
              "temp directory; survives and feeds recovery when set)")
define_string("ps_table_kind", "array", "array|matrix: table kind a PS "
              "shard seat serves — matrix serves a sparse "
              "DistributedMatrixTable of -ps_table_size rows x "
              "-ps_table_cols cols")
define_int("ps_table_cols", 8, "matrix seats: columns per row "
           "(-ps_table_kind=matrix)")
# Per-table communication policy (parallel/comm_policy.py;
# docs/DESIGN.md "CommPolicy").
define_string("comm_policy", "", "per-table communication policy: '' = "
              "model default (ps/fused, unchanged), auto = decision "
              "table (sparse/HBM-scale -> ps, small dense -> measured "
              "probe), or ps|allreduce|model_average|hybrid explicit "
              "(models map the value onto their tables)")
define_string("comm_policy_overrides", "", "comma 'table=policy' "
              "per-table overrides under -comm_policy=auto, e.g. "
              "'w2v_wordcount=ps'")
# Telemetry export (multiverso_tpu_torch/telemetry; docs/OBSERVABILITY.md).
define_string("telemetry_dir", "", "write periodic metrics snapshots "
              "(metrics-<pid>-<seq>.json) and a Chrome trace "
              "(trace-<pid>.json) here; empty = telemetry export off")
define_double("telemetry_interval", 10.0, "seconds between telemetry "
              "snapshot exports (a final snapshot is always written at "
              "shutdown)")
define_double("telemetry_sample_rate", 0.02, "head-based trace sampling: "
              "fraction of serving requests whose distributed trace is "
              "recorded (the root client draws once; every hop honors "
              "the decision). Low by default so the request hot path "
              "stays cheap; 0 disables request tracing entirely; shed/"
              "error/slow requests record regardless (tail exemplars)")
define_double("telemetry_slow_ms", 100.0, "tail-exemplar threshold: a "
              "head-UNSAMPLED request that sheds, errors, or exceeds "
              "this latency still records its root span (tagged tail=1)")
define_double("serve_slo_ms", 50.0, "serving latency SLO: requests whose "
              "total latency exceeds this count toward the fleet "
              "rollup's slo_violations burn counter")
# SLO burn-rate alerting + flight recorder (telemetry/alerts.py,
# telemetry/flight.py; docs/OBSERVABILITY.md "Alerting").
define_double("serve_slo_budget", 0.05, "SLO error budget: fraction of "
              "requests allowed over -serve_slo_ms before burn rate 1.0")
define_double("serve_slo_fast_s", 5.0, "fast burn-rate window (seconds): "
              "catches an acute SLO breach within this horizon")
define_double("serve_slo_slow_s", 60.0, "slow burn-rate window (seconds): "
              "both windows must burn before the alert fires, so a "
              "single spike never pages")
define_double("serve_slo_burn", 2.0, "burn-rate threshold that BOTH "
              "windows must exceed: (bad/total)/budget")
define_bool("telemetry_alerts", True, "run the in-process alert engine "
            "(timeseries ticker + SLO burn / saturation / heartbeat-loss "
            "/ straggler rules); alerts ride the fleet heartbeat into "
            "Fleet_Stats and fleet_top")
define_bool("telemetry_flight", True, "arm the flight recorder's wedge "
            "watchdog monitor and fatal-signal (SIGABRT/SIGQUIT) "
            "postmortem handlers; dumps land in "
            "-telemetry_dir/postmortem-<pid>.json")
define_double("telemetry_ts_interval", 1.0, "seconds between timeseries "
              "ticks / alert rule evaluations (the downsampled window "
              "width burn rates are computed over)")
# Attribution layer: continuous profiler + tail exemplars
# (telemetry/profile.py, telemetry/critical_path.py;
# docs/OBSERVABILITY.md "Attribution").
define_bool("telemetry_profile", False, "run the continuous sampling "
            "profiler: a daemon thread samples sys._current_frames() at "
            "-telemetry_profile_hz into a bounded folded-stack aggregate "
            "with per-thread CPU attribution (profile.host_bound_pct "
            "per plane feeds the roofline classifier)")
define_double("telemetry_profile_hz", 4.0, "continuous profiler sample "
              "rate in Hz (bounded 0.2..50; each sample is one thread "
              "enumerate + bounded stack walk)")
define_bool("telemetry_exemplars", True, "keep per-plane tail-exemplar "
            "reservoirs: the slowest-N requests per window with their "
            "full phase ledgers and trace ids, shipped in heartbeats "
            "and embedded in snapshots/postmortems")
define_int("telemetry_exemplar_n", 8, "tail-exemplar reservoir capacity "
           "per plane per rotation window")
# Data-plane traffic sketches (telemetry/sketch.py; docs/OBSERVABILITY.md
# "Data-plane load").
define_bool("telemetry_sketch", True, "record streaming hot-key sketches "
            "(Count-Min + Space-Saving) on every data-plane key surface: "
            "ps_service row ops, serving lookups incl. cache hits, fleet "
            "key-affinity routing — the hot path is one list-append, "
            "folded in on the telemetry tick")
define_int("telemetry_sketch_width", 1024, "Count-Min counters per hash "
           "row: frequency over-estimate bounded by 2*stream/width per "
           "row (8 KiB of int64 per row at the default)")
define_int("telemetry_sketch_depth", 4, "Count-Min hash rows: the "
           "over-estimate bound holds with probability 1 - 2^-depth")
define_int("telemetry_sketch_topk", 128, "Space-Saving heavy-hitter "
           "capacity per surface: every key above stream/topk frequency "
           "is guaranteed tracked (fleet_top hot-keys + the cache "
           "advisor's CDF read from these)")
# Lock witness (telemetry/lockwitness.py via utils/locks.py seam;
# docs/CONCURRENCY.md). Default off: make_lock() returns the bare
# threading primitive, so the hot planes pay exactly nothing.
define_bool("lockwitness", False, "instrument locks built through "
            "utils.locks.make_lock(name): per-thread acquisition-order "
            "edges into the lock-order ledger, lock.<name>.held_ms "
            "histograms, and blocking-while-held flight events; "
            "check_inversions() audits the ledger and a cycle trips a "
            "postmortem (also: MULTIVERSO_LOCKWITNESS env var)")
# Shard-imbalance alerting (fed by the router's per-replica key rates).
define_double("fleet_imbalance_ratio", 1.7, "p99-to-mean per-replica "
              "key-rate ratio at/over which the router's "
              "fleet.shard_imbalance alert turns bad (1.0 = perfectly "
              "balanced)")
define_double("fleet_imbalance_min_keys", 100.0, "minimum fleet-wide "
              "keys/sec before the shard-imbalance rule may fire (an "
              "idle fleet's noise must not page)")
# Skew actuation: hot-key replication + vnode drain-and-handoff
# rebalancing (fleet/rebalance.py; docs/DESIGN.md "Skew actuation").
define_int("fleet_hotkey_replicas", 0, "EXTRA ring owners each confident "
           "hot key is replicated to (0 = off): the router nominates the "
           "Space-Saving top-K confident heavy hitters from the merged "
           "heartbeat sketches; writes fan out with freshness stamps and "
           "reads pick any replica whose step satisfies the HotRowCache "
           "staleness rule, falling back to the home owner")
define_bool("fleet_rebalance", False, "arm the router's vnode "
            "drain-and-handoff rebalancer: when fleet.shard_load_ratio "
            "stays at/over -fleet_rebalance_ratio for "
            "-fleet_rebalance_windows consecutive sweeps (a hot RANGE "
            "replication can't spread), ownership of the hottest "
            "member's busiest vnode arcs migrates to the coldest member "
            "via drain -> transfer -> announce; clients park-and-retry "
            "through the version flip exactly as through shard recovery")
define_double("fleet_rebalance_ratio", 1.5, "sustained p99-to-mean "
              "key-rate ratio at/over which the rebalancer acts (kept "
              "BELOW -fleet_imbalance_ratio so actuation starts before "
              "the alert pages)")
define_int("fleet_rebalance_windows", 3, "consecutive bad sweep windows "
           "before a migration (hysteresis: one noisy window never "
           "moves ownership)")
define_double("fleet_rebalance_cooldown_s", 10.0, "minimum seconds "
              "between vnode migrations (anti-flap, the supervisor's "
              "cooldown discipline)")
define_int("fleet_rebalance_vnodes", 4, "vnode arcs migrated per "
           "rebalance action (small steps: each migration moves "
           "~vnodes/(members*-fleet_vnodes) of the keyspace)")
# Advisor-driven hot-row cache auto-sizing (serving/cache.py).
define_int("serve_cache_mem_budget", 0, "cache autosizer byte budget "
           "(0 = autosizing off): the cache-headroom advisor's "
           "predicted_hit_rate_2x gauge grows -serve_cache_rows when "
           "doubling would pay and shrinks it when the marginal rows "
           "don't, never exceeding this many bytes of cached rows "
           "(hysteresis + cooldown so capacity never flaps)")
