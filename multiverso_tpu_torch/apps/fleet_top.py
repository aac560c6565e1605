"""fleet_top: live cluster-wide serving metrics — `top` for the fleet.

Port of ``multiverso_tpu/apps/fleet_top.py``: the same table, rendered
from the same rollup. Pulls the router's versioned ``Fleet_Stats``
rollup (built from the compact metric snapshots every replica heartbeat
already carries) and renders a refreshing per-replica table plus a fleet
summary row:
QPS, shed rate, queue depth, in-flight, stage-latency percentiles
(total leg), SLO burn, drain cycles, and health, per replica instead of
one aggregate histogram. Like every entry point of the port it starts
the runtime on the card unless ``-serve_device=cpu``.

    python -m multiverso_tpu_torch.apps.fleet_top -fleet_router=127.0.0.1:7071
    python -m multiverso_tpu_torch.apps.fleet_top -fleet_router=... \\
        -fleet_top_n=1            # one snapshot and exit (scripts, CI)
    python -m multiverso_tpu_torch.apps.fleet_top -fleet_router=... \\
        -fleet_top_exemplars=true # + slowest-request phase ledgers
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

from multiverso_tpu_torch.apps._runner import (fleet_config,
                                               pin_device_if_requested,
                                               run_app)
from multiverso_tpu_torch.utils.configure import (define_bool, define_double,
                                                  define_int, define_string,
                                                  get_flag)
from multiverso_tpu_torch.utils.log import check, log

define_double("fleet_top_interval", 1.0, "seconds between fleet_top "
              "stats refreshes")
define_int("fleet_top_n", 0, "number of refreshes before exiting "
           "(0 = run until interrupted)")
define_bool("fleet_top_exemplars", False, "append the fleet's merged "
            "tail-exemplar table (slowest requests with their phase "
            "ledgers) below the member table")

define_string("serve_device", "default", "default|cpu: the card unless "
              "-serve_device=cpu")

_CLEAR = "\x1b[2J\x1b[H"


def _fmt_ms(v: float) -> str:
    return f"{v:9.2f}"


def _fmt_rebal(hot: int, migrations: int) -> str:
    """Compact REBAL cell: '-' when the skew actuators are idle, else
    the replicated-hot-key count, with '/mN' while N migrations are in
    flight (the drain-and-handoff window)."""
    if not hot and not migrations:
        return "-"
    cell = str(int(hot))
    if migrations:
        cell += f"/m{int(migrations)}"
    return cell


def _fmt_alerts(alerts) -> str:
    """Compact ALERTS cell: '-' when quiet, else 'N:first_name' (the
    full list is in the Fleet_Stats JSON; the table names the loudest)."""
    alerts = alerts or []
    if not alerts:
        return "-"
    first = str(alerts[0].get("name", "?"))
    if len(first) > 12:
        first = first[:11] + "…"
    return f"{len(alerts)}:{first}"


def render_stats(stats: Dict, clear: bool = False) -> str:
    """The fleet table as one string (pure function — unit-testable and
    reused by the bench's --fleet-top embed)."""
    lines: List[str] = []
    if clear:
        lines.append(_CLEAR.rstrip("\n"))
    fleet = stats.get("fleet", {})
    replicas = stats.get("replicas", {})
    stamp = time.strftime("%H:%M:%S",
                          time.localtime(stats.get("time_unix", 0)))
    router_alerts = stats.get("router_alerts") or []
    # Fleet-wide data-plane load on the banner: total keys/sec, the
    # p99-to-mean shard-load ratio (1.0 = balanced), and the single
    # hottest key merged across replicas (traffic sketch).
    hot = fleet.get("hot_keys") or []
    hot_cell = f"  hot_key={hot[0][0]}" if hot else ""
    lines.append(f"fleet_top  v{stats.get('version', 0)}  {stamp}  "
                 f"replicas={fleet.get('replicas', 0)}  "
                 f"qps={fleet.get('qps', 0.0):.1f}  "
                 f"keys/s={fleet.get('keys_rate', 0.0):.0f}  "
                 f"shed={100 * fleet.get('shed_rate', 0.0):.2f}%  "
                 f"slo_burn={fleet.get('slo_violations', 0)}  "
                 f"alerts={fleet.get('alerts_active', 0)}{hot_cell}")
    header = (f"{'MEMBER':24s} {'HEALTH':>7s} {'QPS':>8s} {'SHED%':>7s} "
              f"{'QUEUE':>6s} {'INFL':>5s} {'P50ms':>9s} {'P95ms':>9s} "
              f"{'P99ms':>9s} {'SLO':>6s} {'DRAINS':>6s} {'STATE':>8s} "
              f"{'BOUND':>8s} {'SKEW%':>6s} {'REBAL':>6s} {'ALERTS':>15s}")
    lines.append(header)
    bounds: List[str] = []
    for mid in sorted(replicas):
        r = replicas[mid]
        total = r.get("stages", {}).get("total", {})
        state = "drain" if r.get("draining") else "up"
        # Roofline verdict: a JAX replica classifies its own serve plane
        # (dispatch/host/wire/device/idle) and ships the verdict in its
        # heartbeat; a port replica ships none yet ("-").
        bound = str((r.get("roofline") or {}).get("bound") or "-")
        if bound != "-":
            bounds.append(bound)
        lines.append(
            f"{mid[:24]:24s} {r.get('health', 0.0):7.3f} "
            f"{r.get('qps', 0.0):8.1f} "
            f"{100 * r.get('shed_rate', 0.0):7.2f} "
            f"{r.get('queue_depth', 0.0):6.0f} "
            f"{r.get('inflight', 0.0):5.0f} "
            f"{_fmt_ms(total.get('p50', 0.0))} "
            f"{_fmt_ms(total.get('p95', 0.0))} "
            f"{_fmt_ms(total.get('p99', 0.0))} "
            f"{r.get('slo_violations', 0):6d} "
            f"{r.get('drains_completed', 0):6d} {state:>8s} "
            f"{bound:>8s} "
            f"{100 * r.get('skew', 0.0):6.1f} "
            f"{_fmt_rebal(r.get('hot_replicated', 0), r.get('migrations', 0)):>6s} "
            f"{_fmt_alerts(r.get('alerts')):>15s}")
    ftotal = fleet.get("stages", {}).get("total", {})
    rebal = fleet.get("rebalance") or {}
    # The router's own alerts (heartbeat loss fires on the ROUTER — a
    # dead replica cannot report its own absence) render on the FLEET
    # row: they are fleet-scoped, not any one member's. The FLEET SKEW%
    # cell shows the shard-load ratio instead: xR.RR = the hottest
    # shard serves R times the mean (the imbalance alert's input).
    # FLEET BOUND cell: unanimous member verdict, else "mixed".
    fleet_bound = "-"
    if bounds:
        fleet_bound = bounds[0] if len(set(bounds)) == 1 else "mixed"
    lines.append(
        f"{'FLEET':24s} {'':7s} {fleet.get('qps', 0.0):8.1f} "
        f"{100 * fleet.get('shed_rate', 0.0):7.2f} "
        f"{fleet.get('queue_depth', 0.0):6.0f} "
        f"{fleet.get('inflight', 0.0):5.0f} "
        f"{_fmt_ms(ftotal.get('p50', 0.0))} "
        f"{_fmt_ms(ftotal.get('p95', 0.0))} "
        f"{_fmt_ms(ftotal.get('p99', 0.0))} "
        f"{fleet.get('slo_violations', 0):6d} "
        f"{'':6s} {'n=%d' % fleet.get('replicas', 0):>8s} "
        f"{fleet_bound:>8s} "
        f"{'x%.2f' % fleet.get('shard_load_ratio', 1.0):>6s} "
        f"{_fmt_rebal(fleet.get('hotkey_replicated', 0), rebal.get('migrations', 0)):>6s} "
        f"{_fmt_alerts(router_alerts):>15s}")
    return "\n".join(lines)


def render_exemplars(stats: Dict, n: int = 8) -> str:
    """The fleet's merged tail-exemplar table: slowest requests across
    all members with their phase ledgers (the heartbeat ships each
    member's slowest few; the router merges and re-sorts). Pure
    function, appended below the member table by -fleet_top_exemplars."""
    ex = (stats.get("fleet") or {}).get("exemplars") or []
    lines = [f"{'TRACE':34s} {'MEMBER':18s} {'TOTALms':>9s} "
             f"{'AGEs':>6s}  PHASES (ms)"]
    if not ex:
        lines.append("(no exemplars: reservoirs empty or "
                     "-telemetry_exemplars off)")
        return "\n".join(lines)
    for e in ex[:n]:
        phases = e.get("phases") or {}
        cells = " ".join(f"{k}={v:.2f}" for k, v in
                         sorted(phases.items(), key=lambda kv: -kv[1]))
        lines.append(
            f"{(e.get('trace') or '-')[:34]:34s} "
            f"{str(e.get('member', '-'))[:18]:18s} "
            f"{e.get('total_ms', 0.0):9.2f} "
            f"{e.get('age_s', 0.0):6.1f}  {cells}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    pin_device_if_requested(args, "serve_device")

    def _body(remaining) -> int:
        del remaining
        from multiverso_tpu_torch.fleet import fetch_fleet_stats
        cfg = fleet_config()
        check(cfg["router"] is not None,
              "-fleet_router=host:port is required for fleet_top")
        interval = max(0.1, float(get_flag("fleet_top_interval")))
        n = int(get_flag("fleet_top_n"))
        shown = 0
        try:
            while True:
                stats = fetch_fleet_stats(cfg["router"])
                # Clear only on live refresh: a single -fleet_top_n=1
                # snapshot must stay pipeable (CI greps it).
                out = render_stats(stats, clear=(n != 1))
                if get_flag("fleet_top_exemplars"):
                    out += "\n\n" + render_exemplars(stats)
                log.raw("%s", out)
                shown += 1
                if n and shown >= n:
                    return 0
                time.sleep(interval)
        except KeyboardInterrupt:
            return 0

    return run_app(_body, args)


if __name__ == "__main__":
    sys.exit(main())
