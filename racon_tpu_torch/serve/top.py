"""``top``: a live view of one daemon, or with ``--fleet`` of several
(JAX package: racon_tpu/serve/top.py).

One daemon: ``top --socket PATH`` follows the daemon's ``watch``
stream and renders each frame (queue, per-tenant waits, per-engine
device utilization with each engine's calibration drift, the result
cache, the serving latency percentiles), redrawn in place on a
terminal and appended as plain text otherwise.

The fleet: ``top --fleet S1,S2,...`` (or one router's socket: the
router, then the backends of its ``route_status``) polls each through the
fleet scrape (``serve/fleet.py``: ``FleetScraper``, ``merge_fleet``)
and renders a row per daemon (identity, state, queue; a dead or stale
one stays as a DOWN or STALE row), a router's backends and routing
counters under its row, and the fleet's latency table, whose
percentiles are those of the union of the daemons' observations
(``obs/aggregate.py``).

``--once --json`` prints one frame (the telemetry frame, or with
``--fleet`` the merged fleet document) as one JSON line and exits.

    python -m racon_tpu_torch.cli top (--socket PATH | --fleet S1,S2,...)
        [--interval S] [--count N] [--once] [--json]

Read-only: ``watch`` and ``metrics`` touch no queue or job.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from racon_tpu_torch.serve import client


def _fmt_s(v) -> str:
    v = float(v)
    if v >= 3600:
        return f"{v / 3600:.1f}h"
    if v >= 60:
        return f"{v / 60:.1f}m"
    if v >= 1:
        return f"{v:.1f}s"
    return f"{v * 1000:.0f}ms"


def render(doc: dict) -> str:
    """One telemetry frame -> the dashboard text (pure function; the
    tests golden it without a terminal)."""
    q = doc.get("queue", {})
    lines = []
    state = ("draining" if q.get("draining")
             else "paused" if q.get("paused") else "running")
    lines.append(
        f"racon-tpu-torch serve  pid {doc.get('pid')}  "
        f"up {_fmt_s(doc.get('uptime_s', 0))}  [{state}]")
    lines.append(
        f"queue  {q.get('queue_depth', 0)}/{q.get('max_queue', '?')} "
        f"queued  {len(q.get('running', []))}/{q.get('max_jobs', '?')} "
        f"running  {q.get('completed', 0)} done")

    # per-tenant breakdown: scheduler occupancy (queued/running) plus
    # the executor-side fused-queue wait percentiles the SLO
    # histograms record per tenant
    tenants = q.get("tenants") or {}
    slo = doc.get("slo") or {}
    if tenants:
        lines.append("")
        lines.append("tenant       queued  running  wait p50    "
                     "p90       p99")
        for name in sorted(tenants):
            row = tenants[name]
            s = slo.get(f"serve_tenant_wait_s.{name}") or {}
            if s.get("count"):
                waits = (f"{_fmt_s(s['p50']):<8s}  "
                         f"{_fmt_s(s['p90']):<8s}  "
                         f"{_fmt_s(s['p99']):<8s}")
            else:
                waits = "-"
            lines.append(
                f"{name:<12s} {row.get('queued', 0):>6d}  "
                f"{row.get('running', 0):>7d}  {waits}")

    du = doc.get("device_util") or {}
    # the calibration-health EWMA rides every telemetry frame
    # (doc["calhealth"]); engine names ARE calhealth stage names, so
    # the drift ratio (measured/predicted) lands next to each
    # engine's utilization — "!" marks a stage outside the band
    cal = (doc.get("calhealth") or {}).get("stages") or {}

    def _drift(stage: str) -> str:
        s = cal.get(stage) or {}
        if not s.get("n") or s.get("ewma") is None:
            return "-"
        return f"{s['ewma']:.2f}" + ("!" if s.get("drift") else "")

    if du:
        lines.append("")
        lines.append("engine       util  busy      idle      "
                     "dispatches  drift")
        for eng in sorted(du):
            e = du[eng]
            lines.append(
                f"{eng:<12s} {e['util'] * 100:4.0f}%  "
                f"{_fmt_s(e['busy_s']):<8s}  "
                f"{_fmt_s(e['idle_s']):<8s}  "
                f"{e['n_dispatches']!s:<10s}  "
                f"{_drift(eng)}")
        host = sorted(k for k in cal
                      if k.startswith("host.") and cal[k].get("n"))
        for stage in host:
            lines.append(f"{stage:<12s}    -  {'-':<8s}  {'-':<8s}  "
                         f"{'-':<10s}  {_drift(stage)}")

    # the result-cache line — hit ratio + resident bytes, so a warm
    # daemon's lookup-instead-of-dispatch win is visible at a glance
    ca = doc.get("cache") or {}
    if ca.get("enabled"):
        total = ca.get("hits", 0) + ca.get("misses", 0)
        lines.append("")
        lines.append(
            f"cache  hit {ca.get('hit_ratio', 0.0) * 100:.0f}% "
            f"({ca.get('hits', 0)}/{total})  "
            f"{ca.get('bytes', 0) / (1 << 20):.1f} MB resident  "
            f"{ca.get('entries', 0)} entries  "
            f"{ca.get('evicts', 0)} evicted")

    slo = doc.get("slo") or {}
    if slo:
        lines.append("")
        lines.append("slo                    count   p50       "
                     "p90       p99")
        for name in sorted(slo):
            s = slo[name]
            if not s.get("count"):
                continue
            lines.append(
                f"{name:<22s} {s['count']:>5d}   "
                f"{_fmt_s(s['p50']):<8s}  {_fmt_s(s['p90']):<8s}  "
                f"{_fmt_s(s['p99']):<8s}")
    return "\n".join(lines) + "\n"


def render_fleet(doc: dict) -> str:
    """One merged fleet document (serve/fleet.py
    ``merge_fleet``) -> the dashboard text (pure function; the tests
    golden it without a terminal)."""
    lines = [
        f"racon-tpu-torch fleet  {doc.get('fleet_size', 0)} daemon(s)  "
        f"{doc.get('alive', 0)} alive  {doc.get('stale', 0)} stale"]
    lines.append("")
    lines.append("daemon        pid      state     up        "
                 "queued  running  done")
    for d in doc.get("daemons", ()):
        ident = d.get("identity") or {}
        did = (ident.get("daemon_id") or d.get("target", "?"))[:12]
        pid = str(ident.get("pid") or "-")
        route = d.get("route")
        if not ident:
            state = "DOWN"       # never answered: no identity known
        elif d.get("stale"):
            state = "STALE"
        elif route:
            state = ("draining" if route.get("draining")
                     else "router")
        elif d.get("draining"):
            state = "draining"
        else:
            state = "up"
        up = (_fmt_s(d["uptime_s"])
              if d.get("uptime_s") is not None else "-")
        qd = d.get("queue_depth")
        done = d.get("completed")
        lines.append(
            f"{did:<12s}  {pid:<7s}  {state:<8s}  {up:<8s}  "
            f"{'-' if qd is None else qd!s:>6s}  "
            f"{d.get('running', 0)!s:>7s}  "
            f"{'-' if done is None else done!s:>4s}")
        if d.get("error") and state in ("DOWN", "STALE"):
            lines.append(f"              ! {d['error']}")
        if route and state not in ("DOWN", "STALE"):
            # one sub-row per fronted backend — breaker state
            # (CLOSED/OPEN/HALF-OPEN), consecutive failures, probe
            # staleness — plus the routing counters
            c = route.get("counters") or {}
            lines.append(
                f"              route: "
                f"{c.get('route_submit', 0)} placed, "
                f"{c.get('route_spillover', 0)} spilled, "
                f"{c.get('route_failover', 0)} failed over, "
                f"{route.get('in_flight', 0)} in flight")
            for b in route.get("backends", ()):
                age = b.get("probe_age_s")
                probe = "never" if age is None else f"{age:.1f}s"
                if b.get("stale"):
                    probe += " STALE"
                flags = " draining" if b.get("draining") else ""
                lines.append(
                    f"              -> {b.get('target', '?')}  "
                    f"{b.get('breaker')}"
                    f"  fails {b.get('failures', 0)}"
                    f"  probe {probe}{flags}")

    slo = doc.get("slo") or {}
    if slo:
        lines.append("")
        lines.append("fleet slo              count   p50       "
                     "p90       p99")
        for name in sorted(slo):
            s = slo[name]
            if not s.get("count"):
                continue
            lines.append(
                f"{name:<22s} {s['count']:>5d}   "
                f"{_fmt_s(s['p50']):<8s}  {_fmt_s(s['p90']):<8s}  "
                f"{_fmt_s(s['p99']):<8s}")

    # fleet-wide cache effectiveness — the hit/miss counters sum
    # EXACTLY across daemons (obs/aggregate.py), so the
    # merged ratio is the true fleet ratio, not a mean of ratios;
    # bytes-resident stays per-daemon (a gauge sum means little, but
    # the per_source map keeps attribution)
    merged = (doc.get("merged") or {})
    mc = merged.get("counters") or {}
    hits, misses = mc.get("cache_hit", 0), mc.get("cache_miss", 0)
    if hits or misses:
        ratio = hits / (hits + misses)
        mb = ((merged.get("gauges") or {}).get("cache_bytes")
              or {}).get("sum", 0) / (1 << 20)
        lines.append("")
        lines.append(
            f"fleet cache  hit {ratio * 100:.0f}% "
            f"({hits}/{hits + misses})  {mb:.1f} MB resident  "
            f"{mc.get('cache_fill', 0)} fills  "
            f"{mc.get('cache_evict', 0)} evicted")

    # fleet-wide calibration health from the exactly-merged
    # snapshot union (serve/fleet.py merge_fleet)
    cal = (doc.get("calhealth") or {}).get("stages") or {}
    rows = {k: v for k, v in cal.items() if v.get("n")}
    if rows:
        lines.append("")
        lines.append("fleet drift            n      ewma     p50     "
                     " p99")
        for name in sorted(rows):
            s = rows[name]
            ew = s.get("ewma")
            lines.append(
                f"{name:<22s} {s['n']:>4d}   "
                f"{'-' if ew is None else format(ew, '6.2f'):>6s}  "
                f"{s.get('p50', 0.0):>6.2f}  {s.get('p99', 0.0):>6.2f}"
                + ("   DRIFT" if s.get("drift") else ""))
    return "\n".join(lines) + "\n"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon-tpu-torch top",
        description="Live status view of one racon-tpu-torch serve daemon "
        "(watch stream) or a fleet of them (scrape tier).")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--socket",
                   help="unix-domain socket of the server to watch")
    g.add_argument("--fleet", metavar="SOCK1,SOCK2,...",
                   help="comma-separated daemon sockets, or a single "
                   "router socket (the router and the backends of its "
                   "route_status); renders per-daemon rows + the "
                   "merged fleet SLO table")
    p.add_argument("--interval", type=float, default=1.0,
                   help="refresh period in seconds (default 1.0)")
    p.add_argument("--count", type=int, default=0,
                   help="exit after N frames (default 0 = forever)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (implies --count 1)")
    p.add_argument("--json", action="store_true",
                   help="print raw frames as JSON lines instead of "
                   "the dashboard")
    return p


def fleet_targets(fleet_arg: str) -> list:
    """The daemons ``--fleet`` names: a comma-separated list as given;
    one router, itself first and then the backends it fronts (so that
    its ``route`` block renders as router rows); one plain daemon,
    itself."""
    from racon_tpu_torch.serve import fleet

    targets = fleet.resolve_fleet_targets(fleet_arg)
    given = [t for t in fleet_arg.split(",") if t]
    if len(given) == 1 and targets != given:
        return given + [t for t in targets if t != given[0]]
    return targets


def _main_fleet(args, count: int) -> int:
    from racon_tpu_torch.serve import fleet

    scraper = fleet.FleetScraper(fleet_targets(args.fleet))
    live = sys.stdout.isatty() and not args.json and count != 1
    sent = 0
    try:
        while True:
            scraper.scrape_once()
            doc = fleet.merge_fleet(scraper.results())
            if args.json:
                print(json.dumps(doc, separators=(",", ":")),
                      flush=True)
            else:
                if live:
                    sys.stdout.write("\x1b[H\x1b[J")
                sys.stdout.write(render_fleet(doc))
                sys.stdout.flush()
            sent += 1
            if count and sent >= count:
                return 0 if doc.get("ok") else 1
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    count = 1 if args.once else args.count
    if args.fleet:
        return _main_fleet(args, count)
    live = sys.stdout.isatty() and not args.json and count != 1
    try:
        for doc in client.watch(args.socket,
                                interval_s=args.interval,
                                count=count):
            if args.json:
                print(json.dumps(doc, separators=(",", ":")),
                      flush=True)
            else:
                if live:
                    # home + clear-below: redraw in place without
                    # the full-screen alternate buffer
                    sys.stdout.write("\x1b[H\x1b[J")
                sys.stdout.write(render(doc))
                sys.stdout.flush()
    except client.ServeError as exc:
        print(f"[racon_tpu_torch::top] error: {exc}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
