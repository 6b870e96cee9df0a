"""``inspect``: one job's timeline, from a live daemon, a flight dump
or the fleet (JAX package: racon_tpu/serve/inspect.py).

The forensic record has three forms: the flight ring (live, through
the ``flight`` op), the flight dump (a JSON file written on drain, idle
exit or crash, or by ``RACON_TPU_TORCH_FLIGHT_DUMP``) and the per-job
trace slice.  This subcommand reads all of them: given a job id it
renders the job's life as one relative-time line per event::

    job 17 (tenantA) — 6 flight event(s)
      +    0.000s  admit           priority=0 predicted_wall=4.1s queue_depth=1
      +    0.012s  start           queue wait 0.012s
      +    0.640s  fused_dispatch  poa units=2 items=96 occupancy=0.75 tenants=tenantA,tenantB
      ...
      +    2.310s  done            ok exec_wall=2.298s

Without ``--job`` it sums up every job the source knows.

Sources:

* ``--socket PATH``: a running daemon's ``flight`` op (with ``--job``,
  the bounded per-job trace slice rides along);
* ``--dump FILE``: a flight dump (schema ``racon-tpu-torch-flight-v1``,
  ``racon_tpu_torch/obs/flight.py``);
* ``--fleet ADDR --job-key K``: the fleet's record of one job
  (``racon_tpu_torch/obs/assemble.py``): flight events, journal records
  and trace slices from the router and every backend it names, the
  lineage (shards, replacements, failovers, dedup joins, gather
  winners) and a timeline across daemons, corrected by each daemon's
  clock offset.  ``--trace-out`` also writes the merged Perfetto trace;
  ``--json`` prints the ``racon-tpu-torch-lineage-v1`` document.  The
  exit status is 0 when the lineage is complete, 1 when it is not.

    python -m racon_tpu_torch.cli inspect (--socket PATH | --dump FILE |
        --fleet ADDR) [--job N] [--job-key K] [--trace-id T]
        [--trace-out FILE] [--last N] [--timeout S] [--json]

Read-only: no op used here touches a queue or a job.
"""

from __future__ import annotations

import argparse
import json
import sys


def job_events(events, job: int) -> list:
    """Events belonging to ``job`` — tagged directly or via a fused
    dispatch's ``jobs`` list — in (time, seq) order."""
    job = int(job)
    sel = [ev for ev in events
           if ev.get("job") == job or job in ev.get("jobs", ())]
    sel.sort(key=lambda ev: (ev.get("t", 0.0), ev.get("seq", 0)))
    return sel


def _detail(ev: dict) -> str:
    kind = ev.get("kind", "?")
    if kind == "submit":
        return f"tenant={ev.get('tenant', 'default')}"
    if kind == "admit":
        parts = [f"priority={ev.get('priority', 0)}"]
        if "predicted_wall_s" in ev:
            parts.append(f"predicted_wall={ev['predicted_wall_s']}s")
        if "shared_wall_s" in ev:
            parts.append(f"shared_wall={ev['shared_wall_s']}s")
        if "queue_depth" in ev:
            parts.append(f"queue_depth={ev['queue_depth']}")
        return " ".join(parts)
    if kind == "reject":
        return f"code={ev.get('code')}"
    if kind == "start":
        if "queue_wait_s" in ev:
            return f"queue wait {ev['queue_wait_s']}s"
        return ""
    if kind == "fused_dispatch":
        return (f"{ev.get('unit_kind', '?')} "
                f"units={ev.get('units', '?')} "
                f"items={ev.get('items', '?')} "
                f"occupancy={ev.get('occupancy', '?')} "
                f"tenants={','.join(ev.get('tenants', []))}")
    if kind == "cache_hit":
        return (f"{ev.get('unit_kind', '?')} "
                f"hits={ev.get('hits', '?')}/{ev.get('items', '?')} "
                f"misses={ev.get('misses', '?')}")
    if kind == "unit_retry":
        return (f"{ev.get('unit_kind', '?')} "
                f"tenant={ev.get('tenant', 'default')} "
                f"items={ev.get('items', '?')} "
                f"error={ev.get('error', '?')}")
    if kind in ("error", "crash"):
        err = str(ev.get("error", "")).splitlines()
        return err[0] if err else ""
    if kind == "done":
        ok = "ok" if ev.get("ok") else "FAILED"
        return f"{ok} exec_wall={ev.get('exec_wall_s', '?')}s"
    if kind == "drain":
        return (f"queued={ev.get('queued', 0)} "
                f"running={ev.get('running', 0)}")
    if kind == "checkpoint":
        return f"windows={ev.get('n_windows', '?')}"
    if kind == "dedup":
        return (f"job_key={ev.get('job_key', '?')} "
                + ("answered from record" if ev.get("recorded")
                   else "joined live job"))
    if kind == "recover":
        return (f"job_key={ev.get('job_key', '?')} "
                f"checkpoint_windows="
                f"{ev.get('checkpoint_windows', 0)} "
                f"from={ev.get('recovered_from', '?')}")
    if kind == "recovery":
        return (f"records={ev.get('records', 0)} "
                f"completed={ev.get('completed', 0)} "
                f"requeued={ev.get('requeued', 0)} "
                f"failed={ev.get('failed', 0)}")
    # straggler replacement: the router's handoff, the daemon's cancel
    # acknowledgement, and the yielding job's terminal event
    if kind == "route_rebalance":
        return (f"shard={ev.get('shard', '?')} "
                f"r{ev.get('attempt', '?')} -> "
                f"{ev.get('backend', '?')} "
                f"elapsed={ev.get('elapsed_s', '?')}s "
                f"threshold={ev.get('threshold_s', '?')}s")
    if kind == "route_stage_plan":
        staged = ev.get("staged_bytes") or []
        return (f"shards={ev.get('shards', '?')} "
                f"staged_bytes={'/'.join(str(b) for b in staged)} "
                f"of {ev.get('total_bytes', '?')}")
    if kind == "cancel":
        return (f"job_key={ev.get('job_key', '?')} "
                f"state={ev.get('state', '?')}")
    if kind == "job_canceled":
        return "yielded to a rebalanced attempt"
    return ""


def render_timeline(events, job: int, trace_events=None) -> str:
    """Pure renderer (tests golden it): one relative-time line per
    flight event, then a short trace-slice appendix when present."""
    sel = job_events(events, job)
    if not sel:
        return (f"job {job}: no events in this source (evicted from "
                f"the ring, or never seen here)\n")
    tenant = next((ev["tenant"] for ev in sel if "tenant" in ev),
                  "default")
    # the job's trace id (possibly the caller's, from the wire) rides
    # the header, so timelines from different daemons line up by eye
    trace = next((ev["trace_id"] for ev in sel
                  if ev.get("trace_id")), None)
    who = f"{tenant}, trace {trace}" if trace else tenant
    t0 = sel[0].get("t", 0.0)
    lines = [f"job {job} ({who}) — {len(sel)} flight event(s)"]
    for ev in sel:
        dt = ev.get("t", t0) - t0
        lines.append(f"  +{dt:9.3f}s  {ev.get('kind', '?'):<15s} "
                     f"{_detail(ev)}".rstrip())
    if trace_events:
        lines.append(f"trace slice — {len(trace_events)} event(s)")
        shown = 0
        for ev in trace_events:
            if ev.get("ph") not in ("X", "i"):
                continue
            ts = ev.get("ts", 0.0) / 1e6 - t0
            dur = ev.get("dur")
            tail = f" dur={dur / 1e6:.3f}s" if dur is not None else ""
            lines.append(f"  +{ts:9.3f}s  {ev.get('name')}{tail}")
            shown += 1
            if shown >= 40:
                lines.append(f"  ... ({len(trace_events) - shown} "
                             f"more)")
                break
    return "\n".join(lines) + "\n"


def render_summary(events, header: str = "") -> str:
    """No ``--job``: one row per job seen in the source, plus the
    non-job markers (drain/crash) that frame them."""
    jobs: dict = {}
    markers = []
    for ev in events:
        ids = [ev["job"]] if "job" in ev else list(ev.get("jobs", ()))
        if not ids and ev.get("kind") in ("drain", "crash", "run",
                                          "run_done"):
            markers.append(ev)
        for j in ids:
            row = jobs.setdefault(j, {"tenant": None, "kinds": [],
                                      "t0": ev.get("t", 0.0)})
            if row["tenant"] is None and ev.get("tenant"):
                row["tenant"] = ev["tenant"]
            row["kinds"].append(ev.get("kind", "?"))
    lines = [header] if header else []
    if not jobs and not markers:
        lines.append("no events recorded")
        return "\n".join(lines) + "\n"
    for j in sorted(jobs):
        row = jobs[j]
        kinds = ",".join(row["kinds"])
        lines.append(f"job {j:<5d} tenant={row['tenant'] or '-':<12s} "
                     f"events: {kinds}")
    for ev in markers:
        lines.append(f"[{ev.get('kind')}] {_detail(ev)}".rstrip())
    return "\n".join(lines) + "\n"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon-tpu-torch inspect",
        description="Render a served job's timeline (queue wait, "
        "exec, fused dispatches with occupancy) from a live daemon's "
        "flight recorder or a flight dump file.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--socket",
                     help="unix-domain socket of a live daemon")
    src.add_argument("--dump",
                     help="flight dump JSON written on "
                     "drain/idle/crash")
    src.add_argument("--fleet", metavar="ADDR",
                     help="router (or daemon) address for fleet "
                     "forensics: lineage DAG + clock-aligned "
                     "cross-daemon timeline (needs --job-key or "
                     "--trace-id)")
    p.add_argument("--job", type=int, default=None,
                   help="job id to render (omit for a per-job "
                   "summary of the whole source)")
    p.add_argument("--job-key", default=None,
                   help="with --fleet: the job's idempotence key "
                   "(lineage covers its derived shard/rebalance "
                   "keys)")
    p.add_argument("--trace-id", default=None,
                   help="with --fleet: wire trace id to assemble "
                   "instead of a job key")
    p.add_argument("--trace-out", metavar="FILE", default=None,
                   help="with --fleet: also write the merged "
                   "Perfetto-loadable trace document here")
    p.add_argument("--last", type=int, default=0,
                   help="with --socket and no --job: only the newest "
                   "N events")
    p.add_argument("--timeout", type=float, default=None,
                   help="with --fleet: per-target timeout in seconds "
                   "(default RACON_TPU_TORCH_FLEET_TIMEOUT_S)")
    p.add_argument("--json", action="store_true",
                   help="print the raw event document instead of the "
                   "rendered timeline (with --fleet: the "
                   "racon-tpu-torch-lineage-v1 document)")
    return p


def main_fleet(args) -> int:
    """The ``--fleet`` path: collect, build the lineage DAG, render.
    Exit status reflects lineage completeness (0 complete, 1 not) so
    scripts can gate on it."""
    from racon_tpu_torch.obs import assemble
    if not args.job_key and not args.trace_id:
        print("[racon_tpu_torch::inspect] --fleet needs --job-key or "
              "--trace-id", file=sys.stderr)
        return 2
    try:
        collection, lineage = assemble.assemble(
            args.fleet, job_key=args.job_key,
            trace_id=args.trace_id, timeout=args.timeout)
    except Exception as exc:
        print(f"[racon_tpu_torch::inspect] error: {exc}", file=sys.stderr)
        return 1
    if args.trace_out:
        doc = assemble.merged_trace_doc(lineage, collection)
        with open(args.trace_out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        print(f"[racon_tpu_torch::inspect] merged trace -> "
              f"{args.trace_out} ({len(doc['traceEvents'])} "
              f"event(s))", file=sys.stderr)
    if args.json:
        json.dump(lineage, sys.stdout, indent=1)
        print()
    else:
        sys.stdout.write(
            assemble.render_fleet_timeline(lineage, collection))
    return 0 if lineage.get("complete") else 1


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.fleet:
        return main_fleet(args)
    if args.socket:
        from racon_tpu_torch.serve import client
        try:
            doc = client.flight(args.socket, job=args.job,
                                last=args.last,
                                job_key=args.job_key,
                                trace_id=args.trace_id)
        except client.ServeError as exc:
            print(f"[racon_tpu_torch::inspect] error: {exc}",
                  file=sys.stderr)
            return 1
        if not doc.get("ok"):
            print(f"[racon_tpu_torch::inspect] error: "
                  f"{doc.get('error')}", file=sys.stderr)
            return 1
        events = doc.get("events", [])
        trace_events = doc.get("job_trace")
        ring = doc.get("ring", {})
        header = (f"flight ring @ pid {doc.get('pid')}: "
                  f"{ring.get('size', 0)}/{ring.get('capacity', 0)} "
                  f"event(s), {ring.get('dropped', 0)} dropped")
    else:
        from racon_tpu_torch.obs import flight as obs_flight
        try:
            doc = obs_flight.load_dump(args.dump)
        except (OSError, ValueError) as exc:
            print(f"[racon_tpu_torch::inspect] error: {exc}",
                  file=sys.stderr)
            return 1
        events = doc.get("events", [])
        trace_events = None
        ring = doc.get("ring", {})
        header = (f"flight dump {args.dump} (pid {doc.get('pid')}, "
                  f"reason {doc.get('reason')!r}): "
                  f"{len(events)} event(s), "
                  f"{ring.get('dropped', 0)} dropped")
    if args.json:
        json.dump(doc, sys.stdout, indent=1)
        print()
        return 0
    print(header)
    if args.job is not None:
        sys.stdout.write(render_timeline(events, args.job,
                                         trace_events=trace_events))
    else:
        sys.stdout.write(render_summary(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
