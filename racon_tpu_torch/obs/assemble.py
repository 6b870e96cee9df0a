"""The fleet's read side: one job's lineage across daemons (JAX
package: racon_tpu/obs/assemble.py).

A routed or scattered job runs on several processes: the router places
it, shards it into derived keys, fails a shard over when its backend
dies, replaces a straggler, and each backend journals what it ran.
This module reads them back together.  Given a job key (or a trace id)
and a router's (or a daemon's) address, it

* **collects**, one bounded thread per target (the fleet scrape's
  shape, ``serve/fleet.py``), each daemon's flight events (the
  ``flight`` op's key and trace filters), journal records (the bounded
  ``journal_query`` op) and captured trace slices (``trace_query``),
  with the health block's capture depths and clock anchors;
* **estimates each daemon's clock offset** from three health probes:
  for the one of least round trip, ``offset = server_wall_t - (t0 +
  t1) / 2`` with confidence ``(t1 - t0) / 2``.  Offsets feed the
  renderers only;
* **rebuilds the lineage**: submit, scatter, shard keys, replacement
  attempts, failovers, dedup joins, cache hits, gather, from the
  derived-key grammar ``<key>-shard-<i>of<k>[-r<n>]`` and the trace id
  the router threads through every sub-submit;
* **renders** a text timeline with a lane per daemon and each lane's
  offset (``inspect --fleet``), a merged Perfetto trace with flow
  events from the router's ``route`` decisions to the backends'
  ``admit`` (``--trace-out``), and the ``racon-tpu-torch-lineage-v1``
  document (``--json``).

``build_lineage`` and both renderers are pure functions of the collected
document, so tests skew a daemon's anchors and hold the order of events
without a live fleet.  Nothing here writes to a daemon.
"""

from __future__ import annotations

import re
import zlib

from racon_tpu_torch.obs import trace as obs_trace

SCHEMA = "racon-tpu-torch-lineage-v1"
COLLECT_SCHEMA = "racon-tpu-torch-fleet-collect-v1"

#: the scatter's derived-key grammar: ``<base>-shard-<i>of<k>`` for the
#: original attempt, ``...-r<n>`` for the n-th rebalance replacement
DERIVED_KEY_RE = re.compile(
    r"^(?P<base>.+)-shard-(?P<i>\d+)of(?P<k>\d+)(?:-r(?P<n>\d+))?$")

#: clock-offset probes per target; the min-RTT pair wins
_OFFSET_PROBES = 3
#: per-daemon collection bounds (the wire ops enforce their own caps;
#: these keep the collector's asks modest)
_MAX_JOURNAL_RECORDS = 512
_MAX_TRACE_EVENTS = 2048
_MAX_TRACE_JOBS = 8


def parse_key(key):
    """Derived-key grammar walk: ``None`` for a root key, else
    ``{"base", "shard", "count", "attempt"}`` (attempt 0 = the
    original shard attempt, n = the n-th rebalance)."""
    if not isinstance(key, str):
        return None
    m = DERIVED_KEY_RE.match(key)
    if not m:
        return None
    return {"base": m.group("base"), "shard": int(m.group("i")),
            "count": int(m.group("k")),
            "attempt": int(m.group("n") or 0)}


# ---------------------------------------------------------------------------
# collection (the only part that talks to sockets)
# ---------------------------------------------------------------------------


def estimate_clock_offset(target: str, timeout: float = None,
                          probes: int = _OFFSET_PROBES):
    """Midpoint clock-offset estimate against one daemon.

    Sends ``probes`` health frames, wall-stamping send and receive on
    the collector's clock; the probe with the smallest round trip
    yields ``offset = server_wall_t - (t0 + t1) / 2`` (positive =
    the daemon's clock runs ahead of the collector's) with confidence
    half the round trip — the asymmetric-path error bound.  Returns
    ``(offset_s, confidence_s, rtt_s, health_doc)``; all-None offset
    fields when the target answered no anchors and
    raises nothing — transport errors propagate from the caller's
    own collection attempt instead."""
    from racon_tpu_torch.serve import client

    best = None
    doc = None
    for _ in range(max(1, probes)):
        t0 = obs_trace.wall_now()
        d = client.request(target, {"op": "health"}, timeout=timeout)
        t1 = obs_trace.wall_now()
        doc = d
        wall = d.get("wall_t")
        if not isinstance(wall, (int, float)):
            continue
        rtt = max(0.0, t1 - t0)
        if best is None or rtt < best[2]:
            best = (wall - (t0 + t1) / 2.0, rtt / 2.0, rtt)
    if best is None:
        return None, None, None, doc
    return round(best[0], 6), round(best[1], 6), \
        round(best[2], 6), doc


def _collect_target(target: str, job_key, trace_id,
                    timeout) -> dict:
    """One daemon's forensic contribution (runs on its own thread).
    Degrades, never throws: an unreachable daemon becomes an
    ``ok: False`` row that ``build_lineage`` treats as a lost-capture
    warning, exactly like a SIGKILL'd backend."""
    from racon_tpu_torch.serve import client

    row = {"target": target, "ok": False, "error": None,
           "router": False, "pid": None, "identity": None,
           "clock_offset_s": None, "offset_confidence_s": None,
           "probe_rtt_s": None, "wall_t": None,
           "trace_epoch_wall": None, "capture": None,
           "flight_events": [], "journal": None,
           "trace_slices": {}}
    try:
        off, conf, rtt, health = estimate_clock_offset(
            target, timeout=timeout)
        row.update(clock_offset_s=off, offset_confidence_s=conf,
                   probe_rtt_s=rtt,
                   router=bool(health.get("router")),
                   pid=health.get("pid"),
                   identity=health.get("identity"),
                   wall_t=health.get("wall_t"),
                   trace_epoch_wall=health.get("trace_epoch_wall"),
                   capture=health.get("capture"))
        fdoc = client.flight(target, job_key=job_key,
                             trace_id=trace_id, timeout=timeout)
        if fdoc.get("ok"):
            row["flight_events"] = fdoc.get("events") or []
        jdoc = client.journal_query(
            target, job_key=job_key,
            job_key_prefix=(None if job_key else trace_id),
            max_records=_MAX_JOURNAL_RECORDS, timeout=timeout)
        if jdoc.get("ok"):
            row["journal"] = {
                "enabled": bool(jdoc.get("enabled")),
                "records": jdoc.get("records") or [],
                "complete": jdoc.get("complete", True),
                "scan_truncated": bool(jdoc.get("scan_truncated")),
            }
        # the daemon-local job ids this key family touched — each has
        # a bounded captured trace slice worth pulling
        jobs = []
        for ev in row["flight_events"]:
            for j in ([ev["job"]] if "job" in ev else []) \
                    + list(ev.get("jobs", ())):
                if j not in jobs:
                    jobs.append(j)
        for j in jobs[:_MAX_TRACE_JOBS]:
            try:
                tdoc = client.trace_query(
                    target, j, max_events=_MAX_TRACE_EVENTS,
                    timeout=timeout)
            except client.ServeError:
                continue
            if tdoc.get("ok") and tdoc.get("events"):
                row["trace_slices"][str(j)] = tdoc["events"]
        row["ok"] = True
    except Exception as exc:
        row["error"] = f"{type(exc).__name__}: {exc}"
    return row


def collect_fleet(address: str, job_key: str = None,
                  trace_id: str = None,
                  timeout: float = None) -> dict:
    """Collect the fleet's forensic record for one job key / trace
    id: the fronting address (router or plain daemon) plus every
    backend it discloses (``resolve_fleet_targets``), scraped
    concurrently.  Returns the ``racon-tpu-torch-fleet-collect-v1``
    document that ``build_lineage`` and the renderers consume."""
    from racon_tpu_torch.serve import fleet as serve_fleet

    if timeout is None:
        timeout = serve_fleet.fleet_timeout_s()
    backends = serve_fleet.resolve_fleet_targets(address,
                                                timeout=timeout)
    targets = [address] + [t for t in backends if t != address]
    rows = serve_fleet.scrape_concurrently(
        targets,
        lambda t: _collect_target(t, job_key, trace_id, timeout),
        timeout_s=timeout)
    rows = [r if r is not None
            else {"target": t, "ok": False, "router": False,
                  "error": "collection timed out",
                  "flight_events": [], "journal": None,
                  "trace_slices": {}, "capture": None,
                  "pid": None, "identity": None,
                  "clock_offset_s": None,
                  "offset_confidence_s": None, "probe_rtt_s": None,
                  "wall_t": None, "trace_epoch_wall": None}
            for r, t in zip(rows, targets)]
    return {"schema": COLLECT_SCHEMA, "address": address,
            "job_key": job_key, "trace_id": trace_id,
            "daemons": rows}


# ---------------------------------------------------------------------------
# clock alignment (pure; rendering only)
# ---------------------------------------------------------------------------


def aligned_wall(daemon: dict, t: float, wall: bool = False):
    """A daemon-local timestamp on the COLLECTOR's wall clock:
    flight/trace timestamps (seconds since the daemon's trace epoch)
    are lifted through its ``trace_epoch_wall`` anchor, journal
    timestamps (``wall=True``) are already wall-clock; both then have
    the estimated daemon-vs-collector offset subtracted.  Returns
    None when the needed anchor is missing."""
    if t is None:
        return None
    if not wall:
        epoch = daemon.get("trace_epoch_wall")
        if not isinstance(epoch, (int, float)):
            return None
        t = epoch + t
    off = daemon.get("clock_offset_s") or 0.0
    return t - off


# ---------------------------------------------------------------------------
# lineage DAG (pure)
# ---------------------------------------------------------------------------


def _root_key(collection: dict):
    """The lineage root: the asked-for job_key, else the common base
    of the derived keys (or the bare key) the records mention."""
    if collection.get("job_key"):
        return collection["job_key"]
    bases, bare = [], []
    for d in collection.get("daemons", ()):
        for ev in d.get("flight_events", ()):
            for f in ("job_key", "key"):
                k = ev.get(f)
                p = parse_key(k)
                if p:
                    bases.append(p["base"])
                elif isinstance(k, str):
                    bare.append(k)
    for k in bases + bare:
        return k
    return None


def _iter_records(collection: dict):
    """Every (daemon, source, record) triple: flight events and
    journal records, uniformly shaped enough to walk for keys."""
    for d in collection.get("daemons", ()):
        for ev in d.get("flight_events", ()):
            yield d, "flight", ev
        j = d.get("journal") or {}
        for rec in j.get("records", ()):
            yield d, "journal", rec


def build_lineage(collection: dict) -> dict:
    """The ``racon-tpu-torch-lineage-v1`` document: nodes (root + every
    derived attempt key), typed edges (shard / rebalance / failover /
    dedup / cache_hit / gather), per-shard winners, and completeness
    — every key any daemon's record mentions must resolve to a node,
    and a sharded job must show exactly one winning attempt per
    shard.  Pure function of the collected doc; clock offsets are
    carried for renderers but decide nothing here."""
    root = _root_key(collection)
    trace_id = collection.get("trace_id")
    nodes: dict = {}
    edges: list = []
    warnings: list = []
    shard_count = None

    def node(key, kind="attempt"):
        n = nodes.get(key)
        if n is None:
            p = parse_key(key)
            n = nodes[key] = {
                "key": key, "kind": "root" if key == root else kind,
                "shard": p["shard"] if p else None,
                "count": p["count"] if p else None,
                "attempt": p["attempt"] if p else None,
                "backends": [], "events": 0, "sources": [],
                "winner": False, "ok": None}
        return n

    def edge(kind, src, dst, **fields):
        e = {"kind": kind, "from": src, "to": dst}
        e.update({k: v for k, v in fields.items() if v is not None})
        if e not in edges:
            edges.append(e)

    if root is not None:
        node(root)

    # -- walk every record once, growing nodes/edges ------------------
    winner_keys: list = []
    for d, source, rec in _iter_records(collection):
        kind = rec.get("kind")
        keys = [k for k in (rec.get("job_key"), rec.get("key"))
                if isinstance(k, str)]
        for k in list(rec.get("keys") or ()) \
                + list(rec.get("winner_keys") or ()) \
                + list(rec.get("superseded") or ()):
            if isinstance(k, str):
                keys.append(k)
        seen_here = set()
        for k in keys:
            if k in seen_here:
                continue
            seen_here.add(k)
            p = parse_key(k)
            if p is not None and root is not None \
                    and p["base"] != root:
                continue     # another job's family sharing the ring
            if p is None and root is not None and k != root:
                continue
            n = node(k)
            n["events"] += 1
            if source not in n["sources"]:
                n["sources"].append(source)
            b = rec.get("backend") or rec.get("routed_backend")
            if b and b not in n["backends"]:
                n["backends"].append(b)
            if source == "flight" and not d.get("router") \
                    and d["target"] not in n["backends"] \
                    and kind in ("admit", "start", "done", "dedup"):
                n["backends"].append(d["target"])
        # typed edges per record kind
        if kind == "route_scatter":
            shard_count = rec.get("shards") or shard_count
            for k in rec.get("keys") or ():
                if parse_key(k):
                    edge("shard", root, k)
        elif kind == "route_rebalance":
            k = rec.get("key")
            p = parse_key(k)
            if p:
                shard_count = p["count"]
                prev = (p["base"]
                        + f"-shard-{p['shard']}of{p['count']}")
                if p["attempt"] > 1:
                    prev += f"-r{p['attempt'] - 1}"
                edge("rebalance", prev, k,
                     backend=rec.get("backend"),
                     elapsed_s=rec.get("elapsed_s"),
                     threshold_s=rec.get("threshold_s"))
        elif kind == "route_failover":
            k = rec.get("job_key")
            edge("failover", k, k, backend_lost=rec.get("backend"),
                 error=rec.get("error"))
        elif kind in ("dedup", "route_dedup"):
            k = rec.get("job_key")
            edge("dedup", k, k,
                 joined=rec.get("joined")
                 or ("recorded" if rec.get("recorded") else "live"))
        elif kind == "cache_hit":
            # backend-local result-cache hits ride the job context;
            # attribute them to the daemon's attempt keys
            for k in keys:
                edge("cache_hit", k, k,
                     hits=rec.get("hits"), unit=rec.get("unit_kind"))
        elif kind == "route_gather":
            for k in rec.get("winner_keys") or ():
                if isinstance(k, str) and k not in winner_keys:
                    winner_keys.append(k)
                edge("gather", k, root,
                     wall_s=rec.get("wall_s"))
        elif kind == "route_scatter_shard" and rec.get("winner"):
            k = rec.get("key")
            if isinstance(k, str) and k not in winner_keys:
                winner_keys.append(k)
        elif kind == "done" and source == "journal" \
                and (rec.get("result") or {}).get("ok"):
            k = rec.get("job_key")
            n = nodes.get(k)
            if n is not None:
                n["ok"] = True

    # shard edges can also be implied by keys alone (ring rolled over
    # the route_scatter event but the attempts are still on record)
    for k, n in list(nodes.items()):
        if n["kind"] == "attempt" and n["shard"] is not None:
            shard_count = shard_count or n["count"]
            if n["attempt"] == 0:
                edge("shard", root, k)

    for k in winner_keys:
        n = nodes.get(k)
        if n is not None:
            n["winner"] = True
            n["ok"] = True if n["ok"] is None else n["ok"]

    # -- completeness --------------------------------------------------
    shards: dict = {}
    for n in nodes.values():
        if n["shard"] is not None:
            shards.setdefault(n["shard"], []).append(n)
    missing_shards = []
    bad_winner_shards = []
    if shard_count:
        for i in range(shard_count):
            atts = shards.get(i)
            if not atts:
                missing_shards.append(i)
                continue
            won = [a for a in atts if a["winner"]]
            if len(won) != 1:
                bad_winner_shards.append(i)
    for d in collection.get("daemons", ()):
        if not d.get("ok"):
            warnings.append(
                f"{d['target']}: unreachable during collection "
                f"({d.get('error')}) — its local capture is lost; "
                f"lineage relies on the surviving daemons' records")
            continue
        cap = d.get("capture") or {}
        fl = cap.get("flight") or {}
        if fl.get("dropped"):
            warnings.append(
                f"{d['target']}: flight ring rolled over "
                f"({fl['dropped']} event(s) dropped) — early events "
                f"of this job may be missing here")
        tr = cap.get("trace") or {}
        if tr.get("evicted"):
            warnings.append(
                f"{d['target']}: per-job trace index evicted "
                f"{tr['evicted']} job(s) — trace slices may be "
                f"partial")
        j = d.get("journal") or {}
        if j.get("scan_truncated"):
            warnings.append(
                f"{d['target']}: journal scan hit a torn tail")
        if j and not j.get("complete", True):
            warnings.append(
                f"{d['target']}: journal_query clipped records "
                f"(bounded read)")
    if missing_shards:
        warnings.append(
            f"missing shard attempt(s) for shard(s) "
            f"{missing_shards} of {shard_count}")
    if bad_winner_shards:
        warnings.append(
            f"shard(s) {bad_winner_shards} lack exactly one "
            f"winning attempt")
    complete = (root is not None and not missing_shards
                and not bad_winner_shards)

    daemons = [{
        "target": d["target"], "ok": d.get("ok", False),
        "router": d.get("router", False), "pid": d.get("pid"),
        "daemon_id": (d.get("identity") or {}).get("daemon_id"),
        "clock_offset_s": d.get("clock_offset_s"),
        "offset_confidence_s": d.get("offset_confidence_s"),
        "probe_rtt_s": d.get("probe_rtt_s"),
        "capture": d.get("capture"),
        "error": d.get("error"),
    } for d in collection.get("daemons", ())]
    return {
        "schema": SCHEMA,
        "job_key": root,
        "trace_id": trace_id or root,
        "shards": shard_count,
        "complete": complete,
        "nodes": [nodes[k] for k in sorted(
            nodes, key=lambda k: (nodes[k]["kind"] != "root",
                                  nodes[k]["shard"] or 0,
                                  nodes[k]["attempt"] or 0))],
        "edges": edges,
        "winners": winner_keys,
        "daemons": daemons,
        "warnings": warnings,
    }


# ---------------------------------------------------------------------------
# renderers (pure)
# ---------------------------------------------------------------------------


def _lane_name(d: dict) -> str:
    """Works on both collection rows (identity nested) and lineage
    daemon rows (daemon_id flattened)."""
    return ("router" if d.get("router") else None) \
        or d.get("daemon_id") \
        or (d.get("identity") or {}).get("daemon_id") \
        or d["target"]


def _timeline_rows(collection: dict):
    """(aligned_wall_s, lane, text, raw) rows across every daemon's
    flight events and journal records, offset-corrected onto the
    collector's clock."""
    rows = []
    for d in collection.get("daemons", ()):
        lane = _lane_name(d)
        for ev in d.get("flight_events", ()):
            w = aligned_wall(d, ev.get("t"))
            if w is None:
                continue
            bits = [ev.get("kind", "?")]
            for f in ("key", "job_key", "shard", "backend", "ok",
                      "winner", "attempt", "code", "joined"):
                if f in ev and ev[f] is not None:
                    bits.append(f"{f}={ev[f]}")
            rows.append((w, lane, " ".join(bits)))
        j = d.get("journal") or {}
        for rec in j.get("records", ()):
            w = aligned_wall(d, rec.get("t"), wall=True)
            if w is None:
                continue
            bits = [f"journal.{rec.get('kind', '?')}"]
            if rec.get("job_key"):
                bits.append(f"job_key={rec['job_key']}")
            res = rec.get("result")
            if isinstance(res, dict) and "n_sequences" in res:
                bits.append(f"n_sequences={res['n_sequences']}")
            rows.append((w, lane, " ".join(bits)))
    rows.sort(key=lambda r: r[0])
    return rows


def render_fleet_timeline(lineage: dict, collection: dict) -> str:
    """The ``inspect --fleet`` text rendering: lineage summary,
    per-daemon clock-offset lanes with confidence, warnings, then
    one offset-corrected chronological line per fleet event."""
    lines = [f"fleet lineage: job_key {lineage.get('job_key')} "
             f"(trace {lineage.get('trace_id')}) — "
             f"{len(lineage.get('daemons', ()))} daemon(s), "
             + ("complete" if lineage.get("complete")
                else "INCOMPLETE")]
    if lineage.get("shards"):
        lines.append(
            f"scatter     {lineage['shards']} shard(s), winners: "
            + (", ".join(lineage.get("winners") or ()) or "-"))
    for d in lineage.get("daemons", ()):
        off = d.get("clock_offset_s")
        conf = d.get("offset_confidence_s")
        anno = ("offset unknown" if off is None else
                f"offset {off:+.3f}s ±{conf:.3f}s")
        state = "" if d.get("ok") else "  UNREACHABLE"
        lines.append(f"lane {_lane_name(d):<24s} "
                     f"pid {d.get('pid') or '?':<7} {anno}{state}")
    for w in lineage.get("warnings", ()):
        lines.append(f"warning: {w}")
    rows = _timeline_rows(collection)
    if rows:
        t0 = rows[0][0]
        for w, lane, text in rows:
            lines.append(f"  +{w - t0:9.3f}s  [{lane:<20s}] {text}")
    else:
        lines.append("no fleet events collected")
    # the DAG itself, one edge per line
    for e in lineage.get("edges", ()):
        extra = " ".join(f"{k}={v}" for k, v in e.items()
                         if k not in ("kind", "from", "to"))
        lines.append(f"edge {e['kind']:<10s} {e['from']} -> "
                     f"{e['to']}" + (f"  {extra}" if extra else ""))
    return "\n".join(lines) + "\n"


def _flow_id(key: str) -> int:
    return zlib.crc32(key.encode()) & 0x7FFFFFFF


def merged_trace_doc(lineage: dict, collection: dict) -> dict:
    """One Perfetto-loadable trace document for the whole fleet: each
    daemon is a process (its real pid, named by target), its captured
    trace slices keep their spans with timestamps re-based onto the
    offset-corrected collector clock, flight events become instants,
    and per-attempt flow events tie the router's ``route`` decision
    to the backend's ``admit`` — the cross-process arrow that answers
    "who ran this key"."""
    events = []
    pids = {}
    rows = []
    # pick a global time base so ts stays small and positive
    base = None
    for d in collection.get("daemons", ()):
        for ev in d.get("flight_events", ()):
            w = aligned_wall(d, ev.get("t"))
            if w is not None:
                base = w if base is None else min(base, w)
        for evs in (d.get("trace_slices") or {}).values():
            for ev in evs:
                w = aligned_wall(d, ev.get("ts", 0.0) / 1e6)
                if w is not None:
                    base = w if base is None else min(base, w)
    base = base or 0.0

    def us(w):
        return round((w - base) * 1e6, 3)

    for idx, d in enumerate(collection.get("daemons", ())):
        pid = d.get("pid")
        if pid is None or pid in pids:
            pid = -(idx + 1)     # unreachable daemon / pid collision
        pids[pid] = d
        name = d["target"] + (" (router)" if d.get("router") else "")
        events.append({"name": "process_name", "ph": "M",
                       "pid": pid, "tid": 0,
                       "args": {"name": name}})
        off = d.get("clock_offset_s")
        if off is not None:
            events.append({
                "name": "clock_offset", "ph": "M", "pid": pid,
                "tid": 0,
                "args": {"offset_s": off,
                         "confidence_s":
                             d.get("offset_confidence_s")}})
        for evs in (d.get("trace_slices") or {}).values():
            for ev in evs:
                w = aligned_wall(d, ev.get("ts", 0.0) / 1e6)
                if w is None:
                    continue
                out = dict(ev)
                out["pid"] = pid
                out["ts"] = us(w)
                events.append(out)
        for ev in d.get("flight_events", ()):
            w = aligned_wall(d, ev.get("t"))
            if w is None:
                continue
            args = {k: v for k, v in ev.items()
                    if k not in ("t", "seq") and v is not None
                    and isinstance(v, (str, int, float, bool))}
            events.append({"name": ev.get("kind", "?"), "ph": "i",
                           "s": "t", "cat": "flight", "pid": pid,
                           "tid": 0, "ts": us(w), "args": args})
        # flow arrows: router route decision -> backend admit, per
        # attempt key (synthesized here — no wire plumbing needed)
        if d.get("router"):
            for ev in d.get("flight_events", ()):
                if ev.get("kind") != "route" \
                        or not ev.get("job_key"):
                    continue
                w = aligned_wall(d, ev.get("t"))
                if w is None:
                    continue
                events.append({
                    "name": "route", "ph": "s", "cat": "lineage",
                    "id": _flow_id(ev["job_key"]), "pid": pid,
                    "tid": 0, "ts": us(w),
                    "args": {"key": ev["job_key"],
                             "backend": ev.get("backend")}})
                rows.append(ev["job_key"])
        else:
            for ev in d.get("flight_events", ()):
                if ev.get("kind") != "admit" \
                        or not ev.get("job_key"):
                    continue
                w = aligned_wall(d, ev.get("t"))
                if w is None:
                    continue
                events.append({
                    "name": "route", "ph": "f", "bp": "e",
                    "cat": "lineage",
                    "id": _flow_id(ev["job_key"]), "pid": pid,
                    "tid": 0, "ts": us(w),
                    "args": {"key": ev["job_key"]}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "lineage": lineage}


# ---------------------------------------------------------------------------
# collect and build in one call
# ---------------------------------------------------------------------------


def assemble(address: str, job_key: str = None, trace_id: str = None,
             timeout: float = None):
    """Collect + build: returns ``(collection, lineage)`` for one job
    key or trace id against a live router/daemon address."""
    if not job_key and not trace_id:
        raise ValueError("assemble needs a job_key or a trace_id")
    collection = collect_fleet(address, job_key=job_key,
                               trace_id=trace_id, timeout=timeout)
    return collection, build_lineage(collection)
