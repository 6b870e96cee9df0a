"""The fleet scrape: many daemons' telemetry, one merged view (JAX
package: racon_tpu/serve/fleet.py).

One host may run several port daemons (one per card, or a CPU daemon
beside a card's), and the question becomes how the fleet is doing and
which daemon is the outlier.  This module answers it from the read side:

* :class:`FleetScraper` -- polls N sockets concurrently (one short-lived
  thread per target per round, bounded by per-target timeouts) and keeps
  the last good snapshot of each.  A dead or slow daemon degrades to a
  stale row, never taking a healthy daemon's data with it; in the
  background loop (:meth:`FleetScraper.start`) a failing target backs
  off exponentially.
* :func:`merge_fleet` -- scrape rows -> one fleet document: a row per
  daemon (identity, queue) and the exact registry merge
  (``obs/aggregate.py``) with the fleet SLO table over it.  Fleet
  p50/p90/p99 are bit for bit the quantiles of the union of all the
  daemons' observations, not an average of averages.
* :func:`watch_fleet` -- N ``watch`` streams multiplexed into one
  iterator of ``{"target", "frame"}`` records, each frame keeping its
  source's ``seq`` and identity.
* :func:`main_metrics` -- ``python -m racon_tpu_torch.cli metrics``:
  ``--socket PATH`` for one daemon, ``--fleet S1,S2,...`` (or one
  router's socket, whose backends it reads) for the merged view, as
  ``--json`` or ``--prometheus`` (each fleet sample labelled
  ``instance="<daemon_id>"``).

Knobs (provenance.KNOWN_KNOBS; epoch-excluded):

* ``RACON_TPU_TORCH_FLEET_INTERVAL_S`` -- background scrape period (1.0)
* ``RACON_TPU_TORCH_FLEET_TIMEOUT_S``  -- per-target timeout (5.0)
* ``RACON_TPU_TORCH_FLEET_STALE_S``    -- age past which a row is stale
  (10)

Read-only: ``metrics`` and ``watch`` touch no queue or job state, so a
daemon under scrape writes the same bytes as one left alone.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading

from racon_tpu_torch.obs import aggregate, export
from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.serve import client

#: cap on per-target exponential backoff in background mode
_MAX_BACKOFF_S = 30.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def fleet_interval_s() -> float:
    return max(0.05, _env_float("RACON_TPU_TORCH_FLEET_INTERVAL_S", 1.0))


def fleet_timeout_s() -> float:
    return max(0.1, _env_float("RACON_TPU_TORCH_FLEET_TIMEOUT_S", 5.0))


def fleet_stale_s() -> float:
    return max(0.1, _env_float("RACON_TPU_TORCH_FLEET_STALE_S", 10.0))


def scrape_concurrently(targets, fn, timeout_s: float = None):
    """Run ``fn(target) -> row`` once per target, one short-lived
    thread each (the same shape :class:`FleetScraper` polls with),
    and return the rows in ``targets`` order.  A worker that hangs
    past the join budget leaves ``None`` in its slot; ``fn`` is
    expected to catch its own errors and degrade to an error row —
    this helper never raises on a worker's behalf."""
    timeout_s = fleet_timeout_s() if timeout_s is None else timeout_s
    rows = [None] * len(targets)

    def run(idx, target):
        rows[idx] = fn(target)

    threads = [threading.Thread(target=run, args=(i, t), daemon=True)
               for i, t in enumerate(targets)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout_s + 5.0)
    return rows


class FleetScraper:
    """Concurrent multi-target ``metrics`` scraper with per-target
    staleness.  ``targets`` is a list of unix-socket paths.  Use
    :meth:`scrape_once` synchronously, or :meth:`start` /
    :meth:`stop` for a background loop; :meth:`results` reads the
    latest state either way (thread-safe)."""

    def __init__(self, targets, interval_s: float = None,
                 timeout_s: float = None,
                 stale_after_s: float = None):
        if not targets:
            raise ValueError("FleetScraper needs at least one target")
        self.targets = list(targets)
        self.interval_s = (fleet_interval_s()
                           if interval_s is None else interval_s)
        self.timeout_s = (fleet_timeout_s()
                          if timeout_s is None else timeout_s)
        self.stale_after_s = (fleet_stale_s()
                              if stale_after_s is None
                              else stale_after_s)
        self._lock = threading.Lock()
        self._state = {
            t: {"target": t, "ok": False, "doc": None, "t": None,
                "failures": 0, "error": None, "next_due": 0.0}
            for t in self.targets}
        self._stop = threading.Event()
        self._thread = None

    # -- scraping ------------------------------------------------------

    def _scrape_target(self, target: str) -> None:
        try:
            doc = client.metrics(target, timeout=self.timeout_s)
        except Exception as exc:    # ServeError or anything transport
            with self._lock:
                st = self._state[target]
                st["ok"] = False
                st["failures"] += 1
                st["error"] = f"{type(exc).__name__}: {exc}"
                # keep st["doc"]/st["t"]: the last good snapshot
                # stays visible as a STALE row instead of vanishing
                st["next_due"] = obs_trace.now() + min(
                    self.interval_s * (2 ** min(st["failures"], 10)),
                    _MAX_BACKOFF_S)
            return
        with self._lock:
            st = self._state[target]
            st.update(ok=True, doc=doc, t=obs_trace.now(),
                      failures=0, error=None)
            st["next_due"] = st["t"] + self.interval_s

    def scrape_once(self, due_only: bool = False) -> None:
        """One concurrent round over all targets (blocks until every
        target answered or timed out).  ``due_only`` skips targets
        still inside their backoff window (background-loop mode)."""
        now = obs_trace.now()
        with self._lock:
            targets = [t for t in self.targets
                       if not due_only
                       or self._state[t]["next_due"] <= now]
        threads = [threading.Thread(target=self._scrape_target,
                                    args=(t,), daemon=True)
                   for t in targets]
        for th in threads:
            th.start()
        for th in threads:
            th.join(self.timeout_s + 5.0)

    def results(self) -> list:
        """Latest per-target rows (list, ``self.targets`` order).
        ``stale`` is True when the target never answered, last failed,
        or the last good snapshot is older than ``stale_after_s``."""
        now = obs_trace.now()
        rows = []
        with self._lock:
            for t in self.targets:
                st = self._state[t]
                age = None if st["t"] is None else now - st["t"]
                rows.append({
                    "target": t,
                    "ok": st["ok"],
                    "stale": (st["doc"] is None or not st["ok"]
                              or age > self.stale_after_s),
                    "age_s": None if age is None else round(age, 3),
                    "consecutive_failures": st["failures"],
                    "error": st["error"],
                    "doc": st["doc"],
                })
        return rows

    # -- background loop -----------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="racon-torch-fleet-scrape",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.timeout_s + 10.0)
            self._thread = None

    def _loop(self) -> None:
        # first round is unconditional so results() fills promptly
        self.scrape_once()
        while not self._stop.wait(self.interval_s):
            self.scrape_once(due_only=True)


def merge_fleet(rows) -> dict:
    """Scrape rows (:meth:`FleetScraper.results`) -> one fleet
    document: per-daemon rows keyed by identity, the exact merged
    registry (racon_tpu_torch/obs/aggregate.py), and the fleet SLO table
    over the merge."""
    daemons = []
    snapshots = {}
    alive = stale = 0
    for row in rows:
        doc = row["doc"] or {}
        ident = doc.get("identity") or {}
        q = doc.get("queue") or {}
        if row["stale"]:
            stale += 1
        else:
            alive += 1
        daemons.append({
            "target": row["target"],
            "ok": row["ok"],
            "stale": row["stale"],
            "age_s": row["age_s"],
            "consecutive_failures": row["consecutive_failures"],
            "error": row["error"],
            "identity": ident or None,
            "uptime_s": doc.get("uptime_s"),
            "queue_depth": q.get("queue_depth"),
            "running": len(q.get("running", ())),
            "completed": q.get("completed"),
            "draining": q.get("draining"),
            # a router target's metrics doc carries its backend
            # breaker rows and routing counters; plain daemons carry
            # none
            "route": doc.get("route"),
        })
        snap = doc.get("snapshot")
        if snap:
            snapshots[ident.get("daemon_id") or row["target"]] = snap
    merged = aggregate.merge_snapshots(snapshots)
    return {
        "ok": alive > 0,
        "fleet_size": len(rows),
        "alive": alive,
        "stale": stale,
        "daemons": daemons,
        "merged": merged,
        "slo": export.slo_summary(merged),
        # fleet calibration health over the exact merge: the
        # per-stage quantiles come from the union of every daemon's
        # drift-ratio histogram, the EWMA is the per-daemon mean
        "calhealth": export.drift_summary(merged),
    }


def watch_fleet(targets, interval_s: float = None, count: int = 0,
                timeout: float = None):
    """Multiplex N daemons' ``watch`` streams into one generator of
    ``{"target": socket, "frame": frame}`` records (arrival order).
    Each frame keeps its server-assigned per-connection ``seq`` and
    ``identity`` — attribution is per source, never merged.  A
    target that cannot be reached contributes a single
    ``{"ok": False, "error": {...}}`` frame; the generator ends when
    every stream has."""
    targets = list(targets)
    q: queue.Queue = queue.Queue()

    def _reader(t):
        try:
            for frame in client.watch(t, interval_s=interval_s
                                      if interval_s is not None
                                      else fleet_interval_s(),
                                      count=count, timeout=timeout):
                q.put((t, frame))
        except client.ServeError as exc:
            q.put((t, {"ok": False,
                       "error": {"code": "unreachable",
                                 "reason": str(exc)}}))
        finally:
            q.put((t, None))          # end-of-stream sentinel

    for t in targets:
        threading.Thread(target=_reader, args=(t,),
                         daemon=True).start()
    live = len(targets)
    while live:
        t, frame = q.get()
        if frame is None:
            live -= 1
            continue
        yield {"target": t, "frame": frame}


def resolve_fleet_targets(fleet_arg: str, timeout: float = None):
    """``--fleet`` argument -> daemon socket list.

    A comma-separated value is the explicit backend list, as before.
    A single target is probed with ``route_status`` first: a router
    answers with its backend table and the fleet view auto-discovers
    from it (``--fleet ROUTER_SOCK``); a plain daemon (or anything
    that refuses the op) falls back to being the one-element fleet.
    Discovery failures degrade, never fail — a DOWN router behaves
    like a DOWN daemon row."""
    targets = [t for t in (fleet_arg or "").split(",") if t]
    if len(targets) != 1:
        return targets
    try:
        doc = client.route_status(
            targets[0],
            timeout=timeout if timeout is not None
            else fleet_timeout_s())
    except Exception:
        return targets
    backends = [b.get("target") for b in (doc.get("backends") or [])
                if b.get("target")]
    return backends or targets


# -- the `metrics` one-shot CLI ----------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.cli metrics",
        description="One-shot telemetry scrape of one daemon "
        "(--socket) or a fleet (--fleet), as JSON or Prometheus "
        "text exposition.")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--socket",
                   help="unix-domain socket of one daemon")
    g.add_argument("--fleet", metavar="SOCK1,SOCK2,...",
                   help="comma-separated daemon sockets, or a single "
                   "router socket (backends auto-discovered from its "
                   "route_status); output is the merged fleet view")
    f = p.add_mutually_exclusive_group()
    f.add_argument("--json", action="store_true",
                   help="JSON output (default)")
    f.add_argument("--prometheus", action="store_true",
                   help="Prometheus text exposition (fleet samples "
                   "carry instance=\"<daemon_id>\" labels)")
    p.add_argument("--timeout", type=float, default=None,
                   help="per-target timeout in seconds "
                   "(default RACON_TPU_TORCH_FLEET_TIMEOUT_S)")
    return p


def main_metrics(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    timeout = args.timeout if args.timeout is not None \
        else fleet_timeout_s()
    if args.socket:
        try:
            doc = client.metrics(args.socket, timeout=timeout)
        except client.ServeError as exc:
            print(f"[racon_tpu_torch::metrics] error: {exc}",
                  file=sys.stderr)
            return 1
        if args.prometheus:
            sys.stdout.write(doc.get("prometheus", ""))
        else:
            json.dump(doc, sys.stdout, indent=1)
            print()
        return 0

    targets = resolve_fleet_targets(args.fleet, timeout=timeout)
    scraper = FleetScraper(targets, timeout_s=timeout)
    scraper.scrape_once()
    rows = scraper.results()
    doc = merge_fleet(rows)
    if args.prometheus:
        snapshots = {}
        for row in rows:
            d = row["doc"] or {}
            snap = d.get("snapshot")
            if snap:
                ident = d.get("identity") or {}
                snapshots[ident.get("daemon_id")
                          or row["target"]] = snap
        sys.stdout.write(export.prometheus_text_fleet(snapshots))
    else:
        json.dump(doc, sys.stdout, indent=1)
        print()
    for row in rows:
        if not row["ok"]:
            print(f"[racon_tpu_torch::metrics] {row['target']}: "
                  f"{row['error']}", file=sys.stderr)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main_metrics())
