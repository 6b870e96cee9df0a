"""``explain``: a job's cost waterfall and the calibration's health,
from a live daemon or a ``--metrics-json`` run report (JAX package:
racon_tpu/serve/explain.py).

The decision ring (``racon_tpu_torch/obs/decision.py``) records why
the admission and the ladder did what they did, and calhealth
(``obs/calhealth.py``) how far their predictions drifted from the
measured walls.  Given a job id this renders the job's waterfall: the
stage walls as shares of the job's wall, the predicted against the
measured wall, and the per-stage drift table with its advisory
"recalibration recommended" flags::

    job 17 (tenantA) — predicted 4.10s vs measured 4.52s (ratio 1.10)
      stage             wall      share
      align            2.21s  #################                   49%
      poa              1.13s  #########                           25%
      ...
    calibration health (predicted vs actual, band 0.50..2.00)
      stage              n     ewma      p50      p99
      poa               12    1.070    1.050    1.310

Sources:

* ``--socket PATH``: a running daemon's ``explain`` op (calhealth, the
  decision ring's stats, counts and events in one frame);
* ``--metrics-json FILE``: a run report of the port
  (``racon-tpu-torch-metrics-v1``, what the one-shot CLI's
  ``--metrics-json`` writes): the drift is recomputed from its ``run``
  registry snapshot, the waterfall from ``details.stage_walls``.  The
  report is the job.

    python -m racon_tpu_torch.cli explain (--socket PATH |
        --metrics-json FILE) [--job N] [--last N] [--json]

Read-only; decision records feed this view and never control flow.
"""

from __future__ import annotations

import argparse
import json
import sys

#: waterfall bar width in characters at 100% share
_BAR = 34


def _fmt_s(v) -> str:
    v = float(v)
    if v >= 3600:
        return f"{v / 3600:.1f}h"
    if v >= 60:
        return f"{v / 60:.1f}m"
    if v >= 1:
        return f"{v:.2f}s"
    return f"{v * 1000:.0f}ms"


def job_events(events, job: int) -> list:
    """Decision events belonging to ``job``, in (time, seq) order."""
    job = int(job)
    sel = [ev for ev in events
           if ev.get("job") == job or job in ev.get("jobs", ())]
    sel.sort(key=lambda ev: (ev.get("t", 0.0), ev.get("seq", 0)))
    return sel


def render_waterfall(stage_walls: dict, total_s=None) -> str:
    """Stage walls -> the share-bar table (pure; tests golden it)."""
    walls = {k: float(v) for k, v in (stage_walls or {}).items()
             if float(v) > 0.0}
    if not walls:
        return "  (no stage walls recorded)\n"
    denom = float(total_s) if total_s else sum(walls.values())
    denom = max(denom, 1e-9)
    lines = ["  stage             wall      share"]
    for name, w in sorted(walls.items(), key=lambda kv: -kv[1]):
        share = w / denom
        bar = "#" * max(1, round(share * _BAR))
        lines.append(f"  {name:<16s} {_fmt_s(w):>7s}  "
                     f"{bar:<{_BAR}s} {share * 100:3.0f}%")
    other = denom - sum(walls.values())
    if total_s and other > 0.05 * denom:
        lines.append(f"  {'(other)':<16s} {_fmt_s(other):>7s}  "
                     f"{'':<{_BAR}s} {other / denom * 100:3.0f}%")
    return "\n".join(lines) + "\n"


def render_drift(cal: dict) -> str:
    """Calhealth summary -> the drift table + advisories (pure)."""
    cal = cal or {}
    stages = cal.get("stages") or {}
    lo, hi = (cal.get("band") or (0.5, 2.0))[:2]
    lines = [f"calibration health (predicted vs actual, band "
             f"{lo:.2f}..{hi:.2f})"]
    seen = False
    drifted = []
    lines.append("  stage              n     ewma      p50      p99")
    for name in sorted(stages):
        s = stages[name] or {}
        if not s.get("n"):
            continue
        seen = True
        ew = s.get("ewma")
        flag = "   DRIFT" if s.get("drift") else ""
        if s.get("drift") and ew is not None:
            drifted.append((name, ew))
        ew_txt = "-" if ew is None else f"{ew:.3f}"
        lines.append(
            f"  {name:<16s} {s['n']:>4d}  {ew_txt:>7s}  "
            f"{s.get('p50', 0.0):>7.3f}  {s.get('p99', 0.0):>7.3f}"
            f"{flag}")
    if not seen:
        return ("calibration health: no predicted-vs-actual samples "
                "recorded yet\n")
    for name, ew in drifted:
        direction = "slower" if ew is not None and ew > 1.0 \
            else "faster"
        lines.append(
            f"  ! {name}: measured walls {direction} than predicted "
            f"(ewma {ew:.2f} outside {lo:.2f}..{hi:.2f}) — "
            f"recalibration recommended (RACON_TPU_TORCH_RECALIBRATE=1)")
    return "\n".join(lines) + "\n"


def render_counts(counts: dict) -> str:
    counts = counts or {}
    if not counts:
        return ""
    body = "  ".join(f"{k}={counts[k]}" for k in sorted(counts))
    return f"decision events: {body}\n"


def render_job(doc: dict, job: int) -> str:
    """One ``explain`` frame + a job id -> the per-job view (pure)."""
    events = doc.get("events", [])
    sel = job_events(events, job)
    lines = []
    # the rollups serve/session.py and the scheduler record per job:
    # job_stages carries the stage walls, job_wall the admission-priced
    # headline
    stages_ev = next((ev for ev in reversed(sel)
                      if ev.get("kind") == "job_stages"), None)
    wall_ev = next((ev for ev in reversed(sel)
                    if ev.get("kind") == "job_wall"), None)
    if stages_ev is None and wall_ev is None:
        lines.append(f"job {job}: no decision records in this source "
                     f"(evicted from the ring, or never seen here)")
        lines.append("")
        lines.append(render_drift(doc.get("calhealth")).rstrip("\n"))
        return "\n".join(lines) + "\n"
    tenant = next((ev["tenant"] for ev in sel if ev.get("tenant")),
                  "default")
    head = f"job {job} ({tenant})"
    if wall_ev is not None:
        head += (f" — predicted {_fmt_s(wall_ev.get('predicted_s', 0))}"
                 f" vs measured {_fmt_s(wall_ev.get('measured_s', 0))}"
                 f" (ratio {wall_ev.get('ratio', 0):.2f})")
    elif stages_ev is not None and "wall_s" in stages_ev:
        head += f" — wall {_fmt_s(stages_ev['wall_s'])}"
    lines.append(head)
    if stages_ev is not None:
        mode = stages_ev.get("split_mode")
        if mode:
            lines.append(f"  poa split mode: {mode}")
        lines.append(render_waterfall(
            stages_ev.get("stage_walls"),
            total_s=stages_ev.get("wall_s")).rstrip("\n"))
    kinds: dict = {}
    for ev in sel:
        k = ev.get("kind", "?")
        kinds[k] = kinds.get(k, 0) + 1
    c = render_counts(kinds)
    if c:
        lines.append(c.rstrip("\n"))
    lines.append("")
    lines.append(render_drift(doc.get("calhealth")).rstrip("\n"))
    return "\n".join(lines) + "\n"


def render_overview(doc: dict) -> str:
    """No ``--job``: ring stats, per-kind counts, drift table."""
    ring = doc.get("ring") or {}
    lines = [f"decision ring @ pid {doc.get('pid')}: "
             f"{ring.get('size', 0)}/{ring.get('capacity', 0)} "
             f"event(s), {ring.get('dropped', 0)} dropped"
             + ("" if ring.get("enabled", True)
                else "  [RECORDING OFF]")]
    c = render_counts(doc.get("counts"))
    if c:
        lines.append(c.rstrip("\n"))
    # the result cache's block rides the explain frame: its hit ratio
    # and bytes held say why a warm daemon's walls undercut the
    # admission's predictions
    ca = doc.get("cache") or {}
    if ca.get("enabled"):
        total = ca.get("hits", 0) + ca.get("misses", 0)
        lines.append(
            f"result cache: hit {ca.get('hit_ratio', 0.0) * 100:.0f}% "
            f"({ca.get('hits', 0)}/{total})  "
            f"{ca.get('bytes', 0) / (1 << 20):.1f} MB resident  "
            f"{ca.get('entries', 0)} entries  "
            f"{ca.get('fills', 0)} fills  {ca.get('evicts', 0)} evicted")
    lines.append("")
    lines.append(render_drift(doc.get("calhealth")).rstrip("\n"))
    return "\n".join(lines) + "\n"


def _doc_from_report(path: str) -> dict:
    """A ``--metrics-json`` run report -> an explain-shaped doc: the
    drift summary is recomputed from the report's run registry
    snapshot, the waterfall rides as a synthetic ``job_stages``."""
    from racon_tpu_torch.obs import calhealth

    with open(path) as f:
        report = json.load(f)
    snap = report.get("run") or report.get("process") or {}
    details = report.get("details") or {}
    doc = {"ok": True, "pid": None, "ring": {},
           "counts": {}, "events": [],
           "calhealth": calhealth.summary(snap)}
    walls = details.get("stage_walls")
    if walls:
        gauges = (snap.get("gauges") or {})
        wall = gauges.get("job_wall_s") or sum(
            float(v) for v in walls.values())
        doc["events"] = [{"kind": "job_stages", "job": 0,
                          "wall_s": wall, "stage_walls": walls,
                          "split_mode": (details.get(
                              "poa_split_detail") or {}).get("mode")}]
    return doc


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon-tpu-torch explain",
        description="Render the decision plane: a served job's cost "
        "waterfall (stage walls, decision counts) and the per-stage "
        "predicted-vs-actual calibration-health table, from a live "
        "daemon's explain op or a --metrics-json run report.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--socket",
                     help="unix-domain socket of a live daemon")
    src.add_argument("--metrics-json", metavar="FILE",
                     help="run report written by --metrics-json "
                     "(one-shot CLI or submit)")
    p.add_argument("--job", type=int, default=None,
                   help="job id to render (omit for the ring "
                   "overview + drift table; with --metrics-json the "
                   "report IS the job)")
    p.add_argument("--last", type=int, default=0,
                   help="with --socket and no --job: only the newest "
                   "N decision events")
    p.add_argument("--json", action="store_true",
                   help="print the raw explain document instead of "
                   "the rendered view")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.socket:
        from racon_tpu_torch.serve import client
        try:
            doc = client.explain(args.socket, job=args.job,
                                 last=args.last)
        except client.ServeError as exc:
            print(f"[racon_tpu_torch::explain] error: {exc}",
                  file=sys.stderr)
            return 1
        if not doc.get("ok"):
            print(f"[racon_tpu_torch::explain] error: {doc.get('error')}",
                  file=sys.stderr)
            return 1
    else:
        try:
            doc = _doc_from_report(args.metrics_json)
        except (OSError, ValueError) as exc:
            print(f"[racon_tpu_torch::explain] error: {exc}",
                  file=sys.stderr)
            return 1
    if args.json:
        json.dump(doc, sys.stdout, indent=1)
        print()
        return 0
    if args.metrics_json and args.job is None and doc["events"]:
        # a run report describes exactly one run: render it as the job
        sys.stdout.write(render_job(doc, 0))
    elif args.job is not None:
        sys.stdout.write(render_job(doc, args.job))
    else:
        sys.stdout.write(render_overview(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
