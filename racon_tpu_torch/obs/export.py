"""Registry export: Prometheus text exposition and JSON snapshots (JAX
package: racon_tpu/obs/export.py).

The serve daemon's ``metrics`` and ``watch`` ops answer with the process
registry rendered here:

* :func:`prometheus_text` -- Prometheus text exposition (format 0.0.4):
  counters and gauges as single samples, histograms as cumulative
  ``_bucket{le="..."}`` series plus ``_sum`` and ``_count``, all under
  the ``racon_tpu_torch_`` prefix.  Registry names are free-form (dots,
  rung suffixes); :func:`sanitize` maps them onto the Prometheus
  grammar.  The per-tenant queue-wait histograms
  (``serve_queue_wait_s.<tenant>``) are exported under their base name
  with a ``tenant`` label, since ``sanitize`` is not injective;
* :func:`prometheus_text_fleet` -- several daemons' snapshots in one
  exposition, each sample labelled ``instance`` (``metrics --fleet``);
* :func:`json_snapshot` -- the snapshot with p50/p90/p99 attached to
  every histogram;
* :func:`drift_summary` and :func:`slo_summary` -- the calibration
  drift table and the serving percentiles.

Nothing here writes the registry.
"""
from __future__ import annotations

import re

from racon_tpu_torch.obs.metrics import HIST_BUCKETS, hist_quantile

PREFIX = "racon_tpu_torch_"

_INVALID = re.compile(r"[^a-zA-Z0-9_]")

#: quantiles attached to every exported histogram
QUANTILES = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))

#: registry-name prefixes whose dot-suffix is a tenant tag exported
#: as a ``tenant`` label (serve/scheduler.py writes these per-tenant
#: SLO series)
TENANT_SERIES = ("serve_tenant_wait_s", "serve_queue_wait_s")


def sanitize(name: str) -> str:
    """Registry name -> Prometheus metric name (prefixed, every
    character outside ``[a-zA-Z0-9_]`` folded to ``_``).  The mapping
    is deterministic but not injective — which is exactly why tenant
    tags travel as labels (:data:`TENANT_SERIES`), never as folded
    name suffixes."""
    san = _INVALID.sub("_", name)
    # the reject-code names carry a leading '-' ("poa_reject.-1");
    # folding gives a double underscore, which is legal — but a name
    # must not START with a digit after the prefix is applied, and
    # the prefix guarantees that
    return PREFIX + san


def split_tenant(name: str):
    """``serve_tenant_wait_s.alice`` -> ``("serve_tenant_wait_s",
    {"tenant": "alice"})``; any other name -> ``(name, {})``."""
    for base in TENANT_SERIES:
        if name.startswith(base + ".") and len(name) > len(base) + 1:
            return base, {"tenant": name[len(base) + 1:]}
    return name, {}


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _label_str(labels: dict) -> str:
    """Canonical (sorted-key) label block, ``""`` when empty."""
    if not labels:
        return ""
    return "{" + ",".join(
        f'{k}="{_escape_label(labels[k])}"'
        for k in sorted(labels)) + "}"


def _fmt(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _render(sources) -> str:
    """Exposition over ``[(base_labels, snapshot), ...]``: one TYPE line
    per metric name, every sample carrying its source's base labels
    (and ``tenant`` on the per-tenant series, ``le`` on buckets)."""
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    for base_labels, snap in sources:
        for name in sorted(snap.get("counters", {})):
            base, tl = split_tenant(name)
            counters.setdefault(sanitize(base), []).append(
                ({**base_labels, **tl}, snap["counters"][name]))
        for name in sorted(snap.get("gauges", {})):
            v = snap["gauges"][name]
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, (int, float)):
                continue   # non-numeric gauges have no exposition form
            base, tl = split_tenant(name)
            gauges.setdefault(sanitize(base), []).append(
                ({**base_labels, **tl}, v))
        for name in sorted(snap.get("histograms", {})):
            base, tl = split_tenant(name)
            hists.setdefault(sanitize(base), []).append(
                ({**base_labels, **tl}, snap["histograms"][name]))
    lines = []
    for mn in sorted(counters):
        lines.append(f"# TYPE {mn} counter")
        for labels, v in counters[mn]:
            lines.append(f"{mn}{_label_str(labels)} {_fmt(v)}")
    for mn in sorted(gauges):
        lines.append(f"# TYPE {mn} gauge")
        for labels, v in gauges[mn]:
            lines.append(f"{mn}{_label_str(labels)} {_fmt(v)}")
    for mn in sorted(hists):
        lines.append(f"# TYPE {mn} histogram")
        for labels, h in hists[mn]:
            counts = {int(k): v
                      for k, v in h.get("buckets", {}).items()}
            cum = 0
            for idx in sorted(counts):
                cum += counts[idx]
                le = _fmt(HIST_BUCKETS[idx]) \
                    if idx < len(HIST_BUCKETS) else "+Inf"
                if le != "+Inf":
                    ls = _label_str({**labels, "le": le})
                    lines.append(f"{mn}_bucket{ls} {cum}")
            ls = _label_str({**labels, "le": "+Inf"})
            lines.append(f'{mn}_bucket{ls} {h["count"]}')
            lines.append(
                f"{mn}_sum{_label_str(labels)} {_fmt(h['sum'])}")
            lines.append(
                f"{mn}_count{_label_str(labels)} {h['count']}")
    return "\n".join(lines) + "\n"


def prometheus_text(snapshot: dict) -> str:
    """Render a registry snapshot (``Registry.snapshot()``) as
    Prometheus text exposition: one TYPE line per metric name, the
    per-tenant series labelled ``tenant``, buckets ``le``."""
    return _render([({}, snapshot)])


def prometheus_text_fleet(snapshots: dict) -> str:
    """Render ``{instance_id: snapshot}`` as one exposition in which
    every sample carries ``instance="<id>"`` (``metrics --fleet
    --prometheus``)."""
    return _render([({"instance": iid}, snapshots[iid])
                    for iid in sorted(snapshots)])


def percentiles(hist: dict) -> dict:
    """p50/p90/p99 (plus min/max/count/sum passthrough) for one
    histogram snapshot entry."""
    out = {"count": hist.get("count", 0),
           "sum": round(hist.get("sum", 0.0), 6)}
    if out["count"]:
        out["min"] = hist.get("min")
        out["max"] = hist.get("max")
        for label, q in QUANTILES:
            out[label] = round(hist_quantile(hist, q), 6)
    return out


def json_snapshot(snapshot: dict) -> dict:
    """Registry snapshot + per-histogram percentiles — the machine
    twin of :func:`prometheus_text` (the ``metrics`` op's ``snapshot``
    section)."""
    return {
        "counters": dict(snapshot.get("counters", {})),
        "gauges": dict(snapshot.get("gauges", {})),
        "histograms": {
            name: {**h, "percentiles": percentiles(h)}
            for name, h in snapshot.get("histograms", {}).items()},
    }


def drift_summary(snapshot: dict) -> dict:
    """Per-stage calibration-health document for any snapshot form
    (plain, json_snapshot, or fleet-merged) — delegates to
    :func:`racon_tpu_torch.obs.calhealth.summary` so the export surface and
    the ``explain`` op serve the identical shape."""
    from racon_tpu_torch.obs import calhealth

    return calhealth.summary(snapshot)


def slo_summary(snapshot: dict, prefix: str = "serve_") -> dict:
    """Percentile summary of every histogram under ``prefix`` — the
    serving-tier SLO view (queue_wait/exec_wall/e2e_wall/wall error)
    that ``metrics`` and ``watch`` frames carry."""
    return {name: percentiles(h)
            for name, h in snapshot.get("histograms", {}).items()
            if name.startswith(prefix)}
