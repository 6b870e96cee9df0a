"""Exact merge of registry snapshots across processes (JAX package:
racon_tpu/obs/aggregate.py).

The fleet scrape (racon_tpu_torch/serve/fleet.py) reads N daemons, each
exporting one ``Registry.snapshot()``, and merges them exactly: fleet
quantiles must equal what one daemon would have reported for the union
of the observation streams.  Exactness follows from two choices of the
registry (racon_tpu_torch/obs/metrics.py):

* every histogram shares the one fixed bucket ladder
  (:data:`~racon_tpu_torch.obs.metrics.HIST_BUCKETS`), so bucket i means
  the same interval in every process and buckets merge by integer
  addition;
* :func:`~racon_tpu_torch.obs.metrics.hist_quantile` reads only
  ``count``, ``buckets``, ``min`` and ``max``, which merge exactly (sums
  of integers, min of mins, max of maxes).  The float ``sum`` is carried
  for the exposition but never feeds a quantile.

So ``hist_quantile(merge(snapshots), q)`` is bit for bit the quantile of
one registry that saw every observation (tests/test_torch_fleet.py).

Merged schema (``merge_snapshots``)::

    {"schema": "racon-tpu-torch-aggregate-v1",
     "sources": ["d1", "d2", ...],          # the snapshot keys, sorted
     "counters": {name: total},             # summed across sources
     "gauges": {name: {"per_source": {src: v},
                       "min": .., "max": .., "sum": ..}},
     "histograms": {name: merged_entry}}    # single-snapshot shape

Gauges are not summed into one number (a point-in-time reading's sum
across daemons rarely means anything): the per-source map keeps
attribution and min, max and sum serve where they do.  Merged histogram
entries keep the single-snapshot shape, so ``hist_quantile``,
``export.percentiles`` and ``export.slo_summary`` read them unchanged.
Read side only: merging writes no registry.
"""

from __future__ import annotations

SCHEMA = "racon-tpu-torch-aggregate-v1"


def merge_histograms(hists) -> dict:
    """Merge histogram snapshot entries (same fixed bucket ladder)
    bucket-wise.  Accepts any iterable of entries; empty/None entries
    are skipped.  Returns a single-snapshot-shaped entry."""
    merged = None
    for h in hists:
        if not h or not h.get("count"):
            continue
        if merged is None:
            merged = {"count": 0, "sum": 0.0,
                      "min": h["min"], "max": h["max"], "buckets": {}}
        merged["count"] += int(h["count"])
        merged["sum"] += float(h.get("sum", 0.0))
        merged["min"] = min(merged["min"], h["min"])
        merged["max"] = max(merged["max"], h["max"])
        for k, n in (h.get("buckets") or {}).items():
            key = str(int(k))
            merged["buckets"][key] = \
                merged["buckets"].get(key, 0) + int(n)
    return merged if merged is not None else \
        {"count": 0, "sum": 0.0, "buckets": {}}


def merge_snapshots(snapshots: dict) -> dict:
    """Merge ``{source_id: Registry.snapshot()}`` into one aggregate
    document (see the module docstring for the schema).  Sources
    missing a metric simply contribute nothing to it; a source may be
    a raw snapshot or an ``export.json_snapshot`` (the extra
    ``percentiles`` keys are ignored)."""
    sources = sorted(snapshots)
    counters: dict = {}
    gauges: dict = {}
    hist_names: dict = {}
    for src in sources:
        snap = snapshots[src] or {}
        for name, v in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + v
        for name, v in (snap.get("gauges") or {}).items():
            row = gauges.setdefault(name, {"per_source": {}})
            row["per_source"][src] = v
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                row["min"] = min(row.get("min", v), v)
                row["max"] = max(row.get("max", v), v)
                row["sum"] = row.get("sum", 0) + v
        for name in (snap.get("histograms") or {}):
            hist_names.setdefault(name, []).append(src)
    histograms = {
        name: merge_histograms(
            snapshots[src]["histograms"][name] for src in srcs)
        for name, srcs in hist_names.items()}
    return {
        "schema": SCHEMA,
        "sources": sources,
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
    }
