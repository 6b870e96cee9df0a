"""Calibration health: per-stage predicted-against-actual drift (JAX
package: racon_tpu/obs/calhealth.py).

Each calibrated stage prices its work before it dispatches it: the
align ladder and the POA split at the rates of ``utils/calibrate.py``.
This module folds each dispatch's (predicted wall, actual wall) into

    ratio = actual_s / predicted_s

kept three ways in the registry:

* ``calhealth_ratio.<stage>`` -- histogram of the ratios;
* ``calhealth_ewma.<stage>``  -- gauge, exponentially weighted moving
  average (alpha 0.2);
* ``calhealth_n.<stage>``     -- counter of observations.

The device stages (``align_wfa``, ``align_band``, ``poa``) compare with
the rates that priced the split.  The host stages (``host.parse``,
``host.bp_decode``, ``host.fragment``, ``host.stitch``) have no stored
rate: :func:`observe_units` learns a per-unit rate in process, so their
drift reads how unstable the stage's own throughput is.  A stage whose
EWMA leaves :data:`DRIFT_BAND` is flagged ``drift: true`` in
:func:`summary`.  Nothing here feeds control flow.
"""

from __future__ import annotations

import threading

from racon_tpu_torch.obs.metrics import REGISTRY, hist_quantile

#: calibration stages tracked (render order; the JAX package's list,
#: so the two summaries compare stage for stage)
STAGES = ("align_wfa", "align_band", "poa",
          "host.parse", "host.map", "host.bp_decode",
          "host.fragment", "host.stitch")

#: advisory healthy band for the EWMA ratio (actual/predicted)
DRIFT_BAND = (0.5, 2.0)

#: EWMA smoothing factor (~ last 5 observations dominate)
EWMA_ALPHA = 0.2

RATIO_PREFIX = "calhealth_ratio."
EWMA_PREFIX = "calhealth_ewma."

_lock = threading.Lock()
_ewma: dict = {}        # stage -> smoothed ratio
_unit_rate: dict = {}   # stage -> learned seconds-per-unit (host)


def observe(stage: str, predicted_s: float, actual_s: float,
            registry=None) -> None:
    """Fold one (predicted, actual) wall pair into ``stage``'s drift
    state.  Pairs with a non-positive prediction are dropped (a zero
    prediction means the pricing model never saw the stage: there is
    no ratio to attribute).  ``registry`` defaults to the process
    registry; per-run child registries propagate there anyway."""
    try:
        predicted_s = float(predicted_s)
        actual_s = float(actual_s)
    except (TypeError, ValueError):
        return
    if predicted_s <= 0.0 or actual_s < 0.0:
        return
    ratio = actual_s / predicted_s
    with _lock:
        prev = _ewma.get(stage)
        ew = ratio if prev is None else \
            prev + EWMA_ALPHA * (ratio - prev)
        _ewma[stage] = ew
    reg = registry if registry is not None else REGISTRY
    reg.observe(RATIO_PREFIX + stage, ratio)
    reg.set(EWMA_PREFIX + stage, round(ew, 6))
    reg.add("calhealth_n." + stage)


def observe_units(stage: str, units: float, actual_s: float,
                  registry=None) -> None:
    """Drift for a stage with no calibrate rate (the host stages):
    predict from an in-process EWMA of the stage's own measured
    per-unit rate, then fold the ratio.  The first sample seeds the
    rate, so it scores ratio 1.0 by construction."""
    try:
        units = float(units)
        actual_s = float(actual_s)
    except (TypeError, ValueError):
        return
    if units <= 0.0 or actual_s < 0.0:
        return
    measured = actual_s / units
    with _lock:
        rate = _unit_rate.get(stage)
        if rate is None or rate <= 0.0:
            rate = measured
        _unit_rate[stage] = rate + EWMA_ALPHA * (measured - rate)
    observe(stage, units * rate, actual_s, registry=registry)


def _ewma_from_gauge(v):
    """A gauge value from a plain snapshot (a number) or a fleet-merged
    one (``{"per_source": .., "min": .., "max": .., "sum": ..}``) as one
    EWMA: the mean over the sources when merged."""
    if isinstance(v, dict):
        per = [x for x in (v.get("per_source") or {}).values()
               if isinstance(x, (int, float))]
        return sum(per) / len(per) if per else None
    return float(v) if isinstance(v, (int, float)) else None


def summary(snapshot: dict = None) -> dict:
    """Per-stage drift document (the run report's ``calhealth``, the
    fleet view's)::

        {"band": [0.5, 2.0],
         "stages": {stage: {"n": .., "ewma": .., "p50": .., "p99": ..,
                            "min": .., "max": .., "drift": bool}}}

    Works on the live process registry (default), any
    ``Registry.snapshot()``, or an ``aggregate.merge_snapshots``
    document (merged histograms keep the single-snapshot shape; a merged
    EWMA gauge reads as its sources' mean).  Stages with no
    observations are omitted."""
    snap = snapshot if snapshot is not None else REGISTRY.snapshot()
    hists = snap.get("histograms") or {}
    gauges = snap.get("gauges") or {}
    stages: dict = {}
    names = list(STAGES) + sorted(
        n[len(RATIO_PREFIX):] for n in hists
        if n.startswith(RATIO_PREFIX)
        and n[len(RATIO_PREFIX):] not in STAGES)
    for stage in names:
        h = hists.get(RATIO_PREFIX + stage)
        if not h or not h.get("count"):
            continue
        ew = _ewma_from_gauge(gauges.get(EWMA_PREFIX + stage))
        # a snapshot without the gauge: the histogram mean
        ew = float(h["sum"]) / h["count"] if ew is None else ew
        row = {"n": int(h["count"]), "ewma": round(ew, 6),
               "p50": round(hist_quantile(h, 0.50), 6),
               "p99": round(hist_quantile(h, 0.99), 6),
               "min": round(float(h["min"]), 6),
               "max": round(float(h["max"]), 6),
               "drift": not (DRIFT_BAND[0] <= ew <= DRIFT_BAND[1])}
        stages[stage] = row
    return {"band": list(DRIFT_BAND), "stages": stages}


def stage_ewma(snapshot: dict, stage: str):
    """The EWMA drift ratio of ``stage`` in any snapshot form, or
    None."""
    row = summary(snapshot).get("stages", {}).get(stage)
    return row.get("ewma") if row else None


def reset() -> None:
    """Forget every stage's smoothed state (the registry keeps its
    values)."""
    with _lock:
        _ewma.clear()
        _unit_rate.clear()


def reset_stage(stage: str) -> None:
    """Forget one stage's smoothed state: after a drift epoch's
    recalibration the next observation re-seeds the EWMA, so the drift
    flag measures the new rates (serve/scheduler.py)."""
    with _lock:
        _ewma.pop(stage, None)
        _unit_rate.pop(stage, None)
