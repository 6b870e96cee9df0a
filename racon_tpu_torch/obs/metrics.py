"""Run-wide metrics registry: counters, gauges, histograms (JAX
package: racon_tpu/obs/metrics.py).

One process-global :data:`REGISTRY` plus per-run child registries (each
polisher owns one): every write to a child also propagates to its
parent, so a process that polishes more than once reads per-run numbers
from the polisher's registry and process totals from the global one.

Only the writers mutate state; readers get plain numbers and
JSON-serializable dicts.  Nothing here feeds control flow.
"""

from __future__ import annotations

import bisect
import threading
from contextlib import contextmanager
from typing import Dict, Optional

#: histogram bucket upper bounds shared by every histogram: 4 per decade
#: over 1e-4 .. 1e4, never derived from observed data, and the JAX
#: package's ladder exactly, so the two packages' histograms compare
#: bucket for bucket.  Values past the last bound go to the implicit
#: +Inf overflow bucket.
HIST_BUCKETS = tuple(round(10.0 ** (e / 4.0), 10)
                     for e in range(-16, 17))


def hist_quantile(hist: dict, q: float):
    """Quantile estimate from a bucketed histogram snapshot entry: the
    bucket holding the q-quantile observation, log-interpolated, clamped
    to the exact observed ``[min, max]``.  None for an empty
    histogram."""
    count = hist.get("count", 0)
    if not count:
        return None
    buckets = hist.get("buckets")
    lo, hi = hist.get("min", 0.0), hist.get("max", 0.0)
    if not buckets:
        return lo if q <= 0 else hi
    # bucket keys are ints in a live registry, strings after JSON
    counts = {int(k): v for k, v in buckets.items()}
    rank = q * count
    seen = 0.0
    for idx in sorted(counts):
        seen += counts[idx]
        if seen >= rank:
            b_hi = HIST_BUCKETS[idx] if idx < len(HIST_BUCKETS) else hi
            b_lo = HIST_BUCKETS[idx - 1] if idx > 0 else lo
            est = (b_lo * b_hi) ** 0.5 if b_lo > 0 and b_hi > 0 \
                else b_hi
            return min(max(est, lo), hi)
    return hi


class Registry:
    """Thread-safe metrics store.

    * ``add(name, v)``     counter: accumulate (default +1)
    * ``set(name, v)``     gauge: overwrite
    * ``peak(name, v)``    gauge: keep the maximum (high-water mark)
    * ``observe(name, v)`` histogram: count/sum/min/max and the fixed
                           buckets of :data:`HIST_BUCKETS`
    * ``zero(name)``       counter: back to 0
    * ``value(name)``      read a counter or gauge
    * ``timer(name)``      context manager adding elapsed seconds to the
                           counter ``name``
    * ``snapshot()``       JSON-serializable dict of everything
    """

    def __init__(self, parent: Optional["Registry"] = None):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, float]] = {}
        self.parent = parent

    def add(self, name: str, value=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value
        if self.parent is not None:
            self.parent.add(name, value)

    def set(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value
        if self.parent is not None:
            self.parent.set(name, value)

    def set_local(self, name: str, value) -> None:
        """Gauge write that does not reach the parent: a per-job view
        of a process-wide counter (the serve tier's per-job deltas of
        kernel builds and loads) must not overwrite the process
        total."""
        with self._lock:
            self._gauges[name] = value

    def zero(self, name: str) -> None:
        """Set the counter ``name`` back to 0, here only."""
        with self._lock:
            if name in self._counters:
                self._counters[name] = 0

    def peak(self, name: str, value) -> None:
        with self._lock:
            if value > self._gauges.get(name, value - 1):
                self._gauges[name] = value
        if self.parent is not None:
            self.parent.peak(name, value)

    def observe(self, name: str, value) -> None:
        v = float(value)
        # bucket index: first bound >= v; past the end = +Inf overflow
        idx = bisect.bisect_left(HIST_BUCKETS, v)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = {
                    "count": 0, "sum": 0.0,
                    "min": v, "max": v, "buckets": {}}
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)
            h["buckets"][idx] = h["buckets"].get(idx, 0) + 1
        if self.parent is not None:
            self.parent.observe(name, value)

    @contextmanager
    def timer(self, name: str):
        from racon_tpu_torch.obs.trace import now

        t0 = now()
        try:
            yield
        finally:
            self.add(name, now() - t0)

    def value(self, name: str, default=0):
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, default)

    def snapshot(self) -> dict:
        with self._lock:
            hists = {}
            for k, v in self._hists.items():
                h = dict(v)
                # string bucket keys: the snapshot survives a JSON round
                # trip unchanged
                h["buckets"] = {str(i): n for i, n in v["buckets"].items()}
                hists[k] = h
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": hists}


class MetricAttr:
    """Class attribute backed by the instance's per-run registry:
    ``obj.<attr>`` reads ``obj.metrics.value(name)`` and assignment (so
    ``+=`` too) writes through ``obj.metrics.set``, so the polisher's
    counters and the ``--metrics-json`` report cannot disagree."""

    def __init__(self, name: str):
        self.name = name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return obj.metrics.value(self.name)

    def __set__(self, obj, value):
        obj.metrics.set(self.name, value)


#: process-wide registry (parent of every per-run registry)
REGISTRY = Registry()
