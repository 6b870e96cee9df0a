"""Per-engine device utilization from dispatch intervals (JAX package:
racon_tpu/obs/devutil.py).

Every device dispatch of the port records its ``[t0, t1]`` interval:
on the card the CUDA events around its kernel launch, mapped onto the
obs clock (racon_tpu_torch/cuda/devclock.py), on the CPU the plain
version's host interval.  This module folds them into per-engine totals:

* ``busy_s``    -- union length of the intervals (overlapping dispatches
  are not counted twice)
* ``horizon_s`` -- first dispatch start .. last completion
* ``idle_s``    -- horizon minus busy: time the engine left the card idle
* ``util``      -- busy / horizon

Engines are the device consumers: ``align_wfa``, ``align_band``,
``poa``, and the mapper's ``seed_words`` (recorded in the process
``DEVICE_UTIL``).  The merge is streaming (O(1) per interval): an engine's
dispatches run on one stream and complete in order, so each interval
only extends the frontier.  :meth:`DeviceUtil.publish` mirrors the
totals into a Registry as gauges for ``--metrics-json``.

Intervals feed only observability, never control flow.
"""

from __future__ import annotations

import threading
from typing import Dict


class DeviceUtil:
    """Thread-safe per-engine interval accumulator."""

    def __init__(self):
        self._lock = threading.Lock()
        # engine -> {"busy": s, "first": t0, "last": t1, "n": count}
        self._eng: Dict[str, Dict[str, float]] = {}

    def record(self, engine: str, t0: float, t1: float) -> None:
        """Fold one dispatch interval ``[t0, t1]`` (monotonic-clock
        seconds on the obs clock) into ``engine``'s totals."""
        if t1 < t0:
            t0, t1 = t1, t0
        with self._lock:
            e = self._eng.get(engine)
            if e is None:
                self._eng[engine] = {
                    "busy": t1 - t0, "first": t0, "last": t1, "n": 1}
                return
            # streaming union merge: count only time past the frontier
            e["busy"] += max(0.0, t1 - max(t0, e["last"]))
            e["last"] = max(e["last"], t1)
            e["first"] = min(e["first"], t0)
            e["n"] += 1

    def snapshot(self) -> dict:
        """``{engine: {busy_s, idle_s, horizon_s, util, n_dispatches}}``."""
        with self._lock:
            out = {}
            for name, e in self._eng.items():
                horizon = e["last"] - e["first"]
                busy = min(e["busy"], horizon) if horizon > 0 \
                    else e["busy"]
                out[name] = {
                    "busy_s": round(e["busy"], 6),
                    "idle_s": round(max(0.0, horizon - busy), 6),
                    "horizon_s": round(horizon, 6),
                    "util": round(busy / horizon, 6)
                    if horizon > 0 else 1.0,
                    "n_dispatches": int(e["n"]),
                }
            return out

    def publish(self, registry) -> dict:
        """Mirror the snapshot into ``registry`` as
        ``device_util.<engine>.{busy_s,idle_s,util,n_dispatches}``
        gauges and return it."""
        snap = self.snapshot()
        for engine, e in snap.items():
            base = f"device_util.{engine}"
            registry.set(f"{base}.busy_s", e["busy_s"])
            registry.set(f"{base}.idle_s", e["idle_s"])
            registry.set(f"{base}.util", e["util"])
            registry.set(f"{base}.n_dispatches", e["n_dispatches"])
        return snap

    def reset(self) -> None:
        with self._lock:
            self._eng.clear()


#: the process-wide accumulator: where a dispatch given no DeviceUtil
#: records (a polisher passes its own)
DEVICE_UTIL = DeviceUtil()
