"""Decision records: why each unit of work ran where it did (JAX
package: racon_tpu/obs/decision.py).

Every placement decision of the pipeline is a small structured event in
a bounded ring, tagged with the active job context.  Kinds the port
writes (fields beyond the envelope at the call sites):

* ``align_split``   -- the align stage's device/CPU cut and its rates
* ``align_chunk``   -- one ladder dispatch: engine, rung, pairs,
  predicted and measured wall
* ``align_retry``   -- pairs a rung left for a later rung
* ``align_cpu_fallthrough`` -- pairs the last rung left for the CPU
* ``poa_split``     -- the POA stage's device/CPU cut and its rates
* ``poa_reject``    -- a window the POA kernel rejected, by fail code
* ``unit_retry``    -- the device executor retried a unit alone, on the
  card, after the fused dispatch it rode failed (also a flight event)

Envelope (as the flight recorder's)::

    {"seq": 91, "t": 3.20154, "kind": "align_chunk", ...}

:data:`ENABLED` and :data:`RING` are module constants (tests patch
them).  Records feed only observability, never control flow.
"""

from __future__ import annotations

import threading
from collections import deque

from racon_tpu_torch.obs import context as _context
from racon_tpu_torch.obs import trace as _trace

#: recording on; a test may patch it off
ENABLED = True
#: ring capacity in events
RING = 2048


class DecisionRecorder:
    """Bounded, thread-safe ring of decision events; :meth:`record` does
    one deque append under the lock."""

    def __init__(self, maxlen: int = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, maxlen or RING))
        self._seq = 0
        self._dropped = 0

    def record(self, kind: str, job=None, tenant=None, **fields) -> None:
        """Append one event.  ``job``/``tenant``/``trace_id`` default
        from the active job context; ``None`` fields are dropped."""
        if not ENABLED:
            return
        ctx = _context.current()
        if ctx is not None:
            if job is None:
                job = ctx.job_id
            if tenant is None:
                tenant = ctx.tenant
            if fields.get("trace_id") is None:
                fields["trace_id"] = ctx.trace_id
        ev = {"kind": kind,
              "t": round(_trace.epoch_offset(_trace.now()), 6)}
        if job is not None:
            ev["job"] = int(job)
        if tenant is not None:
            ev["tenant"] = str(tenant)
        for k, v in fields.items():
            if v is not None:
                ev[k] = v
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(ev)

    def snapshot(self, job=None, last: int = 0) -> list:
        """Copies of the ring's events, oldest first, filtered to one
        job; ``last`` keeps the newest N."""
        with self._lock:
            evs = [dict(ev) for ev in self._ring]
        if job is not None:
            evs = [ev for ev in evs if ev.get("job") == int(job)]
        if last and last > 0:
            evs = evs[-last:]
        return evs

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": ENABLED, "size": len(self._ring),
                    "capacity": self._ring.maxlen,
                    "recorded": self._seq, "dropped": self._dropped}


DECISIONS = DecisionRecorder()
