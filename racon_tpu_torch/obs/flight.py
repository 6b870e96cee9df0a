"""Flight recorder: the last N structured events, cheap enough to leave
on (JAX package: racon_tpu/obs/flight.py).

A bounded ring of events appended O(1) under one lock, with no
filesystem and no clock-driven control flow on the hot path.  The
one-shot CLI records ``run`` at its start and ``run_done`` at its end,
and writes the ring to ``RACON_TPU_TORCH_FLIGHT_DUMP`` when that is set:
at the end of the run, and from the crash hooks on an unhandled
exception.  A dump carries the decision ring too (obs/decision.py), so a
post-mortem sees the placements that led up to the failure.

Envelope::

    {"seq": 412, "t": 17.003215, "kind": "run", ...}

Kinds beyond ``run`` / ``run_done`` / ``crash``: the device executor
records ``cache_hit`` (a submission the result cache served in part or
whole: kind, hits, misses, items), ``fused_dispatch`` (one shared
dispatch: kind, units, items, occupancy, tenants, jobs) and
``unit_retry`` (a unit retried alone after its fused dispatch failed:
kind, tenant, items, jobs, error).

``t`` is seconds since the trace epoch (obs/trace.py), so flight events
and trace spans share one timebase.  :data:`ENABLED` and :data:`RING`
are module constants (tests patch them).  Recording feeds only
observability, never control flow.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import traceback
from collections import deque

from racon_tpu_torch.obs import context as _context
from racon_tpu_torch.obs import decision as _decision
from racon_tpu_torch.obs import trace as _trace

SCHEMA = "racon-tpu-torch-flight-v1"

#: recording on; a test may patch it off
ENABLED = True
#: ring capacity in events
RING = 4096
#: bytes of traceback kept per error event
TB_LIMIT = 8000
#: the dump path's environment variable (the CLI reads it)
DUMP_ENV = "RACON_TPU_TORCH_FLIGHT_DUMP"


def default_dump_path() -> str:
    """Where a dump with no configured path lands: ``DUMP_ENV``, else
    ``racon-tpu-torch-flight-<pid>.json`` in the temporary directory
    (the serve daemon's dump at exit and on a crash)."""
    return (os.environ.get(DUMP_ENV)
            or os.path.join(tempfile.gettempdir(),
                            f"racon-tpu-torch-flight-{os.getpid()}.json"))


class FlightRecorder:
    """Bounded, thread-safe ring of structured events."""

    def __init__(self, maxlen: int = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, maxlen or RING))
        self._seq = 0
        self._dropped = 0
        self._hooks_installed = False

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

    def record_exception(self, kind: str, exc: BaseException,
                         **fields) -> None:
        """An error event carrying a size-bounded traceback."""
        tb = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))
        self.record(kind, error=f"{type(exc).__name__}: {exc}",
                    traceback=tb[-TB_LIMIT:], **fields)

    def snapshot(self, job=None, last: int = 0, job_key: str = None,
                 trace_id: str = None) -> list:
        """Copies of the ring's events, oldest first, filtered to one
        job (its own events and the fused dispatches that carried it),
        to an idempotence key (an event whose ``job_key``, ``key`` or
        ``winner_key`` equals it or derives from it as a shard,
        ``<key>-shard-...``, so one query sees a scattered job's whole
        family) or to a trace id; ``last`` keeps the newest N."""
        with self._lock:
            evs = [dict(ev) for ev in self._ring]
        if job is not None:
            job = int(job)
            evs = [ev for ev in evs
                   if ev.get("job") == job or job in ev.get("jobs", ())]
        if job_key is not None:
            shard = job_key + "-shard-"
            evs = [ev for ev in evs if any(
                isinstance(ev.get(f), str)
                and (ev[f] == job_key or ev[f].startswith(shard))
                for f in ("job_key", "key", "winner_key"))]
        if trace_id is not None:
            evs = [ev for ev in evs if ev.get("trace_id") == trace_id]
        if last and last > 0:
            evs = evs[-last:]
        return evs

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": ENABLED, "size": len(self._ring),
                    "capacity": self._ring.maxlen,
                    "recorded": self._seq, "dropped": self._dropped}

    def dump(self, path: str = None, reason: str = "manual") -> str:
        """Write the ring and the decision ring to ``path`` (default
        :func:`default_dump_path`; atomic replace) as one JSON document;
        returns the path."""
        path = path or default_dump_path()
        doc = {"schema": SCHEMA, "pid": os.getpid(), "reason": reason,
               "ring": self.stats(), "events": self.snapshot(),
               "decisions": {"ring": _decision.DECISIONS.stats(),
                             "events": _decision.DECISIONS.snapshot()}}
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path

    def install_dump_on_crash(self, path: str = None) -> None:
        """Chain ``sys.excepthook`` and ``threading.excepthook`` so an
        unhandled exception in any thread dumps the ring to ``path``
        before the previous hook runs.  Idempotent."""
        if self._hooks_installed:
            return
        self._hooks_installed = True

        def _dump(exc):
            # a hook that raised would hide the exception being reported
            try:
                self.record_exception("crash", exc)
                print(f"[racon_tpu_torch::] flight dump: "
                      f"{self.dump(path, reason='crash')}",
                      file=sys.stderr)
            except Exception as dump_exc:
                print(f"[racon_tpu_torch::] flight dump failed: "
                      f"{dump_exc!r}", file=sys.stderr)

        prev_sys = sys.excepthook

        def _sys_hook(tp, val, tb):
            _dump(val)
            prev_sys(tp, val, tb)

        sys.excepthook = _sys_hook
        prev_thr = threading.excepthook

        def _thr_hook(hook_args):
            if hook_args.exc_value is not None:
                _dump(hook_args.exc_value)
            prev_thr(hook_args)

        threading.excepthook = _thr_hook


FLIGHT = FlightRecorder()


def load_dump(path: str) -> dict:
    """Parse a flight dump, checking the schema marker."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a flight dump "
                         f"(schema={doc.get('schema')!r})")
    return doc
