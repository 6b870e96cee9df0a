"""Thread-safe span tracer writing Chrome trace-event JSON (JAX package:
racon_tpu/obs/trace.py).

Spans are complete (``"ph": "X"``) events with microsecond timestamps
from a process-wide monotonic epoch, on the recording thread's track,
so nested ``with span(...)`` blocks render as a flame graph per thread
in Perfetto or ``chrome://tracing``.  Device dispatches go to a virtual
``device`` lane (``lane="device"``): on the card their intervals are
CUDA events mapped onto this clock (``racon_tpu_torch/cuda/devclock.py``),
on the CPU the plain versions' host intervals.

Tracing is off by default and then costs one attribute test per span;
:func:`enable_trace` (the CLI's ``--trace PATH``) or
``RACON_TPU_TORCH_TRACE=PATH`` turns it on.  :func:`write_trace` writes
the buffer; recording never touches the filesystem.  The serve daemon
turns on the job capture instead (:meth:`Tracer.enable_job_capture`): a
bounded per-job index of every event tagged with a job, which
``submit --trace`` and the ``trace_query`` op read, with no trace file
and no growth of the full buffer.

Timestamps feed only the trace and the metrics, never control flow.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext

from racon_tpu_torch.obs.context import tag_args as _tag_args

#: the one clock for timing in racon_tpu_torch (the timing lint in
#: tests/test_torch_obs.py holds the package to it)
now = time.monotonic
#: wall clock, for records another process reads (the serve tier's
#: journal, a daemon's identity); never for durations
wall_now = time.time

_EPOCH = time.monotonic()

TRACE_ENV = "RACON_TPU_TORCH_TRACE"


def _us(t: float) -> float:
    return (t - _EPOCH) * 1e6


def epoch_offset(t: float) -> float:
    """Seconds since the trace epoch: the timebase shared by trace
    ``ts`` values and flight and decision events."""
    return t - _EPOCH


def epoch_wall() -> float:
    """Wall-clock time of the trace epoch: ``epoch_wall() +
    epoch_offset(t)`` lifts a trace or flight timestamp onto the wall
    clock.  Forensics only."""
    return wall_now() - (now() - _EPOCH)


class Tracer:
    # virtual lanes get tids above this floor, so they sort after the
    # real threads in Perfetto's track list
    _LANE_TID0 = 1 << 20
    # the per-job index: events kept per job, jobs kept (oldest evicted)
    _JOB_SPANS = 2048
    _JOB_MAX = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list = []
        self._enabled = False
        self._path = None
        self._pid = os.getpid()
        self._tids: dict = {}        # thread ident -> small tid
        self._lanes: dict = {}       # lane name -> virtual tid
        self._job_capture = False
        self._by_job: OrderedDict = OrderedDict()  # job -> deque(ev)
        self._evicted = 0

    @property
    def enabled(self) -> bool:
        return self._enabled or bool(os.environ.get(TRACE_ENV))

    @property
    def capturing(self) -> bool:
        """True when events are recorded at all: a trace file or the
        per-job index; callers that build costly ``args`` test it
        first."""
        return self._job_capture or self.enabled

    def enable(self, path: str) -> None:
        self._enabled = True
        self._path = path

    def enable_job_capture(self) -> None:
        """Keep a bounded slice of every job-tagged event, trace file or
        not (the serve daemon's ``submit --trace`` source)."""
        self._job_capture = True

    def disable(self) -> None:
        """Stop recording into the buffer (``RACON_TPU_TORCH_TRACE``
        still turns it on)."""
        self._enabled = False
        self._path = None

    def out_path(self):
        return self._path or os.environ.get(TRACE_ENV) or None

    def _name_track(self, tid: int, name: str) -> None:
        # only the trace file needs track names; the job capture alone
        # must not grow the full buffer
        if self.enabled:
            self._events.append({"name": "thread_name", "ph": "M",
                                 "pid": self._pid, "tid": tid,
                                 "args": {"name": name}})

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids) + 1
                self._name_track(tid, threading.current_thread().name)
        return tid

    def _lane_tid(self, lane: str) -> int:
        with self._lock:
            tid = self._lanes.get(lane)
            if tid is None:
                tid = self._lanes[lane] = self._LANE_TID0 + len(self._lanes)
                self._name_track(tid, lane)
        return tid

    @staticmethod
    def _args(args, jobs):
        """``args`` tagged with the job context, and with ``jobs`` (the
        job ids an event spans, as a fused dispatch does) unless they
        name their own."""
        args = _tag_args(args)
        if jobs:
            args = {"jobs": [int(j) for j in jobs], **(args or {})}
        return args

    @staticmethod
    def _jobs_of(args):
        """The job ids an event is indexed under: its ``jobs`` list (a
        fused dispatch spans several), else its context ``job``."""
        if not args:
            return None
        if "jobs" in args:
            return args["jobs"]
        if "job" in args:
            return [int(args["job"])]
        return None

    def _store(self, ev: dict) -> None:
        """Append to the full buffer (tracing on) and to the per-job
        index (job capture on)."""
        jobs = self._jobs_of(ev.get("args")) if self._job_capture else None
        with self._lock:
            if self.enabled:
                self._events.append(ev)
            for j in jobs or ():
                dq = self._by_job.get(j)
                if dq is None:
                    dq = self._by_job[j] = deque(maxlen=self._JOB_SPANS)
                    while len(self._by_job) > self._JOB_MAX:
                        self._by_job.popitem(last=False)
                        self._evicted += 1
                dq.append(ev)

    def _wanted(self, args) -> bool:
        """Whether an event with these (tagged) ``args`` is kept."""
        return self.enabled or (self._job_capture
                                and self._jobs_of(args) is not None)

    def add_span(self, name: str, t0: float, t1: float, cat: str = "host",
                 lane: str = None, args: dict = None,
                 jobs: list = None) -> None:
        """Record an already measured ``[t0, t1]`` interval (seconds on
        :func:`now`'s clock), on ``lane`` or the calling thread's
        track."""
        if not self.capturing:
            return
        args = self._args(args, jobs)
        if not self._wanted(args):
            return
        tid = self._lane_tid(lane) if lane else self._tid()
        ev = {"name": name, "ph": "X", "cat": cat, "pid": self._pid,
              "tid": tid, "ts": _us(t0), "dur": max(0.0, (t1 - t0) * 1e6)}
        if args:
            ev["args"] = args
        self._store(ev)

    def add_instant(self, name: str, cat: str = "host",
                    args: dict = None, jobs: list = None) -> None:
        if not self.capturing:
            return
        args = self._args(args, jobs)
        if not self._wanted(args):
            return
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat,
              "pid": self._pid, "tid": self._tid(), "ts": _us(now())}
        if args:
            ev["args"] = args
        self._store(ev)

    def add_flow(self, name: str, flow_id: int, phase: str,
                 cat: str = "fuse", lane: str = None, t: float = None,
                 args: dict = None, jobs: list = None) -> None:
        """Chrome flow event: ``phase`` "s" (start), "t" (step) or "f"
        (finish); one ``flow_id`` links the arrows.  The device
        executor ties a unit's submit to the fused dispatch it rode.
        ``bp: "e"`` binds a finish to the enclosing span, so the arrow
        lands on the dispatch span itself."""
        if not self.capturing:
            return
        args = self._args(args, jobs)
        if not self._wanted(args):
            return
        tid = self._lane_tid(lane) if lane else self._tid()
        ev = {"name": name, "ph": phase, "cat": cat, "pid": self._pid,
              "tid": tid, "id": int(flow_id),
              "ts": _us(t if t is not None else now())}
        if phase == "f":
            ev["bp"] = "e"
        if args:
            ev["args"] = args
        self._store(ev)

    def job_slice(self, job_id) -> list:
        """The per-job index's events of ``job_id``, oldest first
        (empty when unknown or evicted)."""
        with self._lock:
            dq = self._by_job.get(int(job_id))
            evs = [dict(ev) for ev in dq] if dq else []
        evs.sort(key=lambda ev: ev.get("ts", 0.0))
        return evs

    def capture_stats(self) -> dict:
        """Depth and eviction counters of the per-job index."""
        with self._lock:
            return {"job_capture": self._job_capture,
                    "jobs": len(self._by_job), "max_jobs": self._JOB_MAX,
                    "spans_per_job": self._JOB_SPANS,
                    "evicted": self._evicted}

    def write(self, path: str = None) -> str:
        """Write the buffer as Chrome trace-event JSON (atomic replace);
        returns the path written."""
        path = path or self.out_path()
        if not path:
            raise ValueError("no trace output path configured")
        with self._lock:
            events = list(self._events)
        doc = {"traceEvents": [{"name": "process_name", "ph": "M",
                                "pid": self._pid, "tid": 0,
                                "args": {"name": "racon-tpu-torch"}}]
               + events,
               "displayTimeUnit": "ms"}
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tids.clear()
            self._lanes.clear()
            self._by_job.clear()
            self._evicted = 0


TRACER = Tracer()


def enable_trace(path: str) -> None:
    """Turn tracing on for this process, writing to ``path``."""
    TRACER.enable(path)


def write_trace(path: str = None) -> str:
    return TRACER.write(path)


@contextmanager
def span(name: str, cat: str = "host", args: dict = None,
         metric: str = None, registry=None):
    """Trace span around a block; with ``metric`` the elapsed seconds
    also accumulate into ``registry`` (default: the global registry),
    whether or not tracing is on."""
    timed = metric is not None or TRACER.capturing
    t0 = now() if timed else 0.0
    try:
        yield
    finally:
        if timed:
            t1 = now()
            if metric is not None:
                if registry is None:
                    from racon_tpu_torch.obs.metrics import REGISTRY \
                        as registry
                registry.add(metric, t1 - t0)
            TRACER.add_span(name, t0, t1, cat=cat, args=args)


@contextmanager
def device_span(name: str, args: dict = None, device=None):
    """Span for a stage that runs on the device: the host span, and on a
    ``cuda`` device an NVTX range of the same name, so a device profile
    carries the host trace's names (the reference's nvprof ranges,
    src/cuda/cudapolisher.cpp:66-70).  A CPU build of torch has no
    NVTX, so a ``cpu`` run enters none."""
    ann = nullcontext()
    if device is not None and getattr(device, "type", device) == "cuda":
        import torch

        ann = torch.cuda.nvtx.range(name)
    t0 = now()
    try:
        with ann:
            yield
    finally:
        TRACER.add_span(name, t0, now(), cat="device_stage", args=args)
