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
the buffer; recording never touches the filesystem.

Timestamps feed only the trace and the metrics, never control flow.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext

from racon_tpu_torch.obs.context import tag_args as _tag_args

#: the one clock for timing in racon_tpu_torch (the timing lint in
#: tests/test_torch_obs.py holds the package to it)
now = time.monotonic

_EPOCH = time.monotonic()

TRACE_ENV = "RACON_TPU_TORCH_TRACE"


def _us(t: float) -> float:
    return (t - _EPOCH) * 1e6


def epoch_offset(t: float) -> float:
    """Seconds since the trace epoch: the timebase shared by trace
    ``ts`` values and flight and decision events."""
    return t - _EPOCH


class Tracer:
    # virtual lanes get tids above this floor, so they sort after the
    # real threads in Perfetto's track list
    _LANE_TID0 = 1 << 20

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list = []
        self._enabled = False
        self._path = None
        self._pid = os.getpid()
        self._tids: dict = {}        # thread ident -> small tid
        self._lanes: dict = {}       # lane name -> virtual tid

    @property
    def enabled(self) -> bool:
        return self._enabled or bool(os.environ.get(TRACE_ENV))

    @property
    def capturing(self) -> bool:
        """True when events are recorded at all.  Only the trace file
        records them in this package, so it equals :attr:`enabled`;
        callers that build costly ``args`` test it first."""
        return self.enabled

    def enable(self, path: str) -> None:
        self._enabled = True
        self._path = path

    def disable(self) -> None:
        """Stop recording into the buffer (``RACON_TPU_TORCH_TRACE``
        still turns it on)."""
        self._enabled = False
        self._path = None

    def out_path(self):
        return self._path or os.environ.get(TRACE_ENV) or None

    def _name_track(self, tid: int, name: str) -> None:
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

    def add_span(self, name: str, t0: float, t1: float, cat: str = "host",
                 lane: str = None, args: dict = None,
                 jobs: list = None) -> None:
        """Record an already measured ``[t0, t1]`` interval (seconds on
        :func:`now`'s clock), on ``lane`` or the calling thread's
        track."""
        if not self.enabled:
            return
        args = self._args(args, jobs)
        tid = self._lane_tid(lane) if lane else self._tid()
        ev = {"name": name, "ph": "X", "cat": cat, "pid": self._pid,
              "tid": tid, "ts": _us(t0), "dur": max(0.0, (t1 - t0) * 1e6)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_instant(self, name: str, cat: str = "host",
                    args: dict = None, jobs: list = None) -> None:
        if not self.enabled:
            return
        args = self._args(args, jobs)
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat,
              "pid": self._pid, "tid": self._tid(), "ts": _us(now())}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_flow(self, name: str, flow_id: int, phase: str,
                 cat: str = "fuse", lane: str = None, t: float = None,
                 args: dict = None, jobs: list = None) -> None:
        """Chrome flow event: ``phase`` "s" (start), "t" (step) or "f"
        (finish); one ``flow_id`` links the arrows.  The device
        executor ties a unit's submit to the fused dispatch it rode.
        ``bp: "e"`` binds a finish to the enclosing span, so the arrow
        lands on the dispatch span itself."""
        if not self.enabled:
            return
        args = self._args(args, jobs)
        tid = self._lane_tid(lane) if lane else self._tid()
        ev = {"name": name, "ph": phase, "cat": cat, "pid": self._pid,
              "tid": tid, "id": int(flow_id),
              "ts": _us(t if t is not None else now())}
        if phase == "f":
            ev["bp"] = "e"
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

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
    timed = metric is not None or TRACER.enabled
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
