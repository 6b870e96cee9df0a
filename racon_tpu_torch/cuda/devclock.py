"""Device lanes: each kernel dispatch's interval on the obs clock.

A :class:`DispatchTimer` marks a dispatch: around the launch, and in the
POA wrapper after each pass.  On the card a mark is a CUDA event on the
current stream; :meth:`DispatchTimer.kernel_ms` is the event time from
the first mark to the last, and each interval between two marks maps
onto the obs clock through the device's anchor: :func:`anchor` records
an event, synchronizes, and reads ``obs.now()`` beside it, and an event
``ev`` is then at ``t_anchor + anchor.elapsed_time(ev) / 1e3``.  Any
anchor of the device maps every event (a polisher re-anchors only to
keep the two clocks' drift short).  On the CPU a mark is an
``obs.now()`` read around the plain version, so the tests drive the
same plumbing.

Each mark also reads the host clock (``obs.now()``) as it is made, and
:meth:`DispatchTimer.record` reads it again: an interval on the card
can start no earlier than its mark was made and end no later than it
is recorded.  The lane span carries both host times (``launch_ts``,
``collect_ts``, in the trace's microseconds), so a reader of the trace
can hold the mapping to them.

The intervals are read at collect (:meth:`DispatchTimer.record`), where
the dispatch's outputs have already come back, so the launch path gains
no synchronize.  Each interval becomes a span of the trace's ``device``
lane and an interval of the timer's ``DeviceUtil`` (a polisher's own,
else ``obs.DEVICE_UTIL``); both feed only observability.
"""

from __future__ import annotations

import threading

import torch

from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.obs.devutil import DEVICE_UTIL

_lock = threading.Lock()
#: device index -> (anchor event, obs time beside it)
_anchors: dict = {}


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def anchor(device) -> None:
    """Record the run's anchor on the card ``device``: one event, one
    synchronize, and the obs clock read beside it."""
    device = torch.device(device)
    ev = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        ev.record()
    ev.synchronize()
    with _lock:
        _anchors[_index(device)] = (ev, obs_trace.now())


def _anchor_of(device: torch.device):
    with _lock:
        a = _anchors.get(_index(device))
    if a is None:
        anchor(device)
        with _lock:
            a = _anchors[_index(device)]
    return a


class DispatchTimer:
    """Marks of one dispatch on ``device`` (see the module docstring);
    its intervals go to ``util`` (default ``obs.DEVICE_UTIL``)."""

    def __init__(self, device, util=None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.util = DEVICE_UTIL if util is None else util
        #: CUDA events on the card (empty on the CPU)
        self.marks: list = []
        #: the obs clock as each mark was made
        self.host: list = []
        self._spans = None
        if self.cuda:
            # a dispatch outside a polisher anchors here, before its
            # first event
            _anchor_of(self.device)

    def mark(self) -> None:
        self.host.append(obs_trace.now())
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)

    def kernel_ms(self) -> float:
        """CUDA-event time from the first mark to the last (0 on the
        CPU); valid once the dispatch's outputs have come back."""
        if len(self.marks) < 2:
            return 0.0
        return self.marks[0].elapsed_time(self.marks[-1])

    def spans(self) -> list:
        """``[(t0, t1), ...]`` on the obs clock, one per pair of
        consecutive marks."""
        if self._spans is None:
            if self.cuda:
                ev0, t_a = _anchor_of(self.device)
                ts = [t_a + ev0.elapsed_time(ev) / 1e3 for ev in self.marks]
            else:
                ts = list(self.host)
            self._spans = list(zip(ts, ts[1:]))
        return self._spans

    def device_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.spans())

    def record(self, name: str, engine: str, args: dict = None) -> None:
        """Each interval as a ``device`` lane span named ``name``, with
        the host times of its first mark and of this call, and an
        interval of ``engine`` in the timer's ``DeviceUtil``."""
        spans = self.spans()
        collect_ts = obs_trace.epoch_offset(obs_trace.now()) * 1e6
        for k, (t0, t1) in enumerate(spans):
            a = {**(args or {}),
                 "launch_ts": obs_trace.epoch_offset(self.host[k]) * 1e6,
                 "collect_ts": collect_ts}
            if len(spans) > 1:
                a["pass"] = k + 1
            obs_trace.TRACER.add_span(name, t0, t1, cat="device",
                                      lane="device", args=a)
            self.util.record(engine, t0, t1)
