"""Stage timing and progress logging (reference: src/logger.{hpp,cpp}).

Same observable behaviour as racon's Logger: ``log()`` (re)starts a stage
timer, ``log(msg)`` prints the elapsed stage seconds to stderr, ``bar``
renders a 20-bin progress bar, and ``total`` prints the cumulative wall
clock.  One re-entrant lock serializes the three, so pool threads can
log without corrupting the bar.  As in the JAX package's logger
(racon_tpu/utils/logger.py), every ``log(msg)`` and ``total`` line is
also a trace instant, the run total is the ``logger_total_s`` gauge,
and a line written under an active job context (obs/context.py) gets a
``[job N/tenant] `` prefix; with no context the stderr format is the
reference's byte for byte.
"""

from __future__ import annotations

import sys
import threading
import time

from racon_tpu_torch.obs import context as obs_context
from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.obs.metrics import REGISTRY


def _ctx_prefix() -> str:
    """``"[job 17/tenantA] "`` under an active job context, else
    ``""``."""
    ctx = obs_context.current()
    return "" if ctx is None else f"[job {ctx.job_id}/{ctx.tenant}] "


class Logger:
    def __init__(self):
        self._time = 0.0
        self._start = time.monotonic()
        self._bar_state = 0
        self._lock = threading.RLock()

    def log(self, message: str | None = None) -> None:
        with self._lock:
            now = time.monotonic()
            if message is None:
                self._start = now
                return
            elapsed = now - self._start
            self._time += elapsed
            print(f"{_ctx_prefix()}{message} {elapsed:.6f} s",
                  file=sys.stderr)
            self._start = now
        obs_trace.TRACER.add_instant(message, cat="log")

    def bar(self, message: str) -> None:
        with self._lock:
            self._bar_state += 1
            percent = self._bar_state * 5
            bar = "=" * self._bar_state + ">" + " " * (20 - self._bar_state)
            end = "\n" if self._bar_state == 20 else ""
            # \r redraw only on a terminal; piped stderr gets one final
            # line per bar
            try:
                tty = sys.stderr.isatty()
            except (AttributeError, ValueError):
                tty = False
            if tty or self._bar_state == 20:
                lead = "\r" if tty else ""
                print(f"{lead}{_ctx_prefix()}{message} [{bar}] {percent}%",
                      end=end, file=sys.stderr, flush=True)
            if self._bar_state == 20:
                now = time.monotonic()
                self._time += now - self._start
                self._start = now
                self._bar_state = 0

    def total(self, message: str) -> None:
        with self._lock:
            self._time += time.monotonic() - self._start
            total = self._time
            print(f"{_ctx_prefix()}{message} {total:.6f} s", file=sys.stderr)
        REGISTRY.set("logger_total_s", round(total, 6))
        obs_trace.TRACER.add_instant(message, cat="log")
