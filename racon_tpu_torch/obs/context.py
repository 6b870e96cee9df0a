"""Request-scoped job context (JAX package: racon_tpu/obs/context.py).

A :mod:`contextvars` variable carrying ``(job_id, tenant, trace_id)``.
Code that runs one job's work enters it with :func:`job_context`, and
everything recorded on that thread -- trace spans and instants
(``obs/trace.py`` tags their ``args``), flight and decision events,
logger lines (``utils/logger.py`` prefixes them) -- names the job
without plumbing at the call sites.

The context is observability only: nothing in the polish reads it to
decide anything, so runs inside and outside a context give the same
bytes.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from contextvars import ContextVar
from typing import NamedTuple, Optional


class JobContext(NamedTuple):
    job_id: int
    tenant: str
    trace_id: str


_current: ContextVar = ContextVar("racon_tpu_torch_job_context",
                                  default=None)


def make_trace_id(job_id) -> str:
    """Deterministic per-process trace id: pid and job id."""
    return f"{os.getpid():08x}-{int(job_id):06d}"


def current() -> Optional[JobContext]:
    """The active job context on this thread (None outside a job)."""
    return _current.get()


@contextmanager
def job_context(job_id, tenant: str = "default", trace_id: str = None):
    """Enter a job's context for the calling thread.  Nests: an inner
    context shadows the outer one until it exits."""
    ctx = JobContext(int(job_id), str(tenant or "default"),
                     trace_id or make_trace_id(job_id))
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def tag_args(args: dict = None) -> Optional[dict]:
    """Merge the active context's identity into a trace ``args`` dict
    (explicit keys win).  Returns ``args`` unchanged when no context is
    active."""
    ctx = _current.get()
    if ctx is None:
        return args
    tagged = {"job": ctx.job_id, "tenant": ctx.tenant,
              "trace_id": ctx.trace_id}
    if args:
        tagged.update(args)
    return tagged
