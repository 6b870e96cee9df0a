"""Request-scoped job context (JAX package: racon_tpu/obs/context.py).

A :mod:`contextvars` variable carrying ``(job_id, tenant, trace_id)``.
Code that runs one job's work enters it with :func:`job_context`, and
everything recorded on that thread -- trace spans and instants
(``obs/trace.py`` tags their ``args``), flight and decision events,
logger lines (``utils/logger.py`` prefixes them) -- names the job
without plumbing at the call sites.

A tenant -> active-jobs registry reaches the threads a context
variable cannot: the device executor's dispatcher thread fuses units
that many tenants' threads submitted, and :func:`jobs_for_tenant` lets
it tag the fused dispatch with the job ids that rode it.

The context is observability only: nothing in the polish reads it to
decide anything, so runs inside and outside a context give the same
bytes.
"""

from __future__ import annotations

import os
import re
import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import List, NamedTuple, Optional


class JobContext(NamedTuple):
    job_id: int
    tenant: str
    trace_id: str


_current: ContextVar = ContextVar("racon_tpu_torch_job_context",
                                  default=None)

_lock = threading.Lock()
#: tenant -> the JobContexts inside :func:`job_context` (newest last)
_by_tenant: dict = {}


def make_trace_id(job_id) -> str:
    """Deterministic per-process trace id: pid and job id."""
    return f"{os.getpid():08x}-{int(job_id):06d}"


_TRACE_ID = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:-]{0,127}$")


def valid_trace_id(s) -> bool:
    """A wire trace id or idempotence key: 1-128 characters of
    ``[A-Za-z0-9._:-]``, starting alphanumeric."""
    return isinstance(s, str) and bool(_TRACE_ID.match(s))


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
    with _lock:
        _by_tenant.setdefault(ctx.tenant, []).append(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)
        with _lock:
            stack = _by_tenant.get(ctx.tenant)
            if stack and ctx in stack:
                stack.remove(ctx)
                if not stack:
                    del _by_tenant[ctx.tenant]


def jobs_for_tenant(tenant) -> List[int]:
    """Job ids running under ``tenant`` now: the executor's dispatcher
    thread reads them, since a context variable does not cross
    threads."""
    with _lock:
        return [c.job_id
                for c in _by_tenant.get(str(tenant or "default"), ())]


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
