"""Deterministic fault injection for the durability tests (JAX package:
racon_tpu/obs/faultinject.py).

``RACON_TPU_TORCH_FAULT=<site>[:<nth>]`` arms one named crash site: the
``nth`` time execution reaches it (default 1) the process SIGKILLs
itself, the abrupt death an OOM kill or a power loss gives, with no
interpreter teardown (no atexit, no flushes, no socket unlink).  The
crash-recovery tests (tests/test_torch_durable.py,
tests/test_torch_fleet.py) and chip_smoke.py's ``serve`` and ``fleet``
phases kill the daemon at a site mid-job and hold a restart on
the same journal to the same FASTA bytes.

Sites (racon_tpu_torch/serve and cuda/polisher.py):

* ``post-admit``          -- job journaled and queued, never started
* ``mid-megabatch``       -- a POA megabatch launched, its result in
  flight
* ``pre-demux``           -- a megabatch's results collected, not
  committed
* ``pre-done-record``     -- job finished, its done record not journaled
* ``journal-write``       -- inside the journal append, before the write
* ``route-pre-forward``   -- the router placed a job, nothing forwarded
* ``route-pre-reply``     -- the router holds the backend's answer, the
  client has none
* ``route-mid-gather``    -- every shard answered, nothing gathered
* ``route-mid-rebalance`` -- a straggler's replacement chosen, not
  launched

Counting is per process and under a lock, so ``<site>:<nth>`` is
deterministic under concurrent workers.  An unarmed site costs one
environment read.  Malformed values disarm rather than raise.
"""

from __future__ import annotations

import os
import signal
import sys
import threading

ENV = "RACON_TPU_TORCH_FAULT"

SITES = ("post-admit", "mid-megabatch", "pre-demux",
         "pre-done-record", "journal-write",
         "route-pre-forward", "route-pre-reply", "route-mid-gather",
         "route-mid-rebalance")

_lock = threading.Lock()
_counts: dict = {}


def spec():
    """``RACON_TPU_TORCH_FAULT`` as ``(site, nth)``, or None when unset
    or malformed."""
    raw = os.environ.get(ENV)
    if not raw:
        return None
    site, _, nth = raw.partition(":")
    site = site.strip()
    if site not in SITES:
        return None
    try:
        n = int(nth) if nth else 1
    except ValueError:
        return None
    if n < 1:
        return None
    return (site, n)


def hit(site: str) -> None:
    """Count one arrival at ``site``; SIGKILL the process at the armed
    site's nth arrival.  A no-op when unarmed."""
    armed = spec()
    if armed is None or armed[0] != site:
        return
    with _lock:
        _counts[site] = _counts.get(site, 0) + 1
        count = _counts[site]
    if count == armed[1]:
        print(f"[racon_tpu_torch::faultinject] site {site!r} hit "
              f"{count}: SIGKILL", file=sys.stderr, flush=True)
        os.kill(os.getpid(), signal.SIGKILL)


def reset() -> None:
    """Forget the arrival counts."""
    with _lock:
        _counts.clear()
