"""Content-addressed unit-result cache (JAX package: racon_tpu/cache/).

The port's polish is byte-deterministic: an identical (canonical input
bytes, engine key, code epoch) unit gives identical output bytes, so
serving a cached result is the same as recomputing it.  Repeat work
(``--rounds N`` windows that already converged, a repeated polish in
one process, a restarted process with the persistent tier) becomes a
lookup:

* :mod:`racon_tpu_torch.cache.keying` -- canonical digests per unit
  kind (POA window, WFA pair, banded pair) and the engine epoch that
  makes a code or knob change invalidate every key;
* :mod:`racon_tpu_torch.cache.store` -- the byte-budgeted in-process
  LRU and the optional shared persistent segment tier;
* :mod:`racon_tpu_torch.cache.codec` -- exact-size tagged value blobs.

It is consulted at unit submit in the device executor
(``cuda/executor.py``: hits come back at once and take no megabatch
slot) and per window in the CPU engine's consensus
(``Polisher._consensus_cached``).

Knobs (``obs.provenance.KNOWN_KNOBS``):

* ``RACON_TPU_TORCH_CACHE``         -- "0" turns it off (default on)
* ``RACON_TPU_TORCH_CACHE_MB``      -- LRU budget in MB (default 256)
* ``RACON_TPU_TORCH_CACHE_PERSIST`` -- persistent tier: unset or "0"
  off, "1" ``<calibrate.cache_root()>/results`` (under
  ``RACON_TPU_TORCH_CACHE_DIR``), any other value that directory

A batch with any hit feeds no rate: its collect carries ``cache_hits``
and the polisher keeps it out of the rate store and calhealth.  The
port's and the JAX package's caches never share a result: the epochs
and the segments' schema differ (store.py).

In-process callers that need a cold start (tests, ``chip_smoke.py``,
a second polish that must recompute) call :func:`reset`.
"""

from __future__ import annotations

import os
import threading

from racon_tpu_torch.cache import keying
from racon_tpu_torch.cache.store import MISS, ResultCache  # noqa: F401

_DEF_MB = 256.0
_MIN_BUDGET = 4096
#: process counter (``obs.REGISTRY``): host seconds of keying, lookups,
#: fills and merges
HOST_S = "cache_host_s"

_lock = threading.Lock()
_cache = None
_cfg = None


def enabled() -> bool:
    return os.environ.get("RACON_TPU_TORCH_CACHE", "1") != "0"


def budget_bytes() -> int:
    try:
        mb = float(os.environ.get("RACON_TPU_TORCH_CACHE_MB", "")
                   or _DEF_MB)
    except ValueError:
        mb = _DEF_MB
    return max(_MIN_BUDGET, int(mb * (1 << 20)))


def persist_dir():
    """Directory of the shared persistent tier, or None (off)."""
    v = os.environ.get("RACON_TPU_TORCH_CACHE_PERSIST", "")
    if not v or v == "0":
        return None
    if v == "1":
        from racon_tpu_torch.utils.calibrate import cache_root

        root = cache_root()
        return os.path.join(root, "results") if root else None
    return v


def result_cache() -> ResultCache:
    """The process-wide cache, rebuilt when its knobs change."""
    global _cache, _cfg
    cfg = (budget_bytes(), persist_dir())
    with _lock:
        if _cache is None or cfg != _cfg:
            if _cache is not None:
                _cache.close()
            _cache = ResultCache(cfg[0], persist_dir=cfg[1])
            _cfg = cfg
        return _cache


def stats() -> dict:
    """The live cache's counters (zeros before its first use)."""
    if not enabled():
        return {"enabled": False}
    with _lock:
        live = _cache
    if live is None:
        return {"enabled": True, "entries": 0, "bytes": 0,
                "hits": 0, "misses": 0, "fills": 0, "evicts": 0,
                "disk_hits": 0, "hit_ratio": 0.0,
                "budget_bytes": budget_bytes()}
    return live.stats()


def sketch_doc():
    """Epoch-tagged digest-sketch export of the live cache, or None
    when the cache is off or not yet built (read as cold)."""
    if not enabled():
        return None
    with _lock:
        live = _cache
    return live.sketch_doc() if live is not None else None


def note_content(digest: bytes) -> None:
    """Mark a job-level content digest warm in the live cache's sketch
    (no-op when the cache is off)."""
    if not enabled():
        return
    result_cache().note_content(digest)


def reset() -> None:
    """Drop the in-process cache and the memoized epoch: the next
    lookup starts from an empty LRU, as a fresh process would (the
    persistent tier's segments stay on disk and are indexed again)."""
    global _cache, _cfg
    keying.forget()
    with _lock:
        if _cache is not None:
            _cache.close()
        _cache = None
        _cfg = None


#: the JAX package's name for :func:`reset`
_reset_for_tests = reset
