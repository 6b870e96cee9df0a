"""Job-agnostic device executor: cross-job continuous batching (JAX
package: racon_tpu/tpu/executor.py).

Every POA megabatch and align chunk of a ``CudaPolisher`` goes through
the process-wide :class:`DeviceExecutor`: POA windows through a
:class:`PoaEngineHandle` on a shared ``CudaPoaBatchEngine``, align
pairs through :meth:`DeviceExecutor.align_wfa` / :meth:`align_band`
(``cuda/align.py``'s ``wfa_dispatch`` / ``band_dispatch``).  With two
or more registered tenants (polishers in one process, each with its
``_executor_tenant``) it fuses their compatible submissions into
shared launches and demultiplexes the results back by position.

Result cache
------------
Each submission first consults the content-addressed result cache
(``racon_tpu_torch/cache``): cached windows and pairs come back at
once and take no megabatch slot, only the misses are dispatched, and
the collect merges both and fills the cache.  ``collect.cache_hits``
tells the polisher to keep the batch out of its rate measurement.

Byte contract
-------------
Fusion never changes a job's bytes: a window's consensus and a pair's
alignment depend on that window or pair alone (batch maxima only pad),
so a fused launch returns for each unit exactly what its own launch
would, in its own order.

Compatibility buckets
---------------------
POA units fuse when they share the engine (scoring, caps, depth,
banded flag, device) and ``trim``; align units when they share the
rung geometry (padded lengths, error cap or band width) and device.

Memory envelope (a departure from the JAX package)
--------------------------------------------------
The JAX executor fuses POA units up to the largest participant's cap
and align units with no cap.  The port sizes both from free device
memory: a POA unit carries the megabatch size its polisher sized for,
and a fused POA batch must also fit the polisher's ``_megabatch_size``
at the fused windows' own depth (``size_at(d1)``); an align unit
carries its polisher's ``_chunk_pairs`` cap, so a fused chunk never
exceeds what one participant sized for.  Every window and pair is
independent, so this is policy and changes no byte.

Fusion window and fairness
--------------------------
A dispatcher thread holds a bucket's head unit up to
``RACON_TPU_TORCH_FUSE_WAIT_MS`` (default 5 ms) for batchmates, less
when the bucket reaches its occupancy target (the largest
participant's cap) or every tenant has a unit there.  Batches form by
weighted deficit round robin over tenants, and a per-tenant in-flight
quota (``RACON_TPU_TORCH_SERVE_TENANT_QUOTA``, default 2) holds back
an at-quota tenant while another tenant waits (work-conserving: alone,
a tenant runs unthrottled).  ``RACON_TPU_TORCH_FUSE_ADAPT=1`` tunes the
window from observed occupancy within [0, the ceiling]; it moves when
a bucket dispatches, never what it computes.

Single tenant
-------------
With ``RACON_TPU_TORCH_FUSE=0`` or fewer than two registered tenants
(the one-shot CLI registers none) a submission is a passthrough: the
engine or ``cuda/align.py`` call on the calling thread.
``RACON_TPU_TORCH_FUSE_FORCE=1`` sends single-tenant work through the
dispatcher too (same bytes, other threads).

Streams, counters and lanes
---------------------------
The dispatcher launches under ``torch.cuda.device(dev)`` on the
default stream of the units' device, as the polisher would; a
``DispatchTimer`` records its events on that stream, so a collect's
``.cpu()`` on another thread orders after them.  Each collect reports
its own ``kernel_ms()`` / ``device_s()`` (prorated by item share in a
fused launch) and its own per-window or per-pair stats, so a tenant
never counts another's launches.  A fused launch's device intervals go
once to every participant's ``DeviceUtil`` and to the process
``obs.DEVICE_UTIL``.

Crash containment
-----------------
A failure while dispatching or collecting a fused launch makes each of
its units retry alone, on the card; a unit whose own retry fails
raises in that unit's collect only.  Nothing moves to the CPU.

Observability: ``fusion_dispatches`` / ``fusion_units_fused`` /
``fused_megabatches`` / ``fused_cross_tenant`` counters,
``cache_host_s`` (host seconds of keying, lookups, fills and merges), the
``fusion_occupancy`` histogram (fused size over occupancy target),
per-tenant ``serve_tenant_wait_s.<tenant>`` histograms, and the flight
kinds ``cache_hit``, ``fused_dispatch`` and ``unit_retry``.
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import OrderedDict
from contextlib import nullcontext

import numpy as np
import torch

from racon_tpu_torch import cache as rcache
from racon_tpu_torch.obs import REGISTRY
from racon_tpu_torch.obs import context as obs_context
from racon_tpu_torch.obs import flight as obs_flight
from racon_tpu_torch.obs.decision import DECISIONS
from racon_tpu_torch.obs.devutil import DEVICE_UTIL
from racon_tpu_torch.obs.trace import TRACER, now as _mono
from racon_tpu_torch.cuda import align
from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine, PoaCounters

#: flow-event ids linking a unit's submit to the fused dispatch it rode
_FLOW_IDS = itertools.count(1)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def fuse_enabled() -> bool:
    return os.environ.get("RACON_TPU_TORCH_FUSE", "1") != "0"


def fuse_forced() -> bool:
    return os.environ.get("RACON_TPU_TORCH_FUSE_FORCE", "0") == "1"


def fuse_wait_s() -> float:
    return max(0.0, _env_float("RACON_TPU_TORCH_FUSE_WAIT_MS", 5.0)) / 1e3


def fuse_adapt_on() -> bool:
    """Online fusion-window tuning: the window moves between 0 and
    ``RACON_TPU_TORCH_FUSE_WAIT_MS`` with the observed occupancy."""
    return os.environ.get("RACON_TPU_TORCH_FUSE_ADAPT", "0") == "1"


#: adaptive-window controller: EMA smoothing, the occupancy dead band
#: (no adjustment inside it), the multiplicative steps, and dispatches
#: between adjustments
_ADAPT_ALPHA = 0.3
_ADAPT_BAND = (0.55, 0.9)
_ADAPT_UP = 1.25
_ADAPT_DOWN = 0.8
_ADAPT_EVERY = 4


def tenant_quota() -> int:
    """Most outstanding device submissions per tenant while other
    tenants have pending work; <= 0 turns the quota off."""
    return _env_int("RACON_TPU_TORCH_SERVE_TENANT_QUOTA", 2)


class _Lanes:
    """A ``DeviceUtil`` stand-in for a fused launch: each interval goes
    once to every distinct participant's ``DeviceUtil``."""

    def __init__(self, utils):
        self.utils = []
        for u in utils:
            if u is not None and all(u is not s for s in self.utils):
                self.utils.append(u)

    def record(self, engine: str, t0: float, t1: float) -> None:
        for u in self.utils:
            u.record(engine, t0, t1)


def _on_device(device):
    """Enter ``device`` on this thread when it is a card."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return nullcontext()


# ---------------------------------------------------------------------------
# work units
# ---------------------------------------------------------------------------

class _Unit:
    """One tenant's submission: a POA window batch or an align pair
    batch, fused whole (never split) into a shared dispatch."""

    __slots__ = ("kind", "tenant", "payload", "size", "cap", "util",
                 "device", "d1", "size_at", "pool", "t_submit", "done",
                 "fused", "lo", "hi", "retry", "fuse_dispatch", "flow_id",
                 "jobs", "src", "share")

    def __init__(self, kind, tenant, payload, size, cap, util=None,
                 device=None):
        self.kind = kind            # "poa" | "wfa" | "band"
        self.tenant = tenant or "default"
        self.payload = payload
        self.size = size
        self.cap = cap              # the submitter's own batch size
        self.util = util            # the submitter's DeviceUtil
        self.device = device
        self.d1 = 0                 # POA: the windows' depth cap
        self.size_at = None         # POA: depth -> the polisher's size
        self.pool = None            # POA: the lockstep engine's pool
        self.t_submit = _mono()
        self.done = threading.Event()
        self.fused = None           # _FusedDispatch once dispatched
        self.lo = self.hi = 0       # slice of the fused batch
        self.retry = None           # the unit's own dispatch
        self.fuse_dispatch = None
        self.flow_id = 0            # trace flow-event id
        self.jobs = ()              # job ids this unit belongs to
        self.src = None             # the collect that gave its rows
        self.share = 0.0            # its share of that collect's time


class _FusedDispatch:
    """One shared dispatch covering >= 1 units.  The collect is
    memoized under a lock: the first unit to collect runs it, the rest
    read the cached rows.  A failure poisons only the shared attempt;
    each unit then retries alone."""

    def __init__(self, collect, n_items):
        self.collect = collect
        self._lock = threading.Lock()
        self._result = None
        self._error = None
        self._ran = False
        self.n_items = n_items

    def result(self):
        with self._lock:
            if not self._ran:
                try:
                    self._result = self.collect()
                except BaseException as exc:  # containment boundary
                    self._error = exc
                self._ran = True
            if self._error is not None:
                raise _FusedBatchError(self._error)
            return self._result


class _FusedBatchError(Exception):
    """A shared dispatch failed; its units retry alone."""

    def __init__(self, cause):
        super().__init__(str(cause))
        self.cause = cause


# ---------------------------------------------------------------------------
# POA engine handle
# ---------------------------------------------------------------------------

class PoaEngineHandle(PoaCounters):
    """One polisher's view of a shared ``CudaPoaBatchEngine``: the
    slice of the engine API the polisher drives, and counters
    (:class:`PoaCounters`) of the windows this handle's own collects
    brought back, so another tenant's launches never show here.

    ``cap`` is the submitter's default batch size, ``util`` the
    polisher's ``DeviceUtil``, ``size_at(d1)`` its megabatch size
    at depth cap ``d1`` (the fused-batch memory bound) and ``pool`` its
    thread pool, over which a lockstep batch's per-window host calls
    run."""

    def __init__(self, executor, engine, tenant, cap, util=None,
                 size_at=None, pool=None):
        super().__init__()
        self._ex = executor
        self._eng = engine
        self.tenant = tenant
        self.cap = max(0, int(cap))
        self.util = util
        self.size_at = size_at
        self.pool = pool
        #: the engine configuration: the result cache's device-space
        #: key (cache/keying.poa_key)
        self.cfg_key = None

    @property
    def wb(self) -> int:
        return self._eng.wb

    def depth_cap(self, windows) -> int:
        return self._eng.depth_cap(windows)

    def fits(self, windows) -> bool:
        return self._eng.fits(windows)

    def fits_depth(self, d1: int) -> bool:
        return self._eng.fits_depth(d1)

    def lockstep_window_bytes(self) -> int:
        return self._eng.lockstep_window_bytes()

    def consensus_batch_async(self, windows, trim, cap: int = 0):
        """The engine's call through the executor; ``cap`` is the batch
        size the caller sized for (default: the handle's)."""
        return self._ex.submit_poa(self, windows, trim, cap)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

class DeviceExecutor:
    """Process-wide device dispatch service (see the module
    docstring)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._engines = {}                  # engine key -> engine
        self._engine_lock = threading.Lock()
        self._buckets = OrderedDict()       # fuse key -> [_Unit]
        self._n_pending = 0
        self._tenants = {}                  # name -> ref count
        self._weights = {}                  # name -> DRR weight
        self._deficit = {}                  # name -> DRR deficit
        self._inflight = {}                 # name -> device submissions
        self._dispatcher = None
        self._shutdown = False
        # adaptive fusion window: current wait (None = the ceiling),
        # occupancy EMA, dispatches since the last adjustment
        self._adapt_wait_s = None
        self._adapt_occ = None
        self._adapt_since = 0

    # -- tenancy ------------------------------------------------------------
    def register_tenant(self, name: str, weight: float = 1.0):
        name = str(name or "default")
        with self._cond:
            self._tenants[name] = self._tenants.get(name, 0) + 1
            self._weights[name] = max(0.1, float(weight))
            self._inflight.setdefault(name, 0)

    def release_tenant(self, name: str):
        name = str(name or "default")
        with self._cond:
            n = self._tenants.get(name, 0) - 1
            if n > 0:
                self._tenants[name] = n
            else:
                self._tenants.pop(name, None)
                self._weights.pop(name, None)
                self._deficit.pop(name, None)
                if not self._inflight.get(name, 0):
                    self._inflight.pop(name, None)
            self._cond.notify_all()

    def _fusion_active(self) -> bool:
        if not fuse_enabled():
            return False
        return fuse_forced() or len(self._tenants) >= 2

    # -- engines ------------------------------------------------------------
    def _make_engine(self, match, mismatch, gap, vcap, pcap, lcap,
                     max_depth, banded, device, lockstep_only=False):
        # a seam for tests (stub engines)
        return CudaPoaBatchEngine(match, mismatch, gap, device=device,
                                  vcap=vcap, pcap=pcap, lcap=lcap,
                                  max_depth=max_depth, banded=banded,
                                  lockstep_only=lockstep_only)

    def poa_handle(self, match, mismatch, gap, vcap, pcap, lcap,
                   max_depth, banded, device, tenant=None, cap=0,
                   util=None, size_at=None, pool=None,
                   lockstep_only=False) -> PoaEngineHandle:
        """A handle on the shared engine of this configuration
        (``lockstep_only``: every batch on the lockstep engine)."""
        device = torch.device(device)
        cfg = (match, mismatch, gap, vcap, pcap, lcap, max_depth,
               bool(banded), device.type)
        if lockstep_only:
            cfg += ("lockstep",)
        with self._engine_lock:
            key = cfg + (str(device),)
            engine = self._engines.get(key)
            if engine is None:
                engine = self._make_engine(match, mismatch, gap, vcap,
                                           pcap, lcap, max_depth, banded,
                                           device,
                                           lockstep_only=lockstep_only)
                self._engines[key] = engine
        handle = PoaEngineHandle(self, engine, tenant, cap, util=util,
                                 size_at=size_at, pool=pool)
        handle.cfg_key = cfg
        return handle

    # -- submissions ---------------------------------------------------------
    def _tag_unit(self, unit: _Unit) -> None:
        """Attribute the unit to its job(s): the submitting thread's job
        context, else every job running under the unit's tenant; and
        emit the flow start that ties it to the fused dispatch it
        rides.  Observability only."""
        ctx = obs_context.current()
        if ctx is not None:
            unit.jobs = (ctx.job_id,)
        else:
            unit.jobs = tuple(obs_context.jobs_for_tenant(unit.tenant))
        unit.flow_id = next(_FLOW_IDS)
        if TRACER.capturing:
            jobs = list(unit.jobs)
            TRACER.add_instant(
                f"executor.submit.{unit.kind}", cat="fuse",
                args={"tenant": unit.tenant, "size": unit.size,
                      "flow": unit.flow_id}, jobs=jobs)
            TRACER.add_flow(f"executor.unit.{unit.kind}",
                            unit.flow_id, "s", jobs=jobs)

    def _cache_partition(self, kind, n, key_fn):
        """Split ``n`` items into cache hits and misses before any
        dispatch.  None when the cache is off, else ``(cache, keys,
        hits, miss)``: ``keys[i]`` None for an uncacheable item (it
        rides the miss dispatch, never filled), ``hits`` item index ->
        decoded value, ``miss`` the indices to compute.  An all-hit
        submission touches neither the fusion queue nor the engine."""
        if n == 0 or not rcache.enabled():
            return None
        with REGISTRY.timer(rcache.HOST_S):
            cache = rcache.result_cache()
            epoch = rcache.keying.engine_epoch()
            keys, hits, miss = [None] * n, {}, []
            for i in range(n):
                k = key_fn(i, epoch)
                if k is None:
                    miss.append(i)
                    continue
                keys[i] = k
                v = cache.get(k)
                if v is rcache.MISS:
                    miss.append(i)
                else:
                    hits[i] = v
        if hits:
            obs_flight.FLIGHT.record(
                "cache_hit", unit_kind=kind, hits=len(hits),
                misses=len(miss), items=n)
        return cache, keys, hits, miss

    def submit_poa(self, handle: PoaEngineHandle, windows, trim,
                   cap: int = 0):
        """A zero-argument collect closure, like the engine's: cached
        windows come from memory, the misses are dispatched (fused or
        passthrough), and the collect merges, fills, and adds the
        dispatch's stats to ``handle``.  The closure's ``cache_hits``,
        ``kernel_ms()`` and ``device_s()`` are this submission's."""
        windows = list(windows)
        cfg = handle.cfg_key
        part = None if cfg is None else self._cache_partition(
            "poa", len(windows),
            lambda i, epoch: (
                rcache.keying.poa_key("dev", cfg, trim, windows[i], epoch)
                if len(windows[i].sequences) >= 3 else None))
        if part is None:
            cache, keys, hits, miss = None, None, {}, range(len(windows))
        else:
            cache, keys, hits, miss = part
        sub = windows if not hits else [windows[i] for i in miss]
        inner = self._submit_poa_raw(handle, sub, trim, cap) \
            if sub else None

        def collect():
            out = [None] * len(windows)
            if inner is not None:
                rows = inner()
                handle.add(inner.stats)
                for j, i in enumerate(miss):
                    out[i] = rows[j]
                if cache is not None:
                    with REGISTRY.timer(rcache.HOST_S):
                        for j, i in enumerate(miss):
                            if keys[i] is not None:
                                cache.put(keys[i], rows[j])
            for i, v in hits.items():
                out[i] = v
            return out

        collect.cache_hits = len(hits)
        collect.kernel_ms = _time_of(inner, "kernel_ms")
        collect.device_s = _time_of(inner, "device_s")
        return collect

    def _submit_poa_raw(self, handle: PoaEngineHandle, windows, trim, cap):
        engine = handle._eng
        # the engine picks the whole-window kernel or the lockstep engine
        # (which runs here, at dispatch), fused or not
        if not self._fusion_active():
            return engine.consensus_batch_async(
                windows, trim, util=handle.util, pool=handle.pool)
        key = ("poa", id(engine), bool(trim))
        unit = _Unit("poa", handle.tenant, list(windows), len(windows),
                     cap or handle.cap, handle.util, engine.device)
        unit.d1 = engine.depth_cap(windows)
        unit.size_at = handle.size_at
        unit.pool = handle.pool
        self._tag_unit(unit)
        unit.retry = lambda u: engine.consensus_batch_async(
            u.payload, trim, util=_Lanes([u.util, DEVICE_UTIL]),
            pool=u.pool)
        self._enqueue(key, unit, lambda units, lanes: (
            engine.consensus_batch_async(
                [w for u in units for w in u.payload], trim, util=lanes,
                pool=units[0].pool),
            sum(u.size for u in units)))
        return self._unit_collect(unit)

    def align_wfa(self, queries, targets, lq, emax, device, tenant=None,
                  util=None, cap=0):
        """Cache-aware WFA pair dispatch: cached pairs come from
        memory, only the misses reach the card; the collect re-stacks
        the rows in submission order (see
        :meth:`_align_cached_collect`).  ``cap`` is the chunk size the
        caller sized for (the fused-chunk bound)."""

        queries, targets = list(queries), list(targets)
        device = torch.device(device)
        dk = device.type
        part = self._cache_partition(
            "wfa", len(queries),
            lambda i, epoch: rcache.keying.wfa_key(
                queries[i], targets[i], lq, emax, dk, epoch))

        def dispatch(payload, lanes):
            return align.wfa_dispatch(payload[0], payload[1], lq, emax,
                                      device, util=lanes)

        return self._align(("wfa", lq, emax), device,
                           (queries, targets), part, dispatch, tenant,
                           util, cap)

    def align_band(self, queries, targets, lq, lt, wb, device,
                   centers=None, tenant=None, util=None, cap=0):
        """Cache-aware banded pair dispatch (see :meth:`align_wfa`);
        keys hash each pair's center knots too, since a measured center
        moves the band."""

        queries, targets = list(queries), list(targets)
        cent = list(centers) if centers is not None \
            else [None] * len(queries)
        device = torch.device(device)
        dk = device.type
        part = self._cache_partition(
            "band", len(queries),
            lambda i, epoch: rcache.keying.band_key(
                queries[i], targets[i], lq, lt, wb, cent[i], dk, epoch))

        def dispatch(payload, lanes):
            return align.band_dispatch(payload[0], payload[1], lq, lt, wb,
                                       device, centers=payload[2],
                                       util=lanes)

        return self._align(("band", lq, lt, wb), device,
                           (queries, targets, cent), part, dispatch,
                           tenant, util, cap)

    def _align(self, geom, device, payload, part, dispatch, tenant, util,
               cap):
        """The misses of ``payload`` (per-pair lists) through
        :meth:`_align_raw`, merged with the hits of ``part``."""
        if part is None:
            return self._align_raw(geom, device, payload, dispatch,
                                   tenant, util, cap)
        cache, keys, hits, miss = part
        inner = self._align_raw(
            geom, device, tuple([col[i] for i in miss] for col in payload),
            dispatch, tenant, util, cap) if miss else None
        return _align_cached_collect(len(payload[0]), inner, cache, keys,
                                     hits, miss)

    def _align_raw(self, geom, device, payload, dispatch, tenant, util,
                   cap):
        if not self._fusion_active():
            return dispatch(payload, util)
        kind = geom[0]
        unit = _Unit(kind, tenant, payload, len(payload[0]), cap, util,
                     device)
        self._tag_unit(unit)
        unit.retry = lambda u: dispatch(u.payload,
                                        _Lanes([u.util, DEVICE_UTIL]))
        self._enqueue(geom + (str(device),), unit, lambda units, lanes: (
            dispatch(tuple([x for u in units for x in u.payload[k]]
                           for k in range(len(payload))), lanes),
            sum(u.size for u in units)))
        return self._unit_collect(unit)

    def _unit_collect(self, unit):
        """A fused unit's collect: its slice of the shared result, with
        ``stats`` (POA) or ``cycles`` / ``phase_cycles`` (align) of its
        own items and ``kernel_ms()`` / ``device_s()`` prorated by its
        item share."""

        def collect(u=unit):
            rows, whole = self._collect_unit(u)
            lo, hi = (0, u.size) if whole else (u.lo, u.hi)
            if u.kind == "poa":
                collect.stats = u.src.stats.slice(lo, hi, u.share)
                return rows if whole else rows[lo:hi]
            cycles = getattr(u.src, "cycles", None)
            if cycles is not None:
                collect.cycles = cycles[lo:hi]
                collect.phase_cycles = collect.cycles.sum(0).tolist()
            return tuple(rows) if whole else tuple(r[lo:hi] for r in rows)

        def share_of(name, u=unit):
            return lambda: (0.0 if u.src is None else
                            u.share * _time_of(u.src, name)())

        collect.kernel_ms = share_of("kernel_ms")
        collect.device_s = share_of("device_s")
        return collect

    # -- queueing + dispatch -------------------------------------------------
    def _enqueue(self, key, unit, fuse_dispatch):
        unit.fuse_dispatch = fuse_dispatch
        with self._cond:
            self._buckets.setdefault(key, []).append(unit)
            self._n_pending += 1
            if self._dispatcher is None or not self._dispatcher.is_alive():
                self._dispatcher = threading.Thread(
                    target=self._dispatcher_loop,
                    name="racon-torch-executor", daemon=True)
                self._dispatcher.start()
            self._cond.notify_all()

    def _collect_unit(self, unit):
        """Returns ``(rows, whole)``: ``whole`` is True when the rows
        cover only this unit (its retry) and False when they are the
        fused result the caller slices.  Sets ``unit.src`` and
        ``unit.share``."""
        unit.done.wait()
        try:
            rows = unit.fused.result()
            unit.src = unit.fused.collect
            unit.share = unit.size / max(1, unit.fused.n_items)
            return rows, False
        except _FusedBatchError as exc:
            cause = exc.cause if exc.cause is not None else exc
            fields = dict(unit_kind=unit.kind, tenant=unit.tenant,
                          items=unit.size, jobs=sorted(unit.jobs) or None,
                          error=type(cause).__name__)
            obs_flight.FLIGHT.record("unit_retry", **fields)
            DECISIONS.record("unit_retry", **fields)
            # the shared attempt failed: this unit stands alone, on the
            # card; its own retry failing raises here, in this unit's
            # collect, and nowhere else
            with _on_device(unit.device):
                retry = unit.retry(unit)
            rows = retry()
            unit.src, unit.share = retry, 1.0
            return rows, True

    def _occupancy_target(self, units) -> int:
        cap = max((u.cap for u in units), default=0)
        return cap if cap > 0 else 0

    def _eligible(self, tenant, quota) -> bool:
        if quota <= 0 or len(self._tenants) < 2:
            return True
        if self._inflight.get(tenant, 0) < quota:
            return True
        # work-conserving: at-quota tenants run when nobody else waits
        others = any(u.tenant != tenant
                     for us in self._buckets.values() for u in us)
        return not others

    @staticmethod
    def _fits_memory(picked, u, limits) -> bool:
        """A POA unit joins a batch only when the fused windows fit
        every participant's megabatch size at their own depth cap (a
        departure from the JAX package, see the module docstring);
        ``limits`` memoizes ``size_at(d1)`` within one formation."""
        if u.size_at is None:
            return True
        members = picked + [u]
        d1 = max(p.d1 for p in members)
        total = sum(p.size for p in members)
        for p in members:
            if p.size_at is None:
                continue
            key = (id(p.size_at), d1)
            if key not in limits:
                limits[key] = p.size_at(d1)
            if total > limits[key]:
                return False
        return True

    def _form_batch(self, key):
        """Weighted deficit-round-robin pick (whole units, total size
        <= the occupancy target, POA units within the memory bound)
        honoring the in-flight quota.  Called under the lock; removes
        the picked units from the bucket."""
        units = self._buckets.get(key, [])
        quota = tenant_quota()
        target = self._occupancy_target(units)
        by_tenant = OrderedDict()
        for u in units:
            by_tenant.setdefault(u.tenant, []).append(u)
        picked, total, limits = [], 0, {}
        quantum = max(1, target or max(u.size for u in units))
        # credit every eligible tenant once per formation, scaled by
        # weight; then take one unit per tenant per cycle so no tenant
        # fills the whole target before the others are visited
        for tenant in by_tenant:
            if self._eligible(tenant, quota):
                self._deficit[tenant] = (
                    self._deficit.get(tenant, 0.0)
                    + quantum * self._weights.get(tenant, 1.0))
        progress = True
        while progress and by_tenant \
                and not (target and total >= target):
            progress = False
            for tenant in list(by_tenant):
                if not self._eligible(tenant, quota):
                    continue
                queue = by_tenant[tenant]
                u = queue[0]
                if picked and target and total + u.size > target:
                    continue
                if picked and not self._fits_memory(picked, u, limits):
                    continue
                if self._deficit.get(tenant, 0.0) < u.size:
                    # short on credit this formation; it accrues on the
                    # next, so a unit larger than one quantum waits
                    # rounds, never forever
                    continue
                self._deficit[tenant] -= u.size
                picked.append(queue.pop(0))
                total += u.size
                progress = True
                if not queue:
                    # classic DRR: an emptied queue forfeits its deficit
                    del by_tenant[tenant]
                    self._deficit[tenant] = 0.0
                if target and total >= target:
                    break
        if picked:
            remaining = [u for u in units if u not in picked]
            if remaining:
                self._buckets[key] = remaining
            else:
                self._buckets.pop(key, None)
            self._n_pending -= len(picked)
            for u in picked:
                self._inflight[u.tenant] = (
                    self._inflight.get(u.tenant, 0) + 1)
        return picked, total, target

    def _current_fuse_wait_s(self) -> float:
        """The fuse window in effect: the env ceiling, or (adaptive)
        the controller's value clamped to [0, ceiling]."""
        ceil = fuse_wait_s()
        if not fuse_adapt_on():
            return ceil
        w = self._adapt_wait_s
        if w is None:
            self._adapt_wait_s = w = ceil
        return min(max(0.0, w), ceil)

    def _adapt_tick(self, occupancy: float) -> None:
        """Fold one dispatch's occupancy into the adaptive window: an
        EMA below the dead band (batches leave underfilled at window
        expiry) grows the wait, above it (batches fill before the
        window binds) shrinks it; inside it, hold.  Dispatcher thread
        only; the window decides when, never what."""
        ceil = fuse_wait_s()
        if not fuse_adapt_on() or ceil <= 0.0:
            return
        prev = self._adapt_occ
        self._adapt_occ = occupancy if prev is None else \
            prev + _ADAPT_ALPHA * (occupancy - prev)
        self._adapt_since += 1
        if self._adapt_since < _ADAPT_EVERY:
            return
        self._adapt_since = 0
        w = self._adapt_wait_s if self._adapt_wait_s is not None \
            else ceil
        if self._adapt_occ < _ADAPT_BAND[0]:
            # a zero window still re-opens: step from a 2% floor
            w = min(ceil, max(w, 0.02 * ceil) * _ADAPT_UP)
        elif self._adapt_occ > _ADAPT_BAND[1]:
            w = w * _ADAPT_DOWN
        else:
            return
        self._adapt_wait_s = min(max(0.0, w), ceil)
        REGISTRY.set("fusion_wait_ms",
                     round(self._adapt_wait_s * 1e3, 4))

    def _bucket_ripe(self, key, now) -> bool:
        units = self._buckets.get(key)
        if not units:
            return False
        head = min(u.t_submit for u in units)
        if now - head >= self._current_fuse_wait_s():
            return True
        target = self._occupancy_target(units)
        if target and sum(u.size for u in units) >= target:
            return True
        # every known tenant already queued here: nothing to wait for
        if len(self._tenants) >= 2 and \
                {u.tenant for u in units} >= set(self._tenants):
            return True
        return False

    def _dispatcher_loop(self):
        while True:
            with self._cond:
                while self._n_pending == 0 and not self._shutdown:
                    self._cond.wait()
                if self._shutdown:
                    return
                now = _mono()
                ripe = [k for k in self._buckets
                        if self._bucket_ripe(k, now)]
                if not ripe:
                    heads = [min(u.t_submit for u in us)
                             for us in self._buckets.values() if us]
                    wait = (min(heads) + self._current_fuse_wait_s()
                            - now) if heads else 0.05
                    self._cond.wait(max(1e-4, min(wait, 0.05)))
                    continue
                key = min(ripe, key=lambda k: min(
                    u.t_submit for u in self._buckets[k]))
                picked, total, target = self._form_batch(key)
                if not picked:
                    # every pending tenant at quota: wait for a collect
                    # to free an in-flight slot
                    self._cond.wait(0.02)
                    continue
            self._dispatch(picked, total, target, now)

    def _dispatch(self, units, total, target, now):
        tenants = {u.tenant for u in units}
        lo = 0
        for u in units:
            u.lo, u.hi = lo, lo + u.size
            lo += u.size
            if u.tenant in self._tenants:
                REGISTRY.observe(f"serve_tenant_wait_s.{u.tenant}",
                                 max(0.0, now - u.t_submit))
        REGISTRY.add("fusion_dispatches")
        REGISTRY.add("fusion_units_fused", len(units))
        if len(units) > 1:
            REGISTRY.add("fused_megabatches")
            if len(tenants) > 1:
                REGISTRY.add("fused_cross_tenant")
        occupancy = total / target if target else 1.0
        REGISTRY.observe("fusion_occupancy", occupancy)
        self._adapt_tick(occupancy)
        lanes = _Lanes([u.util for u in units] + [DEVICE_UTIL])
        try:
            with _on_device(units[0].device):
                collect, n_items = units[0].fuse_dispatch(units, lanes)
            fused = _FusedDispatch(collect, n_items)
        except BaseException as exc:  # containment: fall back per unit
            fused = _FusedDispatch(_raiser(exc), total)
        jobs = sorted({j for u in units for j in u.jobs})
        t1 = _mono()
        if TRACER.capturing:
            TRACER.add_span(
                "executor.fused_dispatch", now, t1, cat="fuse",
                lane="executor",
                args={"kind": units[0].kind, "units": len(units),
                      "items": total, "occupancy": round(occupancy, 4),
                      "tenants": sorted(tenants)},
                jobs=jobs)
            for u in units:
                TRACER.add_flow(f"executor.unit.{u.kind}", u.flow_id,
                                "f", lane="executor", t=t1,
                                jobs=list(u.jobs))
        obs_flight.FLIGHT.record(
            "fused_dispatch", unit_kind=units[0].kind,
            units=len(units), items=total,
            occupancy=round(occupancy, 4), tenants=sorted(tenants),
            jobs=jobs or None)
        # in-flight slots free when the shared device work completes:
        # on the first collect (wrapped before the units wake, so no
        # collect slips past the accounting)
        orig_result = fused.result
        decremented = threading.Event()

        def result():
            try:
                return orig_result()
            finally:
                if not decremented.is_set():
                    decremented.set()
                    with self._cond:
                        for u in units:
                            t = u.tenant
                            if self._inflight.get(t, 0) > 0:
                                self._inflight[t] -= 1
                        self._cond.notify_all()

        fused.result = result
        for u in units:
            u.fused = fused
            u.done.set()

    # -- introspection -------------------------------------------------------
    def pending_units(self) -> int:
        """Units submitted but not yet dispatched."""
        with self._cond:
            return self._n_pending

    def stats(self) -> dict:
        with self._cond:
            pending = {str(k[0]): sum(u.size for u in us)
                       for k, us in self._buckets.items() if us}
            doc = {
                "enabled": fuse_enabled(),
                "active": self._fusion_active(),
                "tenants": dict(self._tenants),
                "inflight": {k: v for k, v in self._inflight.items()
                             if v},
                "pending_units": self._n_pending,
                "pending_items": pending,
                "quota": tenant_quota(),
                "fuse_wait_ms": self._current_fuse_wait_s() * 1e3,
                "fuse_wait_ceiling_ms": fuse_wait_s() * 1e3,
                "fuse_adapt": fuse_adapt_on(),
            }
        for key in ("fusion_dispatches", "fusion_units_fused",
                    "fused_megabatches", "fused_cross_tenant"):
            doc[key] = REGISTRY.value(key)
        return doc

    def close(self):
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()


def _raiser(exc):
    def collect():
        raise exc
    return collect


def _time_of(collect, name):
    """``collect.<name>`` (``kernel_ms`` / ``device_s``) as a callable,
    0 for no collect or one without it."""
    fn = getattr(collect, name, None)
    return fn if callable(fn) else (lambda: 0.0)


def _align_cached_collect(n, inner, cache, keys, hits, miss):
    """Collect closure merging cached align rows with the miss
    dispatch's ``(rows_2d, lens, dists)`` (WFA: tapes, entry counts;
    band: moves, move counts).  Each fresh row is filled into the cache
    cut to its length (``lens``): consumers read only ``row[:len]``,
    and the merge zero-pads every row to the widest, so the cut is
    byte-neutral and keeps 16,384-entry int64 tape rows out of the LRU.
    With no hit the fresh arrays pass through untouched.  The closure
    keeps the dispatch's ``kernel_ms()``, ``device_s()`` and
    ``phase_cycles`` (0 for an all-hit submission) and carries
    ``cache_hits``."""

    def collect():
        fresh = inner() if inner is not None else None
        with REGISTRY.timer(rcache.HOST_S):
            return merge(fresh)

    def merge(fresh):
        if fresh is not None:
            rows2d = np.asarray(fresh[0])
            cols = [np.asarray(a) for a in fresh[1:]]
            width = rows2d.shape[1] if rows2d.ndim == 2 else 0
            for j, i in enumerate(miss):
                if keys[i] is not None:
                    keep = min(max(int(cols[0][j]), 0), width)
                    cache.put(keys[i], (rows2d[j, :keep].copy(),)
                              + tuple(int(c[j]) for c in cols))
            collect.phase_cycles = list(getattr(inner, "phase_cycles",
                                                (0, 0)))
            if not hits:
                return fresh
        else:
            collect.phase_cycles = [0, 0]
        rows, col_vals = [None] * n, [[0] * n for _ in range(2)]
        for i, v in hits.items():
            rows[i] = np.asarray(v[0])
            for a, cv in enumerate(v[1:]):
                col_vals[a][i] = cv
        if fresh is not None:
            for j, i in enumerate(miss):
                rows[i] = rows2d[j]
                for a, c in enumerate(cols):
                    col_vals[a][i] = int(c[j])
        width = max(r.shape[0] for r in rows)
        stacked = np.zeros((n, width), dtype=rows[0].dtype)
        for i, r in enumerate(rows):
            stacked[i, :r.shape[0]] = r
        return (stacked,) + tuple(np.asarray(cv, dtype=np.int64)
                                  for cv in col_vals)

    collect.kernel_ms = _time_of(inner, "kernel_ms")
    collect.device_s = _time_of(inner, "device_s")
    collect.cache_hits = len(hits)
    return collect


# ---------------------------------------------------------------------------
# process-wide singleton
# ---------------------------------------------------------------------------

_EXECUTOR = None
_EXECUTOR_LOCK = threading.Lock()


def get_executor() -> DeviceExecutor:
    global _EXECUTOR
    with _EXECUTOR_LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = DeviceExecutor()
        return _EXECUTOR


def _reset_for_tests():
    """Drop the singleton (live collects keep working: they hold their
    own unit and engine references)."""
    global _EXECUTOR
    with _EXECUTOR_LOCK:
        if _EXECUTOR is not None:
            _EXECUTOR.close()
        _EXECUTOR = None
