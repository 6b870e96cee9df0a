"""The fleet router: one address in front of several daemons (JAX
package: racon_tpu/serve/router.py).

``python -m racon_tpu_torch.cli route --socket PATH --backends S1,S2,...
[--tcp HOST:PORT]`` starts a routing process in front of several
``serve`` daemons of the port, so one daemon's crash, drain or full
queue is not an outage the client sees: the online, crash-tolerant form
of the reference wrapper's offline split driver (racon_wrapper.py).
The router never touches a card: it proxies frames and prices jobs, so
it holds no CUDA context (chip_smoke.py's ``fleet`` phase checks that
its pid is not among the card's compute processes).

* **Health-probed placement** -- a background loop (every
  ``RACON_TPU_TORCH_ROUTE_PROBE_S``) sends the cheap ``health`` op to
  every backend and keeps its queue depth, running count and draining
  state.  Every submit is priced per backend by
  :func:`scheduler.estimate_job`, the daemons' own admission model
  (``calibrate.predict_walls``, with the shared-wall term at this
  backend's load + 1 and the cache hit-ratio discount), and placed on
  the lowest predicted wall (ties: lowest load, then the ``--backends``
  order, so placement is deterministic under equal load).
* **Content affinity** -- each submit's content-digest sample
  (``serve/affinity.py``) is scored against every backend's epoch-tagged
  cache sketch from its health doc (``cache/sketch.py``); the estimated
  hit fraction feeds the discount, so the backend whose result cache
  holds the job's content wins the pricing.  A stale sketch (older than
  3 probe periods + the timeout) or a false positive only misprices a
  placement: the cache checks every lookup by its full key.
  ``RACON_TPU_TORCH_ROUTE_AFFINITY=0`` turns it off.
* **Spillover** -- a backend's retryable reject (``queue_full``,
  ``job_too_large``, ``draining``) is not surfaced: the router tries the
  next-best backend, and only when every eligible one rejected does it
  sleep (on the servers' ``retry_after_s`` hints first) and re-rank.
* **Circuit breakers** -- ``RACON_TPU_TORCH_ROUTE_BREAKER_FAILS``
  consecutive probe or submit failures open a backend's breaker: no
  placements and no probes until a jittered cooldown
  (``RACON_TPU_TORCH_ROUTE_BREAKER_COOLDOWN_S``), then one half-open
  probe decides.  A dead socket costs one connect per cooldown.
* **Draining-aware failover** -- a SIGTERM'd backend answers probes with
  ``status: draining``; new jobs go elsewhere while its in-flight jobs
  finish.
* **Crash failover, exactly once** -- a backend that dies mid-job
  surfaces as a transport error on the blocked submit; the router
  resubmits to a survivor under the same ``job_key`` (the client's, or
  one the router mints).  The daemons' write-ahead journals dedup any
  replay and the bytes are deterministic, so the crash is invisible to
  the client.  Completed keys stay sticky to the backend that ran them.
* **Scatter/gather** -- a submit with a ``shards`` field (or one priced
  past ``RACON_TPU_TORCH_SCATTER_MIN_WALL_S``) is split into K
  target-sharded sub-jobs (``serve/scatter.py``) fanned out at once,
  each placed on its own under ``<job_key>-shard-<i>of<k>``, so a
  backend death mid-shard re-places only that shard.  The gather
  concatenates the shard FASTAs in shard order, byte-identical to the
  unsharded run, and answers with one merged frame.
* **Staged inputs** -- at plan time the router builds a one-pass slice
  index over the overlaps file (``io/staging.py``) and ships each
  sub-job a ``stage`` hint: the line ranges of the query-runs that can
  reach its targets.  The daemon validates the hint and parses only
  those ranges.  ``RACON_TPU_TORCH_STAGE=0`` restores the full parse; a
  plan that cannot be built (non-PAF input, malformed rows, paths this
  host cannot read) ships no hint.
* **Straggler rebalancing** -- the probe loop watches live scatters; a
  shard whose attempt has run past ``RACON_TPU_TORCH_SCATTER_REBALANCE x
  p50`` of the plan's predicted shard walls (and four probe periods)
  gets a speculative attempt under ``<key>-r<n>`` on the idlest backend
  it has not tried, and the superseded attempt is asked to cancel after
  its checkpoint.  The first success wins the shard.
* **TCP front** -- ``--tcp HOST:PORT`` (or
  ``RACON_TPU_TORCH_ROUTE_TCP``) also listens on TCP with the same
  framing; port 0 binds an ephemeral port, reported in ``route_status``.

Every decision is observable: the ``route_submit``, ``route_spillover``,
``route_failover`` and ``route_dedup_joins`` counters and
``route_breaker_open.<backend>`` in the registry (exported with the
port's metric prefix), and a flight event per decision (``route``,
``route_spillover``, ``route_failover``, ``route_breaker``,
``route_dedup``).  The ``route_status`` op (``status`` renders it)
reports each backend's breaker, probe age and the counters.  The fault
sites ``route-pre-forward``, ``route-pre-reply``, ``route-mid-gather``
and ``route-mid-rebalance`` (``obs/faultinject.py``) kill the router at
those points.

Every knob here is placement policy, none can change a job's bytes, so
all are in ``keying.EPOCH_EXCLUDE``.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import os
import random
import signal
import socket
import sys
import threading

from racon_tpu_torch.obs import REGISTRY
from racon_tpu_torch.obs import context as obs_context
from racon_tpu_torch.obs import faultinject
from racon_tpu_torch.obs import flight as obs_flight
from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.serve import affinity, client, protocol, scatter


def eprint(*args):
    print(*args, file=sys.stderr, flush=True)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def probe_interval_s() -> float:
    return max(0.05, _env_float("RACON_TPU_TORCH_ROUTE_PROBE_S", 1.0))


def probe_timeout_s() -> float:
    return max(0.1, _env_float("RACON_TPU_TORCH_ROUTE_PROBE_TIMEOUT_S", 2.0))


def breaker_fails() -> int:
    return max(1, _env_int("RACON_TPU_TORCH_ROUTE_BREAKER_FAILS", 3))


def breaker_cooldown_s() -> float:
    return max(0.1,
               _env_float("RACON_TPU_TORCH_ROUTE_BREAKER_COOLDOWN_S", 5.0))


def route_affinity_on() -> bool:
    """Content-affinity placement: score each submit's content-digest
    sample against the backends' cache sketches and fold the estimated
    hit fraction into the placement price.  Default on; "0" also turns
    off the scalar hit-ratio tiebreak, leaving pure load and price
    ranking."""
    return os.environ.get("RACON_TPU_TORCH_ROUTE_AFFINITY", "1") != "0"


#: breaker states (route_status renders them uppercase)
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

#: spillover rounds before the router gives up and surfaces the
#: last retryable reject (each round re-ranks and re-tries every
#: eligible backend, sleeping on the servers' retry_after_s between)
_MAX_ROUNDS = 3

#: cap on the inter-round spillover sleep
_MAX_ROUND_WAIT_S = 10.0

#: cap on speculative rebalance attempts per shard (r1, r2): a shard
#: slow on its THIRD backend is telling us about the job, not the
#: placement, and further copies only burn fleet capacity
_REBALANCE_MAX_ATTEMPTS = 2

#: bounded forensic reads: mirrors the daemon's
#: server.TRACE_QUERY_MAX_EVENTS (kept local so the router never
#: imports the daemon's heavy module graph)
_TRACE_QUERY_MAX_EVENTS = 4096


class Backend:
    """One fronted daemon: last-known health + its circuit breaker.

    The breaker is a small explicit state machine — CLOSED (normal),
    OPEN (shed: no placements, no probes until ``next_probe``),
    HALF-OPEN (cooldown elapsed; exactly one probe in flight decides)
    — with every transition under one lock and time injected by the
    caller, so the transitions unit-test without a daemon or a
    sleep."""

    def __init__(self, target: str, fails: int = None,
                 cooldown_s: float = None):
        self.target = target
        self._fails_limit = breaker_fails() if fails is None else fails
        self._cooldown_s = (breaker_cooldown_s()
                            if cooldown_s is None else cooldown_s)
        self._lock = threading.Lock()
        self.state = CLOSED
        self.failures = 0          # consecutive probe/submit failures
        self.draining = False
        self.health = None         # last good health doc
        self.t_health = None       # ... and when it arrived
        self.last_error = None
        self.next_probe = 0.0      # earliest half-open probe (OPEN)
        self.opened_count = 0
        self._probing = False      # a half-open probe is in flight

    def note_success(self, doc: dict, now: float) -> bool:
        """A probe answered: refresh health, close the breaker.
        Returns True when this CLOSED a non-closed breaker."""
        with self._lock:
            reopened = self.state != CLOSED
            self.state = CLOSED
            self.failures = 0
            self.health = doc
            self.t_health = now
            self.last_error = None
            self._probing = False
            self.draining = (doc or {}).get("status") == "draining" \
                or not (doc or {}).get("accepting", True)
            return reopened

    def note_failure(self, error: str, now: float) -> bool:
        """A probe or submit transport-failed.  Returns True when
        this OPENED the breaker (the caller records/announces it —
        once per opening, not per failure)."""
        with self._lock:
            self.failures += 1
            self.last_error = error
            self._probing = False
            if self.state == HALF_OPEN or (
                    self.state == CLOSED
                    and self.failures >= self._fails_limit):
                self.state = OPEN
                # jittered cooldown: a fleet of routers (or breakers)
                # must not re-probe a recovering daemon in lockstep
                self.next_probe = now + self._cooldown_s * (
                    0.75 + 0.5 * random.random())
                self.opened_count += 1
                return True
            return False

    def probe_due(self, now: float) -> bool:
        """Whether the probe loop should probe this backend now.
        CLOSED probes every round; OPEN waits out the cooldown, then
        admits exactly ONE half-open probe."""
        with self._lock:
            if self._probing:
                return False
            if self.state == CLOSED:
                return True
            if now >= self.next_probe:
                self.state = HALF_OPEN
                self._probing = True
                return True
            return False

    def eligible(self) -> bool:
        """May receive a NEW placement: breaker closed, not
        draining."""
        with self._lock:
            return self.state == CLOSED and not self.draining

    def mark_draining(self) -> None:
        with self._lock:
            self.draining = True

    def load(self) -> int:
        """Queued + running jobs from the last good health doc (0
        when never probed — optimism costs one spillover, pessimism
        would blackhole a fresh backend)."""
        with self._lock:
            h = self.health or {}
        try:
            return int(h.get("queue_depth") or 0) + \
                int(h.get("running") or 0)
        except (TypeError, ValueError):
            return 0

    def snapshot(self, now: float) -> dict:
        with self._lock:
            h = self.health or {}
            age = None if self.t_health is None \
                else round(now - self.t_health, 3)
            return {
                "target": self.target,
                "breaker": self.state.upper(),
                "failures": self.failures,
                "opened_count": self.opened_count,
                "draining": self.draining,
                "probe_age_s": age,
                "queue_depth": h.get("queue_depth"),
                "running": h.get("running"),
                "daemon_pid": h.get("pid"),
                "last_error": self.last_error,
            }


class _RoutedJob:
    """In-router rendezvous for one idempotence key: concurrent
    duplicate submits join the owner's routing instead of racing two
    placements for one key."""

    def __init__(self, job_key: str):
        self.job_key = job_key
        self.done = threading.Event()
        self.response = None


class FleetRouter:
    def __init__(self, socket_path: str, backends,
                 tcp: str = None):
        if not backends:
            raise ValueError("FleetRouter needs at least one backend")
        self.socket_path = socket_path
        self.backends = [Backend(t) for t in backends]
        self.tcp_spec = tcp or None
        self.probe_interval = probe_interval_s()
        self.probe_timeout = probe_timeout_s()
        self._sock = None
        self._tcp_sock = None
        self.tcp_addr = None         # actual host:port once bound
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._handlers: list = []
        self._in_flight = 0          # live proxied submits
        self._live: dict = {}        # job_key -> _RoutedJob
        self._done_backend: dict = {}  # job_key -> backend target
        # scatter state: placements this router has chosen but
        # whose submits are still in flight (so K concurrent shards
        # spread instead of all picking the same stale-cheapest
        # backend), live shard-progress docs for route_status, and a
        # bounded per-tenant memory of which backends recently served
        # content-keyed jobs (the cache-affinity tiebreak)
        self._plan_lock = threading.Lock()
        self._placing: dict = {}       # backend target -> in-flight
        self._scatter_live: dict = {}  # job_key -> progress doc
        self._tenant_recent: dict = {}  # tenant -> deque of targets
        self._keyseq = itertools.count(1)
        # the router keeps its own bounded per-job trace capture, as
        # the daemons do,
        # keyed by a router-local routing id minted per owned submit
        self._jobseq = itertools.count(1)
        obs_trace.TRACER.enable_job_capture()
        self._t_start = obs_trace.now()
        self._drain_logged = False
        obs_flight.FLIGHT.install_dump_on_crash()
        from racon_tpu_torch.obs import provenance
        provenance.daemon_identity(socket_path)
        REGISTRY.set("route_backends", len(self.backends))

    def _identity(self) -> dict:
        from racon_tpu_torch.obs import provenance
        return provenance.daemon_identity(self.socket_path)

    # -- health probing / breakers -------------------------------------

    def _probe_one(self, backend: Backend) -> None:
        try:
            doc = client.health(backend.target,
                                timeout=self.probe_timeout)
            ok = bool(doc.get("ok"))
            error = None if ok else "health answered ok=false"
        except Exception as exc:    # ServeError or anything transport
            doc, ok = None, False
            error = f"{type(exc).__name__}: {exc}"
        now = obs_trace.now()
        if ok:
            closed = backend.note_success(doc, now)
            REGISTRY.set(f"route_backend_up.{backend.target}", 1)
            if closed:
                obs_flight.FLIGHT.record(
                    "route_breaker", backend=backend.target,
                    state="closed")
                eprint(f"[racon_tpu_torch::route] breaker CLOSED for "
                       f"{backend.target} (half-open probe answered)")
        else:
            opened = backend.note_failure(error, now)
            REGISTRY.set(f"route_backend_up.{backend.target}", 0)
            if opened:
                self._record_breaker_open(backend, error)

    def _record_breaker_open(self, backend: Backend,
                             error: str) -> None:
        REGISTRY.add(f"route_breaker_open.{backend.target}")
        obs_flight.FLIGHT.record(
            "route_breaker", backend=backend.target, state="open",
            failures=backend.failures, error=(error or "")[:200])
        eprint(f"[racon_tpu_torch::route] breaker OPEN for "
               f"{backend.target} after {backend.failures} "
               f"consecutive failure(s): {error}")

    def _probe_round(self) -> None:
        """One concurrent probe round over every due backend (the
        FleetScraper shape: one bounded thread per target, last good
        doc retained on failure)."""
        now = obs_trace.now()
        due = [b for b in self.backends if b.probe_due(now)]
        threads = [threading.Thread(target=self._probe_one, args=(b,),
                                    daemon=True) for b in due]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.probe_timeout + 5.0)

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            self._probe_round()
            # the same cadence that refreshes backend health
            # watches live scatters for straggling shards
            try:
                self._rebalance_round()
            except Exception as exc:   # a watchdog bug must never
                obs_flight.FLIGHT.record_exception(  # kill probing
                    "route_rebalance_error", exc)

    # -- placement -----------------------------------------------------

    def _price(self, spec: dict, concurrency: int,
               hit_ratio: float = None):
        """Predicted wall for this job at this backend's load — the
        daemons' own admission model (scheduler.estimate_job ->
        calibrate.predict_walls with shared-wall + hit-ratio terms).
        ``hit_ratio`` is the per-backend sketch-estimated hit
        fraction; when given it replaces the router-local
        trailing ratio in the discount, making the predicted wall
        backend-specific in cache warmth, not just in load.  None
        when the inputs cannot be priced from here (e.g. a
        TCP-remote client naming paths this host cannot stat) —
        ranking then falls back to raw load."""
        from racon_tpu_torch.serve import scheduler
        try:
            return scheduler.estimate_job(spec,
                                          concurrency=concurrency,
                                          hit_ratio=hit_ratio)
        except (OSError, KeyError, TypeError, ValueError):
            return None

    def _placing_inc(self, target: str) -> None:
        with self._lock:
            self._placing[target] = self._placing.get(target, 0) + 1

    def _placing_dec(self, target: str) -> None:
        with self._lock:
            n = self._placing.get(target, 0) - 1
            if n > 0:
                self._placing[target] = n
            else:
                self._placing.pop(target, None)

    def _cache_block(self, backend: Backend, now: float) -> dict:
        """The ``cache`` block of the backend's last good health doc,
        or {} when that doc is older than the probe staleness window
        (3 probe periods + the probe timeout — the same bound
        ``route_status`` reports staleness against).  The age guard
        keeps a dead backend's last-known hot cache
        must not keep attracting placements its breaker will only
        reject later."""
        health, t = backend.health, backend.t_health
        if not health or t is None:
            return {}
        if now - t > 3 * self.probe_interval + self.probe_timeout:
            return {}
        return health.get("cache") or {}

    def _hit_ratio(self, backend: Backend, now: float) -> float:
        """The backend's result-cache hit ratio from its last good
        health doc (0.0 when it reports no cache block or the doc is
        past the staleness window)."""
        try:
            return float(
                self._cache_block(backend, now).get("hit_ratio")
                or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def _affinity_reorder(self, rows: list, tenant: str,
                          now: float) -> list:
        """Scalar cache-locality tiebreak, the fallback used
        only when no content-digest sample exists for the submit
        (affinity off handles neither path; sketch pricing in
        :meth:`_rank` replaces this when a sample is available):
        among backends whose predicted wall is within 10% of the
        best, prefer the hottest result cache, then one that
        recently served this tenant's content-keyed jobs.  First-max
        on ties keeps placement deterministic; unpriceable specs
        (wall == inf) never reorder — affinity refines the cost
        model, it never replaces it.  Rows are the pre-sorted
        ``(wall, load, idx, backend, est)`` tuples."""
        if len(rows) < 2:
            return rows
        best_wall = rows[0][0]
        if not best_wall < float("inf"):
            return rows
        tied = [r for r in rows if r[0] <= best_wall * 1.10]
        if len(tied) < 2:
            return rows
        with self._lock:
            recent = set(self._tenant_recent.get(tenant or "default",
                                                 ()))

        def warmth(row):
            return (round(self._hit_ratio(row[3], now), 3),
                    1 if row[3].target in recent else 0)

        leader = max(tied, key=warmth)
        if leader is rows[0] or warmth(leader) <= warmth(rows[0]):
            return rows
        REGISTRY.add("route_cache_affinity")
        obs_flight.FLIGHT.record(
            "route_cache_affinity", backend=leader[3].target,
            over=rows[0][3].target, tenant=tenant,
            hit_ratio=self._hit_ratio(leader[3], now),
            wall_s=(round(leader[0], 4)
                    if leader[0] < float("inf") else None))
        rows.remove(leader)
        rows.insert(0, leader)
        return rows

    def _affinity_sample(self, spec: dict):
        """(content-digest sample, local engine-epoch hex) for a
        submit, or ``([], None)`` when affinity routing is off or the
        sample cannot be derived (unreadable inputs, TCP-remote
        paths) — ranking then falls back to the scalar tiebreak."""
        if not route_affinity_on():
            return [], None
        try:
            from racon_tpu_torch.cache import keying

            epoch = keying.engine_epoch()
            sample = affinity.job_digest_sample(spec, epoch)
            return sample, epoch.hex()
        except Exception:
            return [], None

    def _note_tenant_backend(self, tenant: str, job_key: str,
                             target: str) -> None:
        """Remember which backend served a tenant's CONTENT-keyed job
        (router-minted ``route-*`` keys carry no content identity, so
        nothing would be warm for their duplicates)."""
        if not job_key or job_key.startswith("route-"):
            return
        with self._lock:
            dq = self._tenant_recent.get(tenant or "default")
            if dq is None:
                dq = collections.deque(maxlen=32)
                self._tenant_recent[tenant or "default"] = dq
            dq.append(target)

    def _rank(self, spec: dict, exclude=(), tenant: str = None) -> list:
        """Eligible backends, best placement first: (predicted wall,
        load, CLI list order) — the last term makes placement
        deterministic under equal load.  Load counts this router's
        own still-in-flight placements on top of the probed depth, so
        K scattered shards planned in one burst spread over the fleet
        instead of all chasing the same stale-cheapest backend.

        Content affinity: when the submit yields a content-digest
        sample, each backend's price carries ITS OWN estimated hit
        fraction (sample vs the backend's epoch-tagged cache sketch)
        as the hit-ratio discount: a warm backend's predicted wall shrinks
        by up to 90%, so cache locality is priced against load and
        queue depth in one model instead of breaking near-ties.  A
        stale or foreign-epoch sketch scores as cold; false positives
        only under-price.  Without a sample, near ties fall back to
        the scalar tiebreak (:meth:`_affinity_reorder`)."""
        sample, epoch_hex = self._affinity_sample(spec)
        now = obs_trace.now()
        rows = []
        with self._lock:
            placing = dict(self._placing)
        for idx, backend in enumerate(self.backends):
            if backend.target in exclude or not backend.eligible():
                continue
            load = backend.load() + placing.get(backend.target, 0)
            frac = None
            if sample:
                frac = affinity.backend_hit_fraction(
                    self._cache_block(backend, now).get("sketch"),
                    sample, epoch_hex)
            # pass the warmth kwarg only when there is a fraction to
            # price with; cold-path calls keep the plain signature
            est = (self._price(spec, load + 1, hit_ratio=frac)
                   if frac is not None
                   else self._price(spec, load + 1))
            if est is not None and frac is not None:
                est["affinity_hit_fraction"] = round(frac, 4)
            wall = None
            if est:
                wall = est.get("shared_wall_s",
                               est.get("predicted_wall_s"))
            rows.append((wall if wall is not None else float("inf"),
                         load, idx, backend, est))
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        if not sample:
            rows = self._affinity_reorder(rows, tenant, now)
        elif rows and (rows[0][4] or {}).get("affinity_hit_fraction"):
            REGISTRY.add("route_sketch_affinity")
            obs_flight.FLIGHT.record(
                "route_sketch_affinity", backend=rows[0][3].target,
                tenant=tenant,
                hit_fraction=rows[0][4]["affinity_hit_fraction"],
                wall_s=(round(rows[0][0], 4)
                        if rows[0][0] < float("inf") else None))
        return [(backend, est) for _, _, _, backend, est in rows]

    # -- submit proxying -----------------------------------------------

    def _handle_submit(self, req: dict) -> dict:
        spec = req.get("job")
        if not isinstance(spec, dict):
            return protocol.error_frame(
                "bad_request", "submit carries no job object")
        job_key = req.get("job_key")
        if job_key is not None and \
                not obs_context.valid_trace_id(job_key):
            return protocol.error_frame(
                "bad_request",
                "job_key must be 1..128 chars of "
                "[A-Za-z0-9._:-] starting alphanumeric")
        trace_context = req.get("trace_context")
        if trace_context is not None and \
                not obs_context.valid_trace_id(trace_context):
            return protocol.error_frame(
                "bad_request",
                "trace_context must be 1..128 chars of "
                "[A-Za-z0-9._:-] starting alphanumeric")
        try:
            requested_shards = scatter.parse_requested(
                req.get("shards"))
        except ValueError as exc:
            return protocol.error_frame("bad_request", str(exc))
        if self._stop.is_set():
            REGISTRY.add("route_reject.draining")
            return protocol.error_frame(
                "draining", "router is draining: in-flight jobs "
                "finish, new jobs are rejected", retry_after_s=2.0)
        if job_key is None:
            # failover safety net: the resubmit after a backend crash
            # must carry the SAME key as the original placement, or
            # the surviving backend could re-run work the dead one's
            # journal already recorded
            job_key = f"route-{os.getpid()}-{next(self._keyseq)}"
        if trace_context is None:
            # a context-less submit would reach every
            # backend with NO trace_context, so each scheduler minted
            # its own unlinked <pid>-<job> id and sibling shards /
            # failover retries could not be correlated.  The router
            # adopts the job_key (client-supplied or just minted —
            # both pass the same charset contract) as the fleet-wide
            # trace context; every sub-submit below reads it from
            # this shared req dict, so shards, rebalance attempts and
            # failovers all land under one id
            trace_context = job_key
            req["trace_context"] = trace_context
        # in-router rendezvous: concurrent duplicates of one key join
        # the owner's routing (one placement, every caller gets the
        # same response) — the router-level twin of the scheduler's
        # _by_key rendezvous
        with self._lock:
            live = self._live.get(job_key)
            owner = live is None
            if owner:
                live = _RoutedJob(job_key)
                self._live[job_key] = live
        if not owner:
            REGISTRY.add("route_dedup_joins")
            obs_flight.FLIGHT.record("route_dedup", job_key=job_key,
                                     trace_id=trace_context,
                                     joined="live")
            live.done.wait()
            return live.response
        # the owned submit gets a
        # router-local routing id; every routing decision below is
        # flight-tagged and span-captured under it, so the router's
        # own per-job slice exists just like a backend's
        rid = next(self._jobseq)
        t_route0 = obs_trace.now()
        try:
            resp = self._submit_planned(spec, req, job_key,
                                        requested_shards, rid=rid)
        except Exception as exc:     # router bug: job fails, router
            obs_flight.FLIGHT.record_exception(   # survives
                "route_error", exc)
            resp = protocol.error_frame(
                "job_failed", f"router error: {exc}",
                type=type(exc).__name__)
        obs_trace.TRACER.add_span(
            "route.submit", t_route0, obs_trace.now(), cat="route",
            args={"job": rid, "job_key": job_key,
                  "trace_id": trace_context,
                  "ok": bool(resp.get("ok"))}, jobs=[rid])
        if req.get("trace") and isinstance(resp, dict):
            # router-side forensics ride the traced response so a
            # routed `submit --trace` is not backend-only
            resp = dict(resp)
            resp["router_pid"] = os.getpid()
            resp["router_flight_events"] = \
                obs_flight.FLIGHT.snapshot(job=rid)
            resp["router_trace_events"] = \
                obs_trace.TRACER.job_slice(rid)
        with self._lock:
            self._live.pop(job_key, None)
            if resp.get("ok") and resp.get("routed_backend"):
                # completed keys stay sticky to the backend whose
                # journal holds the record, so a late duplicate is
                # answered by THAT journal (dedup, not re-run)
                self._done_backend[job_key] = resp["routed_backend"]
        faultinject.hit("route-pre-reply")
        live.response = resp
        live.done.set()
        return resp

    def _submit_planned(self, spec: dict, req: dict, job_key: str,
                        requested, rid: int = None) -> dict:
        """Decide scatter vs unsharded for a submit this router owns,
        then run it.  Auto-scatter prices the whole job once at
        concurrency 1 (the single-backend wall the split is trying to
        beat) and only engages when RACON_TPU_TORCH_SCATTER_MIN_WALL_S is
        set; an explicit ``shards`` on the submit always wins.
        ``rid`` is the router-local routing id the owned submit's
        forensics are captured under."""
        n_eligible = sum(1 for b in self.backends if b.eligible())
        wall = None
        if requested is None and scatter.min_wall_s() is not None:
            est = self._price(spec, 1)
            if est:
                wall = est.get("predicted_wall_s")
        k = scatter.plan_shards(requested, wall, n_eligible)
        if k <= 1:
            return self._route_job(spec, req, job_key, rid=rid)
        return self._scatter_job(spec, req, job_key, k, rid=rid)

    def _plan_stage(self, spec: dict, k: int, rid: int = None,
                    trace_id: str = None) -> dict:
        """Staged inputs: build the overlaps slice index once at plan
        time (racon_tpu_torch/io/staging.py) and derive each shard's
        ``stage`` hint from it, so the K daemons skip the (K-1)/K of
        the overlap parse their ownership mask would drop anyway.
        Strictly best-effort: any failure (non-PAF input, malformed
        rows, unreadable targets, a TCP-remote client naming paths
        this host cannot read) returns no hints and every shard
        self-plans or full-parses — a hint can speed a shard up,
        never fail it.  The receiving daemons re-validate path + file
        signature + shard coordinates before trusting a hint."""
        from racon_tpu_torch.io import staging
        if not staging.stage_enabled():
            return {}
        # an internal-mapping spec has no overlaps file to
        # slice — each shard maps its reads itself; the rounds field
        # rides the shard specs (scatter.shard_spec copies the whole
        # spec), which IS the per-shard round plan
        if spec.get("overlaps") is None:
            return {}
        try:
            names = staging.fasta_names(spec["targets"])
            index = staging.get_index(spec["overlaps"], names)
            if index is None:
                return {}
            hints = {i: staging.shard_hint(index, (i, k), len(names))
                     for i in range(k)}
        except Exception:
            return {}
        REGISTRY.add("route_stage_plans")
        obs_flight.FLIGHT.record(
            "route_stage_plan", job=rid, trace_id=trace_id, shards=k,
            total_bytes=hints[0].get("total_bytes"),
            staged_bytes=[hints[i].get("staged_bytes")
                          for i in range(k)])
        return hints

    def _scatter_job(self, spec: dict, req: dict, job_key: str,
                     k: int, rid: int = None) -> dict:
        """Fan a mega-job out as K target-sharded sub-jobs and gather
        the merged reply.  Each shard is a full :meth:`_route_job` —
        independently priced, spilled over, failed over — under the
        derived key ``<job_key>-shard-<i>of<k>``, so exactly-once
        per shard rides on the backends' journals: a duplicate of
        the WHOLE mega-job (e.g. a client retry through a restarted
        router) re-plans identical shards and every backend answers
        its shard from the record.  An explicit shard count is never
        capped by transient eligibility (scatter.plan_shards), so the
        retry's plan matches the original's even when a breaker
        opened in between; and because ``k`` is baked into the key, a
        retry whose auto/threshold plan DID change simply misses the
        old records and re-runs fresh instead of gathering stale
        slices.

        For that journal rendezvous to actually happen, the duplicate
        must re-MEET its records: shard i's first-choice backend is
        the i-th eligible backend in CLI list order — a deterministic
        mapping that survives router restarts (same ``--backends``
        flag => same mapping) and spreads K shards over the fleet by
        construction.  It is only a preference: cost ranking takes
        over the moment the preferred backend is dead, draining or
        full, and a re-run on a different survivor still returns the
        same bytes (the target_slice contract) — exactly-once decays
        to at-least-once only when the fleet itself changed between
        duplicates.

        Each shard runs as a slot holding one or more attempts.
        The original attempt runs under the shard key; the probe
        loop's watchdog (:meth:`_rebalance_scan`) may add speculative
        replacement attempts under derived ``-r<n>`` keys when the
        shard straggles.  First successful attempt wins the slot —
        the gather concatenates winners in target order, so the bytes
        are those of the unsharded run regardless of which attempt
        delivered them — and a superseded attempt's ``job_canceled``
        reply never fails the shard."""
        t0 = obs_trace.now()
        trace_ctx = req.get("trace_context")
        REGISTRY.add("route_scatter_jobs")
        REGISTRY.add("route_scatter_shards", k)
        keys = [scatter.shard_key(job_key, i, k) for i in range(k)]
        eligible = [b.target for b in self.backends if b.eligible()]
        prefer = {i: eligible[i % len(eligible)]
                  for i in range(k)} if eligible else {}
        stage_hints = self._plan_stage(spec, k, rid=rid,
                                       trace_id=trace_ctx)
        # the plan's per-shard predicted walls: the p50 is the
        # straggler watchdog's yardstick for "this shard is late"
        predicted = []
        for i in range(k):
            est = self._price(
                scatter.shard_spec(spec, i, k,
                                   stage=stage_hints.get(i)), 1)
            predicted.append(est.get("predicted_wall_s")
                             if est else None)
        walls = sorted(w for w in predicted if w is not None)
        p50 = walls[len(walls) // 2] if walls else None
        slots = []
        for i in range(k):
            hint = stage_hints.get(i) or {}
            staged = hint.get("staged_bytes")
            total = hint.get("total_bytes")
            slots.append({
                "shard": i, "done": threading.Event(),
                "finished": False, "result": None,
                "winner_key": None, "errors": [], "keys": [],
                "pending": 0, "rebalances": 0,
                "backends": set(), "started": None, "lineage": None,
                "staged_bytes": staged,
                "parse_skipped_bytes": (
                    total - staged
                    if staged is not None and total else None),
            })
        progress = {"job_key": job_key, "shards": k, "done": 0,
                    "backends": [None] * k, "p50_wall_s": p50,
                    "rid": rid, "trace": trace_ctx,
                    "slots": slots}

        def settle(i: int, key: str, resp: dict) -> None:
            slot = slots[i]
            cancel_keys, finished = None, False
            with self._lock:
                slot["pending"] -= 1
                if resp.get("ok") and slot["result"] is None:
                    slot["result"] = resp
                    slot["winner_key"] = key
                    progress["backends"][i] = \
                        resp.get("routed_backend")
                    if resp.get("routed_backend"):
                        # per-attempt sticky: a later duplicate of
                        # this key routes straight back to the
                        # journal that recorded it, even if failover
                        # moved the attempt off its preferred backend
                        self._done_backend[key] = \
                            resp["routed_backend"]
                    cancel_keys = [x for x in slot["keys"]
                                   if x != key]
                elif not resp.get("ok"):
                    slot["errors"].append((key, dict(resp)))
                if (slot["result"] is not None
                        or slot["pending"] == 0) \
                        and not slot["finished"]:
                    slot["finished"] = True
                    progress["done"] += 1
                    finished = True
            obs_flight.FLIGHT.record(
                "route_scatter_shard", job=rid, job_key=job_key,
                trace_id=trace_ctx, shard=i,
                key=key, ok=bool(resp.get("ok")),
                winner=(key == slot["winner_key"]),
                backend=resp.get("routed_backend"),
                wall_s=resp.get("wall_s"))
            if cancel_keys:
                # a superseded sibling may still be running its
                # copy: cancel-after-checkpoint, fire-and-forget
                self._broadcast_cancel(cancel_keys)
            if finished:
                slot["done"].set()

        def run_attempt(i: int, key: str, pref) -> None:
            ta = obs_trace.now()
            try:
                resp = self._route_job(
                    scatter.shard_spec(spec, i, k,
                                       stage=stage_hints.get(i)),
                    req, key, prefer=pref, rid=rid)
            except Exception as exc:  # router bug: the attempt fails,
                # the gather must NOT hang on a slot that can never
                # settle
                obs_flight.FLIGHT.record_exception("error", exc)
                resp = {"ok": False,
                        "error": {"code": "job_failed",
                                  "type": type(exc).__name__,
                                  "reason": str(exc)}}
            if rid is not None:
                obs_trace.TRACER.add_span(
                    "route.attempt", ta, obs_trace.now(), cat="route",
                    args={"job": rid, "job_key": job_key, "key": key,
                          "shard": i, "trace_id": trace_ctx,
                          "backend": resp.get("routed_backend"),
                          "ok": bool(resp.get("ok"))},
                    jobs=[rid])
            settle(i, key, resp)

        def launch(i: int, key: str, pref) -> None:
            slot = slots[i]
            with self._lock:
                slot["pending"] += 1
                slot["keys"].append(key)
                slot["started"] = obs_trace.now()
                if pref:
                    slot["backends"].add(pref)
            threading.Thread(
                target=run_attempt, args=(i, key, pref),
                daemon=True,
                name=f"racon-route-shard-{i}").start()

        # the watchdog launches replacement attempts through the
        # same path the originals take
        progress["launch"] = launch
        with self._lock:
            self._scatter_live[job_key] = progress
        obs_flight.FLIGHT.record(
            "route_scatter", job=rid, job_key=job_key,
            trace_id=trace_ctx, shards=k, keys=keys,
            staged=bool(stage_hints), tenant=spec.get("tenant"))
        eprint(f"[racon_tpu_torch::route] scatter: job {job_key} -> {k} "
               f"target shard(s)"
               + (" (staged inputs)" if stage_hints else ""))
        try:
            for i in range(k):
                launch(i, keys[i], prefer.get(i))
            for slot in slots:
                slot["done"].wait()
            faultinject.hit("route-mid-gather")
            results, win_keys = [], []
            for i, slot in enumerate(slots):
                if slot["result"] is not None:
                    results.append(slot["result"])
                    win_keys.append(slot["winner_key"])
                    continue
                # surface the shard's first REAL failure; completed
                # siblings are journaled on their backends, so the
                # client's retry under the same key re-runs ONLY the
                # failures.  A superseded attempt's job_canceled
                # never speaks for the shard
                resp = next(
                    (r for _, r in slot["errors"]
                     if (r.get("error") or {}).get("code")
                     != "job_canceled"),
                    slot["errors"][-1][1] if slot["errors"]
                    else None)
                REGISTRY.add("route_scatter_failed")
                err = dict((resp or {}).get("error")
                           or {"code": "job_failed",
                               "reason": "shard returned no "
                                         "response"})
                err["shard"] = i
                err["shards"] = k
                return {"ok": False, "error": err}
            out = scatter.merge_responses(results, win_keys)
            wall = obs_trace.now() - t0
            out["wall_s"] = round(wall, 6)
            out["scatter"] = {
                "shards": k,
                "backends": list(progress["backends"]),
                "staged_bytes": [s["staged_bytes"] for s in slots],
                "rebalanced": [s["lineage"] for s in slots]}
            obs_flight.FLIGHT.record(
                "route_gather", job=rid, job_key=job_key,
                trace_id=trace_ctx, shards=k,
                winner_keys=list(win_keys),
                wall_s=round(wall, 6),
                n_sequences=out.get("n_sequences"))
            return out
        finally:
            with self._lock:
                self._scatter_live.pop(job_key, None)

    # -- straggler rebalancing ---------------------------------------

    def _idlest_backend(self, exclude=()):
        """The eligible backend with the lowest live load (probed
        depth + this router's in-flight placements), CLI order as
        the tiebreak — where a straggler's replacement attempt
        goes."""
        with self._lock:
            placing = dict(self._placing)
        best = None
        for idx, backend in enumerate(self.backends):
            if backend.target in exclude or not backend.eligible():
                continue
            rank = (backend.load()
                    + placing.get(backend.target, 0), idx)
            if best is None or rank < best[0]:
                best = (rank, backend.target)
        return best[1] if best else None

    def _broadcast_cancel(self, keys) -> None:
        """Best-effort cancel of superseded attempt keys on every
        backend (failover may have moved an attempt anywhere, and a
        cancel for a key a backend never saw is a cheap no-op).
        Runs detached: the daemon stops the job at its next poll
        site AFTER the last committed checkpoint; nothing here
        blocks routing or gathering."""
        targets = [b.target for b in self.backends]
        timeout = self.probe_timeout

        def worker() -> None:
            for key in keys:
                REGISTRY.add("route_cancels")
                for target in targets:
                    try:
                        client.cancel(target, key, timeout=timeout)
                    except Exception:
                        pass

        threading.Thread(target=worker, daemon=True,
                         name="racon-route-cancel").start()

    def _rebalance_round(self) -> None:
        factor = scatter.rebalance_factor()
        if factor is None:
            return
        now = obs_trace.now()
        with self._lock:
            live = list(self._scatter_live.values())
        for prog in live:
            self._rebalance_scan(prog, factor, now)

    def _rebalance_scan(self, prog: dict, factor: float,
                        now: float) -> None:
        """One watchdog pass over a live scatter: any unfinished
        shard whose CURRENT attempt has run past ``max(factor x
        p50(predicted shard walls), 4 probe periods)`` gets a
        speculative replacement on the idlest eligible backend the
        shard has not yet tried, under a derived ``-r<n>`` key
        (scatter.rebalance_key) so the replacement is its own
        exactly-once unit at its backend's journal.  First success
        wins the slot; the superseded attempts are
        cancel-after-checkpoint'd.  The floor of four probe periods
        keeps a fast plan from tripping on probe jitter; launching
        an attempt resets the shard's clock, so a second rebalance
        needs the replacement to straggle too."""
        k = prog["shards"]
        threshold = max(
            factor * float(prog.get("p50_wall_s") or 0.0),
            4.0 * self.probe_interval)
        for slot in prog.get("slots", ()):
            with self._lock:
                started = slot["started"]
                if slot["finished"] or started is None \
                        or now - started <= threshold \
                        or slot["rebalances"] \
                        >= _REBALANCE_MAX_ATTEMPTS:
                    continue
                exclude = set(slot["backends"])
                superseded = list(slot["keys"])
            target = self._idlest_backend(exclude)
            if target is None:
                continue    # nowhere better to run a copy
            with self._lock:
                if slot["finished"] or slot["rebalances"] \
                        >= _REBALANCE_MAX_ATTEMPTS:
                    continue
                slot["rebalances"] += 1
                attempt = slot["rebalances"]
                i = slot["shard"]
                slot["lineage"] = f"{i}of{k}-r{attempt} <- {i}of{k}"
            key = scatter.rebalance_key(prog["job_key"], i, k,
                                        attempt)
            REGISTRY.add("route_rebalance")
            obs_flight.FLIGHT.record(
                "route_rebalance", job=prog.get("rid"),
                job_key=prog["job_key"], trace_id=prog.get("trace"),
                shard=i, attempt=attempt, key=key,
                superseded=superseded, backend=target,
                elapsed_s=round(now - started, 3),
                threshold_s=round(threshold, 3))
            eprint(f"[racon_tpu_torch::route] rebalance: shard {i}of{k} "
                   f"of job {prog['job_key']} straggling "
                   f"({now - started:.1f}s > {threshold:.1f}s); "
                   f"speculative attempt r{attempt} -> {target}")
            faultinject.hit("route-mid-rebalance")
            prog["launch"](i, key, target)
            # cancel-after-checkpoint on the superseded original:
            # it stops at its next poll site, keeping everything it
            # already journaled
            self._broadcast_cancel(superseded)

    def _route_job(self, spec: dict, req: dict, job_key: str,
                   prefer: str = None, rid: int = None) -> dict:
        priority = int(req.get("priority", 0))
        trace_ctx = req.get("trace_context")
        tenant = spec.get("tenant") if isinstance(spec, dict) else None
        dead = set()          # backends that transport-failed: never
        last_reject = None    # retried for THIS job this round-trip
        # a recorded completion outranks the scatter plan's
        # deterministic shard preference; both are soft — cost order
        # resumes for everything behind the front of the list
        sticky = self._done_backend.get(job_key) or prefer
        for round_no in range(_MAX_ROUNDS):
            hint = None
            tried = set()     # retryable rejects this round
            while True:
                # pick under the plan lock so concurrent placements
                # (scattered shards above all) see each other's
                # still-in-flight choices and spread; the forward
                # itself runs outside the lock
                with self._plan_lock:
                    ranked = self._rank(spec, exclude=dead | tried,
                                        tenant=tenant)
                    if sticky is not None:
                        # a completed key's duplicate goes back to
                        # the recording backend first (stable sort
                        # keeps the cost order for the rest)
                        ranked.sort(key=lambda row:
                                    0 if row[0].target == sticky
                                    else 1)
                    if not ranked:
                        break
                    backend, est = ranked[0]
                    self._placing_inc(backend.target)
                try:
                    faultinject.hit("route-pre-forward")
                    REGISTRY.add("route_submit")
                    obs_flight.FLIGHT.record(
                        "route", job=rid, job_key=job_key,
                        trace_id=trace_ctx,
                        backend=backend.target,
                        round=round_no, load=backend.load(),
                        predicted_wall_s=(round(est.get(
                            "shared_wall_s",
                            est.get("predicted_wall_s", 0.0)), 4)
                            if est else None))
                    try:
                        resp = client.submit(
                            backend.target, spec, priority=priority,
                            want_trace=bool(req.get("trace")),
                            trace_context=req.get("trace_context"),
                            job_key=job_key)
                    except client.ServeError as exc:
                        # the backend died (possibly mid-job): crash
                        # failover — feed the breaker and resubmit
                        # the SAME key to the next survivor; the
                        # journal dedup makes the retry exactly-once
                        if backend.note_failure(str(exc),
                                                obs_trace.now()):
                            self._record_breaker_open(backend,
                                                      str(exc))
                        REGISTRY.add("route_failover")
                        obs_flight.FLIGHT.record(
                            "route_failover", job=rid,
                            job_key=job_key, trace_id=trace_ctx,
                            backend=backend.target,
                            error=str(exc)[:200])
                        eprint(f"[racon_tpu_torch::route] backend "
                               f"{backend.target} failed mid-submit "
                               f"({exc}); failing over")
                        dead.add(backend.target)
                        continue
                finally:
                    self._placing_dec(backend.target)
                err = (resp.get("error") or {}) \
                    if not resp.get("ok") else {}
                code = err.get("code")
                if code in ("queue_full", "job_too_large",
                            "draining"):
                    # retryable elsewhere: spill to the next-best
                    # backend instead of surfacing the reject
                    if code == "draining":
                        backend.mark_draining()
                    REGISTRY.add("route_spillover")
                    obs_flight.FLIGHT.record(
                        "route_spillover", job=rid, job_key=job_key,
                        trace_id=trace_ctx,
                        backend=backend.target, code=code)
                    try:
                        h = float(err["retry_after_s"])
                        hint = h if hint is None else min(hint, h)
                    except (KeyError, TypeError, ValueError):
                        pass
                    last_reject = resp
                    tried.add(backend.target)
                    continue
                # success, or a reject that is the CLIENT's to see
                # (bad_request / input_not_found / job_failed —
                # another backend would answer the same)
                out = dict(resp)
                out["routed_backend"] = backend.target
                if out.get("ok"):
                    self._note_tenant_backend(tenant, job_key,
                                              backend.target)
                return out
            if round_no + 1 < _MAX_ROUNDS and not self._stop.is_set():
                # every eligible backend rejected retryably: honor
                # the servers' retry_after_s hints (min over the
                # round) before re-ranking, jittered — fall back to
                # doubling when no server sent one
                delay = hint if hint is not None and hint > 0 \
                    else 0.5 * (2 ** round_no)
                delay = min(_MAX_ROUND_WAIT_S, delay) * (
                    0.75 + 0.5 * random.random())
                self._stop.wait(delay)
        if last_reject is not None:
            out = dict(last_reject)
            return out
        REGISTRY.add("route_reject.no_backend")
        return protocol.error_frame(
            "no_backend",
            "no live backend accepted the job "
            f"({len(self.backends)} configured)",
            backends=[b.snapshot(obs_trace.now())["breaker"]
                      for b in self.backends])

    # -- status / telemetry docs ---------------------------------------

    def _route_doc(self) -> dict:
        """The ``route_status`` / ``status`` document: per-backend
        breaker + staleness rows, routing counters, listener
        addresses.  ``router: true`` is what clients key rendering
        off."""
        from racon_tpu_torch.io import staging
        now = obs_trace.now()
        stale_after = 3 * self.probe_interval + self.probe_timeout
        rows = []
        for backend in self.backends:
            row = backend.snapshot(now)
            row["stale"] = (row["probe_age_s"] is None
                            or row["probe_age_s"] > stale_after)
            rows.append(row)
        snap = REGISTRY.snapshot()
        counters = {k: v for k, v in snap["counters"].items()
                    if k.startswith("route_")}
        with self._lock:
            in_flight = self._in_flight
            done_keys = len(self._done_backend)
            scatter_rows = [
                {"job_key": p["job_key"], "shards": p["shards"],
                 "done": p["done"], "backends": list(p["backends"]),
                 "staged_bytes": [s["staged_bytes"]
                                  for s in p.get("slots", ())],
                 "parse_skipped_bytes": [s["parse_skipped_bytes"]
                                         for s in p.get("slots",
                                                        ())],
                 "rebalanced": [s["lineage"]
                                for s in p.get("slots", ())]}
                for p in self._scatter_live.values()]
        return {
            "ok": True,
            "router": True,
            "pid": os.getpid(),
            "socket": self.socket_path,
            "tcp": self.tcp_addr,
            "identity": self._identity(),
            "uptime_s": round(now - self._t_start, 3),
            "draining": self._stop.is_set(),
            "in_flight": in_flight,
            "routed_keys": done_keys,
            "probe_interval_s": self.probe_interval,
            "backends": rows,
            "scatter": {"active": scatter_rows,
                        "min_wall_s": scatter.min_wall_s(),
                        "max_shards": scatter.max_shards(),
                        "rebalance_factor":
                            scatter.rebalance_factor(),
                        "staging": staging.stage_enabled()},
            "counters": counters,
        }

    def _health_doc(self) -> dict:
        up = sum(1 for b in self.backends if b.eligible())
        with self._lock:
            in_flight = self._in_flight
        return {
            "ok": True,
            "router": True,
            # capability flag: a wrapper --server pointed here skips
            # client-side --split and lets the router scatter instead
            "scatter": True,
            "status": ("draining" if self._stop.is_set() else "ok"),
            "accepting": not self._stop.is_set(),
            "pid": os.getpid(),
            "identity": self._identity(),
            "uptime_s": round(obs_trace.now() - self._t_start, 3),
            "backends": len(self.backends),
            "backends_up": up,
            "in_flight_jobs": in_flight,
            "queue_depth": 0,
            "running": in_flight,
            # fleet forensics: capture depths + clock anchors
            # (same block shape as the daemon's — the router has no
            # journal)
            "capture": {
                "flight": obs_flight.FLIGHT.stats(),
                "trace": obs_trace.TRACER.capture_stats(),
                "journal": {"enabled": False},
            },
            "wall_t": round(obs_trace.wall_now(), 6),
            "trace_epoch_wall": round(obs_trace.epoch_wall(), 6),
        }

    def _metrics_doc(self) -> dict:
        """Router telemetry in the daemon ``metrics`` shape (identity
        + snapshot + prometheus) so a FleetScraper/``top --fleet``
        over routers and daemons merges without special cases; the
        ``route`` block carries the breaker rows for rendering."""
        from racon_tpu_torch.obs import export
        REGISTRY.set("route_uptime_s",
                     round(obs_trace.now() - self._t_start, 3))
        snap = REGISTRY.snapshot()
        doc = self._route_doc()
        return {
            "ok": True,
            "router": True,
            "pid": os.getpid(),
            "identity": self._identity(),
            "uptime_s": doc["uptime_s"],
            "route": {"backends": doc["backends"],
                      "counters": doc["counters"],
                      "in_flight": doc["in_flight"],
                      "draining": doc["draining"],
                      "tcp": doc["tcp"]},
            "snapshot": export.json_snapshot(snap),
            "prometheus": export.prometheus_text(snap),
        }

    def _flight_doc(self, req: dict) -> dict:
        """Router flight view, at parity with the
        daemon's: ``job`` (routing id), ``job_key`` (key + derived
        family), ``trace_id`` and ``last`` filters, clock anchors,
        and the per-job trace slice when a routing id is given."""
        try:
            job = req.get("job")
            job = int(job) if job is not None else None
            last = int(req.get("last", 0) or 0)
        except (TypeError, ValueError):
            return protocol.error_frame(
                "bad_request", "flight: job/last must be integers")
        job_key = req.get("job_key")
        trace_id = req.get("trace_id")
        if (job_key is not None and not isinstance(job_key, str)) or \
                (trace_id is not None
                 and not isinstance(trace_id, str)):
            return protocol.error_frame(
                "bad_request",
                "flight: job_key/trace_id must be strings")
        doc = {
            "ok": True,
            "router": True,
            "pid": os.getpid(),
            "identity": self._identity(),
            "ring": obs_flight.FLIGHT.stats(),
            "events": obs_flight.FLIGHT.snapshot(
                job=job, last=last, job_key=job_key,
                trace_id=trace_id),
            "wall_t": round(obs_trace.wall_now(), 6),
            "trace_epoch_wall": round(obs_trace.epoch_wall(), 6),
        }
        if job is not None:
            doc["job_trace"] = obs_trace.TRACER.job_slice(job)
        return doc

    def _trace_query_doc(self, req: dict) -> dict:
        """Bounded per-routing-id trace slice (``trace_query``
        parity with the daemon's op; same required bounds)."""
        try:
            job = int(req.get("job"))
        except (TypeError, ValueError):
            return protocol.error_frame(
                "bad_request", "trace_query requires a job id")
        try:
            max_events = int(req.get("max_events"))
        except (TypeError, ValueError):
            max_events = 0
        if max_events <= 0:
            return protocol.error_frame(
                "bad_request",
                "trace_query requires max_events > 0 "
                "(unbounded reads are refused)")
        max_events = min(max_events, _TRACE_QUERY_MAX_EVENTS)
        evs = obs_trace.TRACER.job_slice(job)
        return {
            "ok": True, "router": True, "pid": os.getpid(),
            "identity": self._identity(), "job": job,
            "complete": len(evs) <= max_events,
            "events": evs[-max_events:],
            "capture": obs_trace.TRACER.capture_stats(),
            "wall_t": round(obs_trace.wall_now(), 6),
            "trace_epoch_wall": round(obs_trace.epoch_wall(), 6),
        }

    # -- connection handling -------------------------------------------

    def _serve_connection(self, conn) -> None:
        try:
            req = protocol.recv_frame(conn)
            if req is None:
                return
            op = req.get("op") if isinstance(req, dict) else None
            if op == "submit":
                with self._lock:
                    self._in_flight += 1
                try:
                    resp = self._handle_submit(req)
                finally:
                    with self._lock:
                        self._in_flight -= 1
            elif op in ("status", "route_status"):
                resp = self._route_doc()
            elif op == "health":
                resp = self._health_doc()
            elif op == "metrics":
                resp = self._metrics_doc()
            elif op == "flight":
                resp = self._flight_doc(req)
            elif op == "trace_query":
                resp = self._trace_query_doc(req)
            elif op == "journal_query":
                # the router keeps no journal; answer the op (not
                # bad_request) so a fleet-wide forensic sweep treats
                # "no journal here" as data, not as an error row
                resp = {
                    "ok": True, "router": True, "enabled": False,
                    "pid": os.getpid(),
                    "identity": self._identity(),
                    "records": [], "complete": True, "matched": 0,
                    "wall_t": round(obs_trace.wall_now(), 6),
                    "trace_epoch_wall":
                        round(obs_trace.epoch_wall(), 6),
                }
            elif op == "shutdown":
                resp = {"ok": True, "draining": True}
                self._stop.set()
            else:
                resp = protocol.error_frame(
                    "bad_request", f"unknown op {op!r} (router)")
            protocol.send_frame(conn, resp)
        except protocol.ProtocolError as exc:
            REGISTRY.add("route_bad_frames")
            try:
                protocol.send_frame(conn, protocol.error_frame(
                    "bad_request", str(exc)))
            except OSError:
                pass
        except OSError:
            pass   # client went away mid-reply; nothing to salvage
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _spawn_handler(self, conn) -> None:
        t = threading.Thread(target=self._serve_connection,
                             args=(conn,), daemon=True,
                             name="racon-route-conn")
        self._handlers.append(t)
        t.start()
        self._handlers = [h for h in self._handlers if h.is_alive()]

    def _tcp_accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._tcp_sock.accept()
            except socket.timeout:
                if self._stop.is_set() and self._idle():
                    return
                continue
            except OSError:
                return
            self._spawn_handler(conn)

    def _idle(self) -> bool:
        with self._lock:
            return self._in_flight == 0

    # -- lifecycle -----------------------------------------------------

    def _peer_alive(self):
        """Takeover probe (same proof as the daemon's): True =
        answered a health frame (alive), False = connection refused
        (provably dead), None = ambiguous (refuse takeover)."""
        probe = socket.socket(socket.AF_UNIX)
        probe.settimeout(5.0)
        try:
            probe.connect(self.socket_path)
        except ConnectionRefusedError:
            return False
        except OSError:
            return None
        try:
            protocol.send_frame(probe, {"op": "health"})
            resp = protocol.recv_frame(probe)
            return True if isinstance(resp, dict) else None
        except (protocol.ProtocolError, OSError):
            return None
        finally:
            try:
                probe.close()
            except OSError:
                pass

    def _bind_tcp(self) -> None:
        host, _, port = self.tcp_spec.rpartition(":")
        host = host or "127.0.0.1"
        self._tcp_sock = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._tcp_sock.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._tcp_sock.bind((host, int(port)))
        self._tcp_sock.listen(16)
        self._tcp_sock.settimeout(0.25)
        bound = self._tcp_sock.getsockname()
        self.tcp_addr = f"{bound[0]}:{bound[1]}"

    def serve_forever(self) -> int:
        if os.path.exists(self.socket_path):
            alive = self._peer_alive()
            if alive:
                eprint(f"[racon_tpu_torch::route] error: a live server "
                       f"already owns {self.socket_path}; refusing "
                       f"to take over")
                return 1
            if alive is None:
                eprint(f"[racon_tpu_torch::route] error: cannot prove the "
                       f"owner of {self.socket_path} dead; refusing "
                       f"to take over — remove the socket manually "
                       f"if the process is gone")
                return 1
            eprint(f"[racon_tpu_torch::route] stale socket "
                   f"{self.socket_path}: previous owner is dead, "
                   f"taking over")
            os.unlink(self.socket_path)
        # one synchronous probe round BEFORE accepting: the first
        # submit places against real health, not optimistic zeros
        self._probe_round()
        self._sock = socket.socket(socket.AF_UNIX)
        self._sock.bind(self.socket_path)
        self._sock.listen(16)
        self._sock.settimeout(0.25)
        if self.tcp_spec:
            try:
                self._bind_tcp()
            except (OSError, ValueError) as exc:
                eprint(f"[racon_tpu_torch::route] error: cannot bind TCP "
                       f"front {self.tcp_spec!r}: {exc}")
                self._sock.close()
                try:
                    os.unlink(self.socket_path)
                except OSError:
                    pass
                return 1
            threading.Thread(target=self._tcp_accept_loop,
                             daemon=True,
                             name="racon-route-tcp").start()
        threading.Thread(target=self._probe_loop, daemon=True,
                         name="racon-route-probe").start()
        up = sum(1 for b in self.backends if b.eligible())
        eprint(f"[racon_tpu_torch::route] routing on {self.socket_path}"
               + (f" + tcp {self.tcp_addr}" if self.tcp_addr else "")
               + f" -> {len(self.backends)} backend(s), {up} up "
               f"(probe every {self.probe_interval}s)")
        try:
            while True:
                if self._stop.is_set():
                    if not self._drain_logged:
                        self._drain_logged = True
                        eprint("[racon_tpu_torch::route] draining: "
                               "finishing in-flight jobs, rejecting "
                               "new ones")
                        obs_flight.FLIGHT.record(
                            "drain", in_flight=self._in_flight)
                    if self._idle():
                        break
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                self._spawn_handler(conn)
        finally:
            self._shutdown()
        return 0

    def _shutdown(self) -> None:
        self._stop.set()
        # let blocked submit proxies flush their replies
        for h in list(self._handlers):
            h.join(timeout=10)
        for sock in (self._sock, self._tcp_sock):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        if obs_flight.ENABLED:
            try:
                path = obs_flight.FLIGHT.dump(reason="route-drain")
                eprint(f"[racon_tpu_torch::route] flight dump: {path}")
            except OSError as exc:
                eprint(f"[racon_tpu_torch::route] flight dump failed: "
                       f"{exc}")
        eprint(f"[racon_tpu_torch::route] drained "
               f"({REGISTRY.value('route_submit')} placement(s)); "
               f"bye")

    def request_stop(self, *_sig) -> None:
        self._stop.set()


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.cli route",
        description="Fault-tolerant router fronting several "
        "port's serve daemons: health-probed placement, "
        "spillover on backpressure, circuit breakers, "
        "exactly-once crash failover via idempotent job keys, and "
        "scatter/gather sharding of large jobs across the fleet.")
    p.add_argument("--socket", required=True,
                   help="unix-domain socket path to listen on")
    p.add_argument("--backends", required=True,
                   metavar="SOCK1,SOCK2,...",
                   help="comma-separated backend daemon sockets "
                   "(or host:port TCP fronts)")
    p.add_argument("--tcp", default=None, metavar="HOST:PORT",
                   help="additionally listen on TCP (same framed "
                   "protocol; port 0 = ephemeral, reported in "
                   "route_status).  Default RACON_TPU_TORCH_ROUTE_TCP "
                   "or off")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    backends = [t for t in args.backends.split(",") if t]
    if not backends:
        eprint("[racon_tpu_torch::route] error: --backends needs at least "
               "one socket")
        return 1
    tcp = args.tcp if args.tcp is not None \
        else (os.environ.get("RACON_TPU_TORCH_ROUTE_TCP") or None)
    router = FleetRouter(args.socket, backends, tcp=tcp)
    signal.signal(signal.SIGTERM, router.request_stop)
    signal.signal(signal.SIGINT, router.request_stop)
    return router.serve_forever()


if __name__ == "__main__":
    sys.exit(main())
