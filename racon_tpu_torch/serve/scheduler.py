"""Bounded priority job queue with priced admission control (JAX
package: racon_tpu/serve/scheduler.py).

Whole polish jobs queue for the process's warm kernels, one level above
the reference's per-GPU batch queues (src/cuda/cudapolisher.cpp:257-336).

* **Admission** -- every submission is priced before it enters the
  queue: input file sizes feed byte-rate priors of the align, POA and
  map stages, combined by :func:`racon_tpu_torch.utils.calibrate.
  predict_walls`; ``RACON_TPU_TORCH_SERVE_MAX_WALL_S`` (unset: no cap)
  rejects a job priced past it with ``job_too_large`` and the estimate.
  A spec with no overlaps and no ``rounds`` gets ``missing_overlaps``;
  a malformed ``shard`` (a router's target shard) or ``stage`` (its
  staged-parse plan) gets ``bad_request``, and a staged shard is priced
  at its staged share of the overlaps.
* **Backpressure** -- the queue is bounded
  (``RACON_TPU_TORCH_SERVE_QUEUE``, default 8); a submission past it is
  rejected at once with ``queue_full``, its depth, bound and a
  ``retry_after_s`` priced from the observed exec walls.
* **Workers** -- ``RACON_TPU_TORCH_SERVE_JOBS`` threads (default 2)
  pop jobs by priority, then class (interactive before batch, with an
  aging bound), then arrival, and run each as a tenant of the
  process-wide device executor (``cuda/executor.py``), where concurrent
  jobs' megabatches and align chunks may fuse under deficit round robin
  and a per-tenant in-flight quota.  Each job owns its polisher, whose
  engine assignment is a function of its own input, and the executor
  hands each tenant its own rows back, so bytes stay per job.
* **Durability** -- with a journal attached, the admit record (spec,
  key, calibration snapshot) is written before the job is queued, the
  done or error record before its caller sees the result; keyed
  duplicates join the live job or are answered from the record.
* **Lifecycle** -- ``pause`` and ``resume`` gate the workers without
  touching running jobs; ``drain`` stops admission (``draining``),
  lets queued and running jobs finish, and returns; ``cancel`` by key
  stops a job at its next poll site.
"""

from __future__ import annotations

import heapq
import itertools
import os
import threading
from typing import Callable, Optional

from racon_tpu_torch.obs import REGISTRY
from racon_tpu_torch.obs.metrics import hist_quantile
from racon_tpu_torch.obs import context as obs_context
from racon_tpu_torch.obs import decision as obs_decision
from racon_tpu_torch.obs import faultinject
from racon_tpu_torch.obs import flight as obs_flight
from racon_tpu_torch.obs import trace as obs_trace


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# bytes-per-second priors for the admission price: deliberately crude
# (admission only needs the right order of magnitude to shed a
# monster job) and deliberately NOT the in-run calibrated rates --
# admission prices from file sizes before anything is parsed, and a
# pure-stat model keeps the accept/reject decision a function of the
# submission alone.  RACON_TPU_TORCH_SERVE_{ALIGN,POA}_MBPS override.
_ALIGN_MB_PER_S = 4.0
_POA_MB_PER_S = 2.0
# internal mapping prior: minimizer extraction + chaining over
# reads+draft bytes (RACON_TPU_TORCH_SERVE_MAP_MBPS overrides)
_MAP_MB_PER_S = 8.0


def _mean_fusion_occupancy() -> float:
    """Mean of the executor's ``fusion_occupancy`` histogram (0.0
    before any fused dispatch), the measured input of the shared-wall
    price."""
    h = REGISTRY.snapshot()["histograms"].get("fusion_occupancy")
    if not h or not h.get("count"):
        return 0.0
    return h["sum"] / h["count"]


def _observed_hit_ratio() -> float:
    """Process-wide result-cache hit ratio: hits over lookups
    since daemon start, 0.0 with no traffic or with the cache off.
    Trailing and cross-job by construction — exactly the crudeness
    the admission price already accepts for rates and occupancy."""
    from racon_tpu_torch import cache as rcache

    if not rcache.enabled():
        return 0.0
    hits = REGISTRY.value("cache_hit")
    total = hits + REGISTRY.value("cache_miss")
    return hits / total if total else 0.0


# -- deadline classes ----------------------------------------------
#: valid values for a submission's ``class`` field; rank orders
#: same-priority jobs in the queue (lower rank pops first)
JOB_CLASSES = ("interactive", "batch")
_CLASS_RANK = {"interactive": 0, "batch": 1}


def class_target_p99_s() -> float:
    """The interactive queue-wait SLO target the class machinery
    steers toward (seconds).  Policy plane only."""
    try:
        return float(os.environ.get("RACON_TPU_TORCH_CLASS_TARGET_P99_S",
                                    "2.0"))
    except ValueError:
        return 2.0


def class_headroom() -> float:
    """Base fraction of the queue reserved for interactive work when
    batch admission is throttled (scaled up by observed SLO misses)."""
    try:
        return min(0.9, max(0.0, float(os.environ.get(
            "RACON_TPU_TORCH_CLASS_HEADROOM", "0.125"))))
    except ValueError:
        return 0.125


def _class_wait_p99(job_class: str):
    """Observed queue-wait p99 for one class
    (``serve_class_wait_s.<class>``), or None before any job of that
    class has been popped."""
    h = REGISTRY.snapshot()["histograms"].get(
        f"serve_class_wait_s.{job_class}")
    if not h or not h.get("count"):
        return None
    return hist_quantile(h, 0.99)


def _retry_after_hint_s(pending: int, max_jobs: int,
                        job_class: str = None) -> float:
    """Server-priced backoff hint for retryable rejects.

    The mean observed exec wall (``serve_exec_wall_s``) divided by
    the worker count approximates the drain rate, so ``pending``
    jobs clear in about ``mean * pending / max_jobs`` seconds.
    Before any job has run the mean is unknown; 1 s stands in.
    Clamped to 0.25..30 s — the hint guides a retry schedule, it is
    not a promise.  With a ``job_class`` the hint prices from
    that class's own exec-wall histogram when it has data — a batch
    job retrying against a fleet of short interactive jobs should
    not be told to come back in 250 ms."""
    hists = REGISTRY.snapshot()["histograms"]
    h = hists.get(f"serve_class_exec_s.{job_class}") \
        if job_class else None
    if not h or not h.get("count"):
        h = hists.get("serve_exec_wall_s")
    mean = h["sum"] / h["count"] if h and h.get("count") else 1.0
    return round(min(30.0, max(
        0.25, mean * max(1, pending) / max(1, max_jobs))), 3)


def estimate_job(spec: dict, concurrency: int = 1,
                 hit_ratio: float = None) -> dict:
    """Price a submission from input stats alone.

    Returns the :func:`calibrate.predict_walls` dict (additive wall,
    overlapped floor, predicted wall — plus ``shared_wall_s`` when
    the job would share the device with ``concurrency - 1`` others)
    plus the raw inputs that produced it, so a reject is auditable
    from the response.

    ``hit_ratio`` overrides the trailing process-wide cache ratio in
    the discount — the fleet router passes its per-backend
    sketch-estimated hit fraction here, so the SAME pricing
    model answers both "can this daemon take the job" and "which
    daemon's cache already holds this job's units"."""
    from racon_tpu_torch.utils import calibrate

    sizes = {}
    for key in ("sequences", "overlaps", "targets"):
        path = spec.get(key)
        # overlaps may be absent (internal mapping); the map
        # stage is priced separately below
        sizes[key] = os.stat(path).st_size if path is not None else 0
    align_mbps = float(os.environ.get("RACON_TPU_TORCH_SERVE_ALIGN_MBPS",
                                      _ALIGN_MB_PER_S))
    poa_mbps = float(os.environ.get("RACON_TPU_TORCH_SERVE_POA_MBPS",
                                    _POA_MB_PER_S))
    mb = 1024.0 * 1024.0
    # a staged shard parses only its slice of the overlaps, so the
    # parse and align term prices the staged share of the file
    overlap_bytes = sizes["overlaps"]
    staged_fraction = None
    stage = spec.get("stage")
    if isinstance(stage, dict):
        try:
            sb = int(stage.get("staged_bytes", 0))
            tb = int(stage.get("total_bytes", 0))
        except (TypeError, ValueError):
            sb = tb = 0
        if tb > 0 and 0 <= sb <= tb:
            staged_fraction = sb / tb
            overlap_bytes = sizes["overlaps"] * staged_fraction
    # align work scales with the read+overlap volume, POA with the
    # read volume layered over the targets
    align_s = (sizes["sequences"] + overlap_bytes) / mb / align_mbps
    poa_s = (sizes["sequences"] + sizes["targets"]) / mb / poa_mbps
    # internal mapping: a no-overlaps spec runs the minimap-lite
    # map stage over reads+targets before aligning; priced from its
    # own throughput prior.  A stale externally-supplied PAF never
    # reaches rounds > 1 either — every round past the first re-maps,
    # so the whole pipeline repeats per round.
    map_s = 0.0
    rounds = spec.get("rounds")
    rounds = rounds if isinstance(rounds, int) and rounds >= 1 else 1
    if spec.get("overlaps") is None:
        map_mbps = float(os.environ.get("RACON_TPU_TORCH_SERVE_MAP_MBPS",
                                        _MAP_MB_PER_S))
        map_s = (sizes["sequences"] + sizes["targets"]) / mb / map_mbps
        align_s += map_s
    if hit_ratio is None:
        hit_ratio = _observed_hit_ratio()
    est = calibrate.predict_walls(align_s, poa_s,
                                  overlap_s=min(align_s, poa_s),
                                  concurrency=concurrency,
                                  occupancy=_mean_fusion_occupancy(),
                                  hit_ratio=hit_ratio)
    if rounds > 1:
        # later rounds re-map + re-polish; cache reuse of unchanged
        # windows is already folded in through hit_ratio
        for field in ("additive_wall_s", "overlap_floor_s",
                      "predicted_wall_s", "shared_wall_s"):
            if isinstance(est.get(field), (int, float)):
                est[field] = round(est[field] * rounds, 6)
        est["rounds"] = rounds
    if map_s > 0.0:
        est["map_s"] = round(map_s, 6)
    est["input_bytes"] = sizes
    if staged_fraction is not None:
        est["staged_fraction"] = round(staged_fraction, 6)
        est["input_bytes"] = dict(sizes)
        est["input_bytes"]["overlaps_staged"] = int(overlap_bytes)
    return est


class Job:
    """One queued submission: spec + completion rendezvous."""

    def __init__(self, job_id: int, spec: dict, priority: int,
                 estimate: dict, tenant: str = "default",
                 trace_context: str = None,
                 job_class: str = "interactive"):
        self.id = job_id
        self.spec = spec
        self.priority = priority
        self.estimate = estimate
        self.tenant = tenant
        # deadline class: orders same-priority work (interactive
        # ahead of batch), steers DRR weight and batch admission
        # headroom — policy only, never bytes
        self.job_class = job_class
        # durability plane (all None/unset when the journal is
        # off): the idempotence key, the write-ahead journal handle
        # the session's checkpoint callback appends through, the
        # replayed resume payload ({"windows": ..., "calib": ...}),
        # the admission-time calibration-epoch snapshot, and the
        # dead incarnation's "<pid>:<id>" this job was requeued from
        self.job_key: Optional[str] = None
        self.journal = None
        self.resume: Optional[dict] = None
        self.calib: Optional[dict] = None
        self.recovered_from: Optional[str] = None
        # the job's trace id is fixed AT ADMISSION: a caller-supplied
        # wire trace context wins, else the deterministic
        # per-process id — so the admit flight event, the worker's
        # job context and every span/flight event inside the job all
        # carry the same id, across however many daemons a logical
        # request touched
        self.trace_id = trace_context or \
            obs_context.make_trace_id(job_id)
        self.t_submit: Optional[float] = None   # admission timestamp
        self.done = threading.Event()
        self.result: Optional[dict] = None   # set exactly once
        # rebalancing: set by JobScheduler.cancel(); a queued job
        # finishes as job_canceled without running, a running one
        # stops at the polisher's next between-units poll site
        self.cancel_requested = threading.Event()

    def finish(self, result: dict) -> None:
        self.result = result
        self.done.set()


class RejectError(Exception):
    """Admission refusal; ``.error`` is the machine-readable dict."""

    def __init__(self, error: dict):
        super().__init__(error.get("reason", error.get("code")))
        self.error = error


class JobScheduler:
    def __init__(self, runner: Callable[[Job], dict],
                 max_queue: int = None, max_jobs: int = None):
        self._runner = runner
        self.max_queue = (max_queue if max_queue is not None
                          else _env_int("RACON_TPU_TORCH_SERVE_QUEUE", 8))
        self.max_jobs = max(1, max_jobs if max_jobs is not None
                            else _env_int("RACON_TPU_TORCH_SERVE_JOBS", 2))
        self._cond = threading.Condition()
        self._heap: list = []   # (-priority, class_rank, seq, Job)
        self._seq = itertools.count()
        self._ids = itertools.count(1)
        self._running: dict = {}         # job_id -> Job
        # idempotence plane: live jobs by key (duplicate keyed
        # submit rendezvous on the SAME Job), terminal outcomes by
        # key (duplicate after completion/restart answers from the
        # record), and the write-ahead journal (None = disabled)
        self._by_key: dict = {}          # job_key -> live Job
        self._completed_by_key: dict = {}  # job_key -> result body
        self._journal = None
        self._paused = False
        self._draining = False
        self._stopped = False
        self._completed = 0
        # drift-triggered recalibration: job boundaries left
        # before drift flags may open another epoch (the calhealth
        # registry gauge keeps its stale value until the first
        # post-recalibration observation, so reopening immediately
        # would re-trigger on old data)
        self._drift_cooldown = 0
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"racon-serve-worker-{i}")
            for i in range(self.max_jobs)]
        for t in self._workers:
            t.start()

    # -- durability plane ----------------------------------------

    def attach_journal(self, journal) -> None:
        """Wire the write-ahead journal into the admission and worker
        paths.  The server attaches it BEFORE binding the socket, so
        no submission can race an unjournaled window."""
        self._journal = journal

    def preload_completed(self, results: dict) -> None:
        """Seed the idempotence index with terminal outcomes replayed
        from a previous incarnation's journal (job_key -> result
        frame body): a duplicate keyed submit is answered from the
        record instead of re-running."""
        with self._cond:
            self._completed_by_key.update(results)

    def _journal_append(self, kind: str, **fields) -> None:
        """Best-effort journal write for the worker path: a full disk
        must fail the JOURNAL (counted, visible in health), not the
        job that already ran."""
        if self._journal is None:
            return
        try:
            self._journal.append(kind, **fields)
        except OSError:
            REGISTRY.add("serve_journal_errors")

    def _finished_job(self, job_key: str, result: dict) -> Job:
        """A pre-finished Job wrapping a recorded terminal outcome —
        what a duplicate keyed submit rendezvous on."""
        job = Job(int(result.get("job_id") or 0), None, 0, None)
        job.job_key = job_key
        job.finish(dict(result))
        return job

    def _dedup_lookup(self, job_key: str) -> Optional[Job]:
        """Under ``_cond``: the Job a duplicate keyed submit should
        join, or None if the key is new."""
        done = self._completed_by_key.get(job_key)
        if done is not None:
            return self._finished_job(job_key, done)
        return self._by_key.get(job_key)

    # -- admission -----------------------------------------------------

    def submit(self, spec: dict, priority: int = 0,
               trace_context: str = None, job_key: str = None,
               resume: dict = None,
               recovered_from: str = None) -> Job:
        """Admit a job or raise :class:`RejectError`.  Never blocks on
        queue capacity — backpressure is an immediate structured
        reject, so a full server answers in microseconds.
        ``trace_context`` is the caller's wire trace id: the
        job adopts it as its trace id, so forensics from every daemon
        a logical request touched stitch on one id.

        durability: ``job_key`` is the client's idempotence key —
        a duplicate submit joins the live job or is answered from the
        recorded outcome, never re-run.  ``resume`` /
        ``recovered_from`` are recovery-internal
        (serve/recover.py): the replayed megabatch
        checkpoints + calibration pin of an interrupted job being
        requeued from a dead incarnation."""
        try:
            return self._submit(spec, priority, trace_context,
                                job_key=job_key, resume=resume,
                                recovered_from=recovered_from)
        except RejectError as exc:
            obs_flight.FLIGHT.record(
                "reject",
                tenant=(spec.get("tenant")
                        if isinstance(spec, dict) else None),
                code=exc.error.get("code"),
                trace_id=trace_context,
                predicted_wall_s=(exc.error.get("estimate") or {})
                .get("predicted_wall_s"))
            raise

    def _submit(self, spec: dict, priority: int,
                trace_context: str = None, job_key: str = None,
                resume: dict = None,
                recovered_from: str = None) -> Job:
        if trace_context is not None and \
                not obs_context.valid_trace_id(trace_context):
            raise RejectError({
                "code": "bad_request",
                "reason": "trace_context must be 1..128 chars of "
                          "[A-Za-z0-9._:-] starting alphanumeric"})
        if job_key is not None and \
                not obs_context.valid_trace_id(job_key):
            raise RejectError({
                "code": "bad_request",
                "reason": "job_key must be 1..128 chars of "
                          "[A-Za-z0-9._:-] starting alphanumeric"})
        # idempotence fast path BEFORE input validation: a duplicate
        # of a recorded job must be answered from the record even if
        # its inputs were cleaned up since the original ran
        if job_key is not None:
            with self._cond:
                hit = self._dedup_lookup(job_key)
            if hit is not None:
                REGISTRY.add("serve_dedup_hits")
                obs_flight.FLIGHT.record(
                    "dedup", job=hit.id, job_key=job_key,
                    trace_id=trace_context,
                    recorded=hit.done.is_set())
                return hit
        for key in ("sequences", "overlaps", "targets"):
            path = spec.get(key)
            if key == "overlaps" and path is None:
                # overlaps are optional WHEN the spec opts into
                # internal mapping by carrying a rounds count.  A
                # bare no-overlaps spec gets a structured reject
                # (not the generic input_not_found) telling the
                # client exactly how to opt in.
                if spec.get("rounds") is not None:
                    continue
                raise RejectError({
                    "code": "missing_overlaps",
                    "reason": "spec has no overlaps input and does "
                              "not request internal mapping",
                    "hint": "resubmit with --rounds N (spec field "
                            "\"rounds\") to map reads against the "
                            "draft with the built-in mapper, or "
                            "supply a PAF/MHAP/SAM overlaps path"})
            if not isinstance(path, str):
                raise RejectError({"code": "bad_request",
                                   "reason": f"missing input '{key}'"})
            if not os.path.isfile(path):
                raise RejectError({
                    "code": "input_not_found",
                    "reason": f"{key} file not found on the server "
                              f"host: {path}"})
        rounds = spec.get("rounds")
        if rounds is not None and (not isinstance(rounds, int)
                                   or isinstance(rounds, bool)
                                   or not 1 <= rounds <= 16):
            raise RejectError({
                "code": "bad_request",
                "reason": "rounds must be an integer in [1, 16]"})
        tenant = spec.get("tenant", "default")
        if not isinstance(tenant, str) or not tenant \
                or len(tenant) > 64:
            raise RejectError({
                "code": "bad_request",
                "reason": "tenant must be a non-empty string "
                          "of at most 64 characters"})
        # deadline class: optional, validated at admission
        job_class = spec.get("class", "interactive")
        if job_class not in JOB_CLASSES:
            raise RejectError({
                "code": "bad_request",
                "reason": "class must be one of "
                          + "/".join(JOB_CLASSES)})
        # a routed sub-job carries its target shard as [index, count]
        # (tenant and priority ride the spec and the frame, so a shard
        # inherits both); a malformed one is a bad_request here, not a
        # failed job mid-polish
        shard = spec.get("shard")
        if shard is not None:
            ok_shape = (isinstance(shard, (list, tuple))
                        and len(shard) == 2
                        and all(isinstance(x, int)
                                and not isinstance(x, bool)
                                for x in shard))
            if not ok_shape or not 0 <= shard[0] < shard[1] \
                    or shard[1] > 4096:
                raise RejectError({
                    "code": "bad_request",
                    "reason": "shard must be [index, count] with "
                              "0 <= index < count <= 4096"})
        # the router's slice index may ride a sub-job as "stage": its
        # shape is checked here; the polisher checks its content (path,
        # file signature, shard) and takes the full parse on a mismatch
        stage = spec.get("stage")
        if stage is not None:
            from racon_tpu_torch.io import staging

            stage_err = staging.validate_stage_field(stage)
            if stage_err is not None:
                raise RejectError({"code": "bad_request",
                                   "reason": stage_err})
        # price against the load the job would actually share the
        # device with (approximate read outside the lock is fine --
        # admission only needs the right order of magnitude)
        with self._cond:
            concurrency = len(self._running) + len(self._heap) + 1
        estimate = estimate_job(spec, concurrency=concurrency)
        cap = os.environ.get("RACON_TPU_TORCH_SERVE_MAX_WALL_S")
        priced = estimate.get("shared_wall_s",
                              estimate["predicted_wall_s"])
        if cap and priced > float(cap):
            REGISTRY.add("serve_reject.job_too_large")
            raise RejectError({
                "code": "job_too_large",
                "reason": f"predicted wall {priced:.1f}s "
                          f"(at concurrency {concurrency}) exceeds "
                          f"RACON_TPU_TORCH_SERVE_MAX_WALL_S={cap}",
                "estimate": estimate})
        with self._cond:
            if self._draining:
                REGISTRY.add("serve_reject.draining")
                raise RejectError({
                    "code": "draining",
                    "reason": "server is draining: running jobs "
                              "finish, new jobs are rejected",
                    "retry_after_s": _retry_after_hint_s(
                        len(self._heap) + len(self._running),
                        self.max_jobs, job_class=job_class)})
            if len(self._heap) >= self.max_queue:
                REGISTRY.add("serve_reject.queue_full")
                raise RejectError({
                    "code": "queue_full",
                    "reason": "job queue is at capacity; retry later",
                    "queue_depth": len(self._heap),
                    "max_queue": self.max_queue,
                    "running": len(self._running),
                    # one slot must free before a retry can admit
                    "retry_after_s": _retry_after_hint_s(
                        1, self.max_jobs, job_class=job_class)})
            if job_class == "batch":
                # SLO-driven admission headroom: the queue's tail
                # slots are reserved for interactive work, and the
                # reservation GROWS while the observed interactive
                # queue-wait p99 misses its target — admission derives
                # from measured SLO attainment, not static priority
                reserve = self._batch_reserved_slots()
                if reserve and \
                        len(self._heap) >= self.max_queue - reserve:
                    REGISTRY.add("serve_reject.class_headroom")
                    raise RejectError({
                        "code": "queue_full",
                        "reason": "queue headroom reserved for "
                                  "interactive class; retry later",
                        "queue_depth": len(self._heap),
                        "max_queue": self.max_queue,
                        "reserved_slots": reserve,
                        "running": len(self._running),
                        "retry_after_s": _retry_after_hint_s(
                            1, self.max_jobs, job_class=job_class)})
            if job_key is not None:
                # re-check under the admission lock: two concurrent
                # NEW submits with the same key must admit once
                hit = self._dedup_lookup(job_key)
                if hit is not None:
                    REGISTRY.add("serve_dedup_hits")
                    obs_flight.FLIGHT.record(
                        "dedup", job=hit.id, job_key=job_key,
                        trace_id=trace_context,
                        recorded=hit.done.is_set())
                    return hit
            job = Job(next(self._ids), spec, priority, estimate,
                      tenant=tenant, trace_context=trace_context,
                      job_class=job_class)
            job.t_submit = obs_trace.now()
            job.resume = resume
            job.recovered_from = recovered_from
            job.journal = self._journal
            if self._journal is not None:
                # every journaled job has a key — client-supplied or
                # daemon-minted — because replay merges records
                # across incarnations by key
                job.job_key = job_key or \
                    f"auto-{os.getpid()}-{job.id}"
                # the calibration epoch the job is pinned to: a
                # requeued job carries its ORIGINAL admission
                # snapshot forward (byte-identity across restart),
                # a fresh job snapshots now
                if resume and isinstance(resume.get("calib"), dict):
                    job.calib = resume["calib"]
                else:
                    from racon_tpu_torch.utils import calibrate
                    job.calib = calibrate.epoch_snapshot()
                # write-AHEAD: the admit record is durable before the
                # job is queued (a crash after this line replays it)
                self._journal_append(
                    "admit", job=job.id, job_key=job.job_key,
                    spec=spec, priority=priority, tenant=tenant,
                    trace_id=job.trace_id, calib=job.calib,
                    recovered_from=recovered_from)
            else:
                job.job_key = job_key
            if job.job_key:
                self._by_key[job.job_key] = job
            faultinject.hit("post-admit")
            heapq.heappush(self._heap,
                           (-priority, _CLASS_RANK[job_class],
                            next(self._seq), job))
            REGISTRY.add("serve_jobs_submitted")
            REGISTRY.add("serve_admit")
            REGISTRY.peak("serve_queue_high_water", len(self._heap))
            REGISTRY.set("serve_queue_depth", len(self._heap))
            obs_trace.TRACER.add_instant(
                "serve.submit", cat="serve",
                args={"job": job.id, "tenant": tenant,
                      "trace_id": job.trace_id,
                      "priority": priority,
                      "queue_depth": len(self._heap)})
            obs_flight.FLIGHT.record(
                "admit", job=job.id, tenant=tenant,
                trace_id=job.trace_id, job_key=job.job_key,
                priority=priority, job_class=job_class,
                predicted_wall_s=round(
                    estimate.get("predicted_wall_s", 0.0), 4),
                shared_wall_s=(round(estimate["shared_wall_s"], 4)
                               if "shared_wall_s" in estimate
                               else None),
                queue_depth=len(self._heap))
            self._cond.notify()
            return job

    # -- deadline-class policy -------------------------------------

    #: a queued batch job older than this many interactive p99
    #: targets jumps the class ordering — the starvation bound
    CLASS_STARVATION_FACTOR = 4.0

    def _batch_reserved_slots(self) -> int:
        """Queue slots reserved for interactive admissions while
        batch is throttled.  The base reservation is
        ``RACON_TPU_TORCH_CLASS_HEADROOM`` of the queue; while the observed
        interactive queue-wait p99 exceeds
        ``RACON_TPU_TORCH_CLASS_TARGET_P99_S`` the reservation scales with
        the miss ratio (capped at half the queue) — measured SLO
        attainment drives admission, not static priority."""
        frac = class_headroom()
        if frac <= 0.0:
            return 0
        target = class_target_p99_s()
        p99 = _class_wait_p99("interactive")
        if target > 0 and p99 is not None and p99 > target:
            frac = min(0.5, frac * min(4.0, p99 / target))
        return min(self.max_queue - 1,
                   int(self.max_queue * frac + 0.5))

    def _class_weight(self, job) -> float:
        """DRR weight for a job's executor tenancy, derived from
        observed per-class SLO attainment instead of static
        priority alone.  Interactive work always carries at least 2x
        batch weight; when its observed queue-wait p99 misses the
        target, the weight scales with the miss ratio (capped 8x) so
        the executor's deficit-round-robin leans harder toward the
        class that is actually late.  Priority still floors the
        weight, so explicit priorities keep meaning."""
        base = max(1.0, 1.0 + job.priority)
        if job.job_class != "interactive":
            return base
        target = class_target_p99_s()
        p99 = _class_wait_p99("interactive")
        if target <= 0 or p99 is None:
            return max(base, 2.0)
        return max(base, min(8.0, 2.0 * max(1.0, p99 / target)))

    def _pop_next_job(self):
        """Pop the next job honoring the class order with a
        starvation bound: normally strict heap order (priority, then
        interactive-before-batch, then FIFO), but a batch job queued
        longer than CLASS_STARVATION_FACTOR x the interactive p99
        target jumps ahead of an interactive head — so a steady
        interactive stream can delay batch work only boundedly.
        Called under the lock with a non-empty heap."""
        head = self._heap[0][-1]
        bound = self.CLASS_STARVATION_FACTOR * class_target_p99_s()
        if head.job_class == "interactive" and bound > 0:
            now = obs_trace.now()
            aged = [e for e in self._heap
                    if e[-1].job_class == "batch"
                    and e[-1].t_submit is not None
                    and now - e[-1].t_submit > bound]
            if aged:
                entry = min(aged, key=lambda e: e[-1].t_submit)
                self._heap.remove(entry)
                heapq.heapify(self._heap)
                REGISTRY.add("serve_class_aged_pops")
                obs_flight.FLIGHT.record(
                    "class_age_pop", job=entry[-1].id,
                    tenant=entry[-1].tenant,
                    waited_s=round(now - entry[-1].t_submit, 3))
                return entry[-1]
        return heapq.heappop(self._heap)[-1]

    # -- workers -------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                # event-driven wakeup: every transition that could
                # unblock a worker (submit/resume/start_drain/stop)
                # notifies, so no timeout-poll -- a submission admits
                # the instant a worker is free instead of up to 500 ms
                # later, and an idle daemon stops waking 2x/s
                while not self._stopped and (
                        self._paused or not self._heap):
                    self._cond.wait()
                if self._stopped:
                    return
                job = self._pop_next_job()
                self._running[job.id] = job
                REGISTRY.set("serve_queue_depth", len(self._heap))
                REGISTRY.set("serve_running", len(self._running))
            # SLO clocks: queue wait (admission -> pop), exec wall
            # (pop -> finish), e2e wall (admission -> finish).
            # Observability only -- nothing downstream reads them.
            t_pop = obs_trace.now()
            queue_wait = None
            if job.t_submit is not None:
                queue_wait = t_pop - job.t_submit
                REGISTRY.observe("serve_queue_wait_s", queue_wait)
                REGISTRY.observe(
                    f"serve_queue_wait_s.{job.tenant}", queue_wait)
                REGISTRY.observe(
                    f"serve_class_wait_s.{job.job_class}", queue_wait)
            obs_flight.FLIGHT.record(
                "start", job=job.id, tenant=job.tenant,
                trace_id=job.trace_id, job_key=job.job_key,
                queue_wait_s=(round(queue_wait, 6)
                              if queue_wait is not None else None))
            if job.job_key:
                self._journal_append("start", job=job.id,
                                     job_key=job.job_key,
                                     tenant=job.tenant)
            if job.cancel_requested.is_set():
                # canceled while still queued — finish through
                # the normal terminal path (journal record + dedup
                # index + rendezvous) without ever running
                result = {
                    "ok": False,
                    "error": {"code": "job_canceled",
                              "reason": "job canceled before start "
                                        "(superseded by a rebalanced "
                                        "attempt)"}}
            else:
                # the job is a device-executor tenant for its
                # lifetime: its megabatches fuse with other registered
                # tenants', under the executor's DRR fairness +
                # in-flight quota
                from racon_tpu_torch.cuda import executor as device_executor

                ex = device_executor.get_executor()
                ex.register_tenant(job.tenant,
                                   weight=self._class_weight(job))
                # the job context makes everything recorded during
                # this job's execution — spans, flight events, log
                # lines — attributable to (job, tenant) with no
                # call-site plumbing
                with obs_context.job_context(job.id, job.tenant,
                                             trace_id=job.trace_id):
                    try:
                        result = self._runner(job)
                    except Exception as exc:  # runner bug: job fails,
                        obs_flight.FLIGHT.record_exception(  # server
                            "error", exc)          # and queue survive
                        result = {
                            "ok": False,
                            "error": {"code": "job_failed",
                                      "type": type(exc).__name__,
                                      "reason": str(exc)}}
                    finally:
                        ex.release_tenant(job.tenant)
            t_done = obs_trace.now()
            exec_wall = t_done - t_pop
            obs_trace.TRACER.add_span(
                "serve.exec", t_pop, t_done, cat="serve",
                args={"job": job.id, "tenant": job.tenant,
                      "trace_id": job.trace_id,
                      "ok": bool(result.get("ok"))})
            obs_flight.FLIGHT.record(
                "done", job=job.id, tenant=job.tenant,
                trace_id=job.trace_id, job_key=job.job_key,
                ok=bool(result.get("ok")),
                exec_wall_s=round(exec_wall, 6))
            REGISTRY.observe("serve_exec_wall_s", exec_wall)
            REGISTRY.observe(
                f"serve_class_exec_s.{job.job_class}", exec_wall)
            if job.t_submit is not None:
                REGISTRY.observe("serve_e2e_wall_s",
                                 t_done - job.t_submit)
            # predicted-vs-actual drift of the admission price
            # (calibrate.predict_walls): ratio 1.0 = perfect, the
            # histogram's spread IS the model error
            predicted = (job.estimate or {}).get("predicted_wall_s", 0)
            if predicted and predicted > 0:
                REGISTRY.observe("serve_wall_err_ratio",
                                 exec_wall / predicted)
                # decision-plane twin: the job-level admission
                # drift as an exemplar, so `explain --job N` shows the
                # headline predicted-vs-actual next to the per-stage
                # attribution
                obs_decision.DECISIONS.record(
                    "job_wall", job=job.id, tenant=job.tenant,
                    trace_id=job.trace_id,
                    predicted_s=round(float(predicted), 6),
                    measured_s=round(exec_wall, 6),
                    ratio=round(exec_wall / predicted, 6))
            if result.get("ok"):
                # content affinity: this job's content is warm in
                # the local result cache now — note its digest sample
                # into the sketch the fleet router prices against
                from racon_tpu_torch.serve import affinity

                affinity.note_job_content(job.spec)
            # drift-triggered recalibration: a job boundary is
            # the only place a new calibration epoch may open (jobs
            # in flight keep their pinned rates)
            self._drift_epoch_tick()
            # the response frame names its trace id, so journal-deduped
            # replays (which reuse the recorded frame) correlate too;
            # observability only
            if isinstance(result, dict) and result.get("ok"):
                result.setdefault("trace_id", job.trace_id)
            # terminal record BEFORE the client rendezvous: once the
            # caller sees the result, any crash must replay it from
            # the journal, not re-run the job
            faultinject.hit("pre-done-record")
            if job.job_key:
                if result.get("ok"):
                    self._journal_append("done", job=job.id,
                                         job_key=job.job_key,
                                         result=result)
                else:
                    self._journal_append("error", job=job.id,
                                         job_key=job.job_key,
                                         error=result.get("error"))
            with self._cond:
                del self._running[job.id]
                self._completed += 1
                if job.job_key:
                    self._completed_by_key[job.job_key] = result
                    self._by_key.pop(job.job_key, None)
                REGISTRY.set("serve_running", len(self._running))
                self._cond.notify_all()
            job.finish(result)

    #: job boundaries to wait after a drift epoch closes before
    #: drift flags may open another one
    DRIFT_REOPEN_COOLDOWN = 5

    def _drift_epoch_tick(self) -> None:
        """drift-triggered recalibration, called once per job
        boundary from the worker loop.  When any calhealth stage's
        EWMA drift ratio has left the advisory band, open a
        calibration epoch (calibrate.open_drift_epoch lifts the
        serve-mode freeze for one two-pass recalibration); while an
        epoch is open, count boundaries until it closes.  Policy
        plane only: new rates affect pricing/pacing of jobs admitted
        AFTER they persist — in-flight jobs keep their pinned
        epoch snapshot, so bytes never drift within a job."""
        from racon_tpu_torch.utils import calibrate

        try:
            if not calibrate.drift_epoch_enabled():
                return
            if calibrate.drift_epoch_state()["open"]:
                if calibrate.note_drift_job():
                    # epoch just closed: freeze re-arms, start the
                    # reopen cooldown so the stale EWMA gauge can't
                    # immediately re-trigger
                    self._drift_cooldown = self.DRIFT_REOPEN_COOLDOWN
                    obs_flight.FLIGHT.record("calib_drift_epoch",
                                             state="closed")
                return
            if self._drift_cooldown > 0:
                self._drift_cooldown -= 1
                return
            from racon_tpu_torch.obs import calhealth

            drifted = sorted(
                stage for stage, row in
                calhealth.summary().get("stages", {}).items()
                if row.get("drift"))
            if not drifted:
                return
            if calibrate.open_drift_epoch():
                for stage in drifted:
                    # re-seed the EWMA so the drift flag measures the
                    # NEW rates instead of averaging across the epoch
                    calhealth.reset_stage(stage)
                REGISTRY.add("calib_drift_epochs")
                obs_flight.FLIGHT.record("calib_drift_epoch",
                                         state="open", stages=drifted)
        except Exception:
            # drift bookkeeping is advisory — never fail a job
            # boundary on it
            pass

    # -- cancellation --------------------------------------------

    def cancel(self, job_key: str) -> dict:
        """Best-effort cancel by idempotence key.  A queued job finishes as ``job_canceled`` without running; a
        running one stops at the polisher's next between-units poll
        site — cancel-after-checkpoint, so everything it journaled
        stays replayable.  Unknown/finished keys are a no-op: cancel
        can always be sent safely."""
        with self._cond:
            job = self._by_key.get(job_key)
            if job is None:
                state = ("finished"
                         if job_key in self._completed_by_key
                         else "unknown")
                return {"ok": True, "job_key": job_key,
                        "state": state}
            job.cancel_requested.set()
            state = ("running" if job.id in self._running
                     else "queued")
        REGISTRY.add("serve_cancel_requests")
        obs_flight.FLIGHT.record("cancel", job=job.id,
                                 job_key=job_key, state=state,
                                 trace_id=job.trace_id)
        return {"ok": True, "job_key": job_key, "state": state}

    # -- lifecycle -----------------------------------------------------

    def pause(self) -> None:
        """Stop popping queued jobs (running ones continue) — a
        maintenance gate; admission stays open."""
        with self._cond:
            self._paused = True

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def start_drain(self) -> None:
        """Flip to draining: new submissions reject, queued + running
        jobs keep going.  A paused queue resumes — admitted jobs were
        promised execution."""
        first = False
        with self._cond:
            if not self._draining:
                first = True
                queued, running = len(self._heap), len(self._running)
            self._draining = True
            self._paused = False
            self._cond.notify_all()
        if first:
            # the forensic drain marker: a post-SIGTERM flight dump
            # shows when admission closed and what was still in flight
            obs_flight.FLIGHT.record("drain", queued=queued,
                                     running=running)

    def wait_drained(self, timeout: float = None) -> bool:
        """Block until every admitted job finished, then stop the
        workers.  Returns True when everything finished in time."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._heap and not self._running, timeout)
            self._stopped = True
            self._cond.notify_all()
        return ok

    def drain(self, timeout: float = None) -> bool:
        """Reject new jobs, finish queued + running ones."""
        self.start_drain()
        return self.wait_drained(timeout)

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    def idle(self) -> bool:
        with self._cond:
            return not self._heap and not self._running

    def snapshot(self) -> dict:
        with self._cond:
            tenants: dict = {}
            classes = {c: {"queued": 0, "running": 0}
                       for c in JOB_CLASSES}
            for entry in self._heap:
                job = entry[-1]
                row = tenants.setdefault(
                    job.tenant, {"queued": 0, "running": 0})
                row["queued"] += 1
                classes[job.job_class]["queued"] += 1
            for job in self._running.values():
                row = tenants.setdefault(
                    job.tenant, {"queued": 0, "running": 0})
                row["running"] += 1
                classes[job.job_class]["running"] += 1
            return {
                "queue_depth": len(self._heap),
                "max_queue": self.max_queue,
                "running": sorted(self._running),
                "max_jobs": self.max_jobs,
                "completed": self._completed,
                "paused": self._paused,
                "draining": self._draining,
                "tenants": {t: tenants[t] for t in sorted(tenants)},
                "classes": classes,
            }
