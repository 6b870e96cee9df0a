"""The polishing daemon: warm kernels behind a unix-domain socket (JAX
package: racon_tpu/serve/server.py).

``python -m racon_tpu_torch.cli serve --socket PATH`` starts a long-lived
worker that

* prewarms once at startup (:meth:`PolishServer.prewarm`): builds and
  loads every CUDA kernel and the native engine and creates the CUDA
  context on its device (``--device``, default ``cuda``; a daemon asked
  for the card on a machine without one exits non-zero and never serves
  on the CPU instead), so job N >= 2 pays no build, load or context;
* freezes the calibration store (``RACON_TPU_TORCH_CALIB_FREEZE=1``): a
  served job's bytes must equal a one-shot run's at the store the
  daemon found, whatever jobs ran before it;
* answers length-prefixed JSON frames (``serve/protocol.py``): one
  request per connection; ``submit`` blocks until the job finishes
  (with ``trace: true`` the answer carries the job's trace slice and
  flight events), ``watch`` streams telemetry until the client closes
  or the daemon drains, every other op answers at once;
* keeps a write-ahead journal (``serve/journal.py``) and, at start,
  replays a dead predecessor's: finished jobs answer duplicate keyed
  submits, interrupted ones requeue with their checkpoints;
* takes over a stale socket only from a provably dead owner (a
  ``health`` frame round trip, not a bare connect);
* optionally refreshes its gauges in the background
  (``RACON_TPU_TORCH_SERVE_SAMPLE_S`` seconds, 0 = off);
* drains on SIGTERM, SIGINT or a ``shutdown`` op: running and queued
  jobs finish, new submissions get ``draining``, then it exits 0;
* shuts itself down after ``RACON_TPU_TORCH_SERVE_IDLE_S`` idle
  seconds (0 = never, the default).

Containment: a malformed frame answers ``bad_request`` and drops only
that connection; a failing job answers ``job_failed`` on its own
connection; neither touches the queue or the warm kernels.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import signal
import socket
import sys
import threading

from racon_tpu_torch.obs import REGISTRY
from racon_tpu_torch.obs import context as obs_context
from racon_tpu_torch.obs import decision as obs_decision
from racon_tpu_torch.obs import flight as obs_flight
from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.serve import journal as serve_journal
from racon_tpu_torch.serve import protocol
from racon_tpu_torch.serve import recover
from racon_tpu_torch.serve.scheduler import JobScheduler, RejectError
from racon_tpu_torch.serve.session import run_job


def eprint(*args):
    print(*args, file=sys.stderr, flush=True)


#: bounded forensic reads: hard caps a ``journal_query`` /
#: ``trace_query`` response never exceeds, whatever the client asked
#: for — a forensic scan must not ship a multi-GB journal in one frame
JOURNAL_QUERY_MAX_RECORDS = 1024
JOURNAL_QUERY_MAX_BYTES = 8 << 20
TRACE_QUERY_MAX_EVENTS = 4096


def _key_filter_match(rec_key, job_key: str = None,
                      prefix: str = None) -> bool:
    """Does a record tagged ``rec_key`` belong to the asked-for job:
    equal to ``job_key``, or starting with ``prefix``?"""
    if not isinstance(rec_key, str):
        return False
    return rec_key == job_key or (prefix is not None
                                  and rec_key.startswith(prefix))


class PolishServer:
    def __init__(self, socket_path: str, max_queue: int = None,
                 max_jobs: int = None, idle_timeout: float = None,
                 device=None):
        from racon_tpu_torch import resolve_device

        self.socket_path = socket_path
        # the card unless the caller asks for the CPU; a card asked for
        # and missing raises here, before any socket exists
        self.device = resolve_device(device)
        self.idle_timeout = (
            idle_timeout if idle_timeout is not None
            else float(os.environ.get("RACON_TPU_TORCH_SERVE_IDLE_S", "0")))
        self.scheduler = JobScheduler(
            functools.partial(run_job, device=self.device),
            max_queue=max_queue, max_jobs=max_jobs)
        self._sock = None
        self._stop = threading.Event()
        self._handlers: list = []
        self._t_start = obs_trace.now()
        self._last_activity = self._t_start
        self._lock = threading.Lock()
        self._exit_reason = "drain"
        # durability plane: the write-ahead journal handle
        # (opened in serve_forever AFTER the takeover check, so a
        # refused second daemon never writes into the live daemon's
        # journal) and the recovery summary for health/status
        self._journal = None
        self.recovered = {"requeued": 0, "failed": 0, "completed": 0}
        # request-scoped forensics: keep a bounded per-job
        # trace slice for `submit --trace` / `inspect`, and dump the
        # flight ring if any thread dies with an unhandled exception
        obs_trace.TRACER.enable_job_capture()
        obs_flight.FLIGHT.install_dump_on_crash()
        # fleet identity: pin the static identity fields (id,
        # pid, start epoch) at construction so every frame this
        # daemon ever answers carries the same daemon_id
        from racon_tpu_torch.obs import provenance
        provenance.daemon_identity(socket_path)

    def _identity(self) -> dict:
        """The daemon's stable identity block — on every
        ``metrics``/``health``/``watch``/``status`` frame, so a fleet
        scraper attributes telemetry to a process, not a socket."""
        from racon_tpu_torch.obs import provenance
        return provenance.daemon_identity(self.socket_path)

    # -- warm state ----------------------------------------------------

    def prewarm(self) -> None:
        """Build and load every kernel and the native engine, and create
        the CUDA context on the daemon's device, once, before the first
        job: every job, the first included, then finds the kernels
        warm.  Counts ``serve_prewarm_runs``."""
        from racon_tpu_torch.ops import cpu

        with obs_trace.span("serve.prewarm", cat="serve"):
            cpu.get_library()
            if self.device.type == "cuda":
                import torch

                from racon_tpu_torch.cuda import build

                build.build_all()
                for name in build.SOURCES:
                    build.load(name)
                torch.zeros(1, device=self.device)
                torch.cuda.synchronize(self.device)
        REGISTRY.add("serve_prewarm_runs")
        eprint(f"[racon_tpu_torch::serve] prewarmed on {self.device}")

    # -- request handling ----------------------------------------------

    def _handle_submit(self, req: dict) -> dict:
        spec = req.get("job")
        if not isinstance(spec, dict):
            return protocol.error_frame("bad_request",
                                        "submit carries no job object")
        trace_context = req.get("trace_context")
        if trace_context is not None and \
                not obs_context.valid_trace_id(trace_context):
            return protocol.error_frame(
                "bad_request",
                "trace_context must be 1..128 chars of "
                "[A-Za-z0-9._:-] starting alphanumeric")
        job_key = req.get("job_key")
        if job_key is not None and \
                not obs_context.valid_trace_id(job_key):
            return protocol.error_frame(
                "bad_request",
                "job_key must be 1..128 chars of "
                "[A-Za-z0-9._:-] starting alphanumeric")
        try:
            job = self.scheduler.submit(
                spec, priority=int(req.get("priority", 0)),
                trace_context=trace_context, job_key=job_key)
        except RejectError as exc:
            return {"ok": False, "error": exc.error}
        job.done.wait()
        self._touch()
        if not req.get("trace"):
            return job.result
        # job-scoped observability rides the response frame: the
        # trace slice (spans + flow events tagged with this job) and
        # the flight events, so the client can render/inspect the
        # job without any follow-up op
        result = dict(job.result or {})
        result["trace_events"] = obs_trace.TRACER.job_slice(job.id)
        result["flight_events"] = obs_flight.FLIGHT.snapshot(
            job=job.id)
        return result

    def _status_doc(self) -> dict:
        from racon_tpu_torch.obs import provenance

        return {
            "ok": True,
            "pid": os.getpid(),
            "socket": self.socket_path,
            "identity": self._identity(),
            "uptime_s": round(obs_trace.now() - self._t_start, 3),
            "draining": self.scheduler.draining,
            "queue": self.scheduler.snapshot(),
            "journal": self._journal_doc(),
            "recovered": dict(self.recovered),
            "idle_timeout_s": self.idle_timeout,
            "registry": REGISTRY.snapshot(),
            "provenance": provenance.environment(probe=False),
        }

    # -- telemetry -----------------------------------------------

    def telemetry_doc(self, prometheus: bool = False) -> dict:
        """One self-contained telemetry frame: queue state, per-engine
        device utilization, registry snapshot with percentiles, and
        the serving-SLO table.  ``prometheus=True`` additionally
        renders the text exposition (the ``metrics`` op; ``watch``
        frames skip it to stay small)."""
        from racon_tpu_torch.obs import devutil, export

        # publish BEFORE the snapshot so the exposition carries the
        # device_util.* gauges the JSON section reports
        from racon_tpu_torch.cuda import executor as device_executor

        from racon_tpu_torch import cache as rcache

        du = devutil.DEVICE_UTIL.publish(REGISTRY)
        REGISTRY.set("serve_uptime_s",
                     round(obs_trace.now() - self._t_start, 3))
        snap = REGISTRY.snapshot()
        doc = {
            "ok": True,
            "pid": os.getpid(),
            "identity": self._identity(),
            "uptime_s": snap["gauges"]["serve_uptime_s"],
            "queue": self.scheduler.snapshot(),
            "device_util": du,
            "fusion": device_executor.get_executor().stats(),
            "cache": dict(rcache.stats(),
                          sketch=self._cache_health().get("sketch")),
            "slo": export.slo_summary(snap),
            "calhealth": export.drift_summary(snap),
            "snapshot": export.json_snapshot(snap),
            "device_memory": self._device_memory(),
        }
        if prometheus:
            doc["prometheus"] = export.prometheus_text(snap)
        return doc

    def _device_memory(self):
        """This process's caching-allocator bytes on its card (None on
        the CPU): what several daemons sharing one card each hold."""
        if self.device.type != "cuda":
            return None
        import torch

        return {"reserved_bytes": torch.cuda.memory_reserved(self.device),
                "max_reserved_bytes":
                    torch.cuda.max_memory_reserved(self.device),
                "max_allocated_bytes":
                    torch.cuda.max_memory_allocated(self.device)}

    @staticmethod
    def _clock_anchors() -> dict:
        """Wall-clock anchors every forensic frame carries: the
        daemon's wall time at answer (the collector's offset-probe
        sample) and the wall time of its trace epoch (lifts monotonic
        flight/trace timestamps onto the wall clock).  Rendering
        only — never control flow or bytes."""
        return {"wall_t": round(obs_trace.wall_now(), 6),
                "trace_epoch_wall":
                    round(obs_trace.epoch_wall(), 6)}

    def _capture_doc(self) -> dict:
        """capture depths: how much forensic memory this daemon
        still holds — the flight ring's rollover counter, the per-job
        trace index's eviction counter, and the journal depth — so a
        fleet assembler can warn when a ring rolled over mid-job
        instead of presenting a partial lineage as complete."""
        return {
            "flight": obs_flight.FLIGHT.stats(),
            "trace": obs_trace.TRACER.capture_stats(),
            "journal": self._journal_doc(),
        }

    def _flight_doc(self, req: dict) -> dict:
        """The live flight-recorder view (``flight`` op): ring stats
        plus events — optionally filtered to one job (``job``), an
        idempotence key (``job_key``), an exact ``trace_id``, or the
        newest N (``last``); with ``job`` the bounded per-job trace
        slice rides along for timeline rendering."""
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
            "pid": os.getpid(),
            "identity": self._identity(),
            "ring": obs_flight.FLIGHT.stats(),
            "events": obs_flight.FLIGHT.snapshot(
                job=job, last=last, job_key=job_key,
                trace_id=trace_id),
        }
        doc.update(self._clock_anchors())
        if job is not None:
            doc["job_trace"] = obs_trace.TRACER.job_slice(job)
        return doc

    def _journal_query_doc(self, req: dict) -> dict:
        """Bounded read-only journal slice (``journal_query``).
        The ask MUST carry a key filter (``job_key``, or a raw
        ``job_key_prefix``) and ``max_records`` — an unbounded ask is
        a ``bad_request`` by contract — and the response is further
        capped at JOURNAL_QUERY_MAX_RECORDS /
        JOURNAL_QUERY_MAX_BYTES.  ``done`` records have their result
        body slimmed (the recorded FASTA stays on disk; only its size
        ships).  Scans the file with the torn-tail-tolerant reader —
        the live append handle is never touched, so the op is
        read-only by construction."""
        job_key = req.get("job_key")
        prefix = req.get("job_key_prefix")
        if not (isinstance(job_key, str) and job_key) and \
                not (isinstance(prefix, str) and prefix):
            return protocol.error_frame(
                "bad_request",
                "journal_query requires a job_key or "
                "job_key_prefix filter (unbounded reads are "
                "refused)")
        try:
            max_records = int(req.get("max_records"))
        except (TypeError, ValueError):
            max_records = 0
        if max_records <= 0:
            return protocol.error_frame(
                "bad_request",
                "journal_query requires max_records > 0 "
                "(unbounded reads are refused)")
        max_records = min(max_records, JOURNAL_QUERY_MAX_RECORDS)
        try:
            max_bytes = int(req.get("max_bytes",
                                    JOURNAL_QUERY_MAX_BYTES))
        except (TypeError, ValueError):
            max_bytes = JOURNAL_QUERY_MAX_BYTES
        max_bytes = min(max(1, max_bytes), JOURNAL_QUERY_MAX_BYTES)
        base = {"ok": True, "pid": os.getpid(),
                "identity": self._identity()}
        base.update(self._clock_anchors())
        if self._journal is None:
            return dict(base, enabled=False, records=[],
                        complete=True, matched=0)
        records, truncated = serve_journal.scan(self._journal.path)
        records = serve_journal.own_records(records)

        def _slim(rec: dict) -> dict:
            rec = dict(rec)
            res = rec.get("result")
            if isinstance(res, dict):
                slim = {k: res.get(k) for k in
                        ("ok", "job_id", "n_sequences", "wall_s",
                         "trace_id") if k in res}
                fb = res.get("fasta_b64")
                if isinstance(fb, str):
                    slim["fasta_bytes"] = \
                        len(fb) * 3 // 4 - fb[-2:].count("=")
                rec["result"] = slim
            return rec

        sel = [_slim(rec) for rec in records
               if _key_filter_match(rec.get("job_key"),
                                    job_key=(job_key or None),
                                    prefix=(prefix or None))]
        matched = len(sel)
        complete = matched <= max_records
        sel = sel[-max_records:]
        out, used = [], 0
        for rec in sel:
            n = len(json.dumps(rec, separators=(",", ":")))
            if out and used + n > max_bytes:
                complete = False
                break
            out.append(rec)
            used += n
        return dict(base, enabled=True, path=self._journal.path,
                    records=out, scan_truncated=truncated,
                    complete=complete, matched=matched)

    def _trace_query_doc(self, req: dict) -> dict:
        """Bounded per-job trace slice (``trace_query``): the
        same events ``submit --trace`` rides on the response frame,
        readable after the fact by a fleet assembler.  Requires
        ``job`` and ``max_events`` (capped at
        TRACE_QUERY_MAX_EVENTS); read-only against the tracer's
        bounded LRU index."""
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
        max_events = min(max_events, TRACE_QUERY_MAX_EVENTS)
        evs = obs_trace.TRACER.job_slice(job)
        doc = {"ok": True, "pid": os.getpid(),
               "identity": self._identity(), "job": job,
               "complete": len(evs) <= max_events,
               "events": evs[-max_events:],
               "capture": obs_trace.TRACER.capture_stats()}
        doc.update(self._clock_anchors())
        return doc

    def _explain_doc(self, req: dict) -> dict:
        """The decision-plane view (``explain`` op):
        per-stage calibration health plus the decision-record ring —
        optionally filtered to one job (``job``) or the newest N
        events (``last``).  The client CLI renders the per-job cost
        waterfall from this one frame."""
        from racon_tpu_torch.obs import export

        try:
            job = req.get("job")
            job = int(job) if job is not None else None
            last = int(req.get("last", 0) or 0)
        except (TypeError, ValueError):
            return protocol.error_frame(
                "bad_request", "explain: job/last must be integers")
        from racon_tpu_torch import cache as rcache

        snap = REGISTRY.snapshot()
        return {
            "ok": True,
            "pid": os.getpid(),
            "identity": self._identity(),
            "calhealth": export.drift_summary(snap),
            "cache": rcache.stats(),
            "ring": obs_decision.DECISIONS.stats(),
            "counts": obs_decision.DECISIONS.counts(job=job),
            "events": obs_decision.DECISIONS.snapshot(job=job,
                                                      last=last),
        }

    def _health_doc(self) -> dict:
        """Liveness/readiness without a registry walk — cheap enough
        for a tight poll loop, with the internal depths an
        overseer triages with: the flight-ring fill, the device
        executor's fusion-queue backlog, and the in-flight job
        count."""
        from racon_tpu_torch.cuda import executor as device_executor

        q = self.scheduler.snapshot()
        doc = {
            "ok": True,
            "status": "draining" if q["draining"] else "ok",
            "pid": os.getpid(),
            "identity": self._identity(),
            "uptime_s": round(obs_trace.now() - self._t_start, 3),
            "accepting": not q["draining"],
            "queue_depth": q["queue_depth"],
            "running": len(q["running"]),
            "in_flight_jobs": len(q["running"]),
            "paused": q["paused"],
            "flight_ring_depth": obs_flight.FLIGHT.stats()["size"],
            "fusion_queue_depth":
                device_executor.get_executor().pending_units(),
            "cache": self._cache_health(),
            "journal": self._journal_doc(),
            "recovered_jobs": self.recovered["requeued"],
            "recovery": dict(self.recovered),
            # capture depths + clock anchors, so a collector estimates
            # this daemon's clock offset
            # from the probe round trip and warns on rollover
            "capture": self._capture_doc(),
        }
        doc.update(self._clock_anchors())
        return doc

    def _cache_health(self) -> dict:
        """The result cache's cheap health block: hit ratio +
        resident bytes, without the full stats walk.  attaches
        the epoch-tagged digest sketch (cache/sketch.py) —
        ~11 KiB base64 — which the fleet router scores content-keyed
        submits against for affinity placement."""
        from racon_tpu_torch import cache as rcache

        st = rcache.stats()
        doc = {"enabled": st.get("enabled", False),
               "hit_ratio": st.get("hit_ratio", 0.0),
               "bytes": st.get("bytes", 0),
               "entries": st.get("entries", 0)}
        try:
            doc["sketch"] = rcache.sketch_doc()
        except Exception:
            # sketch export is advisory routing data; never let it
            # break a health probe
            doc["sketch"] = None
        return doc

    def _journal_doc(self) -> dict:
        """The write-ahead journal's health block."""
        if self._journal is not None:
            return self._journal.stats()
        return {"enabled": False}

    def _handle_watch(self, conn, req: dict) -> None:
        """Stream telemetry frames on this connection (the one
        multi-frame op).  Ends when ``count`` frames were sent, the
        client closes, or the server drains — sleeping on
        ``self._stop.wait`` so drain interrupts the stream
        promptly."""
        try:
            interval = float(req.get("interval_s", 1.0))
        except (TypeError, ValueError):
            interval = 1.0
        interval = min(max(interval, 0.05), 60.0)
        try:
            count = int(req.get("count", 0))
        except (TypeError, ValueError):
            count = 0
        REGISTRY.add("serve_watchers")
        sent = 0
        try:
            while True:
                doc = self.telemetry_doc(prometheus=False)
                doc["seq"] = sent
                protocol.send_frame(conn, doc)
                sent += 1
                if count and sent >= count:
                    return
                if self._stop.wait(interval):
                    return
        except OSError:
            return   # watcher went away; nothing to salvage

    def _sampler_loop(self, period: float) -> None:
        """Background gauge refresh (RACON_TPU_TORCH_SERVE_SAMPLE_S): keeps
        queue depth / uptime / device utilization current in the
        registry between requests so an exposition scrape never reads
        stale gauges.  Pure read-side — it writes only gauges derived
        from state the events already maintain."""
        from racon_tpu_torch.obs import devutil

        while not self._stop.wait(period):
            devutil.DEVICE_UTIL.publish(REGISTRY)
            q = self.scheduler.snapshot()
            REGISTRY.set("serve_queue_depth", q["queue_depth"])
            REGISTRY.set("serve_running", len(q["running"]))
            REGISTRY.set("serve_uptime_s",
                         round(obs_trace.now() - self._t_start, 3))

    def _serve_connection(self, conn) -> None:
        try:
            req = protocol.recv_frame(conn)
            if req is None:
                return
            op = req.get("op") if isinstance(req, dict) else None
            if op == "watch":
                # multi-frame: the handler owns the connection
                self._handle_watch(conn, req)
                return
            if op == "submit":
                resp = self._handle_submit(req)
            elif op == "status":
                resp = self._status_doc()
            elif op == "metrics":
                resp = self.telemetry_doc(prometheus=True)
            elif op == "health":
                resp = self._health_doc()
            elif op == "flight":
                resp = self._flight_doc(req)
            elif op == "journal_query":
                resp = self._journal_query_doc(req)
            elif op == "trace_query":
                resp = self._trace_query_doc(req)
            elif op == "explain":
                resp = self._explain_doc(req)
            elif op == "cancel":
                key = req.get("job_key")
                if not isinstance(key, str) or not key:
                    resp = protocol.error_frame(
                        "bad_request", "cancel carries no job_key")
                else:
                    resp = self.scheduler.cancel(key)
            elif op == "pause":
                self.scheduler.pause()
                resp = {"ok": True, "paused": True}
            elif op == "resume":
                self.scheduler.resume()
                resp = {"ok": True, "paused": False}
            elif op == "shutdown":
                resp = {"ok": True, "draining": True}
                self._stop.set()
            else:
                resp = protocol.error_frame("bad_request",
                                            f"unknown op {op!r}")
            protocol.send_frame(conn, resp)
        except protocol.ProtocolError as exc:
            REGISTRY.add("serve_bad_frames")
            try:
                protocol.send_frame(
                    conn, protocol.error_frame("bad_request", str(exc)))
            except OSError:
                pass
        except OSError:
            pass   # client went away mid-reply; nothing to salvage
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _touch(self) -> None:
        with self._lock:
            self._last_activity = obs_trace.now()

    def _idle_expired(self) -> bool:
        if self.idle_timeout <= 0:
            return False
        if not self.scheduler.idle():
            return False
        with self._lock:
            return (obs_trace.now() - self._last_activity
                    > self.idle_timeout)

    # -- durability ----------------------------------------------

    def _peer_alive(self):
        """Probe the socket's current owner with a real ``health``
        frame: ``True`` = answered (alive), ``False`` = connection
        refused (dead — the socket is stale), ``None`` = ambiguous
        (connected but no valid frame; the caller refuses takeover
        rather than orphan a wedged-but-alive daemon's queue)."""
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

    def _recover(self) -> None:
        """Open the write-ahead journal and replay any previous
        incarnation's record: terminal outcomes preload the
        scheduler's idempotence index (duplicate keyed submits answer
        from the record), interrupted jobs requeue through NORMAL
        admission carrying their megabatch checkpoints, and the
        replay summary is journaled + flight-recorded.  No-op with
        ``RACON_TPU_TORCH_JOURNAL=0`` — the daemon then behaves exactly as
        without a journal."""
        if not serve_journal.enabled():
            return
        path = serve_journal.journal_path(self.socket_path)
        records, truncated = serve_journal.scan(path)
        # another package's incarnations in the file are never replayed
        records = serve_journal.own_records(records)
        plan = recover.replay(records)
        self._journal = serve_journal.JobJournal(
            path, prior_records=len(records))
        self.scheduler.attach_journal(self._journal)
        self.scheduler.preload_completed(plan["completed"])
        out = recover.requeue(self.scheduler, plan,
                              journal=self._journal,
                              flight=obs_flight.FLIGHT)
        self.recovered = {
            "requeued": out["requeued"],
            "failed": plan["stats"]["failed"] + out["failed"],
            "completed": plan["stats"]["completed"],
        }
        REGISTRY.set("serve_recovered_jobs", out["requeued"])
        if records:
            self._journal.append(
                "recovery", stats=plan["stats"],
                requeued=out["requeued"],
                requeue_failed=out["failed"],
                truncated=truncated or None)
            obs_flight.FLIGHT.record(
                "recovery", records=len(records),
                completed=plan["stats"]["completed"],
                requeued=out["requeued"],
                failed=self.recovered["failed"])
            eprint(f"[racon_tpu_torch::serve] journal replay ({path}): "
                   f"{len(records)} record(s) -> "
                   f"{plan['stats']['completed']} completed, "
                   f"{out['requeued']} requeued, "
                   f"{self.recovered['failed']} failed"
                   + (" (torn tail dropped)" if truncated else ""))

    # -- main loop -----------------------------------------------------

    def serve_forever(self) -> int:
        # a served job's split must be a pure function of the
        # server-start calibration state (see module docstring)
        os.environ["RACON_TPU_TORCH_CALIB_FREEZE"] = "1"
        if os.path.exists(self.socket_path):
            # takeover decision: unlink ONLY a provably dead
            # peer.  A bare connect() can succeed against a wedged
            # listener backlog, so the liveness proof is a real
            # health-frame round trip; anything short of a refused
            # connection or a valid answer refuses takeover rather
            # than orphan a live daemon's queue.
            alive = self._peer_alive()
            if alive:
                eprint(f"[racon_tpu_torch::serve] error: a live server "
                       f"already owns {self.socket_path} "
                       f"(health-frame probe answered); refusing "
                       f"to take over")
                return 1
            if alive is None:
                eprint(f"[racon_tpu_torch::serve] error: cannot prove the "
                       f"owner of {self.socket_path} dead (probe "
                       f"connected but no health frame answered); "
                       f"refusing to take over — remove the socket "
                       f"manually if the process is gone")
                return 1
            eprint(f"[racon_tpu_torch::serve] stale socket "
                   f"{self.socket_path}: previous owner is dead, "
                   f"taking over")
            os.unlink(self.socket_path)
        # journal + crash recovery AFTER the takeover check (a
        # refused second daemon must never touch the live daemon's
        # journal) and BEFORE bind (requeued jobs re-admit before
        # any new submission can race them)
        self._recover()
        self._sock = socket.socket(socket.AF_UNIX)
        self._sock.bind(self.socket_path)
        self._sock.listen(16)
        self._sock.settimeout(0.25)
        eprint(f"[racon_tpu_torch::serve] listening on {self.socket_path} "
               f"(queue {self.scheduler.max_queue}, "
               f"jobs {self.scheduler.max_jobs}, "
               f"idle_timeout {self.idle_timeout or 'off'})")
        try:
            sample_s = float(
                os.environ.get("RACON_TPU_TORCH_SERVE_SAMPLE_S", "0"))
        except ValueError:
            sample_s = 0.0
        if sample_s > 0:
            threading.Thread(
                target=self._sampler_loop,
                args=(max(sample_s, 0.05),), daemon=True,
                name="racon-serve-sampler").start()
        self._touch()   # prewarm time must not count against idle
        try:
            while True:
                if self._stop.is_set():
                    # drain mode: keep ACCEPTING so new submissions
                    # get a structured "draining" reject (and status
                    # keeps answering) while admitted jobs finish;
                    # the loop ends once the last one has
                    if not self.scheduler.draining:
                        eprint("[racon_tpu_torch::serve] draining: "
                               "finishing queued/running jobs, "
                               "rejecting new ones")
                        self.scheduler.start_drain()
                    if self.scheduler.idle():
                        break
                elif self._idle_expired():
                    eprint("[racon_tpu_torch::serve] idle timeout reached, "
                           "shutting down")
                    self._exit_reason = "idle_timeout"
                    break
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                self._touch()
                t = threading.Thread(target=self._serve_connection,
                                     args=(conn,), daemon=True,
                                     name="racon-serve-conn")
                self._handlers.append(t)
                t.start()
                self._handlers = [h for h in self._handlers
                                  if h.is_alive()]
        finally:
            self._shutdown()
        return 0

    def _shutdown(self) -> None:
        with obs_trace.span("serve.drain", cat="serve"):
            self.scheduler.drain()
            # let blocked submit handlers flush their replies before
            # the process goes away
            for h in list(self._handlers):
                h.join(timeout=10)
        try:
            self._sock.close()
        finally:
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        snap = self.scheduler.snapshot()
        if obs_flight.ENABLED:
            # the ring now holds the drain marker and every job's
            # final events — persist it so a post-mortem has the
            # same record the live `flight` op would have served
            try:
                path = obs_flight.FLIGHT.dump(
                    reason=self._exit_reason)
                eprint(f"[racon_tpu_torch::serve] flight dump: {path}")
            except OSError as exc:
                eprint(f"[racon_tpu_torch::serve] flight dump failed: "
                       f"{exc}")
        if self._journal is not None:
            self._journal.close()
        eprint(f"[racon_tpu_torch::serve] drained "
               f"({snap['completed']} job(s) served); bye")

    def request_stop(self, *_sig) -> None:
        self._stop.set()


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.cli serve",
        description="Polishing daemon: keeps the built kernels, the "
        "native engine and the CUDA context warm across jobs submitted "
        "over a unix-domain socket (python -m racon_tpu_torch.cli "
        "submit).")
    p.add_argument("--socket", required=True,
                   help="unix-domain socket path to listen on")
    p.add_argument("--queue", type=int, default=None,
                   help="max queued jobs before backpressure rejects "
                   "(default: RACON_TPU_TORCH_SERVE_QUEUE or 8)")
    p.add_argument("--jobs", type=int, default=None,
                   help="max concurrently running jobs (default: "
                   "RACON_TPU_TORCH_SERVE_JOBS or 2)")
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="self-shutdown after this many idle seconds "
                   "(default: RACON_TPU_TORCH_SERVE_IDLE_S or 0 = never)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu: the device every served "
                   "job runs on")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        server = PolishServer(args.socket, max_queue=args.queue,
                              max_jobs=args.jobs,
                              idle_timeout=args.idle_timeout,
                              device=args.device)
    except (RuntimeError, ValueError) as exc:
        eprint(f"[racon_tpu_torch::serve] error: {exc}")
        return 1
    # graceful drain on SIGTERM/SIGINT (fleet managers send TERM)
    signal.signal(signal.SIGTERM, server.request_stop)
    signal.signal(signal.SIGINT, server.request_stop)
    server.prewarm()
    return server.serve_forever()


if __name__ == "__main__":
    sys.exit(main())
