"""One served job's execution: a polisher and its own report (JAX
package: racon_tpu/serve/session.py).

A worker of the scheduler runs :func:`run_job` for one admitted job: a
fresh polisher from the job's spec, through the same
``overlap/rounds.polish_rounds`` as the one-shot CLI, on the daemon's
device; the response is the FASTA bytes the CLI would have written
plus a ``--metrics-json``-style report of the job's own registry.  The
warm state (built and loaded kernels, the native engine, the CUDA
context, the device executor's engines) is process-wide, so a fresh
polisher on a warm daemon pays none of it.

Per-job counters of process-wide state: the kernel builds and loads
(``cuda/build.py``), native-engine builds (``ops/cpu.py``) and the
daemon's prewarm runs live in the process registry; the session records
each one's delta over the job into the job's registry alone
(``set_local``), so a warm job 2 reports 0 builds and 0 loads while the
process totals keep job 1's.  The job's kernel launches (the wrappers'
counters) are reported the same way, in ``details.launches``.  With
several jobs in flight a delta may include a concurrent job's.

Crash containment: any exception in the polish becomes a structured
``job_failed`` (or ``job_canceled``) answer; the polisher is closed
either way, and nothing the job touched poisons the queue or the warm
kernels.
"""

from __future__ import annotations

import base64

from racon_tpu_torch import obs
from racon_tpu_torch.cuda import build as cuda_build
from racon_tpu_torch.obs import REGISTRY
from racon_tpu_torch.obs import decision as obs_decision
from racon_tpu_torch.obs import flight as obs_flight
from racon_tpu_torch.obs import trace as obs_trace

#: process counters re-reported per job as deltas
PROCESS_COUNTERS = ("cuda_kernel_builds", "cuda_kernel_loads",
                    "native_builds", "serve_prewarm_runs")

#: job-spec option defaults: the one-shot CLI's (cli.parse_args), so
#: an option the client leaves out resolves as the CLI would
OPTION_DEFAULTS = {
    "type": "kC", "window_length": 500, "quality_threshold": 10.0,
    "error_threshold": 0.3, "trim": True, "match": 3, "mismatch": -5,
    "gap": -4, "threads": 1, "drop_unpolished": True,
    "cuda_poa_batches": 0, "cuda_banded_alignment": False,
    "cuda_aligner_batches": 0,
}


def _resolve_options(spec: dict) -> dict:
    opts = dict(OPTION_DEFAULTS)
    for key in OPTION_DEFAULTS:
        if key in spec:
            opts[key] = spec[key]
    return opts


def _wire_durability(polisher, job) -> None:
    """Connect the polisher's durability hooks to the job's journal and
    recovery state (no-ops with the journal off):

    * the calibration pin: split rates from the job's admission
      snapshot, so a resumed job splits as the interrupted run did;
    * the resume windows: megabatch checkpoints replayed from a dead
      incarnation's journal;
    * the checkpoint callback: each committed megabatch appends one
      ``checkpoint`` record.  A full disk degrades durability (counted
      in ``serve_journal_errors``) and never fails the job.
    """
    calib = getattr(job, "calib", None)
    if isinstance(calib, dict) and isinstance(calib.get("data"), dict):
        polisher._calib_pin = calib["data"]
    resume = getattr(job, "resume", None)
    if isinstance(resume, dict):
        windows = {}
        for k, v in (resume.get("windows") or {}).items():
            try:
                cons = base64.b64decode(v[0]) if v[0] else None
                windows[int(k)] = (cons, bool(v[1]))
            except (ValueError, TypeError, IndexError):
                continue   # a torn checkpoint entry: recompute it
        if windows:
            polisher._resume_windows = windows
    journal = getattr(job, "journal", None)
    if journal is None or not getattr(job, "job_key", None):
        return

    def checkpoint(entries):
        enc = {str(i): [(base64.b64encode(cons).decode("ascii")
                         if cons is not None else None), bool(ok)]
               for i, cons, ok in entries}
        try:
            journal.append("checkpoint", job=job.id, job_key=job.job_key,
                           windows=enc)
        except OSError:
            REGISTRY.add("serve_journal_errors")
        obs_flight.FLIGHT.record("checkpoint", job=job.id,
                                 tenant=job.tenant, trace_id=job.trace_id,
                                 n_windows=len(entries))

    polisher._checkpoint_cb = checkpoint


def run_job(job, device=None) -> dict:
    """Run one admitted job on ``device`` (the daemon's); returns the
    response frame body."""
    from racon_tpu_torch.core.polisher import JobCanceledError, PolisherType
    from racon_tpu_torch.obs import provenance
    from racon_tpu_torch.overlap import rounds as overlap_rounds

    spec = job.spec
    opts = _resolve_options(spec)
    base = {k: REGISTRY.value(k) for k in PROCESS_COUNTERS}
    launches0 = cuda_build.launch_counts()
    t0 = obs.now()
    polisher = None
    # a spec with no overlaps carries a rounds count (admission checked
    # it); rounds 1 with an overlaps file is the one-shot CLI's path
    rounds = spec.get("rounds")
    rounds = (rounds if isinstance(rounds, int)
              and not isinstance(rounds, bool) and rounds >= 1 else 1)
    # a scattered sub-job's target shard (admission checked its shape)
    shard = tuple(spec["shard"]) if spec.get("shard") is not None else None
    try:
        with obs.span("serve.job", cat="serve",
                      args={"job": job.id, "priority": job.priority}):

            def configure(p):
                # applied to every round's polisher
                nonlocal polisher
                polisher = p
                # the job's device submissions are its tenant's in the
                # process-wide executor
                p._executor_tenant = getattr(job, "tenant", "default")
                if shard is not None:
                    p._target_shard = shard
                    # the router's slice index; the polisher validates
                    # it and builds its own or takes the full parse on
                    # a mismatch.  Only a parsed overlaps file stages.
                    if isinstance(spec.get("stage"), dict) \
                            and spec.get("overlaps") is not None:
                        p._stage_hint = spec["stage"]
                cancel = getattr(job, "cancel_requested", None)
                if cancel is not None:
                    p._cancel_check = cancel.is_set
                # checkpoints key windows within one pass; a later
                # round's windows would collide, so durability wires
                # single-round jobs only
                if rounds == 1:
                    _wire_durability(p, job)

            polished, polisher = overlap_rounds.polish_rounds(
                spec["sequences"], spec.get("overlaps"), spec["targets"],
                PolisherType[opts["type"]], opts["window_length"],
                opts["quality_threshold"], opts["error_threshold"],
                opts["trim"], opts["match"], opts["mismatch"], opts["gap"],
                opts["threads"], rounds=rounds,
                drop_unpolished=opts["drop_unpolished"],
                cuda_poa_batches=opts["cuda_poa_batches"],
                cuda_banded_alignment=opts["cuda_banded_alignment"],
                cuda_aligner_batches=opts["cuda_aligner_batches"],
                device=device, configure=configure)
        fasta = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                         for s in polished)
    except JobCanceledError:
        if polisher is not None:
            polisher.close()
        REGISTRY.add("serve_jobs_canceled")
        obs_flight.FLIGHT.record("job_canceled", job=job.id,
                                 tenant=job.tenant, trace_id=job.trace_id)
        return {"ok": False,
                "error": {"code": "job_canceled",
                          "reason": "job canceled by the serve tier"}}
    except Exception as exc:
        # the containment boundary: any failure releases the polisher
        # and leaves the daemon serving
        if polisher is not None:
            polisher.close()
        REGISTRY.add("serve_jobs_failed")
        obs_trace.TRACER.add_instant(
            "serve.job_failed", cat="serve",
            args={"job": job.id, "type": type(exc).__name__})
        # the traceback goes to the flight ring, not the response
        obs_flight.FLIGHT.record_exception("error", exc, job=job.id)
        return {"ok": False,
                "error": {"code": "job_failed", "type": type(exc).__name__,
                          "reason": str(exc)}}

    wall = obs.now() - t0
    m = polisher.metrics
    stage_walls = {k: round(v, 6) for k, v in polisher.stage_walls.items()}
    obs_decision.DECISIONS.record(
        "job_stages", wall_s=round(wall, 6), stage_walls=stage_walls,
        split_mode=getattr(polisher, "poa_split_detail", {}).get("mode"))
    # per-job deltas of process counters: local writes only, so the
    # process totals stay untouched
    for name in PROCESS_COUNTERS:
        m.set_local(name, REGISTRY.value(name) - base[name])
    m.set_local("job_wall_s", round(wall, 6))
    launches = {k: v - launches0[k]
                for k, v in cuda_build.launch_counts().items()}
    report = provenance.metrics_doc(
        run_registry=m,
        details={"device": str(getattr(polisher, "device", "cpu")),
                 "stage_walls": stage_walls,
                 "poa_split_detail": getattr(polisher, "poa_split_detail",
                                             {}),
                 "align_split_detail": getattr(polisher,
                                               "align_split_detail", {}),
                 "poa_resumed_windows": getattr(polisher,
                                                "poa_resumed_windows", 0),
                 "launches": launches,
                 "shard": list(shard) if shard is not None else None,
                 "rounds": getattr(polisher, "rounds_report", [])},
        probe=False, device_util=getattr(polisher, "device_util", None))
    polisher.close()
    REGISTRY.add("serve_jobs_completed")
    REGISTRY.add("serve_busy_s", wall)
    return {
        "ok": True,
        "job_id": job.id,
        "n_sequences": fasta.count(b">"),
        "wall_s": round(wall, 6),
        "estimate": job.estimate,
        "fasta_b64": base64.b64encode(fasta).decode("ascii"),
        "report": report,
    }
