"""Journal replay: a dead daemon's record made into live work (JAX
package: racon_tpu/serve/recover.py).

:func:`replay` folds scanned journal records (``serve/journal.py``) into
a plan; the restarting daemon (``serve/server.py``) then

* preloads every terminal job's outcome into the scheduler's
  idempotence index, so a client retrying ``submit --job-key`` after
  the crash gets the recorded result (or error) without a re-run;
* requeues every interrupted job (admitted, neither ``done`` nor
  ``error``) through the normal admission path with its priority,
  tenant, trace id, calibration pin and the union of its megabatch
  checkpoints, so the resumed run skips the committed windows and
  writes the same bytes;
* journals an ``error`` for a job whose requeue is rejected (inputs
  deleted, queue shrunk), so its failure is terminal and visible.

Records merge across incarnations by ``job_key``, later records winning
per window: a job that survived two crashes resumes with everything any
incarnation committed.
"""

from __future__ import annotations

def replay(records) -> dict:
    """Fold journal records into a recovery plan::

        {"completed":   {job_key: result_frame_body},
         "interrupted": [{"job_key", "spec", "priority", "tenant",
                          "trace_id", "calib",
                          "windows": {ordinal: [cons_b64|None, ok]},
                          "started": bool, "job", "pid"}, ...],
         "stats": {"records", "jobs", "completed", "failed",
                   "interrupted", "checkpoint_windows"}}

    ``completed`` holds terminal outcomes (success AND journaled
    errors — both answer a duplicate submit without a re-run).
    ``interrupted`` preserves journal admission order, so requeue
    order matches the dead daemon's queue order.
    """
    jobs: dict = {}        # job_key -> folded state
    order: list = []       # admission order of keys
    # journal records carry (pid, job) — unique per incarnation --
    # and admit maps that pair to the job_key every later record of
    # the same incarnation is folded under
    key_of: dict = {}      # (pid, job) -> job_key
    n_jobs = 0

    for rec in records:
        kind = rec.get("kind")
        pid, jid = rec.get("pid"), rec.get("job")
        if kind == "admit":
            key = rec.get("job_key") or f"auto-{pid}-{jid}"
            key_of[(pid, jid)] = key
            st = jobs.get(key)
            if st is None:
                n_jobs += 1
                st = {"job_key": key, "windows": {},
                      "started": False, "terminal": None,
                      "result": None}
                jobs[key] = st
                order.append(key)
            # latest admit wins for the job description (a requeued
            # job's spec is identical; its calib pin must be the
            # ORIGINAL epoch, which the requeue admit carries along)
            st.update({
                "spec": rec.get("spec"),
                "priority": rec.get("priority", 0),
                "tenant": rec.get("tenant"),
                "trace_id": rec.get("trace_id"),
                "calib": rec.get("calib"),
                "job": jid, "pid": pid,
            })
            continue
        key = rec.get("job_key") or key_of.get((pid, jid))
        st = jobs.get(key)
        if st is None:
            continue   # header/recovery markers, or a torn admit
        if kind == "start":
            st["started"] = True
        elif kind == "checkpoint":
            for ordinal, payload in (rec.get("windows")
                                     or {}).items():
                st["windows"][str(ordinal)] = payload
        elif kind == "done":
            st["terminal"] = "done"
            st["result"] = rec.get("result")
        elif kind == "error":
            st["terminal"] = "error"
            st["result"] = {"ok": False,
                            "error": rec.get("error")
                            or {"code": "job_failed",
                                "reason": "journaled failure"}}

    completed = {}
    interrupted = []
    n_ckpt = 0
    for key in order:
        st = jobs[key]
        if st["terminal"] is not None:
            if st["result"] is not None:
                completed[key] = st["result"]
            continue
        n_ckpt += len(st["windows"])
        interrupted.append({
            "job_key": key,
            "spec": st.get("spec"),
            "priority": st.get("priority", 0),
            "tenant": st.get("tenant"),
            "trace_id": st.get("trace_id"),
            "calib": st.get("calib"),
            "windows": st["windows"],
            "started": st["started"],
            "job": st.get("job"), "pid": st.get("pid"),
        })
    n_failed = sum(1 for key in order
                   if jobs[key]["terminal"] == "error")
    return {
        "completed": completed,
        "interrupted": interrupted,
        "stats": {
            "records": len(records),
            "jobs": n_jobs,
            "completed": len(completed) - n_failed,
            "failed": n_failed,
            "interrupted": len(interrupted),
            "checkpoint_windows": n_ckpt,
        },
    }


def requeue(scheduler, plan, journal=None, flight=None) -> dict:
    """Push a plan's interrupted jobs back through the scheduler's
    normal admission path.  Returns ``{"requeued": n, "failed": n}``.

    Rejected requeues (missing inputs, shrunken queue) become
    terminal: the error is journaled and preloaded into the
    idempotence index so a keyed retry sees ``job_failed`` with the
    reason instead of hanging on a job that will never run."""
    from racon_tpu_torch.serve.scheduler import RejectError

    out = {"requeued": 0, "failed": 0}
    for item in plan["interrupted"]:
        spec = item.get("spec")
        if not isinstance(spec, dict):
            err = {"code": "job_failed",
                   "reason": "journal admit record carries no "
                             "job spec (torn write?)"}
            result = {"ok": False, "error": err}
            scheduler.preload_completed({item["job_key"]: result})
            if journal is not None:
                journal.append("error", job_key=item["job_key"],
                               error=err)
            out["failed"] += 1
            continue
        try:
            job = scheduler.submit(
                spec, priority=int(item.get("priority") or 0),
                trace_context=item.get("trace_id"),
                job_key=item["job_key"],
                resume={"windows": item["windows"],
                        "calib": item.get("calib")},
                recovered_from=f"{item.get('pid')}:{item.get('job')}")
        except RejectError as exc:
            result = {"ok": False, "error": exc.error}
            scheduler.preload_completed({item["job_key"]: result})
            if journal is not None:
                journal.append("error", job_key=item["job_key"],
                               error=exc.error)
            out["failed"] += 1
            continue
        if flight is not None:
            flight.record(
                "recover", job=job.id, tenant=job.tenant,
                trace_id=job.trace_id, job_key=item["job_key"],
                checkpoint_windows=len(item["windows"]),
                recovered_from=f"{item.get('pid')}:"
                               f"{item.get('job')}")
        out["requeued"] += 1
    return out
