"""Blocking client and the ``submit`` / ``status`` subcommands (JAX
package: racon_tpu/serve/client.py).

``python -m racon_tpu_torch.cli submit --socket PATH [options ...]
<sequences> [<overlaps>] <target sequences>`` takes the one-shot CLI's
positionals and options (parsed by the same ``cli.parse_args``), sends
them as a job spec to a running daemon, blocks until the job finishes,
and writes the polished FASTA to stdout: the bytes the one-shot CLI
would have written, without its start-up.  Its own flags: ``--socket``,
``--priority``, ``--tenant``, ``--class``, ``--trace-context``,
``--job-key``, ``--retry`` and ``--shards`` (a router splits the job
into that many target shards, or one per backend with ``auto``).
``--device`` is the daemon's, not the job's, and a submit carrying it
is refused.  ``--socket`` takes a unix socket path or a router's TCP
front as ``host:port``.

Exit codes: 0 on success; 1 on a failed job or a transport error; 75
(EX_TEMPFAIL) on a ``queue_full`` or ``draining`` reject, which may be
retried verbatim.  The structured reject is printed to stderr as one
JSON line.
"""

from __future__ import annotations

import json
import os
import socket
import sys

from racon_tpu_torch.serve import protocol

EX_TEMPFAIL = 75
#: reject codes a caller may retry verbatim later
RETRYABLE = ("queue_full", "draining")


class ServeError(RuntimeError):
    """Transport-level failure (no server, protocol violation)."""


def is_tcp_address(addr: str) -> bool:
    """``host:port`` addressing (the router's TCP front): no path
    separator, a colon and an all-digit port.  Anything else, every
    unix socket path among them, stays a unix socket."""
    if not addr or "/" in addr or os.path.exists(addr):
        return False
    host, sep, port = addr.rpartition(":")
    return bool(sep) and bool(host) and port.isdigit()


def _connect(addr: str, timeout: float = None):
    """Dial ``addr``, a unix socket path or a router's ``host:port``;
    raises OSError on failure (callers wrap it into
    :class:`ServeError`)."""
    if is_tcp_address(addr):
        host, _, port = addr.rpartition(":")
        sock = socket.socket(socket.AF_INET)
        sock.settimeout(timeout)
        try:
            sock.connect((host, int(port)))
        except OSError:
            sock.close()
            raise
        return sock
    sock = socket.socket(socket.AF_UNIX)
    sock.settimeout(timeout)
    try:
        sock.connect(addr)
    except OSError:
        sock.close()
        raise
    return sock


def request(socket_path: str, frame: dict, timeout: float = None):
    """One request/response round trip.  ``timeout`` bounds every
    socket operation; submits block for the whole job, so the default
    is no timeout."""
    try:
        sock = _connect(socket_path, timeout)
    except OSError as exc:
        raise ServeError(
            f"cannot reach server at {socket_path} ({exc})"
        ) from exc
    try:
        try:
            protocol.send_frame(sock, frame)
            resp = protocol.recv_frame(sock)
        except (OSError, protocol.ProtocolError) as exc:
            raise ServeError(f"transport failure ({exc})") from exc
        if resp is None:
            raise ServeError("server closed the connection without "
                             "a response")
        return resp
    finally:
        sock.close()


def submit(socket_path: str, spec: dict, priority: int = 0,
           timeout: float = None, want_trace: bool = False,
           trace_context: str = None, job_key: str = None,
           shards=None) -> dict:
    """Submit one job and block until it completes (or is rejected).
    Returns the raw response frame; callers check ``resp["ok"]``.
    ``want_trace`` asks the server to attach the job's trace slice
    (``trace_events``) and flight events (``flight_events``).
    ``trace_context`` is an optional caller-chosen trace id
    (traceparent-style, ``[A-Za-z0-9._:-]{1,128}``); the daemon
    adopts it as the job's trace id so spans, flight events and
    ``inspect`` timelines across daemons share one id.
    ``job_key`` (same charset) is the idempotence key: a
    duplicate submit with the same key joins the live job or is
    answered from the daemon's write-ahead journal record — the job
    runs exactly once, across client retries AND daemon restarts.
    ``shards`` (a router's field) asks for scatter/gather: an int forces
    that many target shards, ``"auto"`` one per eligible backend, 0 an
    unsharded run; a daemon ignores it."""
    frame = {"op": "submit", "job": spec, "priority": priority}
    if want_trace:
        frame["trace"] = True
    if trace_context is not None:
        frame["trace_context"] = trace_context
    if job_key is not None:
        frame["job_key"] = job_key
    if shards is not None:
        frame["shards"] = shards
    return request(socket_path, frame, timeout=timeout)


def submit_with_retry(socket_path: str, spec: dict,
                      priority: int = 0, retries: int = 0,
                      timeout: float = None, want_trace: bool = False,
                      trace_context: str = None,
                      job_key: str = None, shards=None) -> dict:
    """:func:`submit`, retried with jittered exponential backoff
    (~0.5 s base, doubling, capped at 30 s; jitter 0.5x..1.5x so a
    herd of clients doesn't re-land in lockstep).

    Retries cover exactly the failures that are safe and useful to
    retry: transport errors (daemon not up yet, restarting after a
    crash — connection refused) and the ``RETRYABLE`` reject codes
    (``queue_full``, ``draining``).  Everything else — bad request,
    failed job — returns/raises immediately.  Pass a ``job_key`` to
    make the retries idempotent by contract: a retry that lands
    after the original was admitted joins the SAME job, and one that
    lands after a daemon crash is answered from the journal record
    instead of re-running.

    When the reject carries a server-supplied ``retry_after_s`` hint
    (the scheduler prices it from its own observed exec walls
    and queue state), that hint wins over the blind exponential
    schedule — the server knows when a slot will actually free.  The
    jittered ``0.5·2^n`` schedule stays as the fallback for
    transport errors and hint-less rejects."""
    import random
    import time

    attempt = 0
    while True:
        hint = None
        try:
            resp = submit(socket_path, spec, priority=priority,
                          timeout=timeout, want_trace=want_trace,
                          trace_context=trace_context,
                          job_key=job_key, shards=shards)
        except ServeError as exc:
            if attempt >= retries:
                raise
            reason = str(exc)
        else:
            err = resp.get("error") or {}
            code = err.get("code")
            if resp.get("ok") or code not in RETRYABLE \
                    or attempt >= retries:
                return resp
            reason = code
            try:
                hint = float(err["retry_after_s"])
            except (KeyError, TypeError, ValueError):
                hint = None
        if hint is not None and hint > 0:
            delay = min(30.0, hint) * (0.75 + 0.5 * random.random())
        else:
            delay = min(30.0, 0.5 * (2 ** attempt))
            delay *= 0.5 + random.random()
        attempt += 1
        print(f"[racon_tpu_torch::submit] retryable failure ({reason}); "
              f"attempt {attempt}/{retries} in {delay:.1f}s",
              file=sys.stderr)
        time.sleep(delay)


def status(socket_path: str, timeout: float = 30.0) -> dict:
    return request(socket_path, {"op": "status"}, timeout=timeout)


def admin(socket_path: str, op: str, timeout: float = 30.0) -> dict:
    """pause / resume / shutdown."""
    return request(socket_path, {"op": op}, timeout=timeout)


def metrics(socket_path: str, timeout: float = 30.0) -> dict:
    """Full telemetry frame incl. the Prometheus text exposition."""
    return request(socket_path, {"op": "metrics"}, timeout=timeout)


def health(socket_path: str, timeout: float = 30.0) -> dict:
    """Cheap liveness/readiness document."""
    return request(socket_path, {"op": "health"}, timeout=timeout)


def cancel(socket_path: str, job_key: str,
           timeout: float = 30.0) -> dict:
    """Best-effort job cancellation by idempotence key.  A queued job finishes as ``job_canceled`` without
    running; a running one stops at its next between-units poll site;
    unknown/finished keys are a safe no-op."""
    return request(socket_path, {"op": "cancel", "job_key": job_key},
                   timeout=timeout)


def route_status(socket_path: str, timeout: float = 30.0) -> dict:
    """A router's detail document (the ``route_status`` op): each
    backend's breaker, probe age and queue depth, and the routing
    counters.  Only routers answer it."""
    return request(socket_path, {"op": "route_status"}, timeout=timeout)


def flight(socket_path: str, job=None, last: int = 0,
           job_key: str = None, trace_id: str = None,
           timeout: float = 30.0) -> dict:
    """Live flight-recorder view: ring stats + events, optionally
    filtered to one ``job`` (adds its trace slice as ``job_trace``),
    an idempotence key (``job_key``), an exact ``trace_id``, or the
    newest ``last`` events."""
    frame = {"op": "flight"}
    if job is not None:
        frame["job"] = int(job)
    if last:
        frame["last"] = int(last)
    if job_key is not None:
        frame["job_key"] = job_key
    if trace_id is not None:
        frame["trace_id"] = trace_id
    return request(socket_path, frame, timeout=timeout)


def journal_query(socket_path: str, job_key: str = None,
                  job_key_prefix: str = None,
                  max_records: int = 256, max_bytes: int = None,
                  timeout: float = 30.0) -> dict:
    """Bounded read-only slice of a daemon's write-ahead journal
    (``journal_query``).  A key filter and ``max_records`` are
    REQUIRED by the wire contract — the server answers
    ``bad_request`` to unbounded asks; journal-off
    daemons answer ``{"ok": true, "enabled": false}``."""
    frame = {"op": "journal_query", "max_records": int(max_records)}
    if job_key is not None:
        frame["job_key"] = job_key
    if job_key_prefix is not None:
        frame["job_key_prefix"] = job_key_prefix
    if max_bytes is not None:
        frame["max_bytes"] = int(max_bytes)
    return request(socket_path, frame, timeout=timeout)


def trace_query(socket_path: str, job, max_events: int = 2048,
                timeout: float = 30.0) -> dict:
    """Bounded per-job trace slice (``trace_query``): the events
    ``submit --trace`` would have attached, readable after the fact.
    ``max_events`` is required by the wire contract."""
    return request(socket_path,
                   {"op": "trace_query", "job": int(job),
                    "max_events": int(max_events)},
                   timeout=timeout)


def explain(socket_path: str, job=None, last: int = 0,
            timeout: float = 30.0) -> dict:
    """Decision-plane view (the ``explain`` op): per-stage
    calibration health (``calhealth``), decision-ring stats, per-kind
    counts and the decision events — optionally filtered to one
    ``job`` or the newest ``last`` events."""
    frame = {"op": "explain"}
    if job is not None:
        frame["job"] = int(job)
    if last:
        frame["last"] = int(last)
    return request(socket_path, frame, timeout=timeout)


def watch(socket_path: str, interval_s: float = 1.0, count: int = 0,
          timeout: float = None):
    """Generator over streamed telemetry frames (the ``watch`` op).
    Yields one dict per frame; ends when the server sent ``count``
    frames (0 = unbounded), drained, or the connection dropped.
    Closing the generator closes the connection."""
    try:
        sock = _connect(socket_path, timeout)
    except OSError as exc:
        raise ServeError(
            f"cannot reach server at {socket_path} ({exc})"
        ) from exc
    try:
        try:
            protocol.send_frame(sock, {"op": "watch",
                                       "interval_s": interval_s,
                                       "count": count})
            while True:
                frame = protocol.recv_frame(sock)
                if frame is None:
                    return
                yield frame
        except (OSError, protocol.ProtocolError) as exc:
            raise ServeError(f"transport failure ({exc})") from exc
    finally:
        sock.close()


def spec_from_opts(opts: dict, inputs, tenant: str = None,
                   job_class: str = None) -> dict:
    """One-shot CLI options -> job spec (``serve/session.py`` resolves
    the keys left out to the same CLI defaults).  ``tenant`` and
    ``job_class`` are scheduling tags and change no output byte."""
    spec = {} if tenant is None else {"tenant": tenant}
    if job_class is not None:
        spec["class"] = job_class
    # two inputs (reads, draft): the built-in mapper finds the
    # overlaps; overlaps None plus a rounds count is the spec's opt-in
    if len(inputs) == 2:
        inputs = [inputs[0], None, inputs[1]]
    rounds = int(opts.get("rounds", 1) or 1)
    if inputs[1] is None or rounds > 1:
        spec["rounds"] = max(1, rounds)
    spec.update({
        "sequences": os.path.abspath(inputs[0]),
        "overlaps": (os.path.abspath(inputs[1])
                     if inputs[1] is not None else None),
        "targets": os.path.abspath(inputs[2]),
        "type": opts["type"].name,
        "window_length": opts["window_length"],
        "quality_threshold": opts["quality_threshold"],
        "error_threshold": opts["error_threshold"],
        "trim": opts["trim"],
        "match": opts["match"],
        "mismatch": opts["mismatch"],
        "gap": opts["gap"],
        "threads": opts["threads"],
        "drop_unpolished": opts["drop_unpolished"],
        "cuda_poa_batches": opts["cuda_poa_batches"],
        "cuda_banded_alignment": opts["cuda_banded_alignment"],
        "cuda_aligner_batches": opts["cuda_aligner_batches"],
    })
    return spec


#: the submit/status flags, by name -> (key, converter)
_SERVE_FLAGS = {"--socket": ("socket", str), "--priority": ("priority", int),
                "--tenant": ("tenant", str),
                "--trace-context": ("trace_context", str),
                "--job-key": ("job_key", str), "--retry": ("retry", int),
                "--class": ("job_class", str), "--shards": ("shards", str)}


def _split_serve_flags(argv):
    """Take the serve flags out of ``argv`` (as ``--flag value`` or
    ``--flag=value``) so the rest parses with the one-shot
    ``cli.parse_args``; returns ``(flags, rest)``."""
    flags = {"socket": None, "priority": 0, "tenant": None,
             "trace_context": None, "job_key": None, "retry": 0,
             "job_class": None, "shards": None}
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        name, eq, value = a.partition("=")
        if name in _SERVE_FLAGS:
            key, conv = _SERVE_FLAGS[name]
            if not eq:
                i += 1
                if i >= len(argv):
                    raise ValueError(f"missing argument for {name}")
                value = argv[i]
            flags[key] = conv(value)
        else:
            rest.append(a)
        i += 1
    return flags, rest


def main_submit(argv) -> int:
    from racon_tpu_torch import cli

    try:
        flags, rest = _split_serve_flags(argv)
        opts, inputs = cli.parse_args(rest)
    except ValueError as exc:
        print(f"[racon_tpu_torch::submit] error: {exc}!", file=sys.stderr)
        return 1
    if not flags["socket"]:
        print("[racon_tpu_torch::submit] error: --socket PATH is "
              "required!", file=sys.stderr)
        return 1
    if flags["job_class"] not in (None, "interactive", "batch"):
        print("[racon_tpu_torch::submit] error: --class must be "
              "'interactive' or 'batch'!", file=sys.stderr)
        return 1
    if opts["device"] is not None:
        print("[racon_tpu_torch::submit] error: --device is the daemon's "
              "(serve --device), not a job's!", file=sys.stderr)
        return 1
    if len(inputs) < 2:
        print("[racon_tpu_torch::submit] error: missing input file(s)!",
              file=sys.stderr)
        return 1
    try:
        resp = submit_with_retry(
            flags["socket"],
            spec_from_opts(opts, inputs, tenant=flags["tenant"],
                           job_class=flags["job_class"]),
            priority=flags["priority"], retries=max(0, flags["retry"]),
            want_trace=bool(opts["trace"]),
            trace_context=flags["trace_context"], job_key=flags["job_key"],
            shards=flags["shards"])
    except ServeError as exc:
        print(f"[racon_tpu_torch::submit] error: {exc}", file=sys.stderr)
        return 1
    if not resp.get("ok"):
        err = resp.get("error", {})
        print(json.dumps(err), file=sys.stderr)
        code = err.get("code")
        print(f"[racon_tpu_torch::submit] error: job rejected/failed "
              f"({code}): {err.get('reason')}", file=sys.stderr)
        return EX_TEMPFAIL if code in RETRYABLE else 1

    import base64
    out = sys.stdout.buffer
    out.write(base64.b64decode(resp["fasta_b64"]))
    out.flush()
    if opts["metrics_json"]:
        tmp = opts["metrics_json"] + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(resp["report"], f, indent=1)
        os.replace(tmp, opts["metrics_json"])
        print(f"[racon_tpu_torch::submit] metrics report written to "
              f"{opts['metrics_json']}", file=sys.stderr)
    if opts["trace"]:
        # the job's slice of the daemon's trace as a Chrome trace
        # document; the flight events ride under a key Perfetto ignores
        events = resp.get("trace_events") or []
        pid = events[0].get("pid", 0) if events else 0
        doc = {"traceEvents": [{"name": "process_name", "ph": "M",
                                "pid": pid, "tid": 0,
                                "args": {"name": "racon-tpu-torch serve"}}]
               + events,
               "displayTimeUnit": "ms",
               "flightEvents": resp.get("flight_events") or []}
        tmp = opts["trace"] + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, opts["trace"])
        print(f"[racon_tpu_torch::submit] job trace written to "
              f"{opts['trace']} ({len(events)} event(s))", file=sys.stderr)
    print(f"[racon_tpu_torch::submit] job {resp['job_id']} done in "
          f"{resp['wall_s']:.2f} s ({resp['n_sequences']} sequence(s))",
          file=sys.stderr)
    return 0


def _print_router_status(doc: dict) -> int:
    """A router's ``status`` / ``route_status`` document for a human:
    each backend's breaker (CLOSED / OPEN / HALF-OPEN), probe age and
    load, and the routing counters."""
    tcp = f" + tcp {doc['tcp']}" if doc.get("tcp") else ""
    print(f"router      pid {doc.get('pid')} on "
          f"{doc.get('socket')}{tcp}")
    state = "draining" if doc.get("draining") else "routing"
    print(f"state       {state}, up {doc.get('uptime_s', 0):.1f}s, "
          f"{doc.get('in_flight', 0)} in flight")
    c = doc.get("counters") or {}
    print(f"routing     {c.get('route_submit', 0)} submit(s), "
          f"{c.get('route_spillover', 0)} spillover(s), "
          f"{c.get('route_failover', 0)} failover(s), "
          f"{c.get('route_dedup_joins', 0)} dedup join(s)")
    sc = doc.get("scatter") or {}
    if c.get("route_scatter_jobs") or sc.get("active"):
        print(f"scatter     {c.get('route_scatter_jobs', 0)} "
              f"job(s) -> {c.get('route_scatter_shards', 0)} "
              f"shard(s), {c.get('route_cache_affinity', 0)} "
              f"affinity pick(s)")
    for row in sc.get("active") or []:
        print(f"scatter     {row.get('job_key')}: "
              f"{row.get('done')}/{row.get('shards')} shard(s) done")
    backends = doc.get("backends") or []
    if backends:
        print("backend                           breaker    fails  "
              "probe     queue  run  state")
    for b in backends:
        age = b.get("probe_age_s")
        probe = "never" if age is None else f"{age:5.1f}s"
        if b.get("stale"):
            probe += "!"
        qd = b.get("queue_depth")
        run = b.get("running")
        state = "draining" if b.get("draining") else (
            "down" if b.get("breaker") != "CLOSED" else "up")
        print(f"{b.get('target', '?'):<33s} {b.get('breaker'):<9s}  "
              f"{b.get('failures', 0):>5d}  {probe:<8s}  "
              f"{qd if qd is not None else '-':>5}  "
              f"{run if run is not None else '-':>3}  {state}")
    return 0


def main_status(argv) -> int:
    try:
        flags, rest = _split_serve_flags(argv)
    except ValueError as exc:
        print(f"[racon_tpu_torch::status] error: {exc}!", file=sys.stderr)
        return 1
    as_json = "--json" in rest
    rest = [a for a in rest if a != "--json"]
    if not flags["socket"] or rest:
        print("usage: python -m racon_tpu_torch.cli status --socket PATH "
              "[--json]", file=sys.stderr)
        return 1
    try:
        doc = status(flags["socket"])
    except ServeError as exc:
        print(f"[racon_tpu_torch::status] error: {exc}", file=sys.stderr)
        return 1
    if as_json:
        json.dump(doc, sys.stdout, indent=1)
        print()
        return 0
    if doc.get("router"):
        return _print_router_status(doc)
    q = doc.get("queue", {})
    state = ("draining" if doc.get("draining")
             else "paused" if q.get("paused") else "running")
    print(f"server      pid {doc.get('pid')} on {doc.get('socket')}")
    print(f"state       {state}, up {doc.get('uptime_s', 0):.1f}s")
    print(f"queue       {q.get('queue_depth')}/{q.get('max_queue')} "
          f"queued, {len(q.get('running', []))}/{q.get('max_jobs')} "
          f"running, {q.get('completed')} completed")
    j = doc.get("journal") or {}
    if j.get("enabled"):
        print(f"journal     {j.get('depth')} record(s) "
              f"({j.get('bytes')} B) at {j.get('path')}")
    rec = doc.get("recovered") or {}
    if any(rec.get(k) for k in ("requeued", "completed", "failed")):
        print(f"recovered   {rec.get('requeued', 0)} requeued, "
              f"{rec.get('completed', 0)} completed from record, "
              f"{rec.get('failed', 0)} failed")
    tenants = q.get("tenants") or {}
    if tenants:
        from racon_tpu_torch.obs import export

        hists = (doc.get("registry") or {}).get("histograms", {})
        print("tenant      queued  running  wait p50/p90/p99")
        for name in sorted(tenants):
            row = tenants[name]
            h = hists.get(f"serve_queue_wait_s.{name}")
            if h and h.get("count"):
                p = export.percentiles(h)
                waits = (f"{p['p50'] * 1e3:.0f}/{p['p90'] * 1e3:.0f}/"
                         f"{p['p99'] * 1e3:.0f} ms")
            else:
                waits = "-"
            print(f"{name:<11s} {row.get('queued', 0):>6d}  "
                  f"{row.get('running', 0):>7d}  {waits}")
    return 0
