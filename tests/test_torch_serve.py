"""The port's serve daemon (racon_tpu_torch/serve), on the CPU.

A ``--device cpu`` daemon in a short ``/tmp`` socket directory, on the
JAX package's serve set (tests/test_serve.py: 8 kb genome, 5x, 800 bp
reads, seed 21), with the split rates pinned:

* the frames are the JAX package's bytes both ways, and the port's
  admission price (``estimate_job``) and journal replay
  (``recover.replay``) equal the JAX package's on the same inputs;
* a served job's FASTA equals the port's one-shot CLI bytes and, on the
  CPU polisher, the JAX package's CPU polish;
* job 2 on a warm daemon reports 0 kernel builds, loads and native
  builds; two concurrent jobs of two tenants equal their solo bytes;
* ``queue_full`` under ``pause``, then a SIGTERM drain; a bad frame and
  a failing job are contained; an idle daemon shuts itself down;
* ``missing_overlaps`` and malformed fleet fields' ``bad_request``
  rejects; a daemon asked for the card on a machine without one exits 1.
"""

import base64
import contextlib
import io
import os
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from racon_tpu_torch import cache, cli
from racon_tpu_torch.serve import client, protocol, recover
from racon_tpu_torch.serve.scheduler import (JobScheduler, RejectError,
                                             estimate_job)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the split rates every run of these tests prices at
PINS = {"RACON_TPU_TORCH_RATE_POA_DEV": "0.30",
        "RACON_TPU_TORCH_RATE_POA_CPU": "2.0",
        "RACON_TPU_TORCH_RATE_ALIGN_DEV": "1100",
        "RACON_TPU_TORCH_RATE_ALIGN_CPU": "4.0",
        "RACON_TPU_TORCH_RATE_ALIGN_WFA_DEV": "700",
        # no calibration store
        "RACON_TPU_TORCH_CACHE_DIR": ""}
#: knobs a daemon must not inherit from the test's environment
UNSET = ("RACON_TPU_TORCH_TRACE", "RACON_TPU_TORCH_METRICS_JSON",
         "RACON_TPU_TORCH_FLIGHT_DUMP", "RACON_TPU_TORCH_FAULT",
         "RACON_TPU_TORCH_CALIB_FREEZE")
#: the one-shot options of the kernel path
KERNEL_ARGS = ("-t", "4", "-c", "1", "--cudaaligner-batches", "1")


# ---------------------------------------------------------------------------
# helpers (tests/test_torch_durable.py uses them too)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def pinned(extra=None):
    """The test process's environment with PINS (and ``extra``) set."""
    mp = pytest.MonkeyPatch()
    try:
        for k, v in {**PINS, **(extra or {})}.items():
            mp.setenv(k, v)
        for k in UNSET:
            mp.delenv(k, raising=False)
        yield
    finally:
        mp.undo()


def serve_env(tmp, extra=None) -> dict:
    env = dict(os.environ)
    env.update(PINS)
    for k in UNSET:
        env.pop(k, None)
    # flight dumps land beside the sockets
    env["TMPDIR"] = tmp
    env.update(extra or {})
    return env


def one_shot(*argv, extra=None) -> bytes:
    """The port's one-shot CLI bytes, in this process, from an empty
    result cache."""
    buf = io.BytesIO()
    with pinned(extra):
        cache.reset()
        cli.main(["--device", "cpu", *argv], out=buf)
    return buf.getvalue()


def make_spec(data, kernels: bool = True, **kw) -> dict:
    reads, paf, draft = data
    spec = {"sequences": reads, "overlaps": paf, "targets": draft,
            "threads": 4}
    if kernels:
        spec.update(cuda_poa_batches=1, cuda_aligner_batches=1)
    spec.update(kw)
    return spec


def start_server(tmp, name, args=(), extra_env=None, wait=True):
    """A daemon subprocess on ``<tmp>/<name>.sock``; returns (proc,
    socket path, log path) once the socket answers."""
    sock_path = os.path.join(tmp, name + ".sock")
    log_path = os.path.join(tmp, name + ".log")
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch.cli", "serve",
             "--socket", sock_path, "--device", "cpu", *args],
            cwd=REPO_ROOT, stdout=log, stderr=log,
            env=serve_env(tmp, extra_env))
    if not wait:
        return proc, sock_path, log_path
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError("server died at startup: "
                                 + open(log_path).read())
        if os.path.exists(sock_path):
            probe = socket.socket(socket.AF_UNIX)
            try:
                probe.connect(sock_path)
                return proc, sock_path, log_path
            except OSError:
                pass
            finally:
                probe.close()
        time.sleep(0.1)
    proc.kill()
    raise AssertionError("server socket never came up")


def stop_server(proc, sock_path) -> None:
    if proc.poll() is None:
        try:
            client.admin(sock_path, "shutdown")
        except client.ServeError:
            proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def fasta_of(resp) -> bytes:
    assert resp["ok"], resp
    return base64.b64decode(resp["fasta_b64"])


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def cold_result_cache():
    cache.reset()
    yield
    cache.reset()


@pytest.fixture(scope="module")
def serve_tmp():
    # unix socket paths must stay short (~108 bytes)
    with tempfile.TemporaryDirectory(prefix="rtts_", dir="/tmp") as d:
        yield d


@pytest.fixture(scope="module")
def data(serve_tmp):
    from racon_tpu_torch.tools import simulate

    return simulate.simulate(os.path.join(serve_tmp, "data"),
                             genome_len=8_000, coverage=5, read_len=800,
                             seed=21, ont=True)


@pytest.fixture(scope="module")
def golden(data):
    """The port's one-shot bytes on the kernel path and on the CPU
    polisher."""
    return {"kernels": one_shot(*KERNEL_ARGS, *data),
            "cpu": one_shot("-t", "4", *data)}


@pytest.fixture(scope="module")
def main_server(serve_tmp):
    """One warm daemon, shared: the warm-start test needs its history."""
    proc, sock_path, _ = start_server(serve_tmp, "main",
                                      args=("--jobs", "2"))
    yield sock_path
    stop_server(proc, sock_path)


# ---------------------------------------------------------------------------
# the wire, the price and the replay against the JAX package
# ---------------------------------------------------------------------------

FRAMES = [{"op": "status"},
          {"op": "submit", "job": {"sequences": "/r.fq", "rounds": 2},
           "priority": -3, "job_key": "k:1.a", "trace": True},
          {"ok": False, "error": {"code": "queue_full", "reason": "é\n",
                                  "retry_after_s": 0.25}},
          {"ok": True, "fasta_b64": base64.b64encode(b">a\nACGT\n").decode(),
           "nested": [1, 2.5, None, {"x": []}]}]


@pytest.mark.parametrize("frame", FRAMES, ids=range(len(FRAMES)))
def test_frames_cross_read_with_jax(frame):
    """The port's frames are the JAX package's bytes: each reads the
    other's, and both write the same bytes."""
    from racon_tpu.serve import protocol as jax_protocol

    for send, recv in ((protocol.send_frame, jax_protocol.recv_frame),
                       (jax_protocol.send_frame, protocol.recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, frame)
            assert recv(b) == frame
        finally:
            a.close()
            b.close()
    wire = []
    for send in (protocol.send_frame, jax_protocol.send_frame):
        a, b = socket.socketpair()
        try:
            send(a, frame)
            a.close()
            wire.append(b.recv(1 << 20))
        finally:
            b.close()
    assert wire[0] == wire[1]
    assert protocol.error_frame("x", "y", n=1) == \
        jax_protocol.error_frame("x", "y", n=1)


def test_frame_guards():
    a, b = socket.socketpair()
    try:
        protocol.send_frame(a, {"op": "status"})
        a.close()
        assert protocol.recv_frame(b) == {"op": "status"}
        assert protocol.recv_frame(b) is None        # clean EOF
    finally:
        b.close()
    for junk in (b"\xff\xff\xff\xff", struct.pack(">I", 8) + b"not{json",
                 b"\x00\x00"):
        a, b = socket.socketpair()
        try:
            a.sendall(junk)
            a.close()
            with pytest.raises(protocol.ProtocolError):
                protocol.recv_frame(b)
        finally:
            b.close()


@pytest.mark.parametrize("shape", ["paf", "rounds", "no_overlaps"])
def test_estimate_job_equals_jax(data, shape):
    from racon_tpu.serve import scheduler as jax_scheduler

    reads, paf, draft = data
    spec = {"sequences": reads, "overlaps": paf, "targets": draft}
    if shape == "rounds":
        spec["rounds"] = 3
    elif shape == "no_overlaps":
        spec.update(overlaps=None, rounds=2)
    want = jax_scheduler.estimate_job(spec, concurrency=1, hit_ratio=0.0)
    got = estimate_job(spec, concurrency=1, hit_ratio=0.0)
    assert got == want and got["additive_wall_s"] > 0


@pytest.mark.parametrize("args", [
    (1.0, 2.0, None, 1, None, None), (3.0, 2.0, 1.5, 1, None, None),
    (3.0, 2.0, 0.5, 3, 0.4, None), (3.0, 2.0, None, 2, 0.0, 0.35),
    (0.0, 0.0, 0.0, 1, None, 0.99)])
def test_predict_walls_equals_jax(args):
    from racon_tpu.utils import calibrate as jax_calibrate
    from racon_tpu_torch.utils import calibrate

    align, poa, overlap, n, occ, hit = args
    kw = dict(overlap_s=overlap, concurrency=n, occupancy=occ,
              hit_ratio=hit)
    assert calibrate.predict_walls(align, poa, **kw) == \
        jax_calibrate.predict_walls(align, poa, **kw)


def replay_records():
    """A journal of two incarnations: an interrupted job checkpointed
    in both, a finished auto-keyed job, a journaled failure and a torn
    admit (tests/test_durable.py's record list, with more)."""
    spec = {"sequences": "a", "overlaps": "b", "targets": "c"}
    return [
        {"kind": "journal_open", "pid": 10, "seq": 1},
        {"kind": "admit", "pid": 10, "job": 1, "job_key": "A",
         "spec": spec, "priority": 2, "tenant": "t", "trace_id": "tr-A",
         "calib": {"epoch": "e1", "data": {}}},
        {"kind": "start", "pid": 10, "job": 1, "job_key": "A"},
        {"kind": "checkpoint", "pid": 10, "job": 1, "job_key": "A",
         "windows": {"0": ["YQ==", True], "1": [None, False]}},
        {"kind": "admit", "pid": 10, "job": 2, "spec": spec},
        {"kind": "done", "pid": 10, "job": 2,
         "result": {"ok": True, "job_id": 2, "fasta_b64": "Zg=="}},
        {"kind": "checkpoint", "pid": 10, "job": 9, "windows": {"5": []}},
        {"kind": "journal_open", "pid": 11, "seq": 1},
        {"kind": "admit", "pid": 11, "job": 1, "job_key": "A",
         "spec": spec, "priority": 2, "tenant": "t", "trace_id": "tr-A",
         "calib": {"epoch": "e1", "data": {}}, "recovered_from": "10:1"},
        {"kind": "checkpoint", "pid": 11, "job": 1, "job_key": "A",
         "windows": {"1": ["Yg==", True], "2": ["Yw==", True]}},
        {"kind": "admit", "pid": 11, "job": 2, "job_key": "C",
         "spec": spec},
        {"kind": "error", "pid": 11, "job": 2, "job_key": "C",
         "error": {"code": "job_failed", "reason": "boom"}},
        {"kind": "admit", "pid": 11, "job": 3, "job_key": "D"},
        {"kind": "recovery", "pid": 11, "stats": {}},
    ]


def test_replay_equals_jax():
    from racon_tpu.serve import recover as jax_recover

    records = replay_records()
    plan = recover.replay(records)
    assert plan == jax_recover.replay(records)
    assert [i["job_key"] for i in plan["interrupted"]] == ["A", "D"]
    assert plan["interrupted"][0]["windows"] == {
        "0": ["YQ==", True], "1": ["Yg==", True], "2": ["Yw==", True]}
    assert plan["completed"]["C"]["error"]["reason"] == "boom"


# ---------------------------------------------------------------------------
# admission, without a daemon
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,code", [
    ("no_overlaps", "missing_overlaps"), ("shard", "bad_request"),
    ("stage", "bad_request"), ("rounds_zero", "bad_request"),
    ("bad_class", "bad_request"), ("bad_tenant", "bad_request"),
    ("missing_file", "input_not_found")])
def test_admission_rejects(data, case, code):
    spec = make_spec(data)
    if case == "no_overlaps":
        spec["overlaps"] = None
    elif case == "shard":
        # index past count: malformed (a well-formed shard is served)
        spec["shard"] = [2, 2]
    elif case == "stage":
        # no schema version: malformed
        spec["stage"] = {"ranges": [[0, 10]], "shard": [0, 2]}
    elif case == "rounds_zero":
        spec["rounds"] = 0
    elif case == "bad_class":
        spec["class"] = "urgent"
    elif case == "bad_tenant":
        spec["tenant"] = "x" * 65
    else:
        spec["sequences"] += ".missing"
    sched = JobScheduler(lambda job: {"ok": True}, max_queue=2, max_jobs=1)
    try:
        with pytest.raises(RejectError) as exc:
            sched.submit(spec)
        err = exc.value.error
        assert err["code"] == code
        if code == "missing_overlaps":
            assert "--rounds" in err["hint"]
        if case == "shard":
            assert err["reason"] == ("shard must be [index, count] with "
                                     "0 <= index < count <= 4096")
        if case == "stage":
            assert err["reason"] == "stage.v must be 1"
        # a spec with no overlaps but a rounds count is admitted
        if case == "no_overlaps":
            spec["rounds"] = 1
            job = sched.submit(spec)
            assert job.done.wait(30) and job.result["ok"]
    finally:
        sched.drain(timeout=10)


def test_admission_price_caps_monster_jobs(data, monkeypatch):
    sched = JobScheduler(lambda job: {"ok": True}, max_queue=2, max_jobs=1)
    try:
        monkeypatch.setenv("RACON_TPU_TORCH_SERVE_MAX_WALL_S", "0.000001")
        with pytest.raises(RejectError) as exc:
            sched.submit(make_spec(data))
        est = exc.value.error["estimate"]
        assert exc.value.error["code"] == "job_too_large"
        assert est["predicted_wall_s"] >= est["overlapped_floor_s"]
        monkeypatch.delenv("RACON_TPU_TORCH_SERVE_MAX_WALL_S")
        job = sched.submit(make_spec(data))
        assert job.done.wait(30)
        assert job.result == {"ok": True, "trace_id": job.trace_id}
    finally:
        sched.drain(timeout=10)


# ---------------------------------------------------------------------------
# served jobs (the shared warm daemon)
# ---------------------------------------------------------------------------

def test_served_bytes_equal_one_shot_and_jax(main_server, data, golden):
    """On the CPU polisher a served job equals the one-shot CLI and the
    JAX package's CPU polish (as tests/test_torch_formats.py compares
    them); on the kernel path it equals the one-shot CLI."""
    from racon_tpu.core import polisher as jax_polisher

    pol = jax_polisher.create_polisher(
        *data, jax_polisher.PolisherType.kC, 500, 10.0, 0.3, True, 3, -5,
        -4, 4)
    try:
        pol.initialize()
        jax_bytes = b"".join(b">" + s.name.encode() + b"\n" + s.data
                             + b"\n" for s in pol.polish(True))
    finally:
        pol.close()
    served = fasta_of(client.submit(main_server,
                                    make_spec(data, kernels=False)))
    assert served == golden["cpu"] == jax_bytes
    resp = client.submit(main_server, make_spec(data))
    assert fasta_of(resp) == golden["kernels"]
    rep = resp["report"]
    assert rep["schema"] == "racon-tpu-torch-metrics-v1"
    assert "RACON_TPU_TORCH_SERVE_QUEUE" in rep["environment"]["knobs"]
    assert rep["run"]["gauges"]["job_wall_s"] > 0
    assert rep["details"]["device"] == "cpu"
    assert resp["estimate"]["predicted_wall_s"] > 0 or \
        resp["estimate"]["additive_wall_s"] > 0


def test_warm_job_reports_no_builds(main_server, data, golden):
    """Job N >= 2 on a warm daemon: 0 kernel builds and loads, 0 native
    builds, no prewarm; the daemon prewarmed once."""
    client.submit(main_server, make_spec(data))
    resp = client.submit(main_server, make_spec(data))
    assert fasta_of(resp) == golden["kernels"]
    gauges = resp["report"]["run"]["gauges"]
    for name in ("cuda_kernel_builds", "cuda_kernel_loads",
                 "native_builds", "serve_prewarm_runs"):
        assert gauges[name] == 0, name
    counters = resp["report"]["process"]["counters"]
    assert counters["serve_prewarm_runs"] == 1
    assert counters["serve_jobs_submitted"] >= 2


def test_concurrent_tenants_equal_solo(main_server, data, golden):
    """Two jobs of two tenants in flight at once on the 2-worker
    daemon: each writes its solo bytes."""
    results = [None, None]

    def run(slot, spec):
        results[slot] = client.submit(main_server, spec)

    specs = [make_spec(data, tenant="a"),
             make_spec(data, kernels=False, tenant="b")]
    threads = [threading.Thread(target=run, args=(i, s))
               for i, s in enumerate(specs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert fasta_of(results[0]) == golden["kernels"]
    assert fasta_of(results[1]) == golden["cpu"]
    assert results[0]["job_id"] != results[1]["job_id"]


def test_submit_and_status_subcommands(main_server, data, golden,
                                       serve_tmp):
    env = serve_env(serve_tmp)
    run = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "submit",
         "--socket", main_server, "--tenant", "cli", *KERNEL_ARGS, *data],
        cwd=REPO_ROOT, capture_output=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr.decode()
    assert run.stdout == golden["kernels"]
    st = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "status", "--socket",
         main_server], cwd=REPO_ROOT, capture_output=True, env=env,
        timeout=120)
    assert st.returncode == 0 and b"queue" in st.stdout
    # two positionals: the daemon maps the reads to the draft
    mapped = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "submit", "--socket",
         main_server, "-t", "4", *data[::2]], cwd=REPO_ROOT,
        capture_output=True, env=env, timeout=300)
    assert mapped.returncode == 0, mapped.stderr.decode()
    assert mapped.stdout == one_shot("-t", "4", *data[::2])


def test_telemetry_ops(main_server):
    tel = client.metrics(main_server)
    assert tel["ok"] and "racon_tpu_torch_serve_jobs_submitted" in \
        tel["prometheus"]
    assert tel["fusion"]["enabled"] is True
    assert "serve_exec_wall_s" in tel["slo"]
    h = client.health(main_server)
    assert h["ok"] and h["status"] == "ok" and h["journal"]["enabled"]
    assert h["identity"]["backend"] == "torch"
    fl = client.flight(main_server, last=5)
    assert fl["ok"] and 0 < len(fl["events"]) <= 5
    ex = client.explain(main_server, last=3)
    assert ex["ok"] and "calhealth" in ex
    frames = list(client.watch(main_server, interval_s=0.05, count=2))
    assert [f["seq"] for f in frames] == [0, 1]
    q = client.journal_query(main_server, job_key_prefix="auto-")
    assert q["ok"] and q["records"]
    assert all("fasta_b64" not in (r.get("result") or {})
               for r in q["records"])
    assert not client.request(main_server,
                              {"op": "journal_query"})["ok"]


def test_bad_frame_and_failing_job_contained(main_server, data):
    sock = socket.socket(socket.AF_UNIX)
    try:
        sock.connect(main_server)
        sock.sendall(struct.pack(">I", 8) + b"not{json")
        resp = protocol.recv_frame(sock)
        assert resp["error"]["code"] == "bad_request"
    finally:
        sock.close()
    assert client.request(main_server, {"op": "frobnicate"})["error"][
        "code"] == "bad_request"
    bad = make_spec(data)
    bad["overlaps"] = bad["targets"]       # a FASTA is no overlap format
    resp = client.submit(main_server, bad)
    assert resp["error"]["code"] == "job_failed"
    assert resp["error"]["type"] == "UnsupportedFormatError"
    doc = client.status(main_server)
    assert doc["ok"] and doc["queue"]["queue_depth"] == 0
    assert not doc["queue"]["draining"]


# ---------------------------------------------------------------------------
# daemons of their own
# ---------------------------------------------------------------------------

def test_queue_full_under_pause_then_sigterm_drain(serve_tmp, data, golden):
    proc, sock_path, _ = start_server(serve_tmp, "bp",
                                      args=("--jobs", "1", "--queue", "1"))
    try:
        assert client.admin(sock_path, "pause")["ok"]
        held = {}
        t = threading.Thread(target=lambda: held.update(
            r=client.submit(sock_path, make_spec(data))))
        t.start()
        deadline = time.monotonic() + 30
        while client.status(sock_path)["queue"]["queue_depth"] != 1:
            assert time.monotonic() < deadline, "queued job never landed"
            time.sleep(0.05)
        resp = client.submit(sock_path, make_spec(data))
        err = resp["error"]
        assert err["code"] == "queue_full"
        assert err["queue_depth"] == 1 and err["max_queue"] == 1
        assert err["retry_after_s"] > 0
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                if client.status(sock_path)["queue"]["draining"]:
                    resp = client.submit(sock_path, make_spec(data))
                    assert resp["error"]["code"] == "draining"
                    break
            except client.ServeError:
                break      # the drain already finished
            time.sleep(0.05)
        t.join(300)
        assert fasta_of(held["r"]) == golden["kernels"]
        assert proc.wait(timeout=60) == 0
        assert not os.path.exists(sock_path)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_idle_daemon_shuts_itself_down(serve_tmp):
    proc, sock_path, _ = start_server(serve_tmp, "idle",
                                      args=("--idle-timeout", "0.5"))
    try:
        assert proc.wait(timeout=60) == 0
        assert not os.path.exists(sock_path)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_daemon_asked_for_a_missing_card_exits(serve_tmp):
    """The daemon defaults to the card; with none it exits non-zero and
    never serves on the CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    sock_path = os.path.join(serve_tmp, "nocard.sock")
    run = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "serve", "--socket",
         sock_path], cwd=REPO_ROOT, capture_output=True,
        env=serve_env(serve_tmp), timeout=120)
    assert run.returncode == 1
    assert b"CUDA device was requested" in run.stderr
    assert not os.path.exists(sock_path)
