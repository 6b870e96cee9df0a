"""The port's durable serve tier (racon_tpu_torch/serve/journal.py,
recover.py, obs/faultinject.py), on the CPU.

* the journal's records roundtrip through ``scan``; a torn tail loses
  at most the record being written;
* the fault-site spec parses as the JAX package's does, over the same
  sites;
* ``epoch_snapshot`` and ``get_rates(pin=...)``: a pinned snapshot
  beats the store, an env pin beats the snapshot;
* a second daemon refuses a live owner's socket and takes over a dead
  one's;
* a port daemon and a JAX journal in one directory never replay each
  other's records;
* SIGKILL at each fault site mid-job, a restart on the same socket and
  journal, and a keyed resubmit: the one-shot CLI's bytes
  (``mid-megabatch`` in tier-1, resuming its committed windows; the
  other sites, as every JAX SIGKILL case, under ``-m slow``).

The crash runs are staged (``RACON_TPU_TORCH_PIPELINE=0``) with
``RACON_TPU_TORCH_POA_MEGABATCH=4``, so this set's 8 device-assigned
windows take two megabatches: the second ``mid-megabatch`` arrival has
the first committed and journaled.
"""

import os
import signal
import struct
import tempfile
import threading

import pytest

from racon_tpu_torch import cache
from racon_tpu_torch.obs import faultinject
from racon_tpu_torch.serve import client
from racon_tpu_torch.serve import journal as serve_journal
from racon_tpu_torch.utils import calibrate
from test_torch_serve import (KERNEL_ARGS, fasta_of, make_spec, one_shot,
                              start_server, stop_server)

#: the crash runs' environment (module docstring)
CRASH_ENV = {"RACON_TPU_TORCH_PIPELINE": "0",
             "RACON_TPU_TORCH_POA_MEGABATCH": "4"}


@pytest.fixture(autouse=True)
def cold_result_cache():
    cache.reset()
    yield
    cache.reset()


@pytest.fixture(scope="module")
def serve_tmp():
    with tempfile.TemporaryDirectory(prefix="rttd_", dir="/tmp") as d:
        yield d


@pytest.fixture(scope="module")
def data(serve_tmp):
    from racon_tpu_torch.tools import simulate

    return simulate.simulate(os.path.join(serve_tmp, "data"),
                             genome_len=8_000, coverage=5, read_len=800,
                             seed=21, ont=True)


@pytest.fixture(scope="module")
def golden(data):
    """The one-shot CLI's bytes, staged as the crash runs are; the
    streaming path writes the same bytes (test_torch_pipeline.py)."""
    return one_shot(*KERNEL_ARGS, *data, extra=CRASH_ENV)


# ---------------------------------------------------------------------------
# journal, replay filter, fault harness, calibration pin (no daemon)
# ---------------------------------------------------------------------------

def test_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "j.torch-journal")
    j = serve_journal.JobJournal(path)
    j.append("admit", job=1, job_key="k1", spec={"x": 1})
    j.append("checkpoint", job=1, job_key="k1",
             windows={"0": ["YQ==", True]})
    j.close()
    records, truncated = serve_journal.scan(path)
    assert not truncated
    assert [r["kind"] for r in records] == ["journal_open", "admit",
                                            "checkpoint"]
    assert records[0]["schema"] == serve_journal.SCHEMA == \
        "racon-tpu-torch-journal-v1"
    assert [r["seq"] for r in records] == [1, 2, 3]
    assert records[1]["spec"] == {"x": 1}
    for torn in (struct.pack(">I", 9999) + b"partial", b"\x00\x00",
                 struct.pack(">I", 4) + b"{{{{"):
        with open(path, "ab") as f:
            f.write(torn)
        again, cut = serve_journal.scan(path)
        assert cut and [r["seq"] for r in again] == [1, 2, 3]
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - len(torn))
    j2 = serve_journal.JobJournal(path, prior_records=3)
    j2.append("done", job=1, job_key="k1", result={"ok": True})
    assert j2.stats()["depth"] == 5
    j2.close()


def test_journal_path_and_switches(tmp_path, monkeypatch):
    from racon_tpu.serve import journal as jax_journal

    monkeypatch.delenv("RACON_TPU_TORCH_JOURNAL_DIR", raising=False)
    monkeypatch.delenv("RACON_TPU_JOURNAL_DIR", raising=False)
    assert serve_journal.journal_path("/tmp/x/s.sock") == \
        "/tmp/x/s.sock.torch-journal"
    # the packages' journals of one socket are two files
    assert jax_journal.journal_path("/tmp/x/s.sock") != \
        serve_journal.journal_path("/tmp/x/s.sock")
    monkeypatch.setenv("RACON_TPU_TORCH_JOURNAL_DIR", str(tmp_path))
    assert serve_journal.journal_path("/tmp/x/s.sock") == \
        str(tmp_path / "s.sock.torch-journal")
    monkeypatch.setenv("RACON_TPU_TORCH_JOURNAL", "0")
    assert not serve_journal.enabled()
    monkeypatch.delenv("RACON_TPU_TORCH_JOURNAL")
    assert serve_journal.enabled()


def test_own_records_drop_the_jax_packages(tmp_path):
    """A JAX daemon's incarnation in the port's file is never replayed;
    the port's records around it are."""
    from racon_tpu.serve import journal as jax_journal

    jax = jax_journal.JobJournal(str(tmp_path / "jax"))
    jax.append("admit", job=1, job_key="J", spec={"x": 1})
    jax.close()
    port = serve_journal.JobJournal(str(tmp_path / "port"))
    port.append("admit", job=1, job_key="P", spec={"x": 2})
    port.close()
    ours = serve_journal.scan(str(tmp_path / "port"))[0]
    # the JAX incarnation under another pid, between two of the port's
    theirs = [dict(r, pid=r["pid"] + 1)
              for r in serve_journal.scan(str(tmp_path / "jax"))[0]]
    own = serve_journal.own_records(ours + theirs + ours)
    assert [r["job_key"] for r in own if r["kind"] == "admit"] == \
        ["P", "P"]
    assert serve_journal.own_records(theirs) == []


def test_faultinject_spec_parsing(monkeypatch):
    from racon_tpu.obs import faultinject as jax_faultinject

    assert faultinject.SITES == jax_faultinject.SITES
    for raw, want in (("pre-demux:3", ("pre-demux", 3)),
                      ("post-admit", ("post-admit", 1)),
                      ("", None), ("nope:1", None), ("pre-demux:x", None),
                      ("pre-demux:0", None), (":::", None)):
        monkeypatch.setenv("RACON_TPU_TORCH_FAULT", raw)
        assert faultinject.spec() == want, raw
    monkeypatch.delenv("RACON_TPU_TORCH_FAULT")
    assert faultinject.spec() is None
    # the JAX package's knob does not arm the port
    monkeypatch.setenv("RACON_TPU_FAULT", "pre-demux")
    assert faultinject.spec() is None
    faultinject.reset()
    faultinject.hit("pre-demux")


def test_calibration_epoch_pin(tmp_path, monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", str(tmp_path))
    for var in ("RACON_TPU_TORCH_RATE_POA_DEV", "RACON_TPU_TORCH_RATE_POA_CPU",
                "RACON_TPU_TORCH_CALIB_FREEZE"):
        monkeypatch.delenv(var, raising=False)
    assert calibrate.epoch_snapshot() == {"epoch": "none", "data": {}}
    calibrate.store_rates("poa", "cpu", 3.0, 4.0)
    snap = calibrate.epoch_snapshot()
    assert snap["epoch"] != "none"
    assert calibrate.get_rates("poa", "cpu", 1.0, 2.0) == \
        (3.0, 4.0, "calibrated")
    pin = {calibrate._machine_key("cpu"): {"poa": {"dev": 42.0,
                                                   "cpu": 7.0}}}
    assert calibrate.get_rates("poa", "cpu", 1.0, 2.0, pin=pin) == \
        (42.0, 7.0, "pinned")
    # a pin of another machine or stage falls through to the store
    assert calibrate.get_rates("align", "cpu", 1.0, 2.0, pin=pin)[2] == \
        "default"
    # the freeze: a serve daemon's jobs store nothing
    monkeypatch.setenv("RACON_TPU_TORCH_CALIB_FREEZE", "1")
    calibrate.store_rates("poa", "cpu", 9.0, 9.0)
    assert calibrate.epoch_snapshot() == snap
    # env pins win over the job's pin
    monkeypatch.setenv("RACON_TPU_TORCH_RATE_POA_DEV", "5")
    monkeypatch.setenv("RACON_TPU_TORCH_RATE_POA_CPU", "6")
    assert calibrate.get_rates("poa", "cpu", 1.0, 2.0, pin=pin) == \
        (5.0, 6.0, "env")


def test_drift_epoch_lifts_the_freeze_for_two_jobs(tmp_path, monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("RACON_TPU_TORCH_CALIB_FREEZE", "1")
    calibrate.reset_drift()
    try:
        assert calibrate.open_drift_epoch()
        assert not calibrate.open_drift_epoch()
        calibrate.store_rates("poa", "cpu", 3.0, 4.0)
        assert calibrate.get_rates("poa", "cpu", 1.0, 2.0)[2] == \
            "calibrated"
        assert not calibrate.note_drift_job()
        assert calibrate.note_drift_job()
        assert calibrate.drift_epoch_state() == {"open": False, "jobs": 2}
    finally:
        calibrate.reset_drift()


# ---------------------------------------------------------------------------
# daemons
# ---------------------------------------------------------------------------

def test_stale_socket_takeover_and_live_refusal(serve_tmp):
    proc_a, sock_path, _ = start_server(serve_tmp, "own")
    try:
        proc_b, _, log_b = start_server(serve_tmp, "own", wait=False)
        assert proc_b.wait(timeout=120) == 1
        assert "live server" in open(log_b).read()
        assert client.health(sock_path)["ok"]
        proc_a.kill()
        proc_a.wait(timeout=60)
        assert os.path.exists(sock_path)
        proc_c, _, log_c = start_server(serve_tmp, "own")
        try:
            assert client.health(sock_path)["ok"]
            assert "taking over" in open(log_c).read()
        finally:
            stop_server(proc_c, sock_path)
    finally:
        if proc_a.poll() is None:
            proc_a.kill()


def test_shared_directory_never_mixes_the_packages(serve_tmp, data,
                                                   golden):
    """A JAX daemon's journal beside the port's socket, with an
    interrupted job in it, and a JAX incarnation appended to the port's
    own file: the port daemon replays neither, and its own journal is a
    file the JAX daemon never opens."""
    from racon_tpu.serve import journal as jax_journal

    sock_path = os.path.join(serve_tmp, "mix.sock")
    for path in (jax_journal.journal_path(sock_path),
                 serve_journal.journal_path(sock_path)):
        j = jax_journal.JobJournal(path)
        j.append("admit", job=1, job_key="jax-job", spec=make_spec(data),
                 priority=0, tenant="default")
        j.close()
    proc, sock_path, log = start_server(serve_tmp, "mix")
    try:
        h = client.health(sock_path)
        assert h["recovered_jobs"] == 0 and h["recovery"]["failed"] == 0
        assert h["journal"]["path"] == serve_journal.journal_path(sock_path)
        resp = client.submit(sock_path, make_spec(data), job_key="port-job")
        assert fasta_of(resp) == golden
    finally:
        stop_server(proc, sock_path)
    keys = {r.get("job_key") for r in serve_journal.scan(
        jax_journal.journal_path(sock_path))[0]}
    assert keys == {None, "jax-job"}


#: (site, nth): the arrival that lands mid-job; journal-write's first
#: arrival is the daemon's own journal_open, so its second is the
#: job's admit record
KILL_SITES = [("post-admit", 1), ("mid-megabatch", 2), ("pre-demux", 1),
              ("pre-done-record", 1), ("journal-write", 2)]


@pytest.mark.parametrize(
    "site,nth", [pytest.param(s, n, marks=()
                              if s == "mid-megabatch" else pytest.mark.slow)
                 for s, n in KILL_SITES],
    ids=[s for s, _ in KILL_SITES])
def test_sigkill_recovery_byte_identical(serve_tmp, data, golden, site,
                                         nth):
    name = "kill-" + site
    proc, sock_path, _ = start_server(
        serve_tmp, name,
        extra_env={**CRASH_ENV, "RACON_TPU_TORCH_FAULT": f"{site}:{nth}"})
    key = f"chaos-{site}"
    held = {}

    def doomed():
        try:
            held["resp"] = client.submit(sock_path, make_spec(data),
                                         job_key=key)
        except client.ServeError as exc:
            held["err"] = exc

    t = threading.Thread(target=doomed)
    t.start()
    assert proc.wait(timeout=300) == -signal.SIGKILL
    t.join(60)
    assert "err" in held, held.get("resp")
    assert os.path.exists(serve_journal.journal_path(sock_path))

    proc2, _, log2 = start_server(serve_tmp, name, extra_env=CRASH_ENV)
    try:
        resp = client.submit_with_retry(sock_path, make_spec(data),
                                        retries=4, job_key=key)
        assert fasta_of(resp) == golden, site
        h = client.health(sock_path)
        assert h["journal"]["enabled"] and h["journal"]["depth"] >= 2
        if site != "journal-write":
            assert h["recovered_jobs"] == 1, h
            assert "journal replay" in open(log2).read()
        if site == "mid-megabatch":
            # the first megabatch was committed and journaled
            assert resp["report"]["details"]["poa_resumed_windows"] > 0
        again = client.submit(sock_path, make_spec(data), job_key=key)
        assert again["fasta_b64"] == resp["fasta_b64"]
        assert again["job_id"] == resp["job_id"]
    finally:
        stop_server(proc2, sock_path)


@pytest.mark.cuda
def test_served_job_on_the_card(tmp_path):
    """One served job on the card equals the one-shot CLI's bytes on
    the card (needs a GPU and nvcc; run with ``pytest -m cuda``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import io

    from racon_tpu_torch import cli
    from racon_tpu_torch.tools import simulate
    from test_torch_serve import pinned

    short = tempfile.mkdtemp(prefix="rttc_", dir="/tmp")
    data = simulate.simulate(str(tmp_path / "d"), genome_len=20_000,
                             coverage=10, read_len=2_000, seed=5, ont=True)
    buf = io.BytesIO()
    with pinned():
        cache.reset()
        cli.main([*KERNEL_ARGS, *data], out=buf)
    proc, sock_path, _ = start_server(short, "card", args=("--device",
                                                           "cuda"))
    try:
        resp = client.submit(sock_path, make_spec(data))
        assert fasta_of(resp) == buf.getvalue()
        assert sum(resp["report"]["details"]["launches"].values()) > 0
    finally:
        stop_server(proc, sock_path)
