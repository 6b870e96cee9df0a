"""The port's read-side subcommands (``top``, ``inspect``, ``explain``), on
the CPU.

The renderers are pure functions of the documents a daemon serves; here
the documents come from a live ``--device cpu`` port daemon (a job
served on it), an in-process port router in front of it, a one-shot
run's flight dump and its ``--metrics-json`` report, and both packages'
renderers draw them.  The text must be equal, with the port's names
(``racon-tpu-torch``, ``RACON_TPU_TORCH_``) mapped onto the JAX
package's:

* ``top.render`` (a ``watch`` frame) and ``top.render_fleet`` (the
  merged scrape of the router and the daemon, router rows included);
* ``inspect.render_timeline`` and ``render_summary`` (the daemon's
  flight events and a one-shot run's dump);
* ``explain.render_job``, ``render_overview``, ``render_drift``,
  ``render_counts`` and ``render_waterfall`` (the daemon's ``explain``
  frame and the port's run report, read by each package's reader);

and ``python -m racon_tpu_torch.cli top --once --json``, ``inspect
--dump``, ``inspect --socket --job``, ``explain --metrics-json`` and
``explain --socket --job`` exit 0.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

import pytest

from racon_tpu.serve import explain as jax_explain
from racon_tpu.serve import inspect as jax_inspect
from racon_tpu.serve import top as jax_top
from racon_tpu_torch.obs import flight as obs_flight
from racon_tpu_torch.serve import client, explain, fleet, inspect, router, top

from test_torch_fleet import _env, _serve_inproc, start_daemon, stop

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jaxified(text: str) -> str:
    """The port's names in rendered text mapped onto the JAX package's."""
    return text.replace("racon-tpu-torch", "racon-tpu").replace(
        "RACON_TPU_TORCH_", "RACON_TPU_")


@pytest.fixture(scope="module")
def tmp_dir():
    with tempfile.TemporaryDirectory(prefix="rtfx_", dir="/tmp") as d:
        yield d


@pytest.fixture(scope="module")
def inputs(tmp_dir):
    """tests/test_tools.py's two-target set."""
    t1 = b"ACGTTGCAACGTGGCCAATTCCGGACGTACGTTTAACCGGATCGATCGTA"
    t2 = b"TTGACCAGTAGGCCTTAGGCATCGAATTCGGCCAATGGTTACGCGATCAA"
    paths = [os.path.join(tmp_dir, n) for n in ("reads.fasta", "ovl.paf",
                                                "targets.fasta")]
    with open(paths[2], "wb") as fh:
        fh.write(b">t1\n" + t1 + b"\n>t2\n" + t2 + b"\n")
    with open(paths[0], "wb") as fh:
        fh.write(b">r1\n" + t1 + b"\n>r2\n" + t2 + b"\n")
    with open(paths[1], "wb") as fh:
        fh.write(b"r1\t50\t0\t50\t+\tt1\t50\t0\t50\t50\t50\t255\n"
                 b"r2\t50\t0\t50\t+\tt2\t50\t0\t50\t50\t50\t255\n")
    return paths


@pytest.fixture(scope="module")
def served(tmp_dir, inputs):
    """A daemon with two jobs served (one keyed) and an in-process router
    in front of it; yields (daemon socket, router socket, job ids)."""
    proc, sock = start_daemon(tmp_dir, "fx")
    mp = pytest.MonkeyPatch()
    mp.setenv("RACON_TPU_TORCH_ROUTE_PROBE_S", "0.2")
    mp.setattr(obs_flight, "FLIGHT", obs_flight.FlightRecorder())
    rsock = os.path.join(tmp_dir, "fxr.sock")
    r = None
    try:
        spec = {"sequences": inputs[0], "overlaps": inputs[1],
                "targets": inputs[2], "drop_unpolished": False,
                "tenant": "acme"}
        jobs = [client.submit(sock, spec)["job_id"],
                client.submit(sock, spec, job_key="fx-key")["job_id"]]
        r = _serve_inproc(router, rsock, [sock])
        routed = client.submit(rsock, spec, job_key="fx-routed")
        assert routed["ok"], routed
        yield sock, rsock, jobs
    finally:
        if r is not None:
            r.request_stop()
        mp.undo()
        stop(proc, sock)


@pytest.fixture(scope="module")
def one_shot_run(tmp_dir, inputs):
    """A one-shot run with its flight dump and run report."""
    dump = os.path.join(tmp_dir, "flight.json")
    report = os.path.join(tmp_dir, "report.json")
    out = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "--device", "cpu",
         "-u", "--metrics-json", report, *inputs], capture_output=True,
        cwd=REPO_ROOT, env=_env(tmp_dir, {
            "RACON_TPU_TORCH_FLIGHT_DUMP": dump}), timeout=300)
    assert out.returncode == 0, out.stderr.decode()
    return dump, report


def test_top_render_equals_jax(served):
    sock, _, _ = served
    frame = next(client.watch(sock, interval_s=0.1, count=1))
    assert frame["queue"]["completed"] >= 2
    text = top.render(frame)
    assert text.startswith("racon-tpu-torch serve  pid")
    assert jaxified(text) == jax_top.render(frame)


def test_top_render_fleet_equals_jax_with_router_rows(served):
    sock, rsock, _ = served
    targets = top.fleet_targets(rsock)
    assert targets == [rsock, sock]
    scraper = fleet.FleetScraper(targets)
    scraper.scrape_once()
    doc = fleet.merge_fleet(scraper.results())
    assert doc["alive"] == 2 and doc["daemons"][0]["route"]
    text = top.render_fleet(doc)
    # the in-process router counts into this process's registry, which
    # other in-process routers of the run may have counted into too
    assert re.search(r"route: [1-9]\d* placed", text)
    assert f"-> {sock}" in text
    assert jaxified(text) == jax_top.render_fleet(doc)
    # a list stays as given, a plain daemon is its own fleet
    assert top.fleet_targets(f"{sock},{rsock}") == [sock, rsock]
    assert top.fleet_targets(sock) == [sock]


def test_inspect_renderers_equal_jax(served):
    sock, _, jobs = served
    doc = client.flight(sock)
    events = doc["events"]
    for job in jobs + [999]:
        ours = inspect.render_timeline(events, job)
        assert ours == jax_inspect.render_timeline(events, job)
    jdoc = client.flight(sock, job=jobs[0])
    ours = inspect.render_timeline(jdoc["events"], jobs[0],
                                   trace_events=jdoc.get("job_trace"))
    assert ours == jax_inspect.render_timeline(
        jdoc["events"], jobs[0], trace_events=jdoc.get("job_trace"))
    assert "admit" in ours and "done" in ours
    assert inspect.render_summary(events, header="h") == \
        jax_inspect.render_summary(events, header="h")
    for job in jobs:
        assert inspect.job_events(events, job) == \
            jax_inspect.job_events(events, job)


def test_inspect_dump_renderers_equal_jax(one_shot_run):
    dump, _ = one_shot_run
    doc = obs_flight.load_dump(dump)
    assert doc["schema"] == "racon-tpu-torch-flight-v1"
    events = doc["events"]
    assert {"run", "run_done"} <= {e["kind"] for e in events}
    assert inspect.render_summary(events) == \
        jax_inspect.render_summary(events)


def test_explain_renderers_equal_jax(served):
    sock, _, jobs = served
    doc = client.explain(sock)
    assert doc["ok"]
    for job in jobs + [999]:
        jdoc = client.explain(sock, job=job)
        assert jaxified(explain.render_job(jdoc, job)) == \
            jax_explain.render_job(jdoc, job)
    ours = explain.render_job(client.explain(sock, job=jobs[0]), jobs[0])
    assert "stage             wall" in ours
    assert jaxified(explain.render_overview(doc)) == \
        jax_explain.render_overview(doc)
    assert jaxified(explain.render_drift(doc["calhealth"])) == \
        jax_explain.render_drift(doc["calhealth"])
    assert explain.render_counts(doc["counts"]) == \
        jax_explain.render_counts(doc["counts"])


def test_explain_drift_advisory_names_the_ports_knob():
    cal = {"band": [0.5, 2.0],
           "stages": {"poa": {"n": 3, "ewma": 2.6, "p50": 2.5, "p99": 2.9,
                              "drift": True},
                      "align_wfa": {"n": 2, "ewma": 1.0, "p50": 1.0,
                                    "p99": 1.1, "drift": False}}}
    ours = explain.render_drift(cal)
    assert "RACON_TPU_TORCH_RECALIBRATE=1" in ours
    assert jaxified(ours) == jax_explain.render_drift(cal)
    walls = {"align": 2.5, "poa": 1.25, "device_align": 0.5,
             "windows": 0.0004, "parse": 0.0}
    for total in (None, 4.26, 20.0):
        assert explain.render_waterfall(walls, total_s=total) == \
            jax_explain.render_waterfall(walls, total_s=total)


def test_explain_report_reader_equals_jax(one_shot_run):
    _, report = one_shot_run
    with open(report) as fh:
        rep = json.load(fh)
    assert rep["schema"] == "racon-tpu-torch-metrics-v1"
    ours = explain._doc_from_report(report)
    theirs = jax_explain._doc_from_report(report)
    assert ours == theirs
    assert ours["events"][0]["stage_walls"] == rep["details"]["stage_walls"]
    assert jaxified(explain.render_job(ours, 0)) == \
        jax_explain.render_job(theirs, 0)


def cli(*argv, tmp):
    return subprocess.run([sys.executable, "-m", "racon_tpu_torch.cli",
                           *argv], capture_output=True, cwd=REPO_ROOT,
                          env=_env(tmp), timeout=120)


def test_subcommands_exit_0(served, one_shot_run, tmp_dir):
    sock, rsock, jobs = served
    dump, report = one_shot_run
    out = cli("top", "--socket", sock, "--once", "--json", tmp=tmp_dir)
    assert out.returncode == 0, out.stderr.decode()
    assert json.loads(out.stdout)["queue"]["completed"] >= 2
    out = cli("top", "--fleet", rsock, "--once", "--json", tmp=tmp_dir)
    assert out.returncode == 0, out.stderr.decode()
    assert [d["target"] for d in json.loads(out.stdout)["daemons"]] == \
        [rsock, sock]
    out = cli("inspect", "--dump", dump, tmp=tmp_dir)
    assert out.returncode == 0, out.stderr.decode()
    assert out.stdout.startswith(b"flight dump ")
    out = cli("inspect", "--socket", sock, "--job", str(jobs[1]),
              tmp=tmp_dir)
    assert out.returncode == 0, out.stderr.decode()
    assert f"job {jobs[1]} (acme".encode() in out.stdout
    out = cli("explain", "--metrics-json", report, tmp=tmp_dir)
    assert out.returncode == 0, out.stderr.decode()
    assert b"stage             wall" in out.stdout
    out = cli("explain", "--socket", sock, "--job", str(jobs[0]), "--json",
              tmp=tmp_dir)
    assert out.returncode == 0, out.stderr.decode()
    assert any(e["kind"] == "job_stages"
               for e in json.loads(out.stdout)["events"])


def test_cli_dispatches_the_read_side(capsys):
    from racon_tpu_torch import cli as port_cli

    for sub in ("top", "inspect", "explain"):
        with pytest.raises(SystemExit) as exc:
            port_cli.main([sub, "--help"])
        assert exc.value.code == 0
        assert f"racon-tpu-torch {sub}" in capsys.readouterr().out
    assert "racon_tpu_torch inspect" in port_cli.USAGE
