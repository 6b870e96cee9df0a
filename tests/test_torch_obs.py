"""The port's observability layer (racon_tpu_torch/obs) against the JAX
package's (racon_tpu/obs), and wired through the port's main path.

Unit parity (the same inputs to both packages, equal outputs): the
metrics registry, device utilization, calibration health and the
histogram ladder.  The tracer writes nested, valid Chrome JSON and
records nothing while off.  On a small simulated set through
``--device cpu`` (the kernels' plain versions, whose host intervals feed
the device lanes): a traced polish at pinned rates gives the untraced
bytes and reports every gauge of tests/test_obs.py; the CLI with
``--trace`` and ``--metrics-json`` gives the same bytes as without them,
and its engine-independent counters equal the JAX CLI's on the same
data; the flight dump holds the run and its decisions.  The timing lint
keeps raw clocks out of the port, and the align length cap routes a
20,000-base pair by its setting.
"""

import io
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from racon_tpu.obs import calhealth as jax_calhealth
from racon_tpu.obs import devutil as jax_devutil
from racon_tpu.obs import metrics as jax_metrics
from racon_tpu_torch import cache, cli
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.cuda import devclock
from racon_tpu_torch.cuda.polisher import CudaPolisher
from racon_tpu_torch.obs import calhealth, decision, devutil, flight
from racon_tpu_torch.obs import metrics, provenance
from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.obs.context import job_context
from racon_tpu_torch.tools import simulate
from racon_tpu_torch.utils.logger import Logger


@pytest.fixture(autouse=True)
def cold_result_cache():
    """Every test starts and ends with an empty result cache, as a fresh
    process would: a test here counts launches, rungs or rates, or
    swaps an engine, and must not see what an earlier test filled."""
    cache.reset()
    yield
    cache.reset()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]
#: rates every polish here runs at: both splits give the device and the
#: CPU a share on this set (tests/test_torch_pipeline.py's pins)
PINS = {"RACON_TPU_TORCH_RATE_POA_DEV": "1.0",
        "RACON_TPU_TORCH_RATE_POA_CPU": "2.0",
        "RACON_TPU_TORCH_RATE_ALIGN_DEV": "1000",
        "RACON_TPU_TORCH_RATE_ALIGN_CPU": "20",
        "RACON_TPU_TORCH_RATE_ALIGN_WFA_DEV": "300"}
KNOBS = ("RACON_TPU_TORCH_PIPELINE", "RACON_TPU_TORCH_ALIGN_SPLIT",
         "RACON_TPU_TORCH_POA_SPLIT", "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY",
         "RACON_TPU_TORCH_POA_DEVICE_ONLY", "RACON_TPU_TORCH_RECALIBRATE",
         "RACON_TPU_TORCH_MAX_ALIGN_DIM", "RACON_TPU_TORCH_TRACE",
         "RACON_TPU_TORCH_METRICS_JSON", "RACON_TPU_TORCH_FLIGHT_DUMP")
#: the run-report gauges tests/test_obs.py requires of the JAX package
GAUGES = ("poa_spec_used", "poa_spec_wasted", "pipeline_overlap_s",
          "poa_device_s", "align_device_s", "stage_wall_s.device_align",
          "stage_wall_s.device_poa")


# ---------------------------------------------------------------------------
# unit parity with the JAX package
# ---------------------------------------------------------------------------

def _ops(seed, n=200):
    """A seeded sequence of registry writes: (op, name, value)."""
    rng = np.random.default_rng(seed)
    names = ["a", "b.c", "d_s", "e"]
    kinds = ["add", "set", "peak", "observe", "timer"]
    out = []
    for _ in range(n):
        kind = kinds[int(rng.integers(len(kinds)))]
        name = names[int(rng.integers(len(names)))]
        if kind == "timer":
            out.append((kind, "t." + name, None))
        elif kind == "add" and rng.random() < 0.5:
            out.append((kind, name, int(rng.integers(1, 5))))
        else:
            # spans the histogram ladder, its edges and the overflow
            out.append((kind, name,
                        float(10.0 ** rng.uniform(-5, 5))))
    return out


def _apply(reg, ops):
    for kind, name, value in ops:
        if kind == "timer":
            with reg.timer(name):
                pass
        else:
            getattr(reg, kind)(name, value)


def _drop_timers(snap):
    timers = {k for k in snap["counters"] if k.startswith("t.")}
    return timers, {**snap, "counters": {
        k: v for k, v in snap["counters"].items() if k not in timers}}


@pytest.mark.parametrize("seed", range(4))
def test_registry_snapshots_equal_jax(seed):
    """The same writes to the JAX registry and the port's, each a child
    of its own parent: equal snapshots, child and parent, but for the
    timers' values."""
    ops = _ops(seed)
    jp, pp = jax_metrics.Registry(), metrics.Registry()
    jc, pc = jax_metrics.Registry(parent=jp), metrics.Registry(parent=pp)
    _apply(jc, ops)
    _apply(pc, ops)
    for j, p in ((jc, pc), (jp, pp)):
        jt, js = _drop_timers(j.snapshot())
        pt, ps = _drop_timers(p.snapshot())
        assert jt == pt and js == ps
        assert json.loads(json.dumps(ps)) == ps
        for name in ("a", "b.c", "d_s", "e"):
            assert p.value(name) == j.value(name)
            h = ps["histograms"].get(name)
            if h:
                for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                    assert metrics.hist_quantile(h, q) == \
                        jax_metrics.hist_quantile(h, q)


def test_histogram_ladder_equals_jax():
    assert metrics.HIST_BUCKETS == jax_metrics.HIST_BUCKETS


@pytest.mark.parametrize("seed", range(3))
def test_device_util_equals_jax(seed):
    """The same dispatch intervals (in order, overlapping, nested,
    reversed) to both accumulators: equal snapshots and published
    gauges."""
    rng = np.random.default_rng(seed)
    jd, pd = jax_devutil.DeviceUtil(), devutil.DeviceUtil()
    t = 0.0
    for _ in range(60):
        eng = ["align_wfa", "align_band", "poa"][int(rng.integers(3))]
        t += float(rng.uniform(-0.02, 0.05))
        t0, t1 = t, t + float(rng.uniform(0.0, 0.04))
        if rng.random() < 0.1:
            t0, t1 = t1, t0
        jd.record(eng, t0, t1)
        pd.record(eng, t0, t1)
    assert pd.snapshot() == jd.snapshot()
    jr, pr = jax_metrics.Registry(), metrics.Registry()
    assert pd.publish(pr) == jd.publish(jr)
    assert pr.snapshot() == jr.snapshot()


@pytest.fixture()
def fresh_calhealth():
    jax_calhealth._reset_for_tests()
    calhealth.reset()
    yield
    jax_calhealth._reset_for_tests()
    calhealth.reset()


@pytest.mark.parametrize("seed", range(3))
def test_calhealth_equals_jax(fresh_calhealth, seed):
    """The same (predicted, actual) and (units, actual) observations to
    both: equal registry snapshots and summaries (drift flags
    included)."""
    rng = np.random.default_rng(seed)
    jr, pr = jax_metrics.Registry(), metrics.Registry()
    stages = ["align_wfa", "align_band", "poa", "host.parse",
              "host.stitch", "extra"]
    for _ in range(80):
        stage = stages[int(rng.integers(len(stages)))]
        actual = float(rng.uniform(0.0, 2.0))
        if stage.startswith("host."):
            units = float(rng.integers(0, 50))
            jax_calhealth.observe_units(stage, units, actual, registry=jr)
            calhealth.observe_units(stage, units, actual, registry=pr)
        else:
            pred = float(rng.uniform(-0.1, 3.0))
            jax_calhealth.observe(stage, pred, actual, registry=jr)
            calhealth.observe(stage, pred, actual, registry=pr)
    assert pr.snapshot() == jr.snapshot()
    assert calhealth.summary(pr.snapshot()) == \
        jax_calhealth.summary(jr.snapshot())
    assert calhealth.STAGES == jax_calhealth.STAGES
    assert calhealth.DRIFT_BAND == jax_calhealth.DRIFT_BAND


# ---------------------------------------------------------------------------
# tracer, device lanes, logger, rings
# ---------------------------------------------------------------------------

def validate_chrome_trace(doc) -> set:
    """Assert the Chrome trace-event schema and that the spans of each
    real thread nest; returns the span names."""
    assert isinstance(doc, dict) and doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert isinstance(events, list) and events
    by_tid = {}
    for ev in events:
        assert isinstance(ev["name"], str) and ev["name"]
        assert ev["ph"] in ("X", "i", "M"), ev
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0 and isinstance(ev["ts"], float)
            if ev["tid"] < obs_trace.Tracer._LANE_TID0:
                by_tid.setdefault(ev["tid"], []).append(ev)
    for spans in by_tid.values():
        # longest first at equal starts: a parent precedes its children
        spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for ev in spans:
            end = ev["ts"] + ev["dur"]
            while stack and stack[-1] <= ev["ts"]:
                stack.pop()
            if stack:
                assert end <= stack[-1] + 1e-3, ev
            stack.append(end)
    return {ev["name"] for ev in events if ev["ph"] == "X"}


@pytest.fixture()
def tracer(monkeypatch):
    """A fresh tracer in place of the process's, off until a test turns
    it on."""
    monkeypatch.delenv("RACON_TPU_TORCH_TRACE", raising=False)
    t = obs_trace.Tracer()
    monkeypatch.setattr(obs_trace, "TRACER", t)
    return t


def test_tracer_writes_nested_chrome_json(tracer, tmp_path):
    path = str(tmp_path / "t.json")
    tracer.enable(path)
    reg = metrics.Registry()

    def work(tag):
        with obs_trace.span(f"outer.{tag}", metric="outer_s",
                            registry=reg):
            for k in range(3):
                with obs_trace.span(f"inner.{tag}", args={"k": k}):
                    with obs_trace.span(f"leaf.{tag}"):
                        pass
            tracer.add_instant(f"mark.{tag}")

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    work("main")
    for th in threads:
        th.join(30)
        assert not th.is_alive()
    tracer.add_span("device.poa", 1.0, 1.5, cat="device", lane="device")
    with job_context(7, "tenantA"):
        with obs_trace.device_span("racon_tpu_torch.device_poa",
                                   device=torch.device("cpu")):
            pass
    doc = json.load(open(obs_trace.write_trace(path)))
    names = validate_chrome_trace(doc)
    assert {"outer.0", "inner.2", "leaf.main", "device.poa",
            "racon_tpu_torch.device_poa"} <= names
    lanes = {ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["ph"] == "M" and ev["tid"] >= tracer._LANE_TID0}
    assert lanes == {"device"}
    (dspan,) = [ev for ev in doc["traceEvents"]
                if ev["name"] == "racon_tpu_torch.device_poa"]
    assert dspan["args"]["job"] == 7 and dspan["args"]["tenant"] == "tenantA"
    assert reg.value("outer_s") > 0


def test_tracer_records_nothing_while_off(tracer):
    reg = metrics.Registry()
    with obs_trace.span("s", metric="m_s", registry=reg):
        tracer.add_instant("i")
        tracer.add_span("d", 0.0, 1.0, lane="device")
    assert tracer._events == [] and not tracer.enabled
    # the metric is kept whether or not tracing is on
    assert reg.value("m_s") >= 0 and "m_s" in reg.snapshot()["counters"]
    tracer.enable("unused.json")
    tracer.add_instant("i")
    tracer.disable()
    tracer.add_instant("j")
    assert [ev["name"] for ev in tracer._events if ev["ph"] == "i"] == ["i"]


def test_dispatch_timer_on_cpu_feeds_lane_and_device_util(tracer):
    """On the CPU a dispatch's marks are host clock reads: each pair of
    consecutive marks is one device-lane span and one DEVICE_UTIL
    interval of its engine, and the CUDA-event time is 0.  Each span
    carries the host times of its first mark and of the record, and
    lies between them; a timer given its own DeviceUtil leaves
    DEVICE_UTIL alone."""
    tracer.enable("unused.json")
    devutil.DEVICE_UTIL.reset()
    timer = devclock.DispatchTimer("cpu")
    for _ in range(3):
        timer.mark()
    timer.record("device.poa", "poa", {"n": 4})
    assert timer.kernel_ms() == 0.0
    spans = [ev for ev in tracer._events if ev["ph"] == "X"]
    assert [ev["args"]["pass"] for ev in spans] == [1, 2]
    assert {ev["tid"] for ev in spans} == {tracer._LANE_TID0}
    for ev in spans:
        assert ev["args"]["launch_ts"] == pytest.approx(ev["ts"], abs=1e-3)
        assert ev["ts"] + ev["dur"] <= ev["args"]["collect_ts"] + 1e-3
    assert spans[1]["args"]["launch_ts"] >= spans[0]["args"]["launch_ts"]
    snap = devutil.DEVICE_UTIL.snapshot()["poa"]
    assert snap["n_dispatches"] == 2
    assert snap["busy_s"] == pytest.approx(timer.device_s(), abs=2e-6)
    own = devutil.DeviceUtil()
    timer = devclock.DispatchTimer("cpu", own)
    timer.mark()
    timer.mark()
    timer.record("device.align_wfa512", "align_wfa", {"n": 1})
    assert set(devutil.DEVICE_UTIL.snapshot()) == {"poa"}
    assert own.snapshot()["align_wfa"]["n_dispatches"] == 1
    devutil.DEVICE_UTIL.reset()


def test_logger_format_prefix_and_total(tracer, capsys):
    """No job context: the reference's stderr format; under one, the
    ``[job N/tenant] `` prefix.  Lines are trace instants and the total
    is the ``logger_total_s`` gauge."""
    tracer.enable("unused.json")
    log = Logger()
    log.log()
    log.log("[racon_tpu_torch::x] stage")
    with job_context(3, "t"):
        log.log("[racon_tpu_torch::x] job stage")
    log.total("[racon_tpu_torch::x] total =")
    err = capsys.readouterr().err.splitlines()
    assert re.fullmatch(r"\[racon_tpu_torch::x\] stage \d+\.\d{6} s", err[0])
    assert re.fullmatch(r"\[job 3/t\] \[racon_tpu_torch::x\] job stage "
                        r"\d+\.\d{6} s", err[1])
    assert re.fullmatch(r"\[racon_tpu_torch::x\] total = \d+\.\d{6} s",
                        err[2])
    assert metrics.REGISTRY.value("logger_total_s") == \
        round(float(err[2].split()[-2]), 6)
    assert [ev["name"] for ev in tracer._events if ev["ph"] == "i"] == [
        "[racon_tpu_torch::x] stage", "[racon_tpu_torch::x] job stage",
        "[racon_tpu_torch::x] total ="]


@pytest.mark.parametrize("mod,recorder", [
    (decision, decision.DecisionRecorder),
    (flight, flight.FlightRecorder)])
def test_rings_bound_and_switch_off(monkeypatch, mod, recorder):
    """A ring keeps the newest RING events and counts the dropped; with
    ENABLED off it records nothing."""
    monkeypatch.setattr(mod, "RING", 16)
    ring = recorder()
    with job_context(5):
        for k in range(20):
            ring.record("kind_a" if k % 2 else "kind_b", k=k, none=None)
    evs = ring.snapshot()
    assert [ev["k"] for ev in evs] == list(range(4, 20))
    assert all(ev["job"] == 5 and "none" not in ev for ev in evs)
    assert [ev["seq"] for ev in evs] == list(range(5, 21))
    assert ring.stats()["dropped"] == 4 and ring.snapshot(last=2)[0]["k"] == 18
    monkeypatch.setattr(mod, "ENABLED", False)
    ring.record("kind_a")
    assert ring.stats()["recorded"] == 20


# ---------------------------------------------------------------------------
# the main path on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def pinned_env(tmp_path_factory):
    """Pinned rates and a calibration root of this module's own; no
    knob or obs switch set.  The plain versions' small tensor ops run on
    one intra-op thread (tests/test_torch_pipeline.py)."""
    root = tmp_path_factory.mktemp("obs_calib_root")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RACON_TPU_TORCH_CACHE_DIR", str(root))
            for k, v in PINS.items():
                mp.setenv(k, v)
            for k in KNOBS:
                mp.delenv(k, raising=False)
            yield root
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, pinned_env):
    out = tmp_path_factory.mktemp("obs_sim")
    return simulate.simulate(str(out), genome_len=6_000, coverage=8,
                             read_len=1_000, seed=33, ont=True)


ARGV = ["--device", "cpu", "-t", "4", *SCORES, "-c", "1",
        "--cudaaligner-batches", "1"]


@pytest.fixture(scope="module")
def plain(dataset):
    """The untraced CLI polish's bytes, from an empty result cache."""
    buf = io.BytesIO()
    cache.reset()
    cli.main(ARGV + list(dataset), out=buf)
    return buf.getvalue()


def _fasta(polished):
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in polished)


def test_traced_polish_byte_identical_and_reported(dataset, plain,
                                                   tmp_path, monkeypatch):
    """Tracing on, at pinned rates: the untraced bytes; the stage spans
    and the three engines' device lanes in the trace; every gauge of
    tests/test_obs.py in the report; each engine's dispatches in the
    polisher's own DeviceUtil equal to its dispatches, and its lane
    intervals summing to its device seconds.  The process's DEVICE_UTIL
    gets none of them, and a second polisher leaves the first's alone."""
    trace_path = str(tmp_path / "polish_trace.json")
    # the untraced polish filled the cache: this one starts cold
    cache.reset()
    devutil.DEVICE_UTIL.reset()
    obs_trace.TRACER.clear()
    obs_trace.enable_trace(trace_path)
    try:
        pol = create_polisher(*dataset, PolisherType.kC, 500, 10.0, 0.3,
                              True, 5, -4, -8, 4, cuda_poa_batches=1,
                              cuda_aligner_batches=1, device="cpu")
        try:
            pol.initialize()
            traced = _fasta(pol.polish(True))
        finally:
            pol.close()
        doc = json.load(open(obs_trace.write_trace()))
    finally:
        obs_trace.TRACER.disable()
        obs_trace.TRACER.clear()
    assert traced == plain
    names = validate_chrome_trace(doc)
    assert {"racon_tpu_torch.load_targets", "racon_tpu_torch.load_overlaps",
            "racon_tpu_torch.align_stage", "racon_tpu_torch.device_align",
            "racon_tpu_torch.build_windows", "racon_tpu_torch.device_poa",
            "racon_tpu_torch.consensus_stage", "device.poa"} <= names
    lanes = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X" and ev["name"].startswith("device."):
            eng = re.sub(r"\d+$", "", ev["name"][len("device."):])
            lanes.setdefault(eng, []).append(ev["dur"] / 1e6)
    du = pol.device_util.snapshot()
    assert set(du) == set(lanes) >= {"align_wfa", "poa"}
    assert devutil.DEVICE_UTIL.snapshot() == {}
    create_polisher(*dataset, PolisherType.kC, 500, 10.0, 0.3, True, 5, -4,
                    -8, 4, cuda_poa_batches=1, cuda_aligner_batches=1,
                    device="cpu").close()
    assert pol.device_util.snapshot() == du
    for eng, durs in lanes.items():
        assert du[eng]["n_dispatches"] == len(durs)
    for eng in ("align_wfa", "align_band"):
        assert du.get(eng, {}).get("n_dispatches", 0) == \
            pol.align_dispatches[eng]
        assert sum(lanes.get(eng, ())) == pytest.approx(
            getattr(pol, f"{eng}_device_s"), rel=1e-6, abs=1e-5)
    assert sum(lanes["poa"]) == pytest.approx(pol.poa_device_s, rel=1e-6,
                                              abs=1e-5)
    report = str(tmp_path / "report.json")
    provenance.write_metrics_json(
        report, run_registry=pol.metrics,
        details={"poa_split_detail": pol.poa_split_detail}, probe=False,
        device_util=pol.device_util)
    rep = json.load(open(report))
    assert rep["device_util"] == du
    gauges = rep["run"]["gauges"]
    for key in GAUGES:
        assert key in gauges, f"run report missing {key}"
    assert gauges["stage_wall_s.device_poa"] > 0
    assert gauges["poa_eligible_windows"] == pol.poa_eligible_windows > 0
    assert gauges["device_util.poa.n_dispatches"] == du["poa"]["n_dispatches"]
    assert gauges["ledger_ready_high_water"] == pol.ready_high_water
    assert pol.align_cells == sum(pol.align_kernel_cells.values()) > 0


@pytest.fixture(scope="module")
def cli_run(dataset, tmp_path_factory):
    """The port's CLI in a subprocess with --trace, --metrics-json and
    a flight dump."""
    tmp = tmp_path_factory.mktemp("obs_cli")
    paths = {k: str(tmp / f"{k}.json") for k in ("trace", "report",
                                                 "flight")}
    env = {**os.environ, "RACON_TPU_TORCH_FLIGHT_DUMP": paths["flight"],
           "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", *ARGV,
         f"--trace={paths['trace']}", "--metrics-json", paths["report"],
         *dataset], cwd=ROOT, capture_output=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr.decode()
    return res, paths


def test_cli_trace_and_metrics_json(cli_run, plain):
    res, paths = cli_run
    assert res.stdout == plain, "--trace/--metrics-json changed the bytes"
    err = res.stderr.decode()
    assert "pipeline summary:" in err and "host budget:" in err
    names = validate_chrome_trace(json.load(open(paths["trace"])))
    assert {"racon_tpu_torch.run", "racon_tpu_torch.align_stage",
            "racon_tpu_torch.device_align", "racon_tpu_torch.device_poa",
            "racon_tpu_torch.consensus_stage", "device.poa"} <= names
    assert any(n.startswith("device.align_wfa") for n in names)
    rep = json.load(open(paths["report"]))
    assert set(rep) == {"schema", "environment", "run", "process",
                        "device_util", "details"}
    assert rep["schema"] == provenance.SCHEMA
    assert rep["environment"]["torch"]["version"] == torch.__version__
    assert "probe_wall_s" in rep["environment"]["host"]["capability_probe"]
    knobs = rep["environment"]["knobs"]
    assert knobs["RACON_TPU_TORCH_RATE_POA_DEV"] == {"value": "1.0",
                                                     "source": "env"}
    assert knobs["RACON_TPU_TORCH_MAX_ALIGN_DIM"]["value"] == "16384"
    assert {"poa", "align_wfa"} <= set(rep["device_util"])
    assert {"stage_walls", "poa_split_detail", "align_split_detail",
            "align_rungs", "align_retry_counts",
            "poa_reject_counts"} <= set(rep["details"])
    assert rep["details"]["device"] == "cpu"


def test_flight_dump_holds_run_and_decisions(cli_run):
    _, paths = cli_run
    doc = flight.load_dump(paths["flight"])
    assert [ev["kind"] for ev in doc["events"]][-2:] == ["run", "run_done"]
    kinds = {ev["kind"] for ev in doc["decisions"]["events"]}
    assert {"align_split", "align_chunk", "poa_split"} <= kinds
    chunk = next(ev for ev in doc["decisions"]["events"]
                 if ev["kind"] == "align_chunk")
    assert {"engine", "rung", "n", "predicted_s", "measured_s"} <= set(chunk)


def test_report_counters_equal_jax_cli(cli_run, dataset, tmp_path):
    """The engine-independent counters of the port's report equal the
    JAX CLI's on the same data: the POA-eligible windows and the set of
    ``host.*`` keys.  (The JAX CPU run takes the scan ladder, so its
    rung counters cannot match the port's.)"""
    _, paths = cli_run
    report = str(tmp_path / "jax_report.json")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "RACON_TPU_CACHE_DIR": str(tmp_path / "jax_cache"),
           "RACON_TPU_CLI_PREWARM": "0"}
    for k in ("RACON_TPU_TRACE", "RACON_TPU_METRICS_JSON",
              "RACON_TPU_FLIGHT_DUMP"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "racon_tpu.cli", "-t", "4", *SCORES, "-c",
         "1", "--tpualigner-batches", "1", "--metrics-json", report,
         *dataset], cwd=ROOT, capture_output=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr.decode()

    def flat(doc):
        run = doc["run"]
        return {**run["counters"], **run["gauges"]}

    want, got = flat(json.load(open(report))), flat(json.load(
        open(paths["report"])))
    assert got["poa_eligible_windows"] == want["poa_eligible_windows"] > 0
    assert {k for k in got if k.startswith("host.")} == \
        {k for k in want if k.startswith("host.")}


# ---------------------------------------------------------------------------
# timing lint, align length cap
# ---------------------------------------------------------------------------

def test_no_raw_timing_outside_obs():
    """Timing in racon_tpu_torch/ goes through obs.now()/span();
    utils/logger.py keeps its own clock for the reference's stderr
    format (the JAX package's lint, tests/test_obs.py)."""
    pat = re.compile(r"time\.monotonic\(|time\.perf_counter\(|time\.time\(")
    allowed = {os.path.join("racon_tpu_torch", "utils", "logger.py")}
    offenders = []
    pkg = os.path.join(ROOT, "racon_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        if os.path.basename(dirpath) == "obs":
            continue
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, ROOT)
            if rel in allowed:
                continue
            with open(path) as f:
                for ln, line in enumerate(f, 1):
                    if pat.search(line):
                        offenders.append(f"{rel}:{ln}")
    assert not offenders, ("raw timing outside racon_tpu_torch/obs "
                           "(use obs.now/span): " + ", ".join(offenders))


class _Pair:
    """The overlap fields the align stage's routing reads."""

    def __init__(self, length):
        self.cigar, self.cigar_runs, self.breaking_points = "", None, None
        self.q_begin, self.q_end = 0, length
        self.t_begin, self.t_end = 0, length


@pytest.mark.parametrize("cap,to_ladder", [(None, False),
                                           ("32768", True)])
def test_align_length_cap_routes_long_pairs(dataset, monkeypatch, cap,
                                            to_ladder):
    """A 20,000-base pair goes to the over-length (CPU) list at the
    default cap of 16,384 and to the ladder's pending list at 32,768;
    the report's knobs show the cap in force."""
    if cap is not None:
        monkeypatch.setenv("RACON_TPU_TORCH_MAX_ALIGN_DIM", cap)
    seen = {}
    monkeypatch.setattr(CudaPolisher, "_hybrid_align",
                        lambda self, pending, over=(): seen.update(
                            pending=pending, over=over))
    pol = create_polisher(*dataset, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, 2, cuda_aligner_batches=1,
                          device="cpu")
    try:
        long_pair, short = _Pair(20_000), _Pair(1_000)
        pol._device_align_overlaps([long_pair, short])
    finally:
        pol.close()
    assert pol.max_align_dim == int(cap or CudaPolisher.MAX_ALIGN_DIM)
    pending = [o for _, o in seen["pending"]]
    over = [o for _, o in seen["over"]]
    assert (long_pair in pending) == to_ladder
    assert (long_pair in over) == (not to_ladder)
    assert short in pending and pol.align_over_length == int(not to_ladder)
    knob = provenance.resolved_knobs()["RACON_TPU_TORCH_MAX_ALIGN_DIM"]
    assert knob["value"] == (cap or "16384")


def test_align_length_cap_runs_the_ladder(tmp_path, monkeypatch):
    """At a cap of 32,768 the real ladder takes a 20,000-base pair: past
    the WFA kernel's 16,384 rows, it goes straight to a band rung while
    the short pairs of the same ladder take a WFA rung, and it is
    certified there.  The polished bytes equal those of the default
    cap, where the pair takes the CPU aligner instead."""
    paths = simulate.long_pair(str(tmp_path))
    monkeypatch.setenv("RACON_TPU_TORCH_ALIGN_DEVICE_ONLY", "1")
    # one band rung, so the band's plain version stays narrow here
    monkeypatch.setattr(CudaPolisher, "BAND_RUNGS", (2048,))
    out = {}
    for cap in (None, "32768"):
        if cap is not None:
            monkeypatch.setenv("RACON_TPU_TORCH_MAX_ALIGN_DIM", cap)
        pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3,
                              True, 5, -4, -8, 2, cuda_aligner_batches=1,
                              device="cpu")
        try:
            pol.initialize()
            out[cap] = [(s.name, s.data) for s in pol.polish(True)]
        finally:
            pol.close()
        rungs = pol.align_rungs
        wfa = sum(r["admitted"] for k, r in rungs.items()
                  if k.startswith("wfa"))
        band = sum(r["certified"] for k, r in rungs.items()
                   if k.startswith("band"))
        assert wfa > 0 and pol.align_cpu_fallthrough == 0
        if cap is None:
            assert pol.align_over_length == 1 and band == 0
        else:
            assert pol.align_over_length == 0 and band == 1
            assert pol.metrics.snapshot()["counters"][
                "align_rung_admit.band2048"] == 1
    assert out[None] == out["32768"]
