"""The port's fleet: the router, the fleet scrape and the exact merge, on
the CPU.

Held to the JAX package with a tolerance of zero (bytes, documents,
orders):

* ``merge_snapshots`` and ``merge_fleet`` give the JAX package's
  documents on the same snapshots, and merged quantiles equal those of
  one registry that saw every observation; ``backend_hit_fraction``
  gives the JAX package's fraction on the same digests and refuses a
  foreign epoch, the JAX package's sketch among them;
* ``FleetRouter._rank`` orders the same health documents (loads,
  sketches, breakers, draining) as the JAX router does, and the
  router's ``route_status`` / ``health`` / ``metrics`` documents carry
  the JAX router's keys;
* an in-process router over framed stub backends spills over, opens and
  closes breakers, answers on its TCP front, scatters and gathers in
  shard order, surfaces a failed shard with its coordinates and
  rebalances a straggler (the JAX package's tests/test_router.py and
  tests/test_scatter.py, on the port);
* two ``--device cpu`` daemons behind a ``route`` subprocess: a routed
  job and a scattered job with staging equal the one-shot bytes, the JAX
  client reads the router's frames, ``metrics --fleet`` merges the
  daemons exactly; a ``queue_full`` backend spills over, a dead socket's
  breaker opens and closes after its half-open probe, a draining backend
  fails over, and a backend SIGKILLed mid-shard leaves the bytes as they
  were;
* under ``-m slow``: the router's own SIGKILL at ``route-pre-forward``,
  ``route-pre-reply`` and ``route-mid-gather``, and at
  ``route-mid-rebalance``, each resubmit exactly once through the
  backends' journals.
"""

import base64
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from racon_tpu_torch import cache, cli
from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.serve import client, protocol, router

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the split rates every daemon prices at, the kernel path all on the
#: (plain) device, no calibration store
PINS = {"RACON_TPU_TORCH_RATE_POA_DEV": "0.30",
        "RACON_TPU_TORCH_RATE_POA_CPU": "2.0",
        "RACON_TPU_TORCH_RATE_ALIGN_DEV": "1100",
        "RACON_TPU_TORCH_RATE_ALIGN_CPU": "4.0",
        "RACON_TPU_TORCH_RATE_ALIGN_WFA_DEV": "700",
        "RACON_TPU_TORCH_CACHE_DIR": "",
        "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "1",
        "RACON_TPU_TORCH_POA_DEVICE_ONLY": "1"}
#: knobs no process here may inherit from the test's environment
UNSET = ("RACON_TPU_TORCH_TRACE", "RACON_TPU_TORCH_METRICS_JSON",
         "RACON_TPU_TORCH_FLIGHT_DUMP", "RACON_TPU_TORCH_FAULT",
         "RACON_TPU_TORCH_CALIB_FREEZE", "RACON_TPU_TORCH_COORD",
         "RACON_TPU_TORCH_NPROC", "RACON_TPU_TORCH_RANK",
         "RACON_TPU_TORCH_STAGE", "RACON_TPU_TORCH_PIPELINE",
         "RACON_TPU_TORCH_SCATTER_MIN_WALL_S",
         "RACON_TPU_TORCH_SCATTER_REBALANCE")
#: the router's probe cadence in the daemon tests, and no straggler
#: replacements: the plain versions run far past the shard walls the
#: pricing predicts, and each test pins where its shards run
ROUTE_ENV = {"RACON_TPU_TORCH_ROUTE_PROBE_S": "0.2",
             "RACON_TPU_TORCH_ROUTE_BREAKER_FAILS": "2",
             "RACON_TPU_TORCH_ROUTE_BREAKER_COOLDOWN_S": "0.5",
             "RACON_TPU_TORCH_SCATTER_REBALANCE": "0"}
KERNEL_ARGS = ("-t", "2", "-c", "1", "--cudaaligner-batches", "1")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The plain versions' torch ops on 2 threads: the suite runs files
    side by side, each with daemons of its own."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cold_result_cache():
    cache.reset()
    yield
    cache.reset()


# ---------------------------------------------------------------------------
# the exact merge against the JAX package's
# ---------------------------------------------------------------------------

def _registries(n_sources: int, seed: int):
    """The same observations into ``n_sources`` registries of each
    package, and one registry of each that saw them all."""
    import numpy as np

    from racon_tpu.obs.metrics import Registry as JaxRegistry
    from racon_tpu_torch.obs.metrics import Registry

    rng = np.random.default_rng(seed)
    port = [Registry() for _ in range(n_sources)]
    jax = [JaxRegistry() for _ in range(n_sources)]
    union = (Registry(), JaxRegistry())
    for i in range(n_sources):
        for reg in (port[i], jax[i]) + union:
            reg.add("serve_jobs_completed", i + 1)
            reg.add("route_submit", 2 * i)
        for reg in (port[i], jax[i]):
            reg.set("serve_uptime_s", 10.0 * (i + 1))
            reg.set("calhealth_ewma.poa", 0.8 + 0.3 * i)
        for v in rng.lognormal(-3, 1.5, int(rng.integers(5, 60))):
            for reg in (port[i], jax[i]) + union:
                reg.observe("serve_exec_wall_s", float(v))
                reg.observe("calhealth_ratio.poa", float(v) * 10)
        if i % 2:
            for reg in (port[i], jax[i]) + union:
                reg.observe("serve_queue_wait_s.acme", 0.001 * (i + 1))
    return ({f"d{i}": r.snapshot() for i, r in enumerate(port)},
            {f"d{i}": r.snapshot() for i, r in enumerate(jax)}, union)


@pytest.mark.parametrize("n_sources,seed", [(1, 1), (2, 2), (3, 3), (5, 4)])
def test_merge_snapshots_equals_jax_and_union(n_sources, seed):
    from racon_tpu.obs import aggregate as jax_aggregate
    from racon_tpu_torch.obs import aggregate
    from racon_tpu_torch.obs.metrics import hist_quantile

    port, jax, union = _registries(n_sources, seed)
    merged = aggregate.merge_snapshots(port)
    jmerged = jax_aggregate.merge_snapshots(jax)
    assert merged["schema"] == "racon-tpu-torch-aggregate-v1"
    assert {**merged, "schema": None} == {**jmerged, "schema": None}
    whole = union[0].snapshot()
    for name, h in merged["histograms"].items():
        for q in (0.5, 0.9, 0.99, 0.999):
            assert hist_quantile(h, q) == \
                hist_quantile(whole["histograms"][name], q), (name, q)
    assert merged["counters"] == whole["counters"]
    assert merged["gauges"]["serve_uptime_s"]["sum"] == sum(
        10.0 * (i + 1) for i in range(n_sources))


def _fleet_rows(snaps, export_mod, dead=()):
    rows = []
    for i, (src, snap) in enumerate(sorted(snaps.items())):
        stale = src in dead
        rows.append({
            "target": f"/s/{src}.sock", "ok": not stale, "stale": stale,
            "age_s": None if stale else 0.5,
            "consecutive_failures": 2 if stale else 0,
            "error": "ServeError: gone" if stale else None,
            "doc": {"identity": {"daemon_id": src, "pid": 100 + i},
                    "uptime_s": 12.0,
                    "queue": {"queue_depth": i, "running": [1] * i,
                              "completed": 3 * i, "draining": False},
                    "snapshot": export_mod.json_snapshot(snap)}})
    return rows


def test_merge_fleet_equals_jax():
    from racon_tpu.obs import export as jax_export
    from racon_tpu.serve import fleet as jax_fleet
    from racon_tpu_torch.obs import export
    from racon_tpu_torch.serve import fleet

    port, jax, _ = _registries(3, 9)
    for dead in ((), ("d1",)):
        doc = fleet.merge_fleet(_fleet_rows(port, export, dead))
        jdoc = jax_fleet.merge_fleet(_fleet_rows(jax, jax_export, dead))
        doc["merged"]["schema"] = jdoc["merged"]["schema"] = None
        assert doc == jdoc
        assert doc["alive"] == 3 - len(dead)
        assert set(doc["slo"]) == {"serve_exec_wall_s",
                                   "serve_queue_wait_s.acme"}
        assert doc["calhealth"]["stages"]["poa"]["ewma"] == round(
            sum(0.8 + 0.3 * i for i in range(3)) / 3, 6)


def test_calhealth_stage_ewma_from_merged_equals_jax():
    from racon_tpu.obs import aggregate as jax_aggregate
    from racon_tpu.obs import calhealth as jax_calhealth
    from racon_tpu_torch.obs import aggregate, calhealth

    port, jax, _ = _registries(2, 7)
    for a, b in ((port["d0"], jax["d0"]),
                 (aggregate.merge_snapshots(port),
                  jax_aggregate.merge_snapshots(jax))):
        assert calhealth.stage_ewma(a, "poa") == \
            jax_calhealth.stage_ewma(b, "poa") is not None
        assert calhealth.summary(a) == jax_calhealth.summary(b)
    assert calhealth.stage_ewma(port["d0"], "align_band") is None
    assert calhealth._ewma_from_gauge({"per_source": {}}) is None
    assert calhealth._ewma_from_gauge("x") is None


def test_prometheus_text_fleet_labels_every_sample():
    from racon_tpu.obs import export as jax_export
    from racon_tpu_torch.obs import export

    port, jax, _ = _registries(2, 3)
    text = export.prometheus_text_fleet(port)
    # the JAX package's exposition but for the metric prefix
    assert text == jax_export.prometheus_text_fleet(jax).replace(
        "racon_tpu_", "racon_tpu_torch_")
    for line in text.splitlines():
        if not line.startswith("#"):
            assert 'instance="d0"' in line or 'instance="d1"' in line
    assert 'tenant="acme"' in text
    # one source renders as the plain exposition plus the label
    one = export.prometheus_text_fleet({"x": port["d0"]})
    assert one.replace('{instance="x"}', "").replace(
        'instance="x",', "").replace(',instance="x"', "") == \
        export.prometheus_text(port["d0"])


# ---------------------------------------------------------------------------
# placement against the JAX router's
# ---------------------------------------------------------------------------

def test_breaker_state_machine():
    b = router.Backend("x", fails=2, cooldown_s=10.0)
    assert b.state == router.CLOSED and b.eligible()
    assert b.probe_due(100.0)
    assert not b.note_failure("boom", 100.0)
    assert b.note_failure("boom", 101.0)
    assert b.state == router.OPEN and not b.eligible()
    assert 101.0 + 7.5 <= b.next_probe <= 101.0 + 12.5
    assert not b.probe_due(b.next_probe - 5.0)
    assert b.probe_due(b.next_probe + 0.1)
    assert b.state == router.HALF_OPEN
    assert not b.probe_due(b.next_probe + 0.2)      # exactly one probe
    assert b.note_failure("still down", b.next_probe + 1.0)
    assert b.state == router.OPEN and b.opened_count == 2
    assert b.probe_due(b.next_probe + 0.1)
    assert b.note_success({"ok": True, "status": "ok", "accepting": True},
                          200.0)
    assert b.state == router.CLOSED and b.failures == 0 and b.eligible()
    assert not b.note_success({"ok": True, "status": "draining"}, 201.0)
    assert b.draining and not b.eligible()
    snap = b.snapshot(202.0)
    assert snap["breaker"] == "CLOSED" and snap["draining"]
    assert snap["probe_age_s"] == 1.0


def _statable_spec(tmp_path, tag="a", pad=0):
    """Inputs the pricing can stat; ``pad`` bases of read data make the
    predicted walls large enough to tell warm from cold."""
    reads = tmp_path / f"r{tag}.fasta"
    reads.write_text(f">r{tag}\nACGTACGTACGT\n" + (
        f">pad\n{'A' * pad}\n" if pad else ""))
    paf = tmp_path / f"o{tag}.paf"
    paf.write_text(f"r{tag}\t12\t0\t12\t+\tt1\t12\t0\t12\t12\t12\t255\n")
    draft = tmp_path / f"t{tag}.fasta"
    draft.write_text(">t1\nACGTACGTACGT\n")
    return {"sequences": str(reads), "overlaps": str(paf),
            "targets": str(draft)}


def _sketch_doc(pkg: str, sample):
    """An exported cache sketch holding ``sample``, by ``pkg``'s code and
    tagged with its engine epoch."""
    if pkg == "port":
        from racon_tpu_torch.cache import keying, sketch
    else:
        from racon_tpu.cache import keying, sketch
    sk = sketch.DigestSketch()
    for d in sample:
        sk.add(d)
    return sk.export(keying.engine_epoch().hex(), len(sample))


def _sample(pkg: str, spec):
    if pkg == "port":
        from racon_tpu_torch.cache import keying
        from racon_tpu_torch.serve import affinity
    else:
        from racon_tpu.cache import keying
        from racon_tpu.serve import affinity
    return affinity.job_digest_sample(spec, keying.engine_epoch())


def _rank_both(tmp_path, docs, spec, tenant=None, exclude=(), setup=None):
    """The port's and the JAX router's rankings of three backends given
    per-backend health documents (``docs[i]`` is a function of the
    package name, so each can carry its own package's sketch)."""
    from racon_tpu.obs import trace as jax_trace
    from racon_tpu.serve import router as jax_router

    orders = []
    for pkg, mod, now in (("port", router, obs_trace.now),
                          ("jax", jax_router, jax_trace.now)):
        r = mod.FleetRouter(str(tmp_path / f"{pkg}.sock"),
                            ["a", "b", "c"])
        for backend, doc in zip(r.backends, docs):
            if doc is not None:
                backend.note_success(doc(pkg), now())
        if setup is not None:
            setup(r, mod)
        orders.append([b.target for b, _ in r._rank(
            spec, exclude=set(exclude), tenant=tenant)])
    assert orders[0] == orders[1], orders
    return orders[0]


def _health(qd=0, running=0, hit_ratio=None, sketch_of=None, **kw):
    def doc(pkg):
        d = {"ok": True, "status": "ok", "accepting": True,
             "queue_depth": qd, "running": running, **kw}
        cache_block = {}
        if hit_ratio is not None:
            cache_block["hit_ratio"] = hit_ratio
        if sketch_of is not None:
            cache_block["sketch"] = _sketch_doc(pkg, sketch_of(pkg))
        if cache_block:
            d["cache"] = cache_block
        return d
    return doc


def test_rank_equals_jax(tmp_path, monkeypatch):
    for name in ("RACON_TPU_TORCH_ROUTE_AFFINITY", "RACON_TPU_ROUTE_AFFINITY",
                 "RACON_TPU_TORCH_ROUTE_BREAKER_FAILS",
                 "RACON_TPU_ROUTE_BREAKER_FAILS"):
        monkeypatch.delenv(name, raising=False)
    nope = {"sequences": "/nope", "overlaps": "/nope", "targets": "/nope"}
    statable = _statable_spec(tmp_path, pad=4 << 20)
    # unstatable inputs: raw load, then list order
    assert _rank_both(tmp_path, [_health(2, 1), _health(), _health()],
                      nope) == ["b", "c", "a"]
    assert _rank_both(tmp_path, [_health(2, 1), _health(), _health()],
                      nope, exclude={"b"}) == ["c", "a"]
    # never probed: optimistic load 0
    assert _rank_both(tmp_path, [None, _health(1), None], nope) == \
        ["a", "c", "b"]

    def down(r, mod):
        r.backends[2].mark_draining()
        for _ in range(mod.breaker_fails()):
            r.backends[1].note_failure("down", 1.0)

    assert _rank_both(tmp_path, [_health(3), _health(), _health()], nope,
                      setup=down) == ["a"]
    # priced: the shared wall grows with load
    assert _rank_both(tmp_path, [_health(1), _health(0), _health(4)],
                      statable) == ["b", "a", "c"]
    # content affinity: c's sketch holds the job's sample
    sample = {pkg: _sample(pkg, statable) for pkg in ("port", "jax")}
    assert sample["port"] and len(sample["port"]) == len(sample["jax"])
    warm = _health(0, 1, sketch_of=lambda pkg: sample[pkg])
    assert _rank_both(tmp_path, [_health(), _health(), warm],
                      statable) == ["c", "a", "b"]
    # half warm loses to fully warm, beats cold
    half = _health(0, 0, sketch_of=lambda pkg: sample[pkg][::2])
    assert _rank_both(tmp_path, [half, _health(), warm], statable) == \
        ["c", "a", "b"]
    # a foreign epoch scores cold: the JAX package's sketch to the port
    # and the port's to the JAX package
    swapped = {"port": "jax", "jax": "port"}

    def foreign(pkg):
        d = _health(0, 1)(pkg)
        d["cache"] = {"sketch": _sketch_doc(swapped[pkg],
                                            sample[swapped[pkg]])}
        return d

    assert _rank_both(tmp_path, [_health(), _health(), foreign],
                      statable) == ["a", "b", "c"]
    # affinity off: no sketch pricing; near ties fall to the scalar
    # hit-ratio tiebreak, then to the tenant's recent backends
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_AFFINITY", "0")
    monkeypatch.setenv("RACON_TPU_ROUTE_AFFINITY", "0")
    assert _rank_both(tmp_path, [_health(), _health(), warm],
                      statable) == ["a", "b", "c"]
    assert _rank_both(tmp_path, [_health(hit_ratio=0.1),
                                 _health(hit_ratio=0.9), _health()],
                      statable) == ["b", "a", "c"]

    def recent(r, mod):
        r._note_tenant_backend("acme", "content-key-1", "c")
        r._note_tenant_backend("acme", "route-1-2", "b")

    assert _rank_both(tmp_path, [_health(), _health(), _health()],
                      statable, tenant="acme", setup=recent) == \
        ["c", "a", "b"]
    assert _rank_both(tmp_path, [_health(), _health(), _health()],
                      statable, tenant="other", setup=recent) == \
        ["a", "b", "c"]
    # unpriceable inputs never reorder
    assert _rank_both(tmp_path, [_health(hit_ratio=0.1),
                                 _health(hit_ratio=0.9), _health()],
                      nope) == ["a", "b", "c"]


def test_backend_hit_fraction_equals_jax(tmp_path):
    from racon_tpu.cache import keying as jax_keying
    from racon_tpu.serve import affinity as jax_affinity
    from racon_tpu_torch.cache import keying
    from racon_tpu_torch.serve import affinity

    spec = _statable_spec(tmp_path)
    for shard in (None, [0, 2], [1, 2]):
        s = dict(spec, shard=shard) if shard else spec
        ports, jaxs = _sample("port", s), _sample("jax", s)
        ep, ej = keying.engine_epoch().hex(), jax_keying.engine_epoch().hex()
        assert ep != ej
        for cut in range(len(ports) + 1):
            fp = affinity.backend_hit_fraction(
                _sketch_doc("port", ports[:cut]), ports, ep)
            fj = jax_affinity.backend_hit_fraction(
                _sketch_doc("jax", jaxs[:cut]), jaxs, ej)
            assert fp == fj
        # a foreign epoch, a foreign sketch, nothing: no usable sketch
        assert affinity.backend_hit_fraction(
            _sketch_doc("port", ports), ports, ej) is None
        assert affinity.backend_hit_fraction(
            dict(_sketch_doc("jax", jaxs), epoch=ep), ports, ep) is None
        assert affinity.backend_hit_fraction(None, ports, ep) is None
        assert affinity.backend_hit_fraction(
            _sketch_doc("port", ports), [], ep) is None
    # the shard tag moves the sample, as in the JAX package
    assert _sample("port", dict(spec, shard=[0, 2])) != \
        _sample("port", spec)


def test_is_tcp_address_equals_jax(tmp_path):
    from racon_tpu.serve import client as jax_client

    sock = tmp_path / "x:12"
    sock.write_text("")
    for addr in ("127.0.0.1:9100", "host:0", "localhost:abc", ":12",
                 "/tmp/a.sock", "a.sock", "", str(sock), "h:1:2"):
        assert client.is_tcp_address(addr) == \
            jax_client.is_tcp_address(addr), addr


def test_faultinject_route_sites(monkeypatch):
    from racon_tpu_torch.obs import faultinject

    for site in ("route-pre-forward", "route-pre-reply", "route-mid-gather",
                 "route-mid-rebalance"):
        assert site in faultinject.SITES
        monkeypatch.setenv("RACON_TPU_TORCH_FAULT", site + ":2")
        assert faultinject.spec() == (site, 2)
    monkeypatch.delenv("RACON_TPU_TORCH_FAULT")
    faultinject.reset()


def _router_doc(**over):
    doc = {
        "ok": True, "router": True, "pid": 42, "socket": "/r.sock",
        "tcp": "127.0.0.1:9100", "uptime_s": 12.5, "draining": False,
        "in_flight": 1, "routed_keys": 3, "probe_interval_s": 1.0,
        "backends": [
            {"target": "/a.sock", "breaker": "OPEN", "failures": 4,
             "opened_count": 1, "draining": False, "probe_age_s": 0.4,
             "stale": False, "queue_depth": None, "running": None,
             "last_error": "connection refused"},
            {"target": "/b.sock", "breaker": "CLOSED", "failures": 0,
             "opened_count": 0, "draining": True, "probe_age_s": None,
             "stale": True, "queue_depth": 2, "running": 1,
             "last_error": None}],
        "counters": {"route_submit": 7, "route_spillover": 2,
                     "route_failover": 1, "route_dedup_joins": 1,
                     "route_scatter_jobs": 2, "route_scatter_shards": 6,
                     "route_cache_affinity": 3},
        "scatter": {"active": [{"job_key": "mega", "shards": 3, "done": 1,
                                "backends": ["/a", None, None]}],
                    "min_wall_s": None, "max_shards": 8}}
    doc.update(over)
    return doc


def test_print_router_status_equals_jax(capsys):
    from racon_tpu.serve import client as jax_client

    assert client._print_router_status(_router_doc()) == 0
    out = capsys.readouterr().out
    assert jax_client._print_router_status(_router_doc()) == 0
    assert out == capsys.readouterr().out
    assert "router      pid 42 on /r.sock + tcp 127.0.0.1:9100" in out
    assert "2 job(s) -> 6 shard(s)" in out and "mega: 1/3" in out
    assert "never!" in out and "draining" in out and "down" in out


# ---------------------------------------------------------------------------
# an in-process router over framed stub backends
# ---------------------------------------------------------------------------

def _stub_backend(path, behavior):
    """A framed-protocol daemon answering ``behavior(req)``, one request
    per connection; returns (stop event, listener)."""
    s = socket.socket(socket.AF_UNIX)
    s.bind(path)
    s.listen(16)
    s.settimeout(0.2)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                conn, _ = s.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                req = protocol.recv_frame(conn)
                if req is not None:
                    protocol.send_frame(conn, behavior(req))
            except Exception:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    threading.Thread(target=loop, daemon=True).start()
    return stop, s


def _ok_behavior(name):
    def behavior(req):
        if req["op"] == "health":
            return {"ok": True, "status": "ok", "accepting": True,
                    "queue_depth": 0, "running": 0, "pid": 1}
        if req["op"] == "submit":
            return {"ok": True, "job_id": 7, "fasta_b64": "Zg==",
                    "wall_s": 0.0, "n_sequences": 1, "who": name}
        return {"ok": True}
    return behavior


def _full_behavior(req):
    # idle on probes (the tie puts it first) but every submit is refused
    if req["op"] == "health":
        return {"ok": True, "status": "ok", "accepting": True,
                "queue_depth": 0, "running": 0, "pid": 2}
    if req["op"] == "submit":
        return {"ok": False, "error": {"code": "queue_full",
                                       "reason": "full",
                                       "retry_after_s": 0.05}}
    return {"ok": True}


def _shard_behavior(name, seen, fail_shard=None):
    """Submit answers name their shard (FASTA ``>s<i>``), so the merged
    frame pins the gather's order."""
    def behavior(req):
        if req["op"] == "health":
            return {"ok": True, "status": "ok", "accepting": True,
                    "queue_depth": 0, "running": 0, "pid": 1}
        if req["op"] == "submit":
            shard = (req["job"].get("shard") or [0, 1])[0]
            seen.append((name, shard, req.get("job_key")))
            if fail_shard is not None and shard == fail_shard:
                return {"ok": False,
                        "error": {"code": "job_failed",
                                  "reason": "induced shard failure"}}
            fa = f">s{shard}\n{'ACGT'[shard % 4] * 4}\n".encode()
            return {"ok": True, "job_id": 100 + shard,
                    "fasta_b64": base64.b64encode(fa).decode(),
                    "wall_s": 0.01, "n_sequences": 1,
                    "report": {"who": name}}
        return {"ok": True}
    return behavior


def _serve_inproc(mod, rsock, paths, tcp=None):
    r = mod.FleetRouter(rsock, paths, tcp=tcp)
    threading.Thread(target=r.serve_forever, daemon=True).start()
    deadline = time.monotonic() + 20
    while not os.path.exists(rsock) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert os.path.exists(rsock), "router socket never bound"
    return r


@pytest.fixture
def stub_dir():
    with tempfile.TemporaryDirectory(prefix="rtfl_", dir="/tmp") as d:
        yield d


def test_router_in_process_spillover_breakers_tcp(monkeypatch, stub_dir):
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_PROBE_S", "0.1")
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_BREAKER_FAILS", "2")
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_BREAKER_COOLDOWN_S", "0.5")
    a = os.path.join(stub_dir, "a.sock")
    b = os.path.join(stub_dir, "b.sock")
    rsock = os.path.join(stub_dir, "r.sock")
    stop_a, sock_a = _stub_backend(a, _full_behavior)
    stop_b, sock_b = _stub_backend(b, _ok_behavior("B"))
    r = _serve_inproc(router, rsock, [a, b], tcp="127.0.0.1:0")
    spec = {"sequences": "/nope", "overlaps": "/nope", "targets": "/nope"}
    try:
        resp = client.submit(rsock, spec, job_key="k1")
        assert resp["ok"] and resp["routed_backend"] == b, resp
        assert client.submit(rsock, spec,
                             job_key="k1")["routed_backend"] == b
        doc = client.route_status(rsock)
        assert doc["router"] and doc["ok"]
        assert {row["target"]: row["breaker"]
                for row in doc["backends"]} == {a: "CLOSED", b: "CLOSED"}
        assert doc["counters"]["route_submit"] >= 2
        assert doc["counters"]["route_spillover"] >= 1
        assert doc["tcp"] and client.is_tcp_address(doc["tcp"])
        tdoc = client.route_status(doc["tcp"])
        assert tdoc["router"] and tdoc["pid"] == doc["pid"]
        tresp = client.submit(doc["tcp"], spec, job_key="k2")
        assert tresp["ok"] and tresp["routed_backend"] == b
        h = client.health(rsock)
        assert h["router"] and h["backends"] == 2 and h["scatter"] is True
        m = client.metrics(rsock)
        assert m["router"] and m["route"]["tcp"] == doc["tcp"]
        assert "racon_tpu_torch_route_submit" in m["prometheus"]

        stop_b.set()
        sock_b.close()
        os.unlink(b)
        resp3 = client.submit(rsock, spec, job_key="k3")
        assert not resp3["ok"]
        assert resp3["error"]["code"] in ("queue_full", "no_backend")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            doc = client.route_status(rsock)
            row = [x for x in doc["backends"] if x["target"] == b][0]
            if row["breaker"] == "OPEN":
                break
            time.sleep(0.1)
        assert row["breaker"] == "OPEN", doc
        assert doc["counters"].get(f"route_breaker_open.{b}", 0) >= 1
        stop_b2, sock_b2 = _stub_backend(b, _ok_behavior("B2"))
        try:
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                doc = client.route_status(rsock)
                row = [x for x in doc["backends"] if x["target"] == b][0]
                if row["breaker"] == "CLOSED":
                    break
                time.sleep(0.1)
            assert row["breaker"] == "CLOSED", doc
            stop_a.set()
            sock_a.close()
            os.unlink(a)
            stop_b2.set()
            sock_b2.close()
            os.unlink(b)
            resp4 = client.submit(rsock, spec, job_key="k4")
            assert not resp4["ok"]
            assert resp4["error"]["code"] == "no_backend", resp4
            kinds = {e["kind"] for e in client.flight(rsock)["events"]}
            assert {"route", "route_spillover", "route_failover",
                    "route_breaker"} <= kinds, kinds
        finally:
            stop_b2.set()
        assert client.admin(rsock, "shutdown")["ok"]
        deadline = time.monotonic() + 10
        while os.path.exists(rsock) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not os.path.exists(rsock)
    finally:
        stop_a.set()
        stop_b.set()
        r.request_stop()


def _inproc_shard_router(stub_dir, n, fail_shard=None):
    seen, stops, paths = [], [], []
    for i in range(n):
        path = os.path.join(stub_dir, f"b{i}.sock")
        stops.append(_stub_backend(path, _shard_behavior(
            f"B{i}", seen, fail_shard=fail_shard)))
        paths.append(path)
    rsock = os.path.join(stub_dir, "r.sock")
    return _serve_inproc(router, rsock, paths), rsock, paths, stops, seen


def test_router_in_process_scatter(monkeypatch, stub_dir):
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_PROBE_S", "0.1")
    r, rsock, paths, stops, seen = _inproc_shard_router(stub_dir, 3)
    spec = {"sequences": "/nope", "overlaps": "/nope", "targets": "/nope",
            "tenant": "acme"}
    try:
        resp = client.submit(rsock, spec, job_key="megak", shards=3)
        assert resp["ok"], resp
        assert base64.b64decode(resp["fasta_b64"]) == \
            b">s0\nAAAA\n>s1\nCCCC\n>s2\nGGGG\n"
        assert resp["n_sequences"] == 3 and resp["wall_s"] is not None
        assert resp["scatter"]["shards"] == 3
        # shard i prefers the i-th eligible backend
        assert resp["scatter"]["backends"] == paths
        rep = resp["report"]
        assert [p["job_key"] for p in rep["per_shard"]] == \
            ["megak-shard-0of3", "megak-shard-1of3", "megak-shard-2of3"]
        assert "routed_backend" not in resp
        assert {(s, k) for _, s, k in seen} == {
            (0, "megak-shard-0of3"), (1, "megak-shard-1of3"),
            (2, "megak-shard-2of3")}
        assert client.submit(rsock, spec, job_key="megak2",
                             shards="auto")["scatter"]["shards"] == 3
        resp3 = client.submit(rsock, spec, job_key="plain", shards=0)
        assert resp3["ok"] and "scatter" not in resp3
        bad = client.submit(rsock, spec, job_key="badk", shards="seven")
        assert not bad["ok"] and bad["error"]["code"] == "bad_request"
        doc = client.route_status(rsock)
        assert doc["counters"].get("route_scatter_jobs", 0) >= 2
        assert doc["counters"].get("route_scatter_shards", 0) >= 6
        assert doc["scatter"]["active"] == []
        kinds = {e["kind"] for e in client.flight(rsock)["events"]}
        assert {"route_scatter", "route_scatter_shard",
                "route_gather"} <= kinds, kinds
    finally:
        for stop, sock in stops:
            stop.set()
            sock.close()
        r.request_stop()


def test_router_scatter_auto_threshold(monkeypatch, stub_dir, tmp_path):
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_PROBE_S", "0.1")
    monkeypatch.setenv("RACON_TPU_TORCH_SCATTER_MIN_WALL_S", "5.0")
    r, rsock, paths, stops, seen = _inproc_shard_router(stub_dir, 2)
    r._price = lambda spec, concurrency: {"predicted_wall_s": 8.0}
    try:
        resp = client.submit(rsock, _statable_spec(tmp_path))
        assert resp["ok"] and resp["scatter"]["shards"] == 2
        keys = {k for _, _, k in seen}
        assert len(keys) == 2
        assert all(k.startswith("route-") and "-shard-" in k for k in keys)
    finally:
        for stop, sock in stops:
            stop.set()
            sock.close()
        r.request_stop()


def test_router_scatter_failed_shard_surfaces_shard(monkeypatch, stub_dir):
    """A shard that fails is the job's error, with its coordinates; it
    is never run anywhere else."""
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_PROBE_S", "0.1")
    r, rsock, paths, stops, seen = _inproc_shard_router(stub_dir, 3,
                                                        fail_shard=1)
    spec = {"sequences": "/nope", "overlaps": "/nope", "targets": "/nope"}
    try:
        resp = client.submit(rsock, spec, job_key="megaf", shards=3)
        assert not resp["ok"]
        assert resp["error"]["code"] == "job_failed"
        assert resp["error"]["reason"] == "induced shard failure"
        assert (resp["error"]["shard"], resp["error"]["shards"]) == (1, 3)
        assert [s for _, s, _ in seen].count(1) == 1
        assert client.route_status(rsock)["counters"].get(
            "route_scatter_failed", 0) >= 1
    finally:
        for stop, sock in stops:
            stop.set()
            sock.close()
        r.request_stop()


def test_router_rebalance_straggler_inproc(monkeypatch, stub_dir):
    """The backend of shard 0 stalls; the watchdog starts a replacement
    under ``-r1`` on another backend, which wins the slot."""
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_PROBE_S", "0.05")
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_PROBE_TIMEOUT_S", "0.2")
    monkeypatch.setenv("RACON_TPU_TORCH_SCATTER_REBALANCE", "0.01")
    seen, stops, paths = [], [], []
    stall = threading.Event()
    for i in range(3):
        path = os.path.join(stub_dir, f"b{i}.sock")
        base = _shard_behavior(f"B{i}", seen)
        if i == 0:
            def behavior(req, _base=base):
                if req.get("op") == "submit":
                    stall.wait(30)
                return _base(req)
        else:
            behavior = base
        stops.append(_stub_backend(path, behavior))
        paths.append(path)
    rsock = os.path.join(stub_dir, "r.sock")
    r = _serve_inproc(router, rsock, paths)
    spec = {"sequences": "/nope", "overlaps": "/nope", "targets": "/nope"}
    try:
        t0 = time.monotonic()
        resp = client.submit(rsock, spec, job_key="megarb", shards=2)
        assert resp["ok"], resp
        assert time.monotonic() - t0 < 20
        assert base64.b64decode(resp["fasta_b64"]) == \
            b">s0\nAAAA\n>s1\nCCCC\n"
        assert resp["scatter"]["rebalanced"] == ["0of2-r1 <- 0of2", None]
        assert [p["job_key"] for p in resp["report"]["per_shard"]] == \
            ["megarb-shard-0of2-r1", "megarb-shard-1of2"]
        assert resp["scatter"]["backends"][0] in paths[1:]
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            doc = client.route_status(rsock)
            if doc["counters"].get("route_cancels", 0) >= 1:
                break
            time.sleep(0.05)
        assert doc["counters"].get("route_rebalance", 0) >= 1
        assert doc["counters"].get("route_cancels", 0) >= 1
        kinds = {e["kind"] for e in client.flight(rsock)["events"]}
        assert "route_rebalance" in kinds
    finally:
        stall.set()
        for stop, sock in stops:
            stop.set()
            sock.close()
        r.request_stop()


#: blocks whose keys are the process registry's content, not the shape
CONTENT = ("counters", "snapshot", "events", "gauges", "histograms",
           "job_trace")


def _keys(doc):
    """The nested key structure of a document (list members by their
    first element), content blocks as leaves."""
    if isinstance(doc, dict):
        return {k: None if k in CONTENT else _keys(v)
                for k, v in doc.items()}
    if isinstance(doc, list) and doc and isinstance(doc[0], dict):
        return [_keys(doc[0])]
    return None


def test_router_documents_carry_the_jax_routers_keys(monkeypatch, stub_dir):
    """The port's and the JAX router over the same stubs answer
    ``route_status``, ``health``, ``metrics``, ``flight`` and
    ``trace_query`` with the same keys, and each one's client reads
    the other's frames."""
    from racon_tpu.serve import client as jax_client
    from racon_tpu.serve import router as jax_router

    for prefix in ("RACON_TPU_TORCH_", "RACON_TPU_"):
        monkeypatch.setenv(prefix + "ROUTE_PROBE_S", "0.1")
    paths = [os.path.join(stub_dir, f"b{i}.sock") for i in range(2)]
    stops = [_stub_backend(p, _ok_behavior(f"B{i}"))
             for i, p in enumerate(paths)]
    routers = {}
    try:
        for name, mod in (("port", router), ("jax", jax_router)):
            rsock = os.path.join(stub_dir, f"{name}.sock")
            routers[name] = (_serve_inproc(mod, rsock, paths), rsock)
        docs = {}
        for name, (_, rsock) in routers.items():
            spec = {"sequences": "/nope", "overlaps": "/nope",
                    "targets": "/nope"}
            # each client against the other package's router
            other = jax_client if name == "port" else client
            resp = other.submit(rsock, spec, job_key="kk")
            assert resp["ok"] and resp["routed_backend"] == paths[0]
            docs[name] = {
                "route_status": other.route_status(rsock),
                "health": other.health(rsock),
                "metrics": other.metrics(rsock),
                "flight": other.flight(rsock, job=1),
                "trace_query": other.trace_query(rsock, 1, max_events=8),
                "journal_query": other.request(
                    rsock, {"op": "journal_query"}),
            }
        for op in docs["port"]:
            assert _keys(docs["port"][op]) == _keys(docs["jax"][op]), op
        assert docs["port"]["route_status"]["counters"]["route_submit"] \
            >= 1
    finally:
        for stop, sock in stops:
            stop.set()
            sock.close()
        for r, _ in routers.values():
            r.request_stop()


# ---------------------------------------------------------------------------
# two CPU daemons behind a route subprocess
# ---------------------------------------------------------------------------

def _env(tmp, extra=None) -> dict:
    env = dict(os.environ)
    env.update(PINS)
    for k in UNSET:
        env.pop(k, None)
    env["TMPDIR"] = tmp
    # two daemons at once: each one's torch intra-op pool capped, so the
    # plain versions do not oversubscribe the host's cores
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra or {})
    return env


def _wait_up(proc, sock, log, what):
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{what} died at startup: "
                                 + open(log).read())
        try:
            if client.health(sock, timeout=2).get("ok"):
                return
        except client.ServeError:
            pass
        time.sleep(0.1)
    proc.kill()
    raise AssertionError(f"{what} never answered")


def _spawn(tmp, name, argv, env):
    log = os.path.join(tmp, name + ".log")
    with open(log, "ab") as fh:
        return subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch.cli", *argv],
            cwd=REPO_ROOT, stdout=fh, stderr=fh, env=env), log


def start_daemon(tmp, name, args=(), extra=None, wait=True):
    sock = os.path.join(tmp, name + ".sock")
    proc, log = _spawn(tmp, name, ["serve", "--socket", sock, "--device",
                                   "cpu", "--jobs", "1", *args],
                       _env(tmp, extra))
    if wait:
        _wait_up(proc, sock, log, name)
    return proc, sock


def start_router(tmp, name, backends, extra=None):
    sock = os.path.join(tmp, name + ".sock")
    proc, log = _spawn(tmp, name, ["route", "--socket", sock, "--backends",
                                   ",".join(backends)],
                       _env(tmp, {**ROUTE_ENV, **(extra or {})}))
    _wait_up(proc, sock, log, name)
    return proc, sock


def stop(proc, sock) -> None:
    if proc.poll() is None:
        try:
            client.admin(sock, "shutdown", timeout=10)
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


@pytest.fixture(scope="module")
def fleet_tmp():
    with tempfile.TemporaryDirectory(prefix="rtfl_", dir="/tmp") as d:
        yield d


@pytest.fixture(scope="module")
def dataset(fleet_tmp):
    from test_torch_scatter import four_contigs

    return four_contigs(os.path.join(fleet_tmp, "data"))


def _one_shot(data, *argv, extra=None) -> bytes:
    mp = pytest.MonkeyPatch()
    try:
        for k, v in {**PINS, **(extra or {})}.items():
            mp.setenv(k, v)
        for k in UNSET:
            mp.delenv(k, raising=False)
        buf = io.BytesIO()
        cache.reset()
        cli.main(["--device", "cpu", *argv, *data], out=buf)
        return buf.getvalue()
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def golden(dataset):
    return {"kernels": _one_shot(dataset, *KERNEL_ARGS),
            "cpu": _one_shot(dataset, "-t", "2")}


def _spec(data, kernels=True, **kw):
    reads, paf, draft = data
    spec = {"sequences": reads, "overlaps": paf, "targets": draft,
            "threads": 2}
    if kernels:
        spec.update(cuda_poa_batches=1, cuda_aligner_batches=1)
    spec.update(kw)
    return spec


@pytest.fixture(scope="module")
def fleet(fleet_tmp):
    """Two CPU daemons and a router in front of them."""
    a = start_daemon(fleet_tmp, "a")
    b = start_daemon(fleet_tmp, "b")
    r = start_router(fleet_tmp, "r", [a[1], b[1]])
    yield {"a": a[1], "b": b[1], "r": r[1]}
    for proc, sock in (r, a, b):
        stop(proc, sock)


def test_routed_and_scattered_jobs_equal_one_shot(fleet, dataset, golden):
    resp = client.submit(fleet["r"], _spec(dataset), job_key="whole-1")
    assert fasta_of(resp) == golden["kernels"]
    assert resp["routed_backend"] in (fleet["a"], fleet["b"])
    # the plain versions here, the kernels on a card (chip_smoke.py)
    assert resp["report"]["details"]["device"] == "cpu"
    resp = client.submit(fleet["r"], _spec(dataset), job_key="scat-1",
                         shards=2)
    assert fasta_of(resp) == golden["kernels"]
    assert resp["scatter"]["backends"] == [fleet["a"], fleet["b"]]
    staged = resp["scatter"]["staged_bytes"]
    assert all(s and s > 0 for s in staged)
    for i, rep in enumerate(resp["report"]["shard_reports"]):
        g = rep["run"]["gauges"]
        assert rep["details"]["shard"] == [i, 2]
        assert g["host.staged_bytes"] == staged[i]
        assert g["host.parse_skipped_bytes"] > 0
    # a keyed duplicate is answered by the backends' journals
    again = client.submit(fleet["r"], _spec(dataset), job_key="scat-1",
                          shards=2)
    assert fasta_of(again) == golden["kernels"]
    doc = client.route_status(fleet["r"])
    assert doc["counters"]["route_scatter_jobs"] >= 2
    assert doc["counters"]["route_stage_plans"] >= 2


def test_jax_client_reads_the_routers_frames(fleet, dataset, golden):
    from racon_tpu.serve import client as jax_client

    resp = jax_client.submit(fleet["r"], _spec(dataset, kernels=False),
                             job_key="jax-client-1")
    assert fasta_of(resp) == golden["cpu"]
    doc = jax_client.route_status(fleet["r"])
    assert doc["router"] and len(doc["backends"]) == 2
    assert {b["target"] for b in doc["backends"]} == {fleet["a"],
                                                      fleet["b"]}


def test_status_renders_the_router(fleet, capsys):
    assert client.main_status(["--socket", fleet["r"]]) == 0
    out = capsys.readouterr().out
    assert out.startswith("router      pid ")
    assert fleet["a"] in out and fleet["b"] in out and "CLOSED" in out


def test_metrics_fleet_merges_the_daemons_exactly(fleet, dataset):
    from racon_tpu_torch.obs import aggregate
    from racon_tpu_torch.obs.metrics import hist_quantile

    env = _env(tempfile.gettempdir())
    out = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "metrics", "--fleet",
         f"{fleet['a']},{fleet['b']}", "--json"], cwd=REPO_ROOT, env=env,
        capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    snaps = {}
    for sock in (fleet["a"], fleet["b"]):
        m = client.metrics(sock)
        snaps[m["identity"]["daemon_id"]] = m["snapshot"]
    assert doc["alive"] == 2 and doc["fleet_size"] == 2
    ident = {d["identity"]["daemon_id"] for d in doc["daemons"]}
    assert ident == set(snaps)
    merged = aggregate.merge_snapshots(snaps)
    keys = [f"cuda_kernel_launches.{name}"
            for name in ("poa_full", "align_wfa", "align_band")]
    for key in keys + ["serve_jobs_completed"]:
        assert doc["merged"]["counters"].get(key, 0) == sum(
            s["counters"].get(key, 0) for s in snaps.values())
    assert doc["merged"]["counters"]["serve_jobs_completed"] > 0
    for name, h in doc["merged"]["histograms"].items():
        for q in (0.5, 0.9, 0.99):
            assert hist_quantile(h, q) == hist_quantile(
                merged["histograms"][name], q), name
    # one router socket: its backends are the fleet
    out = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "metrics", "--fleet",
         fleet["r"], "--prometheus"], cwd=REPO_ROOT, env=env,
        capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    text = out.stdout.decode()
    for daemon_id in snaps:
        assert f'instance="{daemon_id}"' in text


def test_spillover_on_queue_full(fleet_tmp, fleet, dataset, golden):
    """A backend that refuses every job with ``queue_full`` ranks first
    (list order) and the job lands on the other, unseen by the client."""
    full = start_daemon(fleet_tmp, "full", args=("--queue", "0"))
    r = start_router(fleet_tmp, "r_full", [full[1], fleet["b"]])
    try:
        resp = client.submit(r[1], _spec(dataset, kernels=False),
                             job_key="spill-1")
        assert fasta_of(resp) == golden["cpu"]
        assert resp["routed_backend"] == fleet["b"]
        assert client.route_status(r[1])["counters"][
            "route_spillover"] >= 1
    finally:
        stop(*r)
        stop(*full)


def test_breaker_opens_on_a_dead_socket_and_closes(fleet_tmp, fleet,
                                                   dataset, golden):
    dead = os.path.join(fleet_tmp, "late.sock")
    r = start_router(fleet_tmp, "r_late", [dead, fleet["b"]])
    late = None
    try:
        def breaker():
            doc = client.route_status(r[1])
            return [x for x in doc["backends"]
                    if x["target"] == dead][0]["breaker"], doc

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and breaker()[0] != "OPEN":
            time.sleep(0.1)
        state, doc = breaker()
        assert state == "OPEN"
        assert doc["counters"][f"route_breaker_open.{dead}"] >= 1
        resp = client.submit(r[1], _spec(dataset, kernels=False),
                             job_key="breaker-1")
        assert fasta_of(resp) == golden["cpu"]
        assert resp["routed_backend"] == fleet["b"]
        late = start_daemon(fleet_tmp, "late")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and breaker()[0] != "CLOSED":
            time.sleep(0.1)
        assert breaker()[0] == "CLOSED"
        kinds = [(e.get("state"), e.get("backend")) for e in
                 client.flight(r[1])["events"]
                 if e["kind"] == "route_breaker"]
        assert ("open", dead) in kinds and ("closed", dead) in kinds
    finally:
        stop(*r)
        if late is not None:
            stop(*late)


def test_draining_backend_fails_over(fleet_tmp, fleet, dataset, golden):
    """A SIGTERM'd backend finishes its job and answers ``draining``; the
    router sends the next job to the other backend."""
    drain = start_daemon(fleet_tmp, "drain")
    r = start_router(fleet_tmp, "r_drain", [drain[1], fleet["b"]])
    try:
        first = {}
        t = threading.Thread(target=lambda: first.update(client.submit(
            r[1], _spec(dataset), job_key="drain-1")))
        t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline \
                and not client.health(drain[1]).get("running"):
            time.sleep(0.05)
        drain[0].send_signal(signal.SIGTERM)
        t.join(300)
        assert fasta_of(first) == golden["kernels"]
        assert first["routed_backend"] == drain[1]
        resp = client.submit(r[1], _spec(dataset, kernels=False),
                             job_key="drain-2")
        assert fasta_of(resp) == golden["cpu"]
        assert resp["routed_backend"] == fleet["b"]
    finally:
        stop(*r)
        stop(*drain)


def test_backend_sigkilled_mid_shard_is_invisible(fleet_tmp, fleet, dataset,
                                                  golden):
    """The backend holding shard 0 dies after its first megabatch; the
    router reruns that shard on the survivor under the same key and the
    gather's bytes are the one-shot's."""
    pins = {"RACON_TPU_TORCH_PIPELINE": "0",
            "RACON_TPU_TORCH_POA_MEGABATCH": "2"}
    doomed = start_daemon(fleet_tmp, "doomed", extra={
        **pins, "RACON_TPU_TORCH_FAULT": "mid-megabatch:1"})
    live = start_daemon(fleet_tmp, "live", extra=pins)
    r = start_router(fleet_tmp, "r_kill", [doomed[1], live[1]])
    try:
        resp = client.submit(r[1], _spec(dataset), job_key="kill-1",
                             shards=2)
        assert doomed[0].wait(60) == -signal.SIGKILL
        assert fasta_of(resp) == golden["kernels"]
        assert resp["scatter"]["backends"] == [live[1], live[1]]
        doc = client.route_status(r[1])
        assert doc["counters"]["route_failover"] >= 1
        failover = [e for e in client.flight(r[1])["events"]
                    if e["kind"] == "route_failover"]
        assert failover[0]["job_key"] == "kill-1-shard-0of2"
        assert failover[0]["backend"] == doomed[1]
        # the survivor's journal holds the dead backend's shard, done
        recs = client.journal_query(live[1], job_key="kill-1-shard-0of2")
        assert any(rec.get("kind") == "done" for rec in recs["records"]), \
            recs
    finally:
        stop(*r)
        stop(*live)
        if doomed[0].poll() is None:
            doomed[0].kill()
            doomed[0].wait()


# ---------------------------------------------------------------------------
# slow: the router's own death at its fault sites
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("site,shards", [("route-pre-forward", 0),
                                         ("route-pre-reply", 0),
                                         ("route-mid-gather", 2)])
def test_router_sigkill_exactly_once(fleet_tmp, fleet, dataset, golden,
                                     site, shards):
    """A router killed at a fault site loses nothing: the keyed resubmit
    through a restarted router is answered once, by the backends'
    journals where a backend already ran the work."""
    name = "r_" + site.replace("-", "_")
    sock = os.path.join(fleet_tmp, name + ".sock")
    proc, log = _spawn(fleet_tmp, name, [
        "route", "--socket", sock, "--backends",
        f"{fleet['a']},{fleet['b']}"], _env(fleet_tmp, {
            **ROUTE_ENV, "RACON_TPU_TORCH_FAULT": site}))
    _wait_up(proc, sock, log, name)
    key = f"chaos-{site}"
    with pytest.raises(client.ServeError):
        client.submit(sock, _spec(dataset), job_key=key,
                      shards=shards or None)
    assert proc.wait(60) == -signal.SIGKILL
    r = start_router(fleet_tmp, name, [fleet["a"], fleet["b"]])
    try:
        resp = client.submit_with_retry(r[1], _spec(dataset), job_key=key,
                                        shards=shards or None, retries=3)
        assert fasta_of(resp) == golden["kernels"]
    finally:
        stop(*r)
    keys = [key] if not shards else [f"{key}-shard-{i}of{shards}"
                                     for i in range(shards)]
    assert _done_records(key, fleet["a"], fleet["b"]) == \
        {k: 1 for k in keys}


def _done_records(prefix, *socks) -> dict:
    """How many ``done`` records each key under ``prefix`` has in the
    backends' journals: 1 each when every unit ran exactly once."""
    out = {}
    for sock in socks:
        for rec in client.journal_query(sock, job_key_prefix=prefix,
                                        max_records=1024)["records"]:
            if rec.get("kind") == "done":
                out[rec["job_key"]] = out.get(rec["job_key"], 0) + 1
    return out


@pytest.mark.slow
def test_router_sigkill_mid_rebalance(fleet_tmp, dataset, golden):
    """The router dies as it hands a straggler's shard to a replacement;
    the restarted router's resubmit gathers the one-shot bytes."""
    slow = start_daemon(fleet_tmp, "slowb", extra={
        "RACON_TPU_TORCH_PIPELINE": "0"})
    other = start_daemon(fleet_tmp, "otherb")
    name = "r_rebalance"
    sock = os.path.join(fleet_tmp, name + ".sock")
    proc, log = _spawn(fleet_tmp, name, [
        "route", "--socket", sock, "--backends", f"{slow[1]},{other[1]}"],
        _env(fleet_tmp, {**ROUTE_ENV,
                         "RACON_TPU_TORCH_SCATTER_REBALANCE": "0.0001",
                         "RACON_TPU_TORCH_FAULT": "route-mid-rebalance"}))
    _wait_up(proc, sock, log, name)
    try:
        with pytest.raises(client.ServeError):
            client.submit(sock, _spec(dataset), job_key="reb-1", shards=2)
        assert proc.wait(60) == -signal.SIGKILL
        r = start_router(fleet_tmp, name, [slow[1], other[1]])
        try:
            resp = client.submit_with_retry(r[1], _spec(dataset),
                                            job_key="reb-1", shards=2,
                                            retries=3)
            assert fasta_of(resp) == golden["kernels"]
        finally:
            stop(*r)
        done = _done_records("reb-1", slow[1], other[1])
        assert done["reb-1-shard-0of2"] == done["reb-1-shard-1of2"] == 1
    finally:
        stop(*slow)
        stop(*other)
