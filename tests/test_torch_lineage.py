"""The port's fleet lineage (``obs/assemble.py``, ``inspect --fleet``), on
the CPU.

* ``parse_key``, ``aligned_wall``, ``build_lineage``, the timeline rows,
  ``render_fleet_timeline`` and ``merged_trace_doc`` of the port equal
  the JAX package's on the same synthetic collections (complete, with a
  shard missing, with two winners for a shard, and with one daemon's
  clock skewed), once the schema strings are normalised, and the
  rendered order of events does not move with the skew;
* ``assemble`` against an in-process port router over framed stub
  backends, one of which drops its first submit, shows the scattered
  job with its failover, and the lineage is complete; ``inspect
  --fleet`` renders it and exits 0;
* ``inspect --fleet`` with no key, and ``assemble`` with none, refuse.
"""

import base64
import copy
import json
import os
import socket
import tempfile
import threading
import time

import pytest

from racon_tpu.obs import assemble as jax_assemble
from racon_tpu_torch.obs import assemble
from racon_tpu_torch.obs import flight as obs_flight
from racon_tpu_torch.serve import client, protocol, router
from racon_tpu_torch.serve import inspect as serve_inspect


def normalised(doc):
    """A document with the port's schema strings mapped onto the JAX
    package's, for comparison."""
    text = json.dumps(doc, sort_keys=True)
    for ours, theirs in ((assemble.SCHEMA, jax_assemble.SCHEMA),
                         (assemble.COLLECT_SCHEMA,
                          jax_assemble.COLLECT_SCHEMA)):
        text = text.replace(ours, theirs)
    return json.loads(text)


@pytest.mark.parametrize("key", [
    "k-shard-0of3", "k-shard-2of3-r1", "a-shard-0of2-r1-shard-1of4",
    "sc-" + "0" * 32 + "-shard-5of8-r2", "plain", "k-shard-xofy",
    "k-shard-1of2-rx", None, 7, "wrap-abc-round-2"])
def test_parse_key_equals_jax(key):
    assert assemble.parse_key(key) == jax_assemble.parse_key(key)


@pytest.mark.parametrize("daemon,t,wall", [
    ({"trace_epoch_wall": 1000.0, "clock_offset_s": 2.5}, 3.0, False),
    ({"trace_epoch_wall": 1000.0, "clock_offset_s": 2.5}, 1004.0, True),
    ({"clock_offset_s": 1.0}, 3.0, False),
    ({"trace_epoch_wall": 10.0}, 3.0, False),
    ({"trace_epoch_wall": 10.0, "clock_offset_s": None}, None, False)])
def test_aligned_wall_equals_jax(daemon, t, wall):
    assert assemble.aligned_wall(daemon, t, wall=wall) == \
        jax_assemble.aligned_wall(daemon, t, wall=wall)


def synthetic_collection(schema=None):
    """A 3-daemon collection: a router, one live backend (its clock +2 s,
    its ring rolled over) and one dead backend; a job scattered in two
    shards with a failover, a replacement attempt and a journal record,
    winners r1/shard 0 and shard 1, and another job's events on the same
    ring."""
    return {
        "schema": schema or assemble.COLLECT_SCHEMA, "address": "r.sock",
        "job_key": "mega", "trace_id": None,
        "daemons": [
            {"target": "r.sock", "ok": True, "router": True,
             "pid": 100, "identity": {"daemon_id": "router"},
             "clock_offset_s": 0.0, "offset_confidence_s": 0.001,
             "probe_rtt_s": 0.002, "wall_t": 1000.0,
             "trace_epoch_wall": 990.0,
             "capture": {"flight": {"dropped": 0},
                         "trace": {"evicted": 2},
                         "journal": {"enabled": False}},
             "flight_events": [
                 {"kind": "route_scatter", "t": 1.0, "job": 1,
                  "shards": 2, "trace_id": "mega",
                  "keys": ["mega-shard-0of2", "mega-shard-1of2"]},
                 {"kind": "route", "t": 1.1, "job": 1,
                  "job_key": "mega-shard-0of2", "backend": "b0.sock"},
                 {"kind": "route", "t": 1.2, "job": 1,
                  "job_key": "mega-shard-1of2", "backend": "b1.sock"},
                 {"kind": "route", "t": 1.25, "job": 2,
                  "job_key": "other-shard-0of2", "backend": "b1.sock"},
                 {"kind": "route_failover", "t": 2.0, "job": 1,
                  "job_key": "mega-shard-0of2", "backend": "b0.sock",
                  "error": "connection reset"},
                 {"kind": "route", "t": 2.1, "job": 1,
                  "job_key": "mega-shard-0of2", "backend": "b1.sock"},
                 {"kind": "route_rebalance", "t": 3.0, "job": 1,
                  "key": "mega-shard-0of2-r1", "backend": "b1.sock",
                  "shard": 0, "attempt": 1, "elapsed_s": 2.0,
                  "threshold_s": 1.0},
                 {"kind": "route", "t": 3.1, "job": 1,
                  "job_key": "mega-shard-0of2-r1",
                  "backend": "b1.sock"},
                 {"kind": "route_dedup", "t": 3.2, "job": 1,
                  "job_key": "mega-shard-1of2", "joined": "live"},
                 {"kind": "route_scatter_shard", "t": 4.0, "job": 1,
                  "key": "mega-shard-0of2-r1", "shard": 0,
                  "ok": True, "winner": True},
                 {"kind": "route_scatter_shard", "t": 4.1, "job": 1,
                  "key": "mega-shard-1of2", "shard": 1, "ok": True,
                  "winner": True},
                 {"kind": "route_gather", "t": 4.2, "job": 1,
                  "shards": 2, "wall_s": 3.2,
                  "winner_keys": ["mega-shard-0of2-r1",
                                  "mega-shard-1of2"]},
             ],
             "journal": None,
             "trace_slices": {"1": [
                 {"name": "route.submit", "ph": "X",
                  "ts": 1_000_000.0, "dur": 3_200_000.0,
                  "pid": 100, "tid": 1, "cat": "route"}]}},
            {"target": "b1.sock", "ok": True, "router": False,
             "pid": 101, "identity": {"daemon_id": "b1"},
             "clock_offset_s": 2.0, "offset_confidence_s": 0.002,
             "probe_rtt_s": 0.004, "wall_t": 1002.0,
             "trace_epoch_wall": 992.0,
             "capture": {"flight": {"dropped": 5},
                         "trace": {"evicted": 0},
                         "journal": {"enabled": True}},
             "flight_events": [
                 {"kind": "admit", "t": 3.2, "job": 7,
                  "job_key": "mega-shard-0of2-r1",
                  "trace_id": "mega"},
                 {"kind": "cache_hit", "t": 3.5, "job": 7,
                  "job_key": "mega-shard-0of2-r1", "hits": 4,
                  "unit_kind": "poa"},
                 {"kind": "dedup", "t": 3.6, "job": 8,
                  "job_key": "mega-shard-1of2", "recorded": True},
                 {"kind": "done", "t": 4.0, "job": 7,
                  "job_key": "mega-shard-0of2-r1", "ok": True},
             ],
             "journal": {"enabled": True, "complete": False,
                         "scan_truncated": True,
                         "records": [
                             {"kind": "done", "t": 996.0,
                              "job_key": "mega-shard-0of2-r1",
                              "result": {"ok": True,
                                         "n_sequences": 3}}]},
             "trace_slices": {"7": [
                 {"name": "serve.job", "ph": "X", "ts": 3_200_000.0,
                  "dur": 800_000.0, "pid": 101, "tid": 3,
                  "cat": "serve"}]}},
            {"target": "b0.sock", "ok": False, "router": False,
             "error": "ServeError: connection refused", "pid": None,
             "identity": None, "clock_offset_s": None,
             "offset_confidence_s": None, "probe_rtt_s": None,
             "wall_t": None, "trace_epoch_wall": None,
             "capture": None, "flight_events": [], "journal": None,
             "trace_slices": {}},
        ]}


def drop_shard_1(coll):
    for d in coll["daemons"]:
        d["flight_events"] = [
            ev for ev in d["flight_events"]
            if "1of2" not in str(ev.get("key") or "")
            and "1of2" not in str(ev.get("job_key") or "")]
        for ev in d["flight_events"]:
            if "keys" in ev:
                ev["keys"] = [k for k in ev["keys"] if "1of2" not in k]
            if "winner_keys" in ev:
                ev["winner_keys"] = [k for k in ev["winner_keys"]
                                     if "1of2" not in k]
    return coll


def two_winners(coll):
    for ev in coll["daemons"][0]["flight_events"]:
        if ev["kind"] == "route_gather":
            ev["winner_keys"].append("mega-shard-0of2")
    return coll


def skew(coll, skews=(5.0, -3.25)):
    """Daemon i's clock ``skews[i]`` ahead, with a perfect offset
    estimate: its anchors, journal walls and offset all move together."""
    for d, s in zip(coll["daemons"], skews):
        for f in ("wall_t", "trace_epoch_wall"):
            if isinstance(d.get(f), (int, float)):
                d[f] += s
        d["clock_offset_s"] = (d.get("clock_offset_s") or 0.0) + s
        for rec in (d.get("journal") or {}).get("records", ()):
            if isinstance(rec.get("t"), (int, float)):
                rec["t"] += s
    return coll


def no_key(coll):
    coll["job_key"] = None
    coll["trace_id"] = "mega"
    return coll


CASES = {"complete": lambda c: c, "missing_shard": drop_shard_1,
         "two_winners": two_winners, "skewed": skew,
         "root_from_records": no_key}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lineage_and_renderers_equal_jax(case):
    ours_c = CASES[case](synthetic_collection())
    theirs_c = CASES[case](synthetic_collection(jax_assemble.COLLECT_SCHEMA))
    ours = assemble.build_lineage(copy.deepcopy(ours_c))
    theirs = jax_assemble.build_lineage(copy.deepcopy(theirs_c))
    assert ours["schema"] == "racon-tpu-torch-lineage-v1"
    assert normalised(ours) == theirs
    assert assemble._timeline_rows(ours_c) == \
        jax_assemble._timeline_rows(theirs_c)
    assert assemble.render_fleet_timeline(ours, ours_c) == \
        jax_assemble.render_fleet_timeline(theirs, theirs_c)
    assert normalised(assemble.merged_trace_doc(ours, ours_c)) == \
        jax_assemble.merged_trace_doc(theirs, theirs_c)
    if case in ("complete", "skewed", "root_from_records"):
        assert ours["complete"], ours["warnings"]
        kinds = {(e["kind"], e["from"], e["to"]) for e in ours["edges"]}
        assert ("failover", "mega-shard-0of2", "mega-shard-0of2") in kinds
        assert ("rebalance", "mega-shard-0of2",
                "mega-shard-0of2-r1") in kinds
        assert ("gather", "mega-shard-1of2", "mega") in kinds
        assert "other-shard-0of2" not in {n["key"] for n in ours["nodes"]}
    else:
        assert not ours["complete"]


def test_skew_keeps_the_rendered_order():
    base = [(lane, text) for _, lane, text
            in assemble._timeline_rows(synthetic_collection())]
    order = [text.split()[0] for _, text in base]
    assert order.index("route_rebalance") < order.index("admit") \
        < order.index("route_scatter_shard")
    for skews in ((5.0, 0.0), (0.0, -3.25), (120.0, 7.5)):
        rows = [(lane, text) for _, lane, text in assemble._timeline_rows(
            skew(synthetic_collection(), skews))]
        assert rows == base, skews
    coll = synthetic_collection()
    text = assemble.render_fleet_timeline(assemble.build_lineage(coll),
                                          coll)
    assert "offset +2.000s ±0.002s" in text and "UNREACHABLE" in text
    assert "lane router" in text and "lane b1" in text


def test_merged_trace_doc_flows():
    coll = synthetic_collection()
    doc = assemble.merged_trace_doc(assemble.build_lineage(coll), coll)
    json.loads(json.dumps(doc))
    evs = doc["traceEvents"]
    fid = assemble._flow_id("mega-shard-0of2-r1")
    assert any(e.get("ph") == "s" and e["id"] == fid for e in evs)
    assert any(e.get("ph") == "f" and e["id"] == fid for e in evs)
    assert all(e.get("ts", 0) >= 0 for e in evs)
    assert doc["lineage"]["schema"] == assemble.SCHEMA


# ---------------------------------------------------------------------------
# an in-process router over framed stub backends
# ---------------------------------------------------------------------------

def _stub_backend(path, behavior):
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


def _behavior(name, seen, drop_first_submit=False):
    """Submit answers name their shard; with ``drop_first_submit`` the
    first submit's connection closes with no answer (a backend lost
    mid-submit), which the router fails over."""
    state = {"dropped": not drop_first_submit}

    def behavior(req):
        if req["op"] == "health":
            return {"ok": True, "status": "ok", "accepting": True,
                    "queue_depth": 0, "running": 0, "pid": 1}
        if req["op"] == "submit":
            shard = (req["job"].get("shard") or [0, 1])[0]
            if not state["dropped"]:
                state["dropped"] = True
                raise ConnectionResetError("dropped")
            seen.append((name, shard, req.get("job_key")))
            fa = f">s{shard}\nACGT\n".encode()
            return {"ok": True, "job_id": 100 + shard,
                    "fasta_b64": base64.b64encode(fa).decode(),
                    "wall_s": 0.01, "n_sequences": 1,
                    "trace_id": req.get("trace_context"),
                    "report": {"who": name}}
        return {"ok": True}
    return behavior


@pytest.fixture()
def inproc_router(monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_PROBE_S", "0.1")
    monkeypatch.setenv("RACON_TPU_TORCH_SCATTER_REBALANCE", "0")
    monkeypatch.delenv("RACON_TPU_TORCH_SCATTER_MIN_WALL_S", raising=False)
    monkeypatch.setattr(obs_flight, "FLIGHT", obs_flight.FlightRecorder())
    with tempfile.TemporaryDirectory(prefix="rtlin_", dir="/tmp") as tmp:
        seen, stops, paths = [], [], []
        for i in range(2):
            path = os.path.join(tmp, f"b{i}.sock")
            stops.append(_stub_backend(path, _behavior(
                f"B{i}", seen, drop_first_submit=i == 0)))
            paths.append(path)
        rsock = os.path.join(tmp, "r.sock")
        r = router.FleetRouter(rsock, paths)
        threading.Thread(target=r.serve_forever, daemon=True).start()
        deadline = time.monotonic() + 20
        while not os.path.exists(rsock) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert os.path.exists(rsock), "router socket never bound"
        yield rsock, paths, seen
        for stop, sock in stops:
            stop.set()
            sock.close()
        r.request_stop()


def test_assemble_scattered_job_with_a_failover(inproc_router, capsys):
    rsock, paths, seen = inproc_router
    spec = {"sequences": "/nope", "overlaps": "/nope", "targets": "/nope"}
    resp = client.submit(rsock, spec, job_key="asmk", shards=2)
    assert resp["ok"], resp
    assert base64.b64decode(resp["fasta_b64"]) == \
        b">s0\nACGT\n>s1\nACGT\n"
    # backend 0 dropped shard 0's submit: the router ran it on backend 1
    assert ("B1", 0, "asmk-shard-0of2") in seen
    collection, lineage = assemble.assemble(rsock, job_key="asmk")
    assert collection["schema"] == assemble.COLLECT_SCHEMA
    assert [d["target"] for d in collection["daemons"]] == [rsock] + paths
    row = collection["daemons"][0]
    assert row["router"] and row["ok"]
    assert abs(row["clock_offset_s"]) < 5.0
    assert row["offset_confidence_s"] < 5.0
    assert lineage["complete"], lineage["warnings"]
    assert lineage["shards"] == 2
    assert {n["key"] for n in lineage["nodes"]} == {
        "asmk", "asmk-shard-0of2", "asmk-shard-1of2"}
    assert sorted(n["shard"] for n in lineage["nodes"] if n["winner"]) == \
        [0, 1]
    kinds = {(e["kind"], e["from"], e["to"]) for e in lineage["edges"]}
    assert ("failover", "asmk-shard-0of2", "asmk-shard-0of2") in kinds
    assert {("shard", "asmk", f"asmk-shard-{i}of2") for i in range(2)} \
        <= kinds
    assert {("gather", f"asmk-shard-{i}of2", "asmk") for i in range(2)} \
        <= kinds
    rc = serve_inspect.main(["--fleet", rsock, "--job-key", "asmk",
                             "--trace-out", os.path.join(
                                 os.path.dirname(rsock), "t.json")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "complete" in out and "lane router" in out
    assert "edge failover" in out and "edge gather" in out
    with open(os.path.join(os.path.dirname(rsock), "t.json")) as fh:
        doc = json.load(fh)
    assert any(e.get("ph") == "s" for e in doc["traceEvents"])
    rc = serve_inspect.main(["--fleet", rsock, "--job-key", "asmk",
                             "--json"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["schema"] == assemble.SCHEMA


def test_inspect_fleet_needs_a_key(capsys):
    assert serve_inspect.main(["--fleet", "/nonexistent.sock"]) != 0
    assert "needs --job-key or --trace-id" in capsys.readouterr().err
    with pytest.raises(ValueError):
        assemble.assemble("/nonexistent.sock")
