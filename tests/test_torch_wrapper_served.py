"""The port's wrapper against served daemons (``--server``), on the CPU.

* against a ``--device cpu`` daemon, a ``--split`` run's chunks are jobs
  whose bytes equal the subprocess path's (one one-shot process per
  chunk), which equal the whole job's; the same invocation again is
  answered from the daemon's journal (dedup hits, no job executed) with
  the same bytes;
* a ``dead,live`` daemon list fails over to the live daemon;
* a scatter-capable router (in process, over framed stub backends) gets
  the whole job with ``shards="auto"`` and no client-side split, under
  the chunk's content key;
* ``--rounds 2`` submits ``<key>-round-1`` and ``<key>-round-2``, the
  second round's draft being the first round's answer.
"""

import base64
import os
import subprocess
import sys
import tempfile

import pytest

from racon_tpu_torch.serve import client, router

from test_torch_fleet import (_ok_behavior, _serve_inproc, _shard_behavior,
                              _stub_backend, start_daemon, stop)
from test_torch_tools import (KERNEL_ARGS, WRAPPER_SCORES, _env, one_shot,
                              pair_split)

WRAPPER = "racon_tpu_torch.tools.wrapper"


@pytest.fixture(scope="module")
def tmp_dir():
    with tempfile.TemporaryDirectory(prefix="rtws_", dir="/tmp") as d:
        yield d


@pytest.fixture(scope="module")
def contigs(tmp_dir):
    from test_torch_scatter import four_contigs

    return four_contigs(os.path.join(tmp_dir, "four"))


@pytest.fixture(scope="module")
def daemon(tmp_dir):
    proc, sock = start_daemon(tmp_dir, "a")
    yield sock
    stop(proc, sock)


def wrap(args, cwd, extra=None):
    return subprocess.run([sys.executable, "-m", WRAPPER, *args],
                          capture_output=True, env=_env(cwd, extra),
                          cwd=cwd, timeout=600)


def counters(sock) -> dict:
    return client.metrics(sock)["snapshot"]["counters"]


def test_served_split_equals_the_subprocess_path(contigs, daemon, tmp_dir):
    args = ["--split", str(pair_split(contigs[2])), "-c", "1",
            "--cudaaligner-batches", "1", "-t", "2"]
    local = wrap([*args, "--device", "cpu", *contigs], tmp_dir)
    assert local.returncode == 0, local.stderr.decode()
    assert local.stdout == one_shot(contigs, *KERNEL_ARGS, *WRAPPER_SCORES)
    served = wrap([*args, "--server", daemon, *contigs], tmp_dir)
    assert served.returncode == 0, served.stderr.decode()
    assert b"target split into 2 chunk(s)" in served.stderr
    assert served.stdout == local.stdout
    # the same invocation again: each chunk's content key is answered
    # from the journal, no job runs
    before = counters(daemon)
    again = wrap([*args, "--server", daemon, *contigs], tmp_dir)
    assert again.returncode == 0, again.stderr.decode()
    assert again.stdout == local.stdout
    after = counters(daemon)
    assert after.get("serve_dedup_hits", 0) - \
        before.get("serve_dedup_hits", 0) == 2
    assert after.get("serve_jobs_completed", 0) == \
        before.get("serve_jobs_completed", 0)
    keys = [e.get("job_key") for e in client.flight(daemon)["events"]
            if e["kind"] == "dedup" and e.get("recorded")]
    assert len(keys) == 2 and all(k.startswith("wrap-") for k in keys)
    assert len(set(keys)) == 2


@pytest.fixture
def stub_dir():
    with tempfile.TemporaryDirectory(prefix="rtwss_", dir="/tmp") as d:
        yield d


@pytest.fixture
def tiny(stub_dir):
    """A two-target set of a few bases: the stubs never read it, the
    wrapper hashes it into the job keys."""
    paths = [os.path.join(stub_dir, n) for n in ("reads.fasta", "ovl.paf",
                                                 "targets.fasta")]
    with open(paths[0], "wb") as fh:
        fh.write(b">r1\nACGTACGT\n>r2\nTTGGCCAA\n")
    with open(paths[1], "wb") as fh:
        fh.write(b"r1\t8\t0\t8\t+\tt1\t8\t0\t8\t8\t8\t255\n"
                 b"r2\t8\t0\t8\t+\tt2\t8\t0\t8\t8\t8\t255\n")
    with open(paths[2], "wb") as fh:
        fh.write(b">t1\nACGTACGT\n>t2\nTTGGCCAA\n")
    return paths


def test_daemon_list_fails_over(stub_dir, tiny):
    live = os.path.join(stub_dir, "live.sock")
    dead = os.path.join(stub_dir, "dead.sock")
    stop_live, sock = _stub_backend(live, _ok_behavior("L"))
    try:
        out = wrap(["--server", f"{dead},{live}", *tiny], stub_dir)
    finally:
        stop_live.set()
        sock.close()
    assert out.returncode == 0, out.stderr.decode()
    assert out.stdout == b"f"
    assert f"{dead} unreachable".encode() in out.stderr
    assert f"submitting chunk {tiny[2]} to {live}".encode() in out.stderr


def test_router_takes_the_whole_job_with_shards_auto(monkeypatch, stub_dir,
                                                     tiny):
    monkeypatch.setenv("RACON_TPU_TORCH_ROUTE_PROBE_S", "0.1")
    monkeypatch.setenv("RACON_TPU_TORCH_SCATTER_REBALANCE", "0")
    seen, stops, paths = [], [], []
    for i in range(2):
        path = os.path.join(stub_dir, f"b{i}.sock")
        stops.append(_stub_backend(path, _shard_behavior(f"B{i}", seen)))
        paths.append(path)
    rsock = os.path.join(stub_dir, "r.sock")
    r = _serve_inproc(router, rsock, paths)
    try:
        out = wrap(["--server", rsock, "--split", "8", *tiny], stub_dir)
    finally:
        for stop_b, sock in stops:
            stop_b.set()
            sock.close()
        r.request_stop()
    assert out.returncode == 0, out.stderr.decode()
    assert b"scatter-capable router: skipping client-side --split" \
        in out.stderr
    assert out.stdout == b">s0\nAAAA\n>s1\nCCCC\n"
    keys = sorted(k for _, _, k in seen)
    assert len(keys) == 2 and keys[0].startswith("wrap-")
    base = keys[0][:-len("-shard-0of2")]
    assert keys == [f"{base}-shard-0of2", f"{base}-shard-1of2"]


def test_rounds_submit_round_keys(stub_dir, tiny):
    seen = []

    def behavior(req):
        if req["op"] == "submit":
            seen.append((req.get("job_key"), req["job"]))
            fa = b">t1\nACGTACGA\n"
            return {"ok": True, "job_id": len(seen),
                    "fasta_b64": base64.b64encode(fa).decode(),
                    "wall_s": 0.0, "n_sequences": 1}
        return {"ok": True, "status": "ok", "pid": 1}

    path = os.path.join(stub_dir, "d.sock")
    stop_d, sock = _stub_backend(path, behavior)
    try:
        out = wrap(["--server", path, "--rounds", "2", tiny[0], tiny[2]],
                   stub_dir)
    finally:
        stop_d.set()
        sock.close()
    assert out.returncode == 0, out.stderr.decode()
    assert out.stdout == b">t1\nACGTACGA\n"
    keys = [k for k, _ in seen]
    assert len(keys) == 2 and keys[0].startswith("wrap-")
    base = keys[0][:-len("-round-1")]
    assert keys == [f"{base}-round-1", f"{base}-round-2"]
    first, second = seen[0][1], seen[1][1]
    assert first["overlaps"] is None and first["rounds"] == 1
    assert first["drop_unpolished"] is False
    assert second["targets"] != tiny[2] and second["drop_unpolished"]
    assert first["cuda_poa_batches"] == 0 and "tpu_poa_batches" not in first
