"""The port's target shards, staged parse and ranks, on the CPU.

The fleet's byte contract (racon_tpu_torch/serve/scatter.py,
io/staging.py, parallel/multihost.py, core/polisher.py's ownership
mask), held to the JAX package with a tolerance of zero:

* the pure functions (``target_slice``, ``env_config``, the scatter
  planner and keys, ``merge_responses``, the slice index and its hints)
  give the JAX package's outputs on the same inputs: seeded grids, the
  JAX test fixture's five query-runs over four targets
  (tests/test_scatter.py:_staging_fixture) and a simulated PAF;
* a staged parse materializes exactly the full parse's records of the
  owned targets, with the full parse's line numbers in diagnostics;
* one four-contig job (``tools/simulate.py:concat_sets``) on the kernel
  path's plain versions, whole and as K = 2 and 3 shards through the
  serve session, with staging on and off and the streaming pipeline on
  and off: every joined result equals the unsharded bytes; the CPU
  polisher's unsharded bytes equal the JAX package's CPU polish;
* the same at the default split (no ``*_DEVICE_ONLY`` pins), where a
  shard's device share differs from the whole job's;
* a ``--rounds 2`` job as two shards and as two ranks joins to the
  whole job's bytes (the mask applies in round 1 only);
* two ``RACON_TPU_TORCH_NPROC=2`` CLI processes at once, joined, equal
  the single-process bytes (tests/test_multihost.py's contract);
* the scheduler serves ``shard`` and ``stage`` and rejects malformed ones
  with the JAX package's ``bad_request`` reasons; the fleet knobs are
  registered and leave the cache epoch alone.
"""

import base64
import io
import itertools
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from racon_tpu.io import staging as jax_staging
from racon_tpu.parallel import multihost as jax_multihost
from racon_tpu.serve import scatter as jax_scatter
from racon_tpu_torch import cache, cli
from racon_tpu_torch.io import staging
from racon_tpu_torch.parallel import multihost
from racon_tpu_torch.serve import scatter

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the split rates every polish here prices at, and the kernel path all
#: on the (plain) device: a whole run and a shard run price different
#: totals, so a rate split could cut them differently
PINS = {"RACON_TPU_TORCH_RATE_POA_DEV": "0.30",
        "RACON_TPU_TORCH_RATE_POA_CPU": "2.0",
        "RACON_TPU_TORCH_RATE_ALIGN_DEV": "1100",
        "RACON_TPU_TORCH_RATE_ALIGN_CPU": "4.0",
        "RACON_TPU_TORCH_RATE_ALIGN_WFA_DEV": "700",
        "RACON_TPU_TORCH_CACHE_DIR": "",
        "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "1",
        "RACON_TPU_TORCH_POA_DEVICE_ONLY": "1"}
#: the one-shot options of the kernel path
KERNEL_ARGS = ("-t", "2", "-c", "1", "--cudaaligner-batches", "1")
#: the multi-process knobs of both packages, unset around every test
RANK_KNOBS = ("RACON_TPU_TORCH_COORD", "RACON_TPU_TORCH_NPROC",
              "RACON_TPU_TORCH_RANK", "RACON_TPU_COORD", "RACON_TPU_NPROC",
              "RACON_TPU_RANK")


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
def clean_env(monkeypatch):
    for k, v in PINS.items():
        monkeypatch.setenv(k, v)
    for k in RANK_KNOBS + ("RACON_TPU_TORCH_STAGE", "RACON_TPU_STAGE",
                           "RACON_TPU_TORCH_PIPELINE"):
        monkeypatch.delenv(k, raising=False)
    cache.reset()
    yield
    cache.reset()


@pytest.fixture(scope="module")
def tmp_dir():
    with tempfile.TemporaryDirectory(prefix="rtsc_torch_", dir="/tmp") as d:
        yield d


def four_contigs(base: str):
    """Four simulated 1.2 kb contigs joined into one job."""
    from racon_tpu_torch.tools import simulate

    sets = [simulate.simulate(os.path.join(base, f"d{i}"), genome_len=1_200,
                              coverage=4, read_len=300, seed=30 + i,
                              ont=True)
            for i in range(4)]
    return simulate.concat_sets(sets, os.path.join(base, "all"))


@pytest.fixture(scope="module")
def dataset(tmp_dir):
    return four_contigs(tmp_dir)


def one_shot(data, *argv, env=None) -> bytes:
    """The port's one-shot CLI bytes, in this process."""
    mp = pytest.MonkeyPatch()
    try:
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        buf = io.BytesIO()
        cache.reset()
        cli.main(["--device", "cpu", *argv, *data], out=buf)
        return buf.getvalue()
    finally:
        mp.undo()


# ---------------------------------------------------------------------------
# target_slice, env_config, rank_device
# ---------------------------------------------------------------------------

def test_target_slice_equals_jax():
    for n in range(0, 40):
        for nproc in range(1, 10):
            slices = [multihost.target_slice(n, nproc, r)
                      for r in range(nproc)]
            assert slices == [jax_multihost.target_slice(n, nproc, r)
                              for r in range(nproc)]
            # a contiguous partition, sizes within one
            assert [i for s in slices for i in range(s.start, s.stop)] \
                == list(range(n))
            sizes = [s.stop - s.start for s in slices]
            assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("coord,nproc,rank", [
    (None, "2", "0"), ("h:1", None, None), ("h:1", "1", "0"),
    ("h:1", "2", "0"), ("h:1", "2", "1"), ("h:1", "4", "3"),
    ("h:1", "2", "2"), ("h:1", "3", "-1")])
def test_env_config_equals_jax(monkeypatch, coord, nproc, rank):
    for prefix in ("RACON_TPU_TORCH_", "RACON_TPU_"):
        for name, v in (("COORD", coord), ("NPROC", nproc), ("RANK", rank)):
            if v is None:
                monkeypatch.delenv(prefix + name, raising=False)
            else:
                monkeypatch.setenv(prefix + name, v)

    def outcome(fn):
        try:
            return fn()
        except ValueError as exc:
            return ("raised", str(exc).replace("RACON_TPU_TORCH_",
                                               "RACON_TPU_"))

    port = outcome(multihost.env_config)
    assert port == outcome(jax_multihost.env_config)
    if port is None or port[0] == "raised":
        return
    assert multihost.maybe_initialize() == (port[1], port[2])


def test_rank_device(monkeypatch):
    import torch

    assert multihost.rank_device() is None
    assert multihost.rank_device("cpu") == "cpu"
    monkeypatch.setenv("RACON_TPU_TORCH_COORD", "h:1")
    monkeypatch.setenv("RACON_TPU_TORCH_NPROC", "6")
    monkeypatch.setenv("RACON_TPU_TORCH_RANK", "4")
    assert multihost.rank_device("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert multihost.rank_device() == "cuda:1"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.rank_device() == "cuda:0"
    # no card: the card is asked for, and resolve_device refuses it
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert multihost.rank_device() == "cuda"


# ---------------------------------------------------------------------------
# the scatter planner against the JAX package's
# ---------------------------------------------------------------------------

def _both(fn_port, fn_jax, *args):
    """Both packages' outputs, or the exception type and text."""
    out = []
    for fn in (fn_port, fn_jax):
        try:
            out.append(fn(*args))
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
    return out


def test_parse_requested_equals_jax():
    values = [None, 0, 1, 3, 4096, "3", " AUTO ", "auto", "seven", "",
              "-1", -1, 4097, 2.5, True, False, [3], {"n": 3}, "0"]
    for v in values:
        port, jax = _both(scatter.parse_requested,
                          jax_scatter.parse_requested, v)
        assert port == jax, v


@pytest.mark.parametrize("threshold,cap", [
    (None, None), ("100", None), ("100", "2"), ("nope", "junk"),
    ("-3", "0"), ("0.5", "5")])
def test_plan_shards_and_knobs_equal_jax(monkeypatch, threshold, cap):
    for prefix in ("RACON_TPU_TORCH_", "RACON_TPU_"):
        for name, v in (("SCATTER_MIN_WALL_S", threshold),
                        ("SCATTER_MAX_SHARDS", cap)):
            if v is None:
                monkeypatch.delenv(prefix + name, raising=False)
            else:
                monkeypatch.setenv(prefix + name, v)
    assert scatter.min_wall_s() == jax_scatter.min_wall_s()
    assert scatter.max_shards() == jax_scatter.max_shards()
    for req, wall, n in itertools.product(
            [None, 0, 1, 2, 3, 5, 9, "auto"],
            [None, 0.2, 1.0, 50.0, 150.0, 250.0, 1e4], range(0, 5)):
        assert scatter.plan_shards(req, wall, n) == \
            jax_scatter.plan_shards(req, wall, n), (req, wall, n)


@pytest.mark.parametrize("raw", [None, "", "2.5", "0", "-1", "junk",
                                 "0.01", "9.5"])
def test_rebalance_factor_equals_jax(monkeypatch, raw):
    for name in ("RACON_TPU_TORCH_SCATTER_REBALANCE",
                 "RACON_TPU_SCATTER_REBALANCE"):
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
    assert scatter.rebalance_factor() == jax_scatter.rebalance_factor()


def test_shard_and_rebalance_keys_equal_jax():
    rng = np.random.default_rng(12)
    bases = ["mega", "a.b:c-d", "k" * 100, "k" * 115, "k" * 128,
             "route-123-4"] + [
        "x" * int(n) for n in rng.integers(1, 129, 20)]
    for base in bases:
        for count in (1, 2, 3, 16, 4096):
            for index in {0, count // 2, count - 1}:
                assert scatter.shard_key(base, index, count) == \
                    jax_scatter.shard_key(base, index, count)
                for attempt in (1, 2):
                    assert scatter.rebalance_key(base, index, count,
                                                 attempt) == \
                        jax_scatter.rebalance_key(base, index, count,
                                                  attempt)


def test_shard_spec_equals_jax():
    spec = {"sequences": "/r", "overlaps": "/o", "targets": "/t",
            "tenant": "acme", "threads": 3}
    hint = {"v": 1, "ranges": [[0, 4]], "path": "/o"}
    for i, k, st in ((0, 1, None), (1, 3, hint), (2, 3, None)):
        sub = scatter.shard_spec(spec, i, k, stage=st)
        assert sub == jax_scatter.shard_spec(spec, i, k, stage=st)
        assert "shard" not in spec


def test_merge_responses_equals_jax():
    rng = np.random.default_rng(5)
    for k in (1, 2, 3, 5):
        resps, keys = [], []
        for i in range(k):
            n = int(rng.integers(1, 4))
            chunk = b"".join(b">t%d_%d\n" % (i, j) + bytes(
                rng.choice(list(b"ACGT"), int(rng.integers(1, 30))))
                + b"\n" for j in range(n))
            resps.append({"ok": True, "job_id": 40 + i,
                          "fasta_b64": base64.b64encode(chunk).decode(),
                          "n_sequences": n, "wall_s": 0.5 + i,
                          "routed_backend": f"/b{i}.sock",
                          "trace_id": f"tr{i}",
                          "estimate": {"predicted_wall_s": 1.0 + i},
                          "report": {"windows": i}})
            keys.append(scatter.shard_key("mega", i, k))
        assert scatter.merge_responses(resps, keys) == \
            jax_scatter.merge_responses(resps, keys)


# ---------------------------------------------------------------------------
# the slice index against the JAX package's
# ---------------------------------------------------------------------------

def _paf_row(q, t):
    return (f"{q}\t100\t0\t100\t+\t{t}\t200\t10\t110\t100\t100\t255"
            .encode())


def _staging_fixture(tmp_path):
    """The JAX test fixture: five query-runs over four targets, with a
    split same-query pair (q1 at runs 0 and 2) and an unknown-target run
    (qX)."""
    rows = [_paf_row("q1", "t0"), _paf_row("q1", "t0"),
            _paf_row("q2", "t1"), _paf_row("q1", "t2"),
            _paf_row("qX", "tUNKNOWN"), _paf_row("q4", "t3"),
            _paf_row("q4", "t3")]
    path = str(tmp_path / "o.paf")
    with open(path, "wb") as fh:
        fh.write(b"\n".join(rows) + b"\n")
    return path, rows, ["t0", "t1", "t2", "t3"]


_INDEX_FIELDS = ("path", "sig", "total_lines", "total_bytes", "run_lo",
                 "run_hi", "run_blo", "run_bhi", "run_q", "run_targets")


def _index_equal_jax(path, names):
    idx = staging.build_index(path, names)
    jidx = jax_staging.build_index(path, names)
    assert (idx is None) == (jidx is None)
    if idx is None:
        return None
    for f in _INDEX_FIELDS:
        assert getattr(idx, f) == getattr(jidx, f), f
    n = len(names)
    for bits in itertools.product((False, True), repeat=min(n, 4)):
        mask = list(bits) + [False] * (n - len(bits))
        assert idx.ranges_for(mask) == jidx.ranges_for(mask), mask
    for count in range(1, n + 2):
        for i in range(count):
            hint = staging.shard_hint(idx, (i, count), n)
            assert hint == jax_staging.shard_hint(jidx, (i, count), n)
            for shard in ((i, count), (i, count + 1)):
                assert staging.plan_from_hint(hint, path, shard) == \
                    jax_staging.plan_from_hint(hint, path, shard)
    return idx


def test_staging_fixture_equals_jax(tmp_path):
    path, rows, targets = _staging_fixture(tmp_path)
    idx = _index_equal_jax(path, targets)
    # the JAX test's readings: the separator rule and the unowned run
    assert idx.run_targets[3] is None
    assert idx.ranges_for([True, False, True, False])["ranges"] == [[0, 5]]
    assert idx.ranges_for([True, False, False, False])["ranges"] == \
        [[0, 2], [4, 5]]
    hint = staging.shard_hint(idx, (1, 2), 4)
    other = str(tmp_path / "other.paf")
    with open(other, "wb") as fh:
        fh.write(rows[0] + b"\n")
    bad_hints = [None, 7, {}, {"v": 2}, dict(hint, ranges=[[5, 3]]),
                 dict(hint, ranges=[[3, 4], [1, 2]]),
                 dict(hint, sig=["x", "y"]), dict(hint, format="sam"),
                 dict(hint, shard=[0, 2])]
    for bad in bad_hints:
        assert staging.plan_from_hint(bad, path, (1, 2)) is None
        assert jax_staging.plan_from_hint(bad, path, (1, 2)) is None
    assert staging.plan_from_hint(hint, other, (1, 2)) is None
    # a changed file re-keys
    with open(path, "ab") as fh:
        fh.write(rows[0] + b"\n")
    assert staging.plan_from_hint(hint, path, (1, 2)) is None
    assert jax_staging.plan_from_hint(hint, path, (1, 2)) is None


def test_staging_refusals_equal_jax(tmp_path):
    path, rows, targets = _staging_fixture(tmp_path)
    mhap = str(tmp_path / "o.mhap")
    with open(mhap, "wb") as fh:
        fh.write(b"0 1 0.05 0.9 0 5 95 100 0 10 190 200\n")
    assert staging.build_index(mhap, targets) is None
    assert jax_staging.build_index(mhap, targets) is None
    for bad in (b"q1\t100\t0\t100\t+\tt0\t200\t10\n",
                b"q1\t100\txx\t100\t+\tt0\t200\t10\t110\n",
                b"q\xff\t100\t0\t100\t+\tt0\t200\t10\t110\n"):
        p = str(tmp_path / "bad.paf")
        with open(p, "wb") as fh:
            fh.write(rows[0] + b"\n" + bad)
        staging._MEMO.clear()
        assert staging.build_index(p, targets) is None
        assert jax_staging.build_index(p, targets) is None
    gone = str(tmp_path / "gone.paf")
    assert staging.build_index(gone, targets) is None
    assert jax_staging.build_index(gone, targets) is None


def test_validate_stage_field_equals_jax():
    values = [None, 7, "x", [], {}, {"v": 2}, {"v": 1},
              {"v": 1, "path": 3}, {"v": 1, "path": "/o"},
              {"v": 1, "path": "/o", "ranges": {}},
              {"v": 1, "path": "/o", "ranges": [[0, 1]]},
              {"v": 1, "path": "/o", "ranges": [[0, 1, 2]]},
              {"v": 1, "path": "/o", "ranges": [[-1, 1]]},
              {"v": 1, "path": "/o", "ranges": [["0", 1]]},
              {"v": 1, "path": "/o", "ranges": [(0, 3), [4, 9]]},
              {"ranges": [[0, 10]], "shard": [0, 2]}]
    for v in values:
        assert staging.validate_stage_field(v) == \
            jax_staging.validate_stage_field(v), v


def test_staging_simulated_paf_equals_jax(dataset):
    names = staging.fasta_names(dataset[2])
    assert names == jax_staging.fasta_names(dataset[2]) == \
        ["ctg0", "ctg1", "ctg2", "ctg3"]
    idx = _index_equal_jax(dataset[1], names)
    assert len(idx.run_lo) > 4
    # the memo serves the same index until the file changes
    assert staging.get_index(dataset[1], names) is \
        staging.get_index(dataset[1], names)


def test_staged_parse_is_the_owned_full_parse(dataset):
    """A staged parse materializes exactly the full parse's records of
    the query-runs that touch owned targets, counting what it skips."""
    from racon_tpu_torch.io import fastio

    names = staging.fasta_names(dataset[2])
    idx = staging.build_index(dataset[1], names)

    def records(ranges, budget):
        p = fastio.PafScanParser(dataset[1])
        p.set_stage(ranges)
        out, rounds = [], 0
        while p.parse(out, budget):
            rounds += 1
        skipped = p.stage_skipped_bytes
        p.close()
        return [(o.q_name, o.t_name, o.q_begin, o.t_begin) for o in out], \
            rounds, skipped

    full, full_rounds, _ = records(None, 4096)
    for k in (2, 3):
        for i in range(k):
            hint = staging.shard_hint(idx, (i, k), len(names))
            got, rounds, skipped = records(hint["ranges"], 4096)
            # the chunking counts every line, staged or not
            assert rounds == full_rounds
            assert skipped == hint["total_bytes"] - hint["staged_bytes"]
            runs = {q for q, t, _, _ in got}
            assert got == [r for r in full if r[0] in runs]
            sl = multihost.target_slice(len(names), k, i)
            owned = set(names[sl])
            assert {t for _, t, _, _ in got} >= owned & {
                t for _, t, _, _ in full}


def test_staged_parse_keeps_full_parse_diagnostics(tmp_path):
    """A malformed row outside the staged ranges is skipped, one inside
    raises with the full parse's line number."""
    from racon_tpu_torch.io import fastio, parsers

    path, rows, _ = _staging_fixture(tmp_path)
    bad = str(tmp_path / "bad.paf")
    with open(bad, "wb") as fh:
        fh.write(b"\n".join(rows[:5]) + b"\nq4\t1\tx\n" + rows[6] + b"\n")
    p = fastio.PafScanParser(bad)
    p.set_stage([[0, 2]])
    out = []
    p.parse(out, -1)
    assert len(out) == 2
    p.set_stage([[4, 7]])
    p.reset()
    with pytest.raises(parsers.MalformedInputError) as exc:
        p.parse([], -1)
    assert f"{bad}:6:" in str(exc.value)
    p.close()


def test_concat_sets_names(tmp_dir, dataset):
    """Every read name is unique across the joined set, and each
    contig's overlaps point at its own contig."""
    from racon_tpu_torch.io import fastio

    reads, paf, draft = dataset
    r = fastio.FastqScanParser(reads)
    seqs = []
    r.parse(seqs, -1)
    r.close()
    names = [s.name for s in seqs]
    assert len(names) == len(set(names)) > 0
    assert {n[:2] for n in names} == {"d0", "d1", "d2", "d3"}
    with open(draft, "rb") as fh:
        heads = [l.strip() for l in fh if l.startswith(b">")]
    assert heads == [b">ctg0", b">ctg1", b">ctg2", b">ctg3"]
    by_contig = {}
    with open(paf, "rb") as fh:
        for line in fh:
            f = line.split(b"\t")
            assert f[5] == b"ctg" + f[0][1:2], f
            by_contig.setdefault(f[5], 0)
            by_contig[f[5]] += 1
    assert sorted(by_contig) == [b"ctg0", b"ctg1", b"ctg2", b"ctg3"]
    # each set's own records, renamed: the per-contig sets' PAF lines
    for i in range(4):
        with open(os.path.join(tmp_dir, f"d{i}", "reads2draft.paf"),
                  "rb") as fh:
            assert sum(1 for _ in fh) == by_contig[b"ctg%d" % i]


# ---------------------------------------------------------------------------
# the byte contract: whole, sharded, staged, pipeline on and off
# ---------------------------------------------------------------------------

def _kernel_spec(data, **kw):
    reads, paf, draft = data
    return {"sequences": reads, "overlaps": paf, "targets": draft,
            "threads": 2, "cuda_poa_batches": 1, "cuda_aligner_batches": 1,
            **kw}


def _served(specs, env):
    """Run specs one after another through a scheduler and the serve
    session on the CPU; returns the responses."""
    from racon_tpu_torch.serve.scheduler import JobScheduler
    from racon_tpu_torch.serve.session import run_job

    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    sched = JobScheduler(lambda job: run_job(job, device="cpu"),
                         max_queue=8, max_jobs=1)
    out = []
    try:
        for spec in specs:
            cache.reset()
            job = sched.submit(spec)
            assert job.done.wait(300)
            assert job.result.get("ok"), job.result
            out.append(job.result)
    finally:
        sched.drain(timeout=60)
        mp.undo()
    return out


@pytest.fixture(scope="module")
def whole(dataset):
    """The unsharded kernel-path bytes, pipeline on and off (equal)."""
    on = one_shot(dataset, *KERNEL_ARGS)
    off = one_shot(dataset, *KERNEL_ARGS,
                   env={"RACON_TPU_TORCH_PIPELINE": "0"})
    assert on == off and on.count(b">") == 4
    return on


@pytest.mark.parametrize("k,stage,pipeline",
                         list(itertools.product((2, 3), ("1", "0"),
                                                ("1", "0"))))
def test_shards_join_to_the_unsharded_bytes(dataset, whole, k, stage,
                                            pipeline):
    names = staging.fasta_names(dataset[2])
    index = staging.build_index(dataset[1], names)
    specs = []
    for i in range(k):
        hint = staging.shard_hint(index, (i, k), len(names))
        specs.append(_kernel_spec(dataset, shard=[i, k], stage=hint))
    env = {"RACON_TPU_TORCH_STAGE": stage,
           "RACON_TPU_TORCH_PIPELINE": pipeline}
    parts = _served(specs, env)
    joined = b"".join(base64.b64decode(p["fasta_b64"]) for p in parts)
    assert joined == whole
    for i, p in enumerate(parts):
        gauges = p["report"]["run"]["gauges"]
        assert p["report"]["details"]["shard"] == [i, k]
        if stage == "1":
            assert gauges["host.parse_skipped_bytes"] == \
                specs[i]["stage"]["total_bytes"] - \
                specs[i]["stage"]["staged_bytes"] > 0
        else:
            assert "host.parse_skipped_bytes" not in gauges


def test_shards_join_where_the_ladder_mixes_engines(tmp_dir, monkeypatch):
    """The WFA and band rungs write different CIGARs for one pair, so a
    pair's rung must not depend on the other targets' overlaps: each
    target's probe prices its own pairs.  With rungs narrow enough that
    the probed divergence splits the pairs between the engines, the
    four-target job and its four one-target shards write the same
    bytes (a ladder priced by one probe over the whole job does not)."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher
    from racon_tpu_torch.cuda.polisher import CudaPolisher
    from racon_tpu_torch.tools import simulate

    monkeypatch.setattr(CudaPolisher, "WFA_RUNGS", (96, 160))
    monkeypatch.setattr(CudaPolisher, "BAND_RUNGS", (1024, 2048))
    # every target probes (its ~15 pairs are under the port's budget)
    monkeypatch.setattr(CudaPolisher, "PROBE_EVERY", 1)
    monkeypatch.setattr(CudaPolisher, "PROBE_MIN", 4)
    monkeypatch.setenv("RACON_TPU_TORCH_PIPELINE", "0")
    base = os.path.join(tmp_dir, "mixed")
    data = simulate.concat_sets(
        [simulate.simulate(os.path.join(base, f"d{i}"), genome_len=2_500,
                           coverage=6, read_len=1_000, seed=90 + i,
                           ont=True) for i in range(4)],
        os.path.join(base, "all"))

    def run(shard=None):
        cache.reset()
        pol = create_polisher(*data, PolisherType.kC, 500, 10.0, 0.3,
                              True, 5, -4, -8, 2, cuda_aligner_batches=1,
                              device="cpu")
        pol._target_shard = shard
        try:
            pol.initialize()
            out = pol.polish(True)
        finally:
            pol.close()
        return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                        for s in out), pol.align_rungs

    whole, rungs = run()
    assert any(r["certified"] for name, r in rungs.items()
               if name.startswith("band"))
    assert any(r["certified"] for name, r in rungs.items()
               if name.startswith("wfa"))
    assert b"".join(run((i, 4))[0] for i in range(4)) == whole


@pytest.mark.parametrize("k", (2, 4))
def test_shards_join_at_the_default_split(dataset, k):
    """With no ``*_DEVICE_ONLY`` pins the rate model splits each job's
    pairs and windows between the kernels' plain versions and the native
    CPU engines (at pinned rates, so every job prices alike), and a
    shard's cut differs from the whole job's.  The joined bytes still
    equal the whole job's."""
    env = {"RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "",
           "RACON_TPU_TORCH_POA_DEVICE_ONLY": ""}
    mp = pytest.MonkeyPatch()
    for key in env:
        mp.delenv(key)
    try:
        runs = _served([_kernel_spec(dataset)]
                       + [_kernel_spec(dataset, shard=[i, k])
                          for i in range(k)], {})
    finally:
        mp.undo()
    fasta = [base64.b64decode(r["fasta_b64"]) for r in runs]
    assert fasta[0].count(b">") == 4
    assert b"".join(fasta[1:]) == fasta[0]
    details = [r["report"]["details"] for r in runs]
    keys = ("align_split_detail", "poa_split_detail")
    assert all(d[key]["mode"] == "rate_model" for d in details
               for key in keys)
    # the shards put another share of the work on the device
    assert tuple(sum(d[key]["cut"] for d in details[1:]) for key in keys) \
        != tuple(details[0][key]["cut"] for key in keys)


def test_rounds_shards_and_ranks_join_to_the_whole_job(dataset):
    """A ``--rounds 2`` job: a shard or a rank masks its targets in
    round 1, whose draft then holds only its own targets, so round 2
    polishes all of them.  Two K = 2 shards through the serve session,
    and two ``_NPROC=2`` ranks of the CLI, each join to the whole job's
    bytes."""
    whole = one_shot(dataset, "--rounds", "2", *KERNEL_ARGS)
    assert whole.count(b">") == 4
    parts = _served([_kernel_spec(dataset, shard=[i, 2], rounds=2)
                     for i in range(2)], {})
    assert b"".join(base64.b64decode(p["fasta_b64"])
                    for p in parts) == whole
    for p in parts:
        assert [r["n_sequences"] for r in p["report"]["details"]["rounds"]]\
            == [2, 2]
    ranks = [one_shot(dataset, "--rounds", "2", *KERNEL_ARGS, env={
        "RACON_TPU_TORCH_COORD": "localhost:1",
        "RACON_TPU_TORCH_NPROC": "2", "RACON_TPU_TORCH_RANK": str(r)})
        for r in range(2)]
    assert [r.count(b">") for r in ranks] == [2, 2]
    assert b"".join(ranks) == whole


def test_rounds_shard_that_owns_no_target_ends_empty(dataset):
    """A shard past the last target owns none: round 1 emits nothing and
    the job ends there with an empty result, not an empty-draft error."""
    [part] = _served([_kernel_spec(dataset, shard=[4, 5], rounds=2)], {})
    assert base64.b64decode(part["fasta_b64"]) == b""
    assert len(part["report"]["details"]["rounds"]) == 1


@pytest.mark.parametrize("every,least", [(32, 3), (2, 3), (1, 4)])
def test_probe_budget_per_target(dataset, monkeypatch, every, least):
    """Each target probes min(PROBE_PAIRS, n // PROBE_EVERY) of its n
    pending pairs, none below PROBE_MIN, so the probe's share of a
    fragmented draft's pairs stays bounded; a target's count depends on
    its own pairs alone."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher
    from racon_tpu_torch.cuda.polisher import CudaPolisher

    monkeypatch.setattr(CudaPolisher, "PROBE_EVERY", every)
    monkeypatch.setattr(CudaPolisher, "PROBE_MIN", least)
    monkeypatch.setenv("RACON_TPU_TORCH_PIPELINE", "0")
    per_target = {}
    real = CudaPolisher._probe_divergence

    def spy(self, pending):
        for _, o in pending:
            per_target[o.t_id] = per_target.get(o.t_id, 0) + 1
        return real(self, pending)

    monkeypatch.setattr(CudaPolisher, "_probe_divergence", spy)
    pol = create_polisher(*dataset, PolisherType.kC, 500, 10.0, 0.3, True,
                          3, -5, -4, 2, cuda_aligner_batches=1,
                          device="cpu")
    try:
        pol.initialize()
    finally:
        pol.close()
    want = {t: min(9, n // every) for t, n in per_target.items()}
    want = {t: k for t, k in want.items() if k >= least}
    assert len(per_target) == 4
    assert pol.align_probed == sum(want.values())
    assert set(pol._probe_by_target) == set(want)


def test_stale_hint_takes_the_self_built_plan(dataset, whole):
    """A hint for another shard is refused and the shard builds its own
    index; a polisher with no hint builds its own too.  Same bytes."""
    names = staging.fasta_names(dataset[2])
    index = staging.build_index(dataset[1], names)
    wrong = staging.shard_hint(index, (0, 2), len(names))
    parts = _served([_kernel_spec(dataset, shard=[0, 2]),
                     _kernel_spec(dataset, shard=[1, 2], stage=wrong)],
                    {"RACON_TPU_TORCH_PIPELINE": "0"})
    assert b"".join(base64.b64decode(p["fasta_b64"])
                    for p in parts) == whole
    right = staging.shard_hint(index, (1, 2), len(names))
    gauges = parts[1]["report"]["run"]["gauges"]
    assert gauges["host.staged_bytes"] == right["staged_bytes"]


def test_unowned_windows_never_reach_the_pipeline(dataset):
    """With the streaming pipeline on, a shard's polisher creates,
    registers and polishes only its own targets' windows."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    pol = create_polisher(*dataset, PolisherType.kC, 500, 10.0, 0.3, True,
                          3, -5, -4, 2, cuda_poa_batches=1,
                          cuda_aligner_batches=1, device="cpu")
    pol._target_shard = (1, 3)
    registered = []
    real_begin = pol._pipeline_begin

    def spy(overlaps):
        registered.extend(o.t_id for o in overlaps)
        real_begin(overlaps)

    pol._pipeline_begin = spy
    try:
        pol.initialize()
        sl = multihost.target_slice(4, 3, 1)
        assert pol._pipeline_mode
        assert registered and set(registered) <= set(range(sl.start,
                                                           sl.stop))
        assert {w.id for w in pol.windows} == set(range(sl.start, sl.stop))
        assert pol._ledger.pending.size == len(pol.windows)
        out = pol.polish(True)
    finally:
        pol.close()
    assert [s.name.split()[0] for s in out] == \
        [f"ctg{t}" for t in range(sl.start, sl.stop)]


def test_cpu_polisher_bytes_equal_jax_and_join(dataset):
    """The CPU polisher's unsharded bytes equal the JAX package's CPU
    polish of the same files, and its two ranks join to them."""
    from racon_tpu.core import polisher as jax_polisher

    pol = jax_polisher.create_polisher(
        *dataset, jax_polisher.PolisherType.kC, 500, 10.0, 0.3, True, 3,
        -5, -4, 2)
    try:
        pol.initialize()
        jax_bytes = b"".join(b">" + s.name.encode() + b"\n" + s.data
                             + b"\n" for s in pol.polish(True))
    finally:
        pol.close()
    port = one_shot(dataset, "-t", "2")
    assert port == jax_bytes
    ranks = [one_shot(dataset, "-t", "2", env={
        "RACON_TPU_TORCH_COORD": "localhost:1",
        "RACON_TPU_TORCH_NPROC": "2", "RACON_TPU_TORCH_RANK": str(r)})
        for r in range(2)]
    assert b"".join(ranks) == port
    assert all(r.count(b">") == 2 for r in ranks)


def test_two_process_ranks_join_to_the_single_process_bytes(tmp_dir,
                                                            dataset,
                                                            whole):
    """Two CLI processes at once, ranks 0 and 1 of 2, on the kernel
    path; ``cat part0 part1`` is the single-process output."""
    env = dict(os.environ)
    env.update(PINS)
    env.update({"RACON_TPU_TORCH_COORD": "localhost:1",
                "RACON_TPU_TORCH_NPROC": "2", "OMP_NUM_THREADS": "2"})
    procs = []
    for rank in range(2):
        out = open(os.path.join(tmp_dir, f"part{rank}.fa"), "wb")
        err = open(os.path.join(tmp_dir, f"part{rank}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch.cli", "--device",
             "cpu", *KERNEL_ARGS, *dataset], cwd=REPO_ROOT, stdout=out,
            stderr=err, env={**env, "RACON_TPU_TORCH_RANK": str(rank)}),
            out, err))
    parts = []
    for rank, (proc, out, err) in enumerate(procs):
        assert proc.wait(timeout=300) == 0
        out.close()
        err.close()
        with open(os.path.join(tmp_dir, f"part{rank}.log")) as fh:
            assert f"rank {rank}/2" in fh.read()
        with open(os.path.join(tmp_dir, f"part{rank}.fa"), "rb") as fh:
            parts.append(fh.read())
    assert parts[0] and parts[1]
    assert parts[0] + parts[1] == whole


def test_rank_out_of_range_exits(dataset):
    env = dict(os.environ)
    env.update(PINS)
    env.update({"RACON_TPU_TORCH_COORD": "localhost:1",
                "RACON_TPU_TORCH_NPROC": "2", "RACON_TPU_TORCH_RANK": "2"})
    proc = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "--device", "cpu",
         *dataset], cwd=REPO_ROOT, capture_output=True, env=env,
        timeout=120)
    assert proc.returncode == 1 and not proc.stdout
    assert b"RACON_TPU_TORCH_RANK 2 out of range" in proc.stderr


# ---------------------------------------------------------------------------
# admission, pricing, knobs
# ---------------------------------------------------------------------------

def test_scheduler_shard_and_stage_rejects_equal_jax(tmp_path):
    from racon_tpu.serve import scheduler as jax_sched
    from racon_tpu_torch.serve import scheduler as sched

    reads = tmp_path / "r.fasta"
    reads.write_text(">r1\nACGT\n")
    paf = tmp_path / "o.paf"
    paf.write_text("r1\t4\t0\t4\t+\tt1\t4\t0\t4\t4\t4\t255\n")
    draft = tmp_path / "t.fasta"
    draft.write_text(">t1\nACGT\n")
    base = {"sequences": str(reads), "overlaps": str(paf),
            "targets": str(draft)}
    cases = [{"shard": s} for s in (
        [1], [1, 2, 3], ["0", "2"], [True, 2], [2, 2], [-1, 2], [0, 5000],
        "0/2", {"i": 0, "k": 2})] + [{"stage": s} for s in (
            7, {}, {"v": 2}, {"v": 1, "path": 3},
            {"v": 1, "path": "/o", "ranges": [[0, 1, 2]]})]
    ours = sched.JobScheduler(lambda job: {"ok": True}, max_queue=8,
                              max_jobs=8)
    theirs = jax_sched.JobScheduler(runner=lambda job: {"ok": True},
                                    max_queue=8, max_jobs=8)
    try:
        for case in cases:
            errs = []
            for mod, s in ((sched, ours), (jax_sched, theirs)):
                with pytest.raises(mod.RejectError) as exc:
                    s.submit({**base, **case})
                errs.append(exc.value.error)
            assert errs[0] == errs[1], case
            assert errs[0]["code"] == "bad_request"
        for good in ({"shard": [1, 3]}, {"shard": (0, 1)},
                     {"shard": [0, 2], "stage": {"v": 1, "path": str(paf),
                                                 "ranges": [[0, 1]]}}):
            job = ours.submit({**base, **good})
            assert job.done.wait(30) and job.result["ok"]
    finally:
        ours.drain(timeout=30)
        theirs.drain(timeout=30)


def test_estimate_prices_the_staged_fraction_as_jax(dataset):
    from racon_tpu.serve import scheduler as jax_sched
    from racon_tpu_torch.serve import scheduler as sched

    names = staging.fasta_names(dataset[2])
    index = staging.build_index(dataset[1], names)
    hint = staging.shard_hint(index, (0, 3), len(names))
    spec = _kernel_spec(dataset, shard=[0, 3], stage=hint)
    est = sched.estimate_job(spec, hit_ratio=0.0)
    jest = jax_sched.estimate_job(spec, hit_ratio=0.0)
    assert est["staged_fraction"] == jest["staged_fraction"] == round(
        hint["staged_bytes"] / hint["total_bytes"], 6)
    assert est["input_bytes"] == jest["input_bytes"]
    assert est["input_bytes"]["overlaps_staged"] < \
        est["input_bytes"]["overlaps"]


FLEET_KNOBS = ("ROUTE_PROBE_S", "ROUTE_PROBE_TIMEOUT_S", "ROUTE_BREAKER_FAILS",
               "ROUTE_BREAKER_COOLDOWN_S", "ROUTE_AFFINITY", "ROUTE_TCP",
               "SCATTER_MIN_WALL_S", "SCATTER_MAX_SHARDS",
               "SCATTER_REBALANCE", "STAGE", "FLEET_INTERVAL_S",
               "FLEET_TIMEOUT_S", "FLEET_STALE_S", "NPROC", "RANK", "COORD")


def test_fleet_knobs_registered_and_epoch_excluded(monkeypatch):
    from racon_tpu_torch.cache import keying
    from racon_tpu_torch.obs import provenance

    names = ["RACON_TPU_TORCH_" + n for n in FLEET_KNOBS]
    for n in names:
        assert n in provenance.KNOWN_KNOBS, n
        assert n in keying.EPOCH_EXCLUDE, n
        monkeypatch.delenv(n, raising=False)
    base = keying.engine_epoch()
    for n, v in zip(names, ("0.1", "0.2", "9", "1", "0", "127.0.0.1:0",
                            "5", "2", "9.5", "0", "2", "3", "4", "2", "1",
                            "h:1")):
        monkeypatch.setenv(n, v)
    assert keying.engine_epoch() == base
    # a knob that shapes the compute does move it
    monkeypatch.setenv("RACON_TPU_TORCH_MAP_K", "15")
    assert keying.engine_epoch() != base


def test_stage_enabled_knob(monkeypatch):
    assert staging.stage_enabled() is True
    monkeypatch.setenv("RACON_TPU_TORCH_STAGE", "0")
    assert staging.stage_enabled() is False
    monkeypatch.setenv("RACON_TPU_TORCH_STAGE", "1")
    assert staging.stage_enabled() is True
