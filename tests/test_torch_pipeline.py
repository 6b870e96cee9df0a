"""The port's default main path on the CPU: the streaming align -> POA
pipeline, the rate-model device/CPU splits with concurrent CPU tail
workers, and the calibrated rate store.

Unit parity with the JAX package (same inputs, equal outputs): the
split boundaries, the window ledger, the batched breaking-point decode
and the calibration store's semantics.  Slice invariants on a small
simulated set through ``CudaPolisher(device="cpu")`` (the kernels'
plain versions): pipeline on and off give the same bytes at pinned
rates, also under timing jitter; a forced split sends each window and
overlap to the engine it names; the default path stays within
``tests/test_torch_slice.py``'s tolerance of the JAX package's CPU
polish; an error in the speculative consumer reaches the caller.
"""

import copy
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from racon_tpu.core import overlap as jax_overlap
from racon_tpu.core import polisher as jax_polisher
from racon_tpu.core.window import WindowLedger as JaxLedger
from racon_tpu.tpu import polisher as jax_tpu_polisher
from racon_tpu.utils import calibrate as jax_calibrate
from racon_tpu_torch import cache
from racon_tpu_torch.core import overlap as port_overlap
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.core.window import WindowLedger
from racon_tpu_torch.cuda import polisher as cuda_polisher
from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine
from racon_tpu_torch.cuda.polisher import CudaPolisher
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.tools import simulate
from racon_tpu_torch.utils import calibrate


@pytest.fixture(autouse=True)
def cold_result_cache():
    """Every test starts and ends with an empty result cache, as a fresh
    process would: a test here counts launches, rungs or rates, or
    swaps an engine, and must not see what an earlier test filled."""
    cache.reset()
    yield
    cache.reset()


#: rates every polish here runs at unless a test says otherwise: a
#: device share of a few windows and about half the overlaps on this
#: set, so both engines of both splits take part
PINS = {"RACON_TPU_TORCH_RATE_POA_DEV": "1.0",
        "RACON_TPU_TORCH_RATE_POA_CPU": "2.0",
        "RACON_TPU_TORCH_RATE_ALIGN_DEV": "1000",
        "RACON_TPU_TORCH_RATE_ALIGN_CPU": "20",
        "RACON_TPU_TORCH_RATE_ALIGN_WFA_DEV": "300"}
#: the port's knobs a test may set; each polish starts with none set
KNOBS = ("RACON_TPU_TORCH_PIPELINE", "RACON_TPU_TORCH_ALIGN_SPLIT",
         "RACON_TPU_TORCH_POA_SPLIT", "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY",
         "RACON_TPU_TORCH_POA_DEVICE_ONLY", "RACON_TPU_TORCH_RECALIBRATE",
         "RACON_TPU_TORCH_RATE_ALIGN_CPU_DEV")


@pytest.fixture(scope="module", autouse=True)
def pinned_env(tmp_path_factory):
    """Pinned rates and a calibration root of this module's own, so no
    polish here reads or writes the user's store.  The plain versions'
    small tensor ops run on one intra-op thread: beside other test
    processes, a team of spinning threads per op slows them tenfold."""
    root = tmp_path_factory.mktemp("calib_root")
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
    # pinned runs store nothing
    assert not os.path.exists(os.path.join(root, "calibration.json"))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, pinned_env):
    out = tmp_path_factory.mktemp("pipe_sim")
    paths = simulate.simulate(str(out), genome_len=6_000, coverage=8,
                              read_len=1_000, seed=33, ont=True)
    with open(os.path.join(out, "genome.fasta"), "rb") as fh:
        truth = b"".join(l.strip() for l in fh if not l.startswith(b">"))
    with open(paths[2], "rb") as fh:
        draft = b"".join(l.strip() for l in fh if not l.startswith(b">"))
    return dict(paths=paths, truth=truth, draft=draft)


def _fasta(polished):
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in polished)


_native_consensus = cpu.PoaEngine.consensus


def _marked_consensus(self, window, trim):
    """The native engine's consensus in lower case: the kernel's plain
    version and the native engine agree on every window of this small
    set, so the case is what shows which engine made a window."""
    return _native_consensus(self, window, trim).lower()


def _polish(dataset, env=(), between=None, threads=4, aligner=1,
            mark_cpu=True, attrs=()):
    """One polish through CudaPolisher on the CPU under ``env``, with
    the class attributes ``attrs`` (PIPE_MIN, PIPE_DEPTH, MEGABATCH_CAP)
    set; ``between(pol)`` runs after initialize(); ``mark_cpu``
    lower-cases the native POA engine's consensus.  Each polish starts
    from an empty result cache, as a fresh process would (a cached
    lower-cased consensus must not reach a run that marks nothing).
    Returns (bytes, polisher, the windows as built)."""
    cache.reset()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(env).items():
            mp.setenv(k, v)
        for k, v in dict(attrs).items():
            mp.setattr(CudaPolisher, k, v)
        if mark_cpu:
            mp.setattr(cpu.PoaEngine, "consensus", _marked_consensus)
        pol = create_polisher(*dataset["paths"], PolisherType.kC, 500,
                              10.0, 0.3, True, 5, -4, -8, threads,
                              cuda_poa_batches=1,
                              cuda_aligner_batches=aligner, device="cpu")
        try:
            pol.initialize()
            windows = list(pol.windows)
            if between is not None:
                between(pol)
            out = _fasta(pol.polish(True))
        finally:
            pol.close()
    return out, pol, windows


@pytest.fixture(scope="module")
def staged(dataset):
    return _polish(dataset, {"RACON_TPU_TORCH_PIPELINE": "0"})


# ---------------------------------------------------------------------------
# unit parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_split_boundaries_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 60))
    dev = (rng.gamma(2.0, 1.0, n) * 10 ** rng.uniform(-1, 1)).tolist()
    cpu_costs = (rng.gamma(2.0, 3.0, n)).tolist()
    assert cuda_polisher._rate_split(dev, cpu_costs) \
        == jax_tpu_polisher._rate_split(dev, cpu_costs)
    weights = rng.integers(1, 5000, n).tolist()
    for share in (0.0, 0.1, 0.37, 0.5, 0.9, 1.0):
        assert cuda_polisher._split_cut(weights, share) \
            == jax_tpu_polisher._split_cut(weights, share)


@pytest.mark.parametrize("seed", range(3))
def test_window_ledger_equals_jax(seed):
    """The same registrations, then completions in a shuffled order:
    the same windows become ready with the same ordinal-sorted
    fragments, and the ready queue behaves the same."""
    rng = np.random.default_rng(seed)
    n_win = 24
    regs = []
    for ordinal in range(40):
        lo = int(rng.integers(0, n_win))
        hi = min(n_win - 1, lo + int(rng.integers(0, 4)))
        regs.append((1000 + ordinal, ordinal, lo, hi))
    ledgers = [WindowLedger(n_win), JaxLedger(n_win)]
    for led in ledgers:
        for reg in regs:
            led.register(*reg)
        led.seal()
    order = rng.permutation(len(regs)).tolist()
    order += order[:5]          # repeated completions are no-ops
    for j in order:
        key, ordinal, lo, hi = regs[j]
        frags = [(ordinal, wid, b"ACGT"[wid % 4:] * 3, None, 0, 2)
                 for wid in range(lo, hi + 1) if rng.random() < 0.7]
        got = [led.complete(key, list(frags)) for led in ledgers]
        assert got[0] == got[1]
        for led, newly in zip(ledgers, got):
            led.push_ready([wid for wid, _ in newly])
        cap, min_n = int(rng.integers(1, 4)), int(rng.integers(1, 3))
        assert ledgers[0].pop_ready(cap, min_n) \
            == ledgers[1].pop_ready(cap, min_n)
    assert [led.remaining() for led in ledgers] == [[], []]
    assert ledgers[0].ready_high_water == ledgers[1].ready_high_water
    assert ledgers[0].n_ready() == ledgers[1].n_ready()
    assert ledgers[0].n_completed == ledgers[1].n_completed == len(regs)


def _run_overlaps(rng, n):
    """(fields, runs) of ``n`` random run-carrying overlaps: short and
    long ones (past the single-walk threshold), both strands, soft
    clips, and one with no match at all."""
    out = []
    for k in range(n):
        n_runs = int(rng.integers(1, 400 if k % 5 else 1500))
        codes = rng.choice([7, 8, 1, 2, 0], n_runs,
                           p=[0.6, 0.15, 0.1, 0.1, 0.05])
        lengths = rng.integers(1, 12, n_runs)
        if k == 3:
            codes[:] = 1
        if k % 4 == 1:
            codes = np.concatenate(([4], codes, [4]))
            lengths = np.concatenate(([7], lengths, [5]))
        t_adv = int(lengths[np.isin(codes, (0, 2, 3, 7, 8))].sum())
        q_adv = int(lengths[np.isin(codes, (0, 1, 7, 8))].sum())
        t_begin = int(rng.integers(0, 3000))
        q_begin = int(rng.integers(0, 200))
        fields = dict(t_begin=t_begin, t_end=t_begin + t_adv,
                      q_begin=q_begin, q_end=q_begin + q_adv,
                      q_length=q_begin + q_adv + int(rng.integers(0, 50)),
                      strand=bool(k % 2), is_transmuted=True)
        out.append((fields, (lengths.astype(np.int64),
                             codes.astype(np.int64))))
    return out


def _make(cls, fields, runs):
    o = cls()
    for k, v in fields.items():
        setattr(o, k, v)
    o.cigar_runs = (runs[0].copy(), runs[1].copy())
    return o


@pytest.mark.parametrize("budget", [None, 3000])
def test_batched_decode_equals_jax_and_single(budget):
    rng = np.random.default_rng(7)
    specs = _run_overlaps(rng, 40)
    port = [_make(port_overlap.Overlap, f, r) for f, r in specs]
    jax = [_make(jax_overlap.Overlap, f, r) for f, r in specs]
    single = [_make(port_overlap.Overlap, f, r) for f, r in specs]
    port_overlap.decode_breaking_points_batch(port, 500, budget)
    jax_overlap.decode_breaking_points_batch(jax, 500, budget)
    for o in single:
        o.find_breaking_points_from_cigar(500)
    for p, j, s in zip(port, jax, single):
        assert p.cigar_runs is None and p.breaking_points is not None
        assert np.array_equal(p.breaking_points, j.breaking_points)
        assert np.array_equal(p.breaking_points, s.breaking_points)
    assert sum(len(o.breaking_points) for o in port) > 0
    # budgeted slabs stay under their column budget
    small = [_make(port_overlap.Overlap, f, r) for f, r in specs
             if int(r[0].sum()) < 3000]
    for slab in port_overlap.iter_decode_slabs(small, 3000):
        assert len(slab) == 1 or sum(
            int(o.cigar_runs[0].sum()) for o in slab) <= 3000


@pytest.mark.parametrize("seed", range(4))
def test_native_walk_equals_jax_walk(seed):
    """Every op code (N, S, H, P too), window lengths down to 1, spans
    that end before or after the alignment's last target column and
    runs of length 0: the native walk's points equal the JAX package's
    numpy walk."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(300):
        n = int(rng.integers(0, 60))
        codes = rng.integers(0, 9, n).astype(np.int64)
        lengths = rng.integers(0, 40, n).astype(np.int64)
        t_adv = int(lengths[np.isin(codes, (0, 2, 3, 7, 8))].sum())
        q_adv = int(lengths[np.isin(codes, (0, 1, 7, 8))].sum())
        t_begin = int(rng.integers(0, 300))
        q_begin = int(rng.integers(0, 100))
        fields = dict(
            t_begin=t_begin,
            t_end=t_begin + t_adv + int(rng.choice([0, 0, -3, 5, -t_adv])),
            q_begin=q_begin, q_end=q_begin + q_adv,
            q_length=q_begin + q_adv + int(rng.integers(0, 20)),
            strand=bool(rng.integers(0, 2)), is_transmuted=True)
        w = int(rng.choice([1, 2, 3, 7, 50, 500]))
        port = _make(port_overlap.Overlap, fields, (lengths, codes))
        jax = _make(jax_overlap.Overlap, fields, (lengths, codes))
        port.find_breaking_points_from_cigar(w)
        jax.find_breaking_points_from_cigar(w)
        assert np.array_equal(port.breaking_points, jax.breaking_points)


def test_cigar_string_decodes_as_jax_findall():
    """A CIGAR string (the native aligner's, or anything else) parses
    natively as the JAX package's regex findall does, and its points
    equal the JAX walk's."""
    import re
    find = re.compile(rb"(\d+)([MIDNSHP=X])").findall
    rng = np.random.default_rng(5)
    alphabet = list("0123456789MIDNSHP=XZ* ")
    for _ in range(3000):
        text = "".join(rng.choice(alphabet, int(rng.integers(0, 30))))
        want = [(int(k), b"MIDNSHP=X".index(op))
                for k, op in find(text.encode())]
        lengths, codes = cpu.cigar_runs(text)
        assert list(zip(lengths.tolist(), codes.tolist())) == want
    for _ in range(200):
        ops = rng.choice(list("MIDX="), int(rng.integers(1, 50)))
        counts = rng.integers(1, 20, ops.size)
        cigar = "".join(f"{k}{op}" for k, op in zip(counts, ops))
        t_adv = sum(int(k) for k, op in zip(counts, ops) if op in "MDX=")
        q_adv = sum(int(k) for k, op in zip(counts, ops) if op in "MIX=")
        got = []
        for cls in (port_overlap.Overlap, jax_overlap.Overlap):
            o = cls()
            o.t_begin, o.t_end = 7, 7 + t_adv
            o.q_begin, o.q_end, o.q_length = 0, q_adv, q_adv + 3
            o.strand = bool(t_adv % 2)
            o.cigar = cigar
            o.find_breaking_points_from_cigar(10)
            got.append(o.breaking_points)
        assert np.array_equal(*got)


def test_routed_overlap_is_not_realigned():
    o = port_overlap.Overlap()
    o.is_transmuted = True
    o.breaking_points = port_overlap.ROUTED

    def aligner(q, t):
        raise AssertionError("a routed overlap was aligned again")

    o.find_breaking_points([], 500, aligner=aligner)
    assert o.breaking_points is port_overlap.ROUTED
    assert not port_overlap.ROUTED.flags.writeable


@pytest.fixture()
def calib_dirs(tmp_path, monkeypatch):
    """Each store in its own directory, no pins, no recalibration."""
    monkeypatch.setenv("RACON_TPU_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", str(tmp_path / "port"))
    for stage in ("POA", "ALIGN", "ALIGN_WFA", "ALIGN_CPU"):
        for side in ("DEV", "CPU"):
            monkeypatch.delenv(f"RACON_TPU_RATE_{stage}_{side}",
                               raising=False)
            monkeypatch.delenv(f"RACON_TPU_TORCH_RATE_{stage}_{side}",
                               raising=False)
    for var in ("RACON_TPU_RECALIBRATE", "RACON_TPU_TORCH_RECALIBRATE",
                "RACON_TPU_CALIB_FREEZE", "RACON_TPU_POA_HOST_RESERVE"):
        monkeypatch.delenv(var, raising=False)
    jax_calibrate._reset_drift_for_tests()
    return tmp_path


def _both_get(stage, d, c):
    return (calibrate.get_rates(stage, "cpu", d, c),
            jax_calibrate.get_rates(stage, 1, d, c))


def _both_store(stage, dev, cpu_rate=None, provisional=False):
    calibrate.store_rates(stage, "cpu", dev, cpu_rate,
                          provisional=provisional)
    jax_calibrate.store_rates(stage, 1, dev, cpu_rate,
                              provisional=provisional)


def test_calibrate_semantics_equal_jax(calib_dirs, monkeypatch):
    port, jax = _both_get("poa", 0.3, 2.0)
    assert port == jax == (0.3, 2.0, "default")
    # two passes, then frozen
    for dev, c in ((1000.0, 4.0), (1500.0, 5.0), (5555.0, 9.0)):
        _both_store("align", dev, c)
        port, jax = _both_get("align", 1100.0, 4.0)
        assert port == jax
    assert port == (1500.0, 5.0, "calibrated")
    # provisional samples never freeze and never replace a real one
    for dev in (0.5, 0.7, 0.9):
        _both_store("poa", dev, 2.5, provisional=True)
        port, jax = _both_get("poa", 0.3, 2.0)
        assert port == jax == (dev, 2.5, "calibrated")
    _both_store("poa", 0.2, 1.5)
    _both_store("poa", 0.25, 1.6)
    _both_store("poa", 0.4, 1.7, provisional=True)
    port, jax = _both_get("poa", 0.3, 2.0)
    assert port == jax == (0.25, 1.6, "calibrated")
    # a device-only store takes the stage's CPU default
    _both_store("align_wfa", 321.0)
    port, jax = _both_get("align_wfa", 700.0, 1.0)
    assert port == jax == (321.0, 1.0, "calibrated")
    # RECALIBRATE reads the defaults and overwrites a frozen entry
    monkeypatch.setenv("RACON_TPU_RECALIBRATE", "1")
    monkeypatch.setenv("RACON_TPU_TORCH_RECALIBRATE", "1")
    port, jax = _both_get("align", 1100.0, 4.0)
    assert port == jax == (1100.0, 4.0, "default")
    _both_store("align", 777.0, 3.0)
    monkeypatch.delenv("RACON_TPU_RECALIBRATE")
    monkeypatch.delenv("RACON_TPU_TORCH_RECALIBRATE")
    port, jax = _both_get("align", 1100.0, 4.0)
    assert port == jax == (777.0, 3.0, "calibrated")
    # env pins win over the store
    monkeypatch.setenv("RACON_TPU_RATE_ALIGN_DEV", "11")
    monkeypatch.setenv("RACON_TPU_RATE_ALIGN_CPU", "2.5")
    monkeypatch.setenv("RACON_TPU_TORCH_RATE_ALIGN_DEV", "11")
    monkeypatch.setenv("RACON_TPU_TORCH_RATE_ALIGN_CPU", "2.5")
    port, jax = _both_get("align", 1100.0, 4.0)
    assert port == jax == (11.0, 2.5, "env")
    # each package wrote its own file only
    files = sorted(os.path.relpath(os.path.join(b, n), calib_dirs)
                   for b, _, ns in os.walk(calib_dirs) for n in ns)
    assert files == ["jax/calibration.json", "port/calibration.json"]
    port_doc = json.load(open(calib_dirs / "port" / "calibration.json"))
    jax_doc = json.load(open(calib_dirs / "jax" / "calibration.json"))
    (pkey, pent), = port_doc.items()
    (_, jent), = jax_doc.items()
    assert pkey.startswith(f"cpu-1dev-{os.cpu_count()}cpu-")
    assert pkey.endswith(calibrate._code_salt())
    assert pent == jent


@pytest.mark.parametrize("src", ["env", "calibrated", "default"])
def test_host_reserved_workers_equal_jax(calib_dirs, src):
    """The port's constant reserve is the JAX package's default one."""
    for n in range(0, 34):
        assert calibrate.host_reserved_workers(n, src) \
            == jax_calibrate.host_reserved_workers(n, src)


def test_single_rate_stage_pinned_by_its_dev_rate(calib_dirs, monkeypatch):
    """align_wfa and align_cpu carry one rate: their _DEV variable
    alone pins it, and a two-rate stage still needs both halves."""
    monkeypatch.setenv("RACON_TPU_TORCH_RATE_ALIGN_WFA_DEV", "250")
    monkeypatch.setenv("RACON_TPU_TORCH_RATE_POA_DEV", "0.5")
    assert calibrate.get_rates("align_wfa", "cpu", 700.0) \
        == (250.0, None, "env")
    assert calibrate.get_rates("poa", "cpu", 0.3, 2.0) \
        == (0.3, 2.0, "default")
    calibrate.store_rates("align_cpu", "cpu", 41.5)
    assert calibrate.get_rates("align_cpu", "cpu", 44.0) \
        == (41.5, None, "calibrated")


def test_machine_key_salts_host_modules(tmp_path, monkeypatch):
    """The salt follows the host modules whose code runs inside a
    measured wall, not only the kernels' sources."""
    pkg = tmp_path / "pkg"
    for rel in ("cuda/csrc/a.cu", "cuda/polisher.py", "core/overlap.py",
                "convert.py", "native/align.cpp", "tools/simulate.py"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text(rel)
    monkeypatch.setattr(calibrate, "_PKG", str(pkg))
    salts = [calibrate._code_salt()]
    for rel in ("cuda/polisher.py", "core/overlap.py", "convert.py",
                "native/align.cpp", "cuda/csrc/a.cu"):
        (pkg / rel).write_text(rel + " changed")
        salts.append(calibrate._code_salt())
    assert len(set(salts)) == len(salts)
    # a module outside the measured walls leaves the key alone
    (pkg / "tools/simulate.py").write_text("changed")
    assert calibrate._code_salt() == salts[-1]


def test_empty_cache_dir_stores_nothing(calib_dirs, monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", "")
    calibrate.store_rates("poa", "cpu", 0.5, 1.0)
    assert calibrate.get_rates("poa", "cpu", 0.3, 2.0) \
        == (0.3, 2.0, "default")
    assert not os.path.exists(calib_dirs / "port")
    assert calibrate.predict_chunk_wall("poa", 1000, 0.5) \
        == jax_calibrate.predict_chunk_wall("poa", 1000, 0.5, 1)


def test_unpinned_polish_stores_then_reads_rates(dataset, tmp_path):
    """Without pins a polish measures and stores its rates (the
    single megabatch provisionally), and the next polisher reads them
    as "calibrated".  POA_SPLIT keeps both engines busy whatever the
    default rates say."""
    env = {"RACON_TPU_TORCH_CACHE_DIR": str(tmp_path),
           "RACON_TPU_TORCH_POA_SPLIT": "0.5"}
    with pytest.MonkeyPatch.context() as mp:
        for k in PINS:
            mp.delenv(k)
        _, pol, _ = _polish(dataset, env, aligner=0)
        assert pol.poa_split_detail["rate_source"] == "default"
        doc = json.load(open(tmp_path / "calibration.json"))
        (key, ent), = doc.items()
        assert key.startswith("cpu-")
        assert ent["poa"]["provisional"] is True
        assert ent["poa"]["dev"] > 0 and ent["poa"]["cpu"] > 0
        mp.setenv("RACON_TPU_TORCH_CACHE_DIR", str(tmp_path))
        assert calibrate.get_rates("poa", "cpu", 1.0, 1.0) == (
            ent["poa"]["dev"], ent["poa"]["cpu"], "calibrated")


# ---------------------------------------------------------------------------
# slice invariants
# ---------------------------------------------------------------------------

@pytest.fixture()
def spec_drained():
    """Hold the align stage's end until the speculative consumer has
    taken every window it may take (fewer than PIPE_MIN = 2 left), so
    that speculation surely ran before the stage."""
    orig = CudaPolisher._pipeline_align_done

    def done(self):
        for _ in range(3000):
            if self._ledger.n_ready() < 2 and self.poa_spec_megabatches:
                break
            threading.Event().wait(0.01)
        return orig(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CudaPolisher, "_pipeline_align_done", done)
        yield


def test_pipeline_on_off_byte_identical(dataset, staged, spec_drained):
    out, pol, _ = _polish(dataset, attrs={"PIPE_MIN": 2})
    assert out == staged[0] and out.count(b">") == 1
    # both engines made windows of it
    seq = out.split(b"\n")[1]
    assert seq != seq.lower() and seq != seq.upper()
    spol = staged[1]
    # both splits are real at these rates, and the same both ways
    for p in (pol, spol):
        a, c = p.align_split_detail, p.poa_split_detail
        assert a["mode"] == c["mode"] == "rate_model"
        assert 0 < a["cut"] < a["n_pending"]
        assert 0 < c["cut"] < c["n_eligible"] == p.poa_eligible_windows
        assert p.align_cpu_tail == a["n_pending"] - a["cut"]
    assert pol.align_split_detail == spol.align_split_detail
    assert pol.poa_split_detail == spol.poa_split_detail
    # the seam ran: speculative results adopted, the rest recomputed
    assert pol.poa_spec_used > 0 and pol.poa_spec_megabatches > 0
    assert pol.ready_high_water > 0 and pol.pipeline_overlap_s >= 0
    assert spol.poa_spec_used == 0 and spol.ready_high_water == 0
    assert set(pol.stage_walls) >= {"parse", "align", "windows", "poa"}


def test_pipeline_timing_jitter_cannot_move_bytes(dataset, staged):
    """Megabatches of 4 windows, speculative takes of 2, three
    megabatches in flight and frequent thread switches: two runs, both
    equal to the staged bytes."""
    jitter = {"MEGABATCH_CAP": 4, "PIPE_MIN": 2, "PIPE_DEPTH": 3}
    interval = sys.getswitchinterval()
    # threads switch far more often than by default
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(2):
            out, pol, _ = _polish(dataset, attrs=jitter)
            assert out == staged[0]
            assert pol.poa_batch_size == 4
    finally:
        sys.setswitchinterval(interval)


def test_forced_splits_send_work_to_their_engines(dataset):
    """ALIGN_SPLIT / POA_SPLIT: every CPU-assigned overlap's breaking
    points are the native aligner's, every CPU-assigned window's
    consensus the native engine's, every device-assigned window's the
    POA kernel's plain version."""
    points, tail = {}, []
    orig_notify = CudaPolisher._notify_overlap_done
    orig_tail = CudaPolisher._cpu_tail_align

    def notify(self, o):
        if o.breaking_points is not None \
                and o.breaking_points is not port_overlap.ROUTED:
            points[id(o)] = np.array(o.breaking_points)
        orig_notify(self, o)

    def tail_align(self, o):
        tail.append(o)
        orig_tail(self, o)

    def check_overlaps(pol):
        assert len(tail) == pol.align_cpu_tail > 0
        for o in tail:
            fresh = copy.copy(o)
            fresh.breaking_points = None
            fresh.cigar, fresh.cigar_runs = "", None
            fresh.find_breaking_points(pol.sequences, 500,
                                       aligner=cpu.align)
            assert np.array_equal(points[id(o)], fresh.breaking_points)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CudaPolisher, "_notify_overlap_done", notify)
        mp.setattr(CudaPolisher, "_cpu_tail_align", tail_align)
        _, pol, windows = _polish(
            dataset, {"RACON_TPU_TORCH_ALIGN_SPLIT": "0.5",
                      "RACON_TPU_TORCH_POA_SPLIT": "0.3"},
            between=check_overlaps, attrs={"PIPE_MIN": 2})
    assert pol.align_split_detail["mode"] == "env_split"
    detail = pol.poa_split_detail
    assert detail["mode"] == "env_split"
    eligible = sorted((i for i, w in enumerate(windows)
                       if len(w.sequences) >= 3),
                      key=lambda i: -len(windows[i].sequences))
    cut = detail["cut"]
    assert 0 < cut < len(eligible)
    native = cpu.PoaEngine(5, -4, -8)
    plain = CudaPoaBatchEngine(5, -4, -8, device="cpu", vcap=2048,
                               lcap=1024)
    for i in eligible[cut:]:
        assert windows[i].consensus \
            == native.consensus(windows[i], True).lower()
    for i in eligible[:cut]:
        (cons, _), = plain.consensus_batch([windows[i]], True)
        want = cons if cons is not None \
            else native.consensus(windows[i], True).lower()
        assert windows[i].consensus == want


def test_over_length_pairs_on_workers_equal_the_pass_after(dataset):
    """With CPU workers, the pairs past MAX_ALIGN_DIM are aligned beside
    the ladder; the FASTA equals the one where they wait for the pass
    after it (ALIGN_DEVICE_ONLY), the card taking every other pair in
    both runs."""
    attrs = {"MAX_ALIGN_DIM": 1200}
    beside, pol, _ = _polish(dataset, {"RACON_TPU_TORCH_ALIGN_SPLIT": "1"},
                             attrs=attrs)
    after, ref, _ = _polish(
        dataset, {"RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "1"}, attrs=attrs)
    detail = pol.align_split_detail
    assert detail["cut"] == detail["n_pending"]
    assert detail["n_over_length_on_workers"] == pol.align_over_length > 0
    assert ref.align_split_detail["n_over_length_on_workers"] == 0
    assert ref.align_over_length == pol.align_over_length
    assert beside == after


def test_default_polish_within_jax_tolerance(dataset):
    """The port's defaults (pipeline on, both splits) against the JAX
    package's CPU polish: the tolerance of tests/test_torch_slice.py."""
    out, pol, _ = _polish(dataset, mark_cpu=False)
    assert pol.poa_split_detail["mode"] == "rate_model"
    data = out.split(b"\n")[1]
    ref = jax_polisher.create_polisher(
        *dataset["paths"], jax_polisher.PolisherType.kC, 500, 10.0, 0.3,
        True, 5, -4, -8, 4)
    ref.initialize()
    (jax_seq,) = ref.polish(True)
    ref.close()
    d_port = cpu.edit_distance(data, dataset["truth"])
    d_jax = cpu.edit_distance(jax_seq.data, dataset["truth"])
    assert d_port < cpu.edit_distance(dataset["draft"], dataset["truth"])
    assert d_port <= 1.1 * d_jax + 10


@pytest.mark.parametrize("where", ["dispatch", "collect"])
def test_consumer_error_reaches_the_caller(dataset, where):
    """A fault in the speculative consumer's launch raises from
    initialize(); one in its collect, recorded after the align stage
    ended, raises from polish() once the stage has joined the
    consumer.  Neither becomes a CPU re-polish."""
    launched = threading.Event()
    align_done = threading.Event()
    orig_async = CudaPoaBatchEngine.consensus_batch_async
    orig_done = CudaPolisher._pipeline_align_done
    holder = {}

    def faulty(self, windows, trim, **kw):
        if threading.current_thread().name != "racon-torch-poa-stream":
            return orig_async(self, windows, trim, **kw)
        if where == "dispatch":
            launched.set()
            raise RuntimeError("injected dispatch fault")
        launched.set()

        def collect():
            align_done.wait(30)
            raise RuntimeError("injected collect fault")

        return collect

    def done(self):
        holder["pol"] = self
        # hold the align stage's end until the consumer has launched
        # (and, for a launch fault, recorded it)
        assert launched.wait(30)
        if where == "dispatch":
            for _ in range(3000):
                with self._stream_lock:
                    if self._stream_errors:
                        break
                threading.Event().wait(0.01)
        errs = orig_done(self)
        align_done.set()
        return errs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CudaPoaBatchEngine, "consensus_batch_async", faulty)
        mp.setattr(CudaPolisher, "_pipeline_align_done", done)
        mp.setattr(CudaPolisher, "PIPE_MIN", 1)
        pol = create_polisher(*dataset["paths"], PolisherType.kC, 500,
                              10.0, 0.3, True, 5, -4, -8, 4,
                              cuda_poa_batches=1, device="cpu")
        try:
            if where == "dispatch":
                with pytest.raises(RuntimeError, match="injected dispatch"):
                    pol.initialize()
            else:
                pol.initialize()
                with pytest.raises(RuntimeError, match="injected collect"):
                    pol.polish(True)
                assert "cpu_repolish" not in pol.stage_walls
        finally:
            pol.close()
    assert holder["pol"] is pol and pol._consumer is None

