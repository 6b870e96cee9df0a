"""The port's scan align ladder (racon_tpu_torch/cuda/aligner.py,
cuda/csrc/align_scan.cu, ``CudaPolisher._scan_align``) against the JAX
package's (racon_tpu/tpu/aligner.py: ``_align_kernel``,
``_banded_align_kernel``, ``band_align_batch``, ``TPUBatchAligner``;
racon_tpu/tpu/polisher.py: ``_hybrid_scan_align``, ``_align_chunk``).

Kernels: the plain versions and the JAX kernels (jitted on the JAX CPU
backend) on the same seeded pairs give equal op tapes on every lane,
tolerance 0: random pairs of 0-300 bases, unequal lengths and bucket
dims, identical pairs, N bases, the constructed edge pairs of
tools/scan_pairs.py, padding lanes and (banded, at odd and even
half-widths) lanes past their band.  Ladder: ``band_align_batch`` gives
the JAX one's ops, cells and unresolved lanes, with and without the
unbanded kernel, at lowered rungs and a budget that chunks every rung.
End to end: the CLI with RACON_TPU_TORCH_SCAN_ALIGN=1 writes the JAX
CLI's bytes (no Pallas on the JAX CPU backend, so it takes its scan
ladder), all on the device and at the default split, and with
RACON_TPU_TORCH_PORTABLE=1 and -c 1 (every POA megabatch on the
lockstep engine on both sides).  The WFA gates of the default ladder
(RACON_TPU_TORCH_WFA, RACON_TPU_TORCH_WFA_EMAX) close last.  The JAX
package is imported inside the tests only, so ``pytest -m cuda`` on the
card imports no JAX; the ``cuda`` test holds the kernels against their
plain versions there.
"""

import io
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from racon_tpu_torch import cache, cli
from racon_tpu_torch.cache import keying
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.cuda.polisher import CudaPolisher
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.tools.scan_pairs import mutate, scan_pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions' small tensor ops on one intra-op thread, and
    no calibration store read or written."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RACON_TPU_TORCH_CACHE_DIR", "")
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def cold_result_cache():
    cache.reset()
    yield
    cache.reset()


def _pairs(seed: int, n: int, max_len: int):
    """``n`` seeded pairs of 0..max_len bases (identical, mutated at
    3-30%, unrelated) and the constructed edge pairs."""
    rng = random.Random(seed)
    qs, ts = [], []
    for k in range(n):
        s = bytes(rng.choice(b"ACGTN" if k % 5 == 0 else b"ACGT")
                  for _ in range(rng.randint(0, max_len)))
        kind = k % 4
        if kind == 0:
            t = s
        elif kind == 3:
            t = bytes(rng.choice(b"ACGT")
                      for _ in range(rng.randint(0, max_len)))
        else:
            t = mutate(s, (0.03, 0.3)[kind - 1], rng)[:max_len]
        qs.append(s)
        ts.append(t)
    eq, et = scan_pairs(rng, max_len // 2)
    return qs + eq, ts + et


def _batch(qs, ts, lq=None, lt=None, pad_lanes: int = 2):
    """Encoded arrays (numpy) at dims lq, lt (default: the longest
    side), with ``pad_lanes`` padding lanes (ql = tl = 0) at the end."""
    qs = list(qs) + [b""] * pad_lanes
    ts = list(ts) + [b""] * pad_lanes
    lq = lq or max(1, max(map(len, qs)))
    lt = lt or max(1, max(map(len, ts)))
    return (al.encode_batch(qs, lq, al.QPAD), al.encode_batch(ts, lt, al.TPAD),
            np.array([len(s) for s in qs], np.int32),
            np.array([len(s) for s in ts], np.int32))


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _cost(ops):
    return ((ops != al.OP_STOP) & (ops != al.OP_EQ)).sum(axis=1)


# ---------------------------------------------------------------------------
# kernels: plain versions == the JAX kernels, every lane
# ---------------------------------------------------------------------------

def _edge_pairs(seed: int):
    """Pairs at the full kernel's edges: queries of 0, 1, 31-33, 63-65
    and 1,023-1,025 bases (a lane's 64-row word, a warp's 32 words
    ends a stripe of 2,048 rows) against short targets, N bases, and
    repeats whose alignments tie between diagonal, up and left."""
    rng = random.Random(seed)

    def seq(n, alphabet=b"ACGT"):
        return bytes(rng.choice(alphabet) for _ in range(n))

    qs, ts = [], []
    for n in (0, 1, 31, 32, 33, 63, 64, 65, 1023, 1024, 1025):
        s = seq(n, b"ACGTN" if n % 2 else b"ACGT")
        qs += [s, s]
        ts += [mutate(s[:70], 0.15, rng), seq(rng.randint(0, 40))]
    for n in (7, 33, 65):
        qs += [b"AC" * n, b"A" * n, b"ACGTN" * (n // 5 + 1)]
        ts += [b"CA" * (n + 2), b"A" * (n // 2) + b"C" + b"A" * (n // 3),
               b"NACGT" * (n // 5)]
    return qs, ts


@pytest.mark.parametrize("seed,max_len,square", [(1, 40, False),
                                                 (2, 120, True),
                                                 (3, 300, False),
                                                 (4, 0, False)])
def test_full_plain_equals_jax(seed, max_len, square):
    """max_len 0: the kernel's edge pairs (``_edge_pairs``)."""
    from racon_tpu.tpu import aligner as ja

    qs, ts = _pairs(seed, 14, max_len) if max_len else _edge_pairs(seed)
    dim = max(map(len, qs + ts))
    arrs = _batch(qs, ts, *((dim, dim) if square else ()))
    lq, lt = arrs[0].shape[1], arrs[1].shape[1]
    want = np.asarray(ja._align_kernel(*arrs, lq, lt))
    got = al.align_full_plain(*_torch(arrs)).numpy()
    assert got.shape == (len(qs) + 2, lq + lt)
    assert np.array_equal(got, want)
    # the unbanded tape is an optimal alignment; padding lanes are empty
    for k in range(len(qs)):
        assert _cost(got[k:k + 1])[0] == cpu.edit_distance(qs[k], ts[k])
    assert not got[-2:].any()


@pytest.mark.parametrize("hw", [1, 2, 7, 16, 33, 64])
def test_banded_plain_equals_jax(hw):
    from racon_tpu.tpu import aligner as ja

    qs, ts = _pairs(4, 14, 160)
    arrs = _batch(qs, ts)
    lq, lt = arrs[0].shape[1], arrs[1].shape[1]
    want = np.asarray(ja._banded_align_kernel(*arrs, lq, lt, hw))
    got = al.align_banded_plain(*_torch(arrs), hw).numpy()
    assert np.array_equal(got, want)
    ql, tl = arrs[2].astype(int), arrs[3].astype(int)
    past = (np.abs(ql - tl) > hw) | (_cost(got) > hw)
    assert past.any()                         # lanes past their band
    # an in-band lane's tape is exact (the Ukkonen certificate)
    for k in np.flatnonzero(~past[:len(qs)]):
        assert _cost(got[k:k + 1])[0] == cpu.edit_distance(qs[k], ts[k])


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions; a bad input
    raises before anything runs."""
    arrs = _torch(_batch(*_pairs(5, 6, 50)))
    assert torch.equal(al.align_full(*arrs), al.align_full_plain(*arrs))
    assert torch.equal(al.align_banded(*arrs, 9),
                       al.align_banded_plain(*arrs, 9))
    with pytest.raises(ValueError):
        al.align_banded(*arrs, 0)
    with pytest.raises(ValueError):
        al.align_full(arrs[0], arrs[1], arrs[2].long(), arrs[3])


def test_buffers_of_another_launch_raise():
    """Buffers sized for one launch are refused by another: the
    direction tape's size follows b, lq, lt and hw, so a launch into a
    smaller tape would write past it."""
    from racon_tpu_torch.cuda import build

    arrs = _torch(_batch(*_pairs(5, 4, 40)))
    b, lq, lt = int(arrs[0].shape[0]), arrs[0].shape[1], arrs[1].shape[1]
    before = build.launch_counts()["align_scan_band"]
    for key in ((b, lq, lt, 8), (2 * b, lq, lt, 9), (b, lq, lt + 1, 9)):
        bufs = al.scan_buffers(*key, "cpu")
        with pytest.raises(ValueError, match="do not fit"):
            al._launch(*arrs, 9, "align_scan_band", bufs)
    assert build.launch_counts()["align_scan_band"] == before


def test_a_failed_launch_raises_and_counts_nothing(monkeypatch):
    """A launch the library refuses raises with its error string, no
    launch is counted and no plain version runs in its place (a stand-in
    library and stream on CPU tensors: the wrapper itself sends a CUDA
    tensor here and a CPU one to the plain version)."""
    import contextlib
    import types

    from racon_tpu_torch.cuda import build

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    class Refusing:
        def align_scan_launch(self, *args):
            return 1

        def align_scan_error_string(self, err):
            return b"invalid argument"

    arrs = _torch(_batch(*_pairs(5, 4, 40)))
    b, lq, lt = int(arrs[0].shape[0]), arrs[0].shape[1], arrs[1].shape[1]
    bufs = al.scan_buffers(b, lq, lt, 9, "cpu")
    bufs.update(lib=Refusing(), dirs=torch.empty(64, dtype=torch.uint8))
    before = build.launch_counts()["align_scan_band"]
    with pytest.raises(RuntimeError, match="invalid argument"):
        al._launch(*arrs, 9, "align_scan_band", bufs)
    assert build.launch_counts()["align_scan_band"] == before
    assert not bufs["ops"].any()


# ---------------------------------------------------------------------------
# the ladder and the batched aligner == the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("allow_full", [True, False])
@pytest.mark.parametrize("need_ratio", [0.05, 0.2])
def test_band_align_batch_equals_jax(monkeypatch, allow_full, need_ratio):
    """Rungs 16 and 48 under a 128-base bucket: the narrow rung retries,
    the last one leaves the unrelated pairs to the unbanded kernel
    (allow_full) or to the caller; a 1.5 kB budget chunks every rung."""
    from racon_tpu.tpu import aligner as ja

    monkeypatch.setattr(al, "BAND_LADDER", (16, 48))
    monkeypatch.setattr(ja, "BAND_LADDER", (16, 48))
    rng = random.Random(6)
    qs, ts = [], []
    for k in range(20):
        s = bytes(rng.choice(b"ACGT") for _ in range(rng.randint(20, 120)))
        qs.append(s)
        ts.append(mutate(s, (0.02, 0.1, 0.3)[k % 4], rng)[:128] if k % 4 < 3
                  else bytes(rng.choice(b"ACGT") for _ in range(128)))
    qs.append(b"")
    ts.append(b"ACGT")
    kw = dict(allow_full=allow_full, mem_budget=1536, need_ratio=need_ratio)
    stats = {}
    got = al.band_align_batch(qs, ts, 128, 128, stats=stats, **kw)
    want = ja.band_align_batch(qs, ts, 128, 128, **kw)
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert np.array_equal(got[2], want[2])
    assert stats["align_scan_band"]["launches"] > 2      # chunked rungs
    if allow_full:
        assert len(got[2]) == 0 and stats["align_scan_full"]["launches"]
    else:
        assert len(got[2]) > 0 and "align_scan_full" not in stats


@pytest.mark.parametrize("chunk", ["one", "two", "all"])
@pytest.mark.parametrize("allow_full", [True, False])
def test_band_align_batch_chunk_and_order_free(monkeypatch, chunk,
                                               allow_full):
    """A lane's tape and whether it is resolved do not depend on the
    chunk it rides in or on its place in the batch: ``mem_budget`` at
    one lane a launch, two at the wider rung (four at the narrow one),
    or every lane in one launch, with the lanes in order and permuted,
    all give the tapes and unresolved set of the one-launch run."""
    monkeypatch.setattr(al, "BAND_LADDER", (16, 48))
    qs, ts = _pairs(12, 20, 110)
    qs, ts = qs[:21], ts[:21]
    per_lane = 256 * ((48 + 5) // 4)
    budget = {"one": 1, "two": 2 * per_lane, "all": 1 << 30}[chunk]
    ref = al.band_align_batch(qs, ts, 128, 128, allow_full=allow_full,
                              mem_budget=1 << 30, need_ratio=0.05)
    perm = np.random.default_rng(4).permutation(len(qs))
    for order in (np.arange(len(qs)), perm):
        stats = {}
        got = al.band_align_batch([qs[k] for k in order],
                                  [ts[k] for k in order], 128, 128,
                                  allow_full=allow_full, mem_budget=budget,
                                  need_ratio=0.05, stats=stats)
        assert np.array_equal(got[0], ref[0][order])
        assert sorted(order[got[2]].tolist()) == sorted(ref[2].tolist())
        if chunk == "one":
            assert stats["align_scan_band"]["launches"] > 2 * 2
    # the unrelated pairs pass the last rung: the unbanded kernel takes
    # them, or they come back unresolved
    assert (len(ref[2]) == 0) == allow_full


@pytest.mark.parametrize("ladder", [None, (8, 32)], ids=["stock", "low"])
def test_batch_aligner_equals_jax(monkeypatch, ladder):
    from racon_tpu.tpu import aligner as ja

    if ladder:
        monkeypatch.setattr(al, "BAND_LADDER", ladder)
        monkeypatch.setattr(ja, "BAND_LADDER", ladder)
    qs, ts = _pairs(7, 12, 200)
    ours = al.CudaBatchAligner(256, 256, 64, device="cpu")
    ref = ja.TPUBatchAligner(256, 256, 64)
    for q, t in zip(qs, ts):
        assert ours.add(q, t) == ref.add(q, t)
    assert not ours.add(b"A" * 257, b"A")
    ours.align_all()
    ref.align_all()
    assert ours.cigars() == ref.cigars()
    assert np.array_equal(ours.distances, ref.distances)
    pairs = list(zip(qs, ts))[:8]
    assert al.align_pairs(pairs, device="cpu") == ja.align_pairs(pairs)


# ---------------------------------------------------------------------------
# end to end: the CLI == the JAX package's CLI
# ---------------------------------------------------------------------------

_RUNS = {
    # name: (port knobs, JAX knobs, flags)
    "device_only": ({"RACON_TPU_TORCH_SCAN_ALIGN": "1",
                     "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "1"},
                    {"RACON_TPU_ALIGN_DEVICE_ONLY": "1"}, []),
    "split": ({"RACON_TPU_TORCH_SCAN_ALIGN": "1"}, {}, []),
    "portable": ({"RACON_TPU_TORCH_PORTABLE": "1",
                  "RACON_TPU_TORCH_POA_DEVICE_ONLY": "1"},
                 {"RACON_TPU_POA_DEVICE_ONLY": "1"}, ["-c", "1"]),
}


@pytest.fixture(scope="module")
def scan_set(tmp_path_factory):
    from racon_tpu.tools import simulate

    out = tmp_path_factory.mktemp("scan_set")
    return simulate.simulate(str(out), genome_len=3000, coverage=6,
                             read_len=1000, seed=4, ont=True)


@pytest.fixture(scope="module")
def jax_runs(scan_set):
    """The JAX CLI of every run, started together (each ``-t 3``,
    ``--tpualigner-batches 1``, the JAX CPU backend, pipeline off);
    ``jax_runs[name]()`` waits for its FASTA."""
    procs = {}
    for name, (_, knobs, flags) in _RUNS.items():
        env = dict(os.environ, JAX_PLATFORMS="cpu", RACON_TPU_PIPELINE="0",
                   PYTHONPATH=ROOT, **knobs)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "racon_tpu.cli", "-t", "3", *flags,
             "--tpualigner-batches", "1", *scan_set], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def waiter(name):
        def wait():
            out, err = procs[name].communicate()
            assert procs[name].returncode == 0, err.decode()[-2000:]
            return out
        return wait

    yield {name: waiter(name) for name in procs}
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _port_run(name, scan_set, monkeypatch, reset=True):
    knobs, _, flags = _RUNS[name]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("RACON_TPU_TORCH_PIPELINE", "0")
    if reset:
        cache.reset()
    buf = io.BytesIO()
    pol = cli.main(["--device", "cpu", "-t", "3", *flags,
                    "--cudaaligner-batches", "1", *scan_set], out=buf)
    return pol, buf.getvalue()


def test_scan_device_only_writes_jax_bytes(scan_set, jax_runs, monkeypatch):
    """Every eligible pair on the scan ladder: its plain kernels, no WFA
    or band rung, and the JAX CLI's bytes."""
    pol, out = _port_run("device_only", scan_set, monkeypatch)
    assert out.startswith(b">") and out == jax_runs["device_only"]()
    assert pol.align_rungs == {} and pol.align_split_detail["cut"] \
        == pol.align_eligible > 0
    assert pol.align_dispatches["align_scan_band"] > 0
    assert pol.align_dispatches["align_wfa"] == 0
    assert pol.align_cells == sum(pol.align_kernel_cells.values()) > 0



def test_scan_default_split_writes_jax_bytes(scan_set, jax_runs,
                                             monkeypatch):
    pol, out = _port_run("split", scan_set, monkeypatch)
    assert out == jax_runs["split"]()
    cut = pol.align_split_detail["cut"]
    assert 0 < cut < pol.align_eligible
    assert pol.align_cpu_tail == pol.align_eligible - cut


def test_portable_writes_jax_bytes(scan_set, jax_runs, monkeypatch):
    """-c 1 with RACON_TPU_TORCH_PORTABLE=1: the scan ladder and every
    POA megabatch on the lockstep engine, the JAX CLI's bytes with
    -c 1 on its CPU backend (which runs its lockstep engine)."""
    pol, out = _port_run("portable", scan_set, monkeypatch)
    assert out == jax_runs["portable"]()
    assert pol.metrics.value("poa_rounds") > 0
    assert pol.poa_engine.n_rounds == pol.metrics.value("poa_rounds")
    assert pol.align_rungs == {}
    assert pol.align_dispatches["align_scan_band"] > 0


def test_portable_engine_is_lockstep_only():
    """The polisher reads RACON_TPU_TORCH_PORTABLE once and asks the
    executor for a lockstep-only engine: a configuration of its own,
    beside the default one, whose ``fits_depth`` is false at every
    depth while the default engine's is true at a shallow one."""
    from racon_tpu_torch.cuda.executor import DeviceExecutor
    from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine

    assert not CudaPoaBatchEngine(5, -4, -8, device="cpu",
                                  lockstep_only=True).fits_depth(8)
    ex = DeviceExecutor()
    kw = dict(vcap=2048, pcap=16, lcap=1024, max_depth=200, banded=False,
              device="cpu")
    default = ex.poa_handle(5, -4, -8, **kw)
    lockstep = ex.poa_handle(5, -4, -8, lockstep_only=True, **kw)
    assert default.fits_depth(8) and not lockstep.fits_depth(8)
    assert default.cfg_key != lockstep.cfg_key
    assert ex.poa_handle(5, -4, -8, **kw).cfg_key == default.cfg_key


def test_second_run_is_served_by_scan_keys(scan_set, monkeypatch):
    """A second in-process run finds every scan_key: no ladder call, the
    same bytes."""
    keys, calls = [], []
    orig_key, orig_ladder = keying.scan_key, al.band_align_batch

    def key_spy(*a, **kw):
        keys.append(orig_key(*a, **kw))
        return keys[-1]

    def ladder_spy(*a, **kw):
        calls.append(1)
        return orig_ladder(*a, **kw)

    monkeypatch.setattr(keying, "scan_key", key_spy)
    monkeypatch.setattr(al, "band_align_batch", ladder_spy)
    pol1, out1 = _port_run("device_only", scan_set, monkeypatch)
    n1, c1 = len(keys), len(calls)
    assert n1 == pol1.align_eligible > 0 and c1 > 0
    pol2, out2 = _port_run("device_only", scan_set, monkeypatch,
                           reset=False)
    assert out2 == out1
    assert keys[n1:] == keys[:n1]
    assert len(calls) == c1
    assert pol2.align_dispatches["align_scan_band"] == 0


# ---------------------------------------------------------------------------
# the default ladder's WFA gates
# ---------------------------------------------------------------------------

def _ladder_run(paths, monkeypatch, **env):
    """The ladder on ``paths`` (no -c); returns (polisher, each pair's
    CIGAR ops as a string by (query id, target id), as the ladder and
    its CPU tail left them)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    code = {0: "M", 1: "I", 2: "D", 7: "=", 8: "X"}
    runs = {}
    orig = CudaPolisher._device_align_overlaps

    def capture(self, overlaps):
        orig(self, overlaps)
        for o in overlaps:
            if o.cigar_runs is not None:
                lengths, codes = o.cigar_runs
                runs[(o.q_id, o.t_id)] = (
                    o.query_span(self.sequences),
                    o.target_span(self.sequences),
                    "".join(code[int(c)] * int(n)
                            for n, c in zip(lengths, codes)))

    monkeypatch.setattr(CudaPolisher, "_device_align_overlaps", capture)
    cache.reset()
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, 2, cuda_aligner_batches=1,
                          device="cpu")
    pol.initialize()
    pol.close()
    return pol, runs


@pytest.fixture(scope="module")
def ladder_set(tmp_path_factory):
    from tests.test_torch_align_slice import _write_set

    return _write_set(str(tmp_path_factory.mktemp("wfa_gate")),
                      np.random.default_rng(3))


@pytest.mark.parametrize("gate", ["wfa_off", "emax_256"])
def test_wfa_gates(ladder_set, monkeypatch, gate):
    """RACON_TPU_TORCH_WFA=0: band rungs only, every certified CIGAR at
    the native engine's distance; RACON_TPU_TORCH_WFA_EMAX=256: the WFA
    rungs up to 256 alone.  Rungs lowered as in
    tests/test_torch_align_slice.py."""
    monkeypatch.setattr(CudaPolisher, "WFA_RUNGS", (256, 512))
    monkeypatch.setattr(CudaPolisher, "BAND_RUNGS", (1024, 2048))
    monkeypatch.setattr(CudaPolisher, "PROBE_EVERY", 1)
    monkeypatch.setattr(CudaPolisher, "PROBE_MIN", 4)
    env = ({"RACON_TPU_TORCH_WFA": "0"} if gate == "wfa_off"
           else {"RACON_TPU_TORCH_WFA_EMAX": "256"})
    pol, runs = _ladder_run(ladder_set, monkeypatch, **env)
    rungs = set(pol.align_rungs)
    if gate == "wfa_off":
        assert rungs and all(r.startswith("band") for r in rungs)
        assert pol.align_dispatches["align_wfa"] == 0
    else:
        assert "wfa256" in rungs and "wfa512" not in rungs
    certified = sum(r["certified"] for r in pol.align_rungs.values())
    assert certified > 0 and len(runs) >= certified
    for q, t, ops in runs.values():
        assert len(ops) - ops.count("=") == cpu.edit_distance(q, t)


def test_wfa_gates_at_their_defaults_change_nothing(ladder_set,
                                                    monkeypatch):
    """The gates set to their defaults run the unset ladder: the same
    rungs and the same CIGARs."""
    monkeypatch.setattr(CudaPolisher, "WFA_RUNGS", (256, 512))
    monkeypatch.setattr(CudaPolisher, "BAND_RUNGS", (1024, 2048))
    monkeypatch.delenv("RACON_TPU_TORCH_WFA", raising=False)
    monkeypatch.delenv("RACON_TPU_TORCH_WFA_EMAX", raising=False)
    base, base_runs = _ladder_run(ladder_set, monkeypatch)
    pol, runs = _ladder_run(ladder_set, monkeypatch, RACON_TPU_TORCH_WFA="1",
                            RACON_TPU_TORCH_WFA_EMAX="2048")
    assert pol.align_rungs == base.align_rungs
    assert any(r.startswith("wfa") for r in base.align_rungs)
    assert runs == base_runs


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Both scan kernels against their plain versions on the card, on
    the seeded and constructed pairs, at odd and even half-widths, at
    full-kernel rows of 18,000 and 20,000 columns, on the full kernel's
    edge pairs and on queries past one stripe (needs a GPU and nvcc; run
    with ``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from racon_tpu_torch.cuda import build

    build.zero_launch_counts()
    qs, ts = _pairs(8, 30, 600)
    arrs = [a.cuda() for a in _torch(_batch(qs, ts))]
    for hw in (0, 1, 7, 64, 513):
        got = al.align_banded(*arrs, hw) if hw else al.align_full(*arrs)
        ref = (al.align_banded_plain(*arrs, hw) if hw
               else al.align_full_plain(*arrs))
        assert torch.equal(got, ref), hw
    # rows of 18,000 and 20,000 columns (a long target: the tape's
    # diagonal-major rows, the traceback's windows along it)
    long_q = [bytes(random.Random(9).choice(b"ACGT") for _ in range(300))]
    for lt in (18000, 20000):
        arrs = [a.cuda() for a in _torch(_batch(long_q, long_q, 320, lt,
                                                pad_lanes=1))]
        assert torch.equal(al.align_full(*arrs),
                           al.align_full_plain(*arrs)), lt
    # the full kernel's edges: queries of 0, 1, 31-33, 63-65 and
    # 1,023-1,025 bases, N bases and tie-heavy repeats; then queries past
    # one stripe of 2,048 rows (2,049 and 4,100 bases), whose stripes
    # hand over through the tape
    for seed in (4, 6):
        arrs = [a.cuda() for a in _torch(_batch(*_edge_pairs(seed)))]
        assert torch.equal(al.align_full(*arrs),
                           al.align_full_plain(*arrs)), seed
    rng = random.Random(10)
    long_qs = [bytes(rng.choice(b"ACGT") for _ in range(n))
               for n in (2_049, 4_100)]
    long_ts = [mutate(s, 0.1, rng)[:1_500] for s in long_qs]
    arrs = [a.cuda() for a in _torch(_batch(long_qs, long_ts))]
    assert torch.equal(al.align_full(*arrs), al.align_full_plain(*arrs))
    counts = build.launch_counts()
    assert counts["align_scan_full"] == 6
    assert counts["align_scan_band"] == 4
    # a band past the kernel's widest (a cluster of 8 blocks of 16
    # warps) raises; nothing runs in its place
    with pytest.raises(ValueError, match="past the banded kernel"):
        al.align_banded(*arrs, 1 << 16)
    assert build.launch_counts()["align_scan_band"] == 4


def _card_set(hw: int, seed: int):
    """Pairs for the banded kernel on the card at half-width ``hw``: a
    0-length and a 1-base lane, lengths of every residue modulo the 9
    slots a thread (and modulo 17) and around multiples of a warp's 288,
    mutated at 2-12%, and lanes past the band (unrelated, or lengths
    apart by more than hw)."""
    rng = random.Random(seed)

    def seq(n):
        return bytes(rng.choice(b"ACGT") for _ in range(n))

    lens = [17 * 9 + r for r in range(17)] + [288 * m + r for m in (1, 2)
                                              for r in (0, 1, 8, 9, 33)]
    qs = [b"", b"A", b"", b"C"]
    ts = [seq(40), b"A", b"", b"G"]
    for n in lens:
        s = seq(n)
        qs.append(s)
        ts.append(mutate(s, rng.choice((0.02, 0.06, 0.12)), rng))
    past = max(hw + 40, 300)
    qs += [seq(300), seq(past + 200), seq(120)]
    ts += [seq(310), seq(90), seq(past + 120)]
    return qs, ts


def _on_card(qs, ts, lq=None, lt=None):
    return [a.cuda() for a in _torch(_batch(qs, ts, lq, lt, pad_lanes=0))]


def _tapes_equal(arrs, hw):
    got = al.align_banded(*arrs, hw)
    ref = al.align_banded_plain(*arrs, hw)
    bad = (got != ref).any(1).nonzero().flatten().tolist()
    return bad, ref


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [1, 7, 512, 2048, 8192])
def test_band_kernel_mixed_lanes_on_card(hw):
    """The banded kernel against its plain version at every rung and at
    narrow half-widths, on mixed lengths with empty, 1-base and
    past-the-band lanes; at hw 2,048 also two pairs of more than 8,192
    bases (needs a GPU and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qs, ts = _card_set(hw, 21 + hw)
    if hw == 2048:
        rng = random.Random(5)
        long_q = bytes(rng.choice(b"ACGT") for _ in range(9000))
        qs += [long_q, long_q[:8500]]
        ts += [mutate(long_q, 0.08, rng), mutate(long_q, 0.03, rng)[:8300]]
    bad, ref = _tapes_equal(_on_card(qs, ts), hw)
    assert bad == [], f"lanes {bad} differ at hw {hw}"
    cost = _cost(ref.cpu().numpy())
    assert (cost > hw).any(), "no lane past its band"


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [512, 2048, 8192])
@pytest.mark.parametrize("b", [1, 3, 33, 257])
def test_band_kernel_batch_sizes_on_card(hw, b):
    """Batches of 1, 3, 33 and 257 lanes (several pairs a block past
    132 lanes; at hw 8,192 a pair split over a cluster of 8, 4 or, at
    257 lanes, the 2 blocks of 15 warps that hold its 29), each lane's
    tape equal to the plain version's and unchanged when the lanes are
    permuted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = random.Random(b)
    qs, ts = [], []
    for k in range(b):
        s = bytes(rng.choice(b"ACGT") for _ in range(rng.randint(0, 700)))
        qs.append(s)
        ts.append(mutate(s, 0.1, rng) if k % 7 else
                  bytes(rng.choice(b"ACGT") for _ in range(600)))
    arrs = _on_card(qs, ts, 768, 768)
    bad, ref = _tapes_equal(arrs, hw)
    assert bad == []
    perm = torch.from_numpy(np.random.default_rng(b).permutation(b)).cuda()
    got = al.align_banded(*[a[perm].contiguous() for a in arrs], hw)
    assert torch.equal(got, ref[perm])
