"""The align slice end to end on the CPU: the one-shot CLI with
``--device cpu --cudaaligner-batches 1`` (every eligible overlap through
the align kernels' plain versions) against the JAX package's CPU polish
of the same simulated set, POA left on the CPU when ``-c`` is absent,
and the device ladder driven through WFA rejects, a band rung and a
measured-center retry by lowered rungs."""

import io
import os

import numpy as np
import pytest
import torch

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.tools import simulate
from racon_tpu_torch import cache, cli
from racon_tpu_torch.core import overlap as overlap_mod
from racon_tpu_torch.core.overlap import Overlap
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.cuda.polisher import CudaPolisher
from racon_tpu_torch.ops import cpu
from tests.test_torch_align_wfa import mutate, seq

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]


def _read_fasta(path):
    with open(path, "rb") as fh:
        return b"".join(l.strip() for l in fh if not l.startswith(b">"))


@pytest.fixture(scope="module", autouse=True)
def device_only_env():
    """This file pins the all-device path (every eligible overlap on the
    ladder, every eligible window on the POA kernel): both splits off,
    and no calibration store read or written.  The plain versions'
    small tensor ops run on one intra-op thread: beside other test
    processes, a team of spinning threads per op slows them tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RACON_TPU_TORCH_ALIGN_DEVICE_ONLY", "1")
            mp.setenv("RACON_TPU_TORCH_POA_DEVICE_ONLY", "1")
            mp.setenv("RACON_TPU_TORCH_CACHE_DIR", "")
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sim(tmp_path_factory, device_only_env):
    out = tmp_path_factory.mktemp("align_slice_sim")
    paths = simulate.simulate(str(out), genome_len=10_000, coverage=10,
                              read_len=2_000, seed=5, ont=True)
    ref = jax_polisher.create_polisher(
        *paths, jax_polisher.PolisherType.kC, 500, 10.0, 0.3, True, 5, -4,
        -8, 4)
    ref.initialize()
    jax_out = ref.polish(True)
    ref.close()
    return dict(paths=paths, jax=jax_out,
                truth=_read_fasta(os.path.join(out, "genome.fasta")))


@pytest.fixture(autouse=True)
def cold_result_cache():
    """Every test starts and ends with an empty result cache, as a fresh
    process would: a test here counts launches, rungs or rates, or
    swaps an engine, and must not see what an earlier test filled."""
    cache.reset()
    yield
    cache.reset()


@pytest.fixture(scope="module")
def align_only(sim):
    """--cudaaligner-batches 1 without -c; counts POA kernel calls."""
    calls = []
    orig = pf.poa_full

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    buf = io.BytesIO()
    cache.reset()                       # a module fixture: cold by hand
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pf, "poa_full", counted)
        pol = cli.main(["--device", "cpu", "-t", "4",
                        "--cudaaligner-batches", "1", *SCORES,
                        *sim["paths"]], out=buf)
    return pol, buf.getvalue(), len(calls)


def test_every_eligible_pair_certified_on_wfa(align_only):
    pol, _, _ = align_only
    assert isinstance(pol, CudaPolisher)
    assert pol.align_eligible > 0 and pol.align_over_length == 0
    rungs = pol.align_rungs
    assert rungs and all(name.startswith("wfa") for name in rungs)
    assert sum(r["certified"] for r in rungs.values()) \
        == pol.align_eligible - pol.align_probed
    assert pol.align_cpu_fallthrough == 0
    assert "device_align" in pol.stage_walls


def test_fasta_identical_to_jax_cpu_polish(align_only, sim):
    """WFA CIGARs equal the native engine's, so breaking points, windows
    and consensus are the JAX package's CPU polish, byte for byte."""
    _, out, _ = align_only
    want = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in sim["jax"])
    assert out == want


def test_no_poa_kernel_without_c(align_only):
    pol, _, poa_calls = align_only
    assert poa_calls == 0
    assert pol.poa_engine is None and "poa" in pol.stage_walls


def test_with_poa_on_kernel_path(sim):
    """-c 1 as well: the POA plain version's ties differ from the native
    engine's (tests/test_torch_slice.py), so the distance to truth may
    exceed the JAX package's by at most 10% + 10 edits."""
    buf = io.BytesIO()
    pol = cli.main(["--device", "cpu", "-t", "4", "-c", "1",
                    "--cudaaligner-batches", "1", *SCORES, *sim["paths"]],
                   out=buf)
    assert pol.poa_engine.windows_on_kernel > 0
    assert pol.align_cpu_fallthrough == 0
    data = buf.getvalue().split(b"\n")[1]
    (jax_seq,) = sim["jax"]
    d_port = cpu.edit_distance(data, sim["truth"])
    d_jax = cpu.edit_distance(jax_seq.data, sim["truth"])
    assert d_port <= 1.1 * d_jax + 10


# ---------------------------------------------------------------------------
# the ladder with lowered rungs
# ---------------------------------------------------------------------------

def _write_set(path, rng):
    """A 12 kb target and reads cut from it: 24 at 10% divergence, one
    long read at 30% (its WFA estimate admits it, its distance rejects
    it) and one long read with a 600-bp deletion (too far apart for WFA,
    certified by a band on the proportional center).  PAF spans are
    exact."""
    target = seq(12_000, rng)
    reads, paf = [], []
    specs = [(int(rng.integers(900, 1300)), 0.10, 0) for _ in range(24)]
    specs += [(2100, 0.30, 0), (2000, 0.03, 600)]
    for k, (n, rate, cut) in enumerate(specs):
        b = int(rng.integers(0, len(target) - n))
        span = target[b:b + n]
        r = mutate(span[:n // 2] + span[n // 2 + cut:], rate, rng)
        name = f"r{k}"
        reads.append(b"@%s\n%s\n+\n%s\n" % (name.encode(), r,
                                             b"I" * len(r)))
        paf.append(f"{name}\t{len(r)}\t0\t{len(r)}\t+\ttgt\t{len(target)}"
                   f"\t{b}\t{b + n}\t{n}\t{n}\t255\n")
    files = {"reads.fastq": b"".join(reads), "ovl.paf": "".join(paf).encode(),
             "tgt.fasta": b">tgt\n" + target + b"\n"}
    for name, data in files.items():
        with open(os.path.join(path, name), "wb") as fh:
            fh.write(data)
    return [os.path.join(path, n) for n in files]


def test_ladder_wfa_reject_band_and_measured_retry(tmp_path, monkeypatch):
    monkeypatch.setattr(CudaPolisher, "WFA_RUNGS", (256, 512))
    monkeypatch.setattr(CudaPolisher, "BAND_RUNGS", (1024, 2048))
    # the JAX package's probe of a whole job (9 of its 26 pairs): the
    # port's budget would price a target this small at the priors
    monkeypatch.setattr(CudaPolisher, "PROBE_EVERY", 1)
    monkeypatch.setattr(CudaPolisher, "PROBE_MIN", 4)
    seen = []
    orig = Overlap.find_breaking_points_from_cigar
    orig_slab = overlap_mod._decode_bp_slab

    def record(self, window_length):
        if self.cigar_runs is not None:
            seen.append((self, [a.copy() for a in self.cigar_runs]))
        return orig(self, window_length)

    def record_slab(overlaps, window_length):
        # the batched decode of the base pass takes short pairs
        seen.extend((o, [a.copy() for a in o.cigar_runs])
                    for o in overlaps)
        return orig_slab(overlaps, window_length)

    monkeypatch.setattr(Overlap, "find_breaking_points_from_cigar", record)
    monkeypatch.setattr(overlap_mod, "_decode_bp_slab", record_slab)
    paths = _write_set(str(tmp_path), np.random.default_rng(3))
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, 2, cuda_aligner_batches=1,
                          device="cpu")
    pol.initialize()
    rungs = pol.align_rungs
    # a WFA reject, then the band rung: the reject on measured centers,
    # the deletion read on the proportional one
    assert sum(r["retried"] for name, r in rungs.items()
               if name.startswith("wfa")) >= 1
    assert rungs["band2048"]["certified"] >= 2
    assert pol.align_cpu_fallthrough == 0
    assert len(seen) == pol.align_eligible - pol.align_probed
    code = {0: "M", 1: "I", 2: "D", 7: "=", 8: "X"}
    for o, (lengths, codes) in seen:
        q = o.query_span(pol.sequences)
        t = o.target_span(pol.sequences)
        ops = "".join(code[int(c)] * int(n) for n, c in zip(lengths, codes))
        assert ops.count("=") + ops.count("X") + ops.count("I") == len(q)
        assert ops.count("=") + ops.count("X") + ops.count("D") == len(t)
        assert len(ops) - ops.count("=") == cpu.edit_distance(q, t)
        # '=' runs are true matches
        qi = ti = 0
        for op in ops:
            if op in "=X":
                assert (q[qi] == t[ti]) == (op == "=")
            qi += op in "=XI"
            ti += op in "=XD"
    pol.close()


def test_ops_to_runs_codes():
    ops = np.array([al.OP_EQ, al.OP_EQ, al.OP_X, al.OP_I, al.OP_D,
                    al.OP_STOP], np.uint8)
    lengths, codes = al.ops_to_runs(ops)
    assert lengths.tolist() == [1, 1, 1, 2]
    assert codes.tolist() == [2, 1, 8, 7]
