"""The port's overlap discovery and rounds (racon_tpu_torch/overlap,
racon_tpu_torch/cuda/seed_words.py) against the JAX package's
(racon_tpu/overlap, racon_tpu/tpu/seedmatch.py) on the CPU: seed words
bit for bit, minimizers, the index and the mapper's overlaps field by
field (with ``primary_only``, the port's departure for contig polishing:
each read's first overlap of the JAX package's), and the polish over 1
and 2 rounds, from the CPU Polisher (bytes equal; with ``primary_only``,
equal to the JAX package's polish from a PAF of those overlaps) and
from the CLI's ``--device cpu`` kernel path (the slice tolerance).
The ``cuda`` tests hold the seed-word kernel against its plain version
on the card (``pytest -m cuda``)."""

import io
import json
import os

import numpy as np
import pytest
import torch

from racon_tpu import cache as jax_cache
from racon_tpu.core import polisher as jax_polisher
from racon_tpu.overlap import map_files as jax_map_files
from racon_tpu.overlap import map_sequences as jax_map_sequences
from racon_tpu.overlap import minimizers as jax_mini
from racon_tpu.overlap import polish_rounds as jax_polish_rounds
from racon_tpu.overlap.index import MinimizerIndex as JaxIndex
from racon_tpu.tools import simulate
from racon_tpu.tpu import seedmatch
from racon_tpu_torch import cache, cli
from racon_tpu_torch.core.polisher import PolisherType
from racon_tpu_torch.cuda import build
from racon_tpu_torch.cuda import seed_words as sw
from racon_tpu_torch.io.parsers import create_sequence_parser
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.overlap import chain, map_files, minimizers
from racon_tpu_torch.overlap import polish_rounds, params_from_env
from racon_tpu_torch.overlap.index import MinimizerIndex

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]
CPU = torch.device("cpu")
OVERLAP_FIELDS = ("q_name", "q_length", "q_begin", "q_end", "t_name",
                  "t_length", "t_begin", "t_end", "strand", "length",
                  "error", "is_valid")
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(autouse=True)
def cold_result_cache():
    """Every test starts and ends with an empty result cache, as a fresh
    process would: a test here counts launches, rungs or rates, or
    swaps an engine, and must not see what an earlier test filled."""
    cache.reset()
    yield
    cache.reset()


class _Seq:
    def __init__(self, name, data):
        self.name = name
        self.data = data


def _random_seq(n, seed, n_frac=0.0):
    rng = np.random.default_rng(seed)
    seq = _ACGT[rng.integers(0, 4, n)].copy()
    if n_frac:
        seq[rng.random(n) < n_frac] = ord("N")
    return seq.tobytes()


def _revcomp(data: bytes) -> bytes:
    return data.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def _load(path):
    parser = create_sequence_parser(path)
    records = []
    parser.reset()
    parser.parse(records, -1)
    parser.close()
    return records


def _fields(overlaps):
    return [tuple(getattr(o, f) for f in OVERLAP_FIELDS) for o in overlaps]


@pytest.fixture(scope="module", autouse=True)
def pinned_env():
    """No calibration store is read or written (the built-in rates
    decide the splits), and the plain versions' small tensor ops run
    on one intra-op thread beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RACON_TPU_TORCH_CACHE_DIR", "")
            for knob in ("K", "W", "OCC", "MIN_CHAIN", "BAND", "MAX_GAP",
                         "DEVICE_SEED"):
                mp.delenv(f"RACON_TPU_TORCH_MAP_{knob}", raising=False)
            yield
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# seed words: plain version == JAX jit == JAX numpy, bit for bit
# ---------------------------------------------------------------------------

SEED_CASES = {"random_with_n": (3_001, 0.02), "below_k": (4, 0.0),
              "exactly_k": (None, 0.0), "all_n": (40, 1.0)}


@pytest.mark.parametrize("case", sorted(SEED_CASES))
@pytest.mark.parametrize("k", [5, 13, 15])
def test_seed_words_match_jax(k, case):
    """Exact: the words are integer programs."""
    n, n_frac = SEED_CASES[case]
    codes = jax_mini.encode(_random_seq(k if n is None else n, k, n_frac))
    want = jax_mini.kmer_words(codes, k)
    jit = seedmatch.kmer_words_device(codes, k)
    for got in (minimizers.kmer_words(codes, k, CPU),
                minimizers.kmer_words(codes, k, minimizers.NUMPY), jit):
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.uint32
            np.testing.assert_array_equal(np.asarray(a), b)
    if codes.size >= k:
        fw, rv = sw.seed_words(torch.from_numpy(codes), k)
        assert fw.dtype == torch.int32 and fw.shape == (codes.size - k + 1,)
        np.testing.assert_array_equal(fw.numpy().view(np.uint32), want[0])
        np.testing.assert_array_equal(rv.numpy().view(np.uint32), want[1])


@pytest.mark.parametrize("k", [5, 13, 15])
def test_batched_words_equal_per_sequence_builds(k):
    """The mapper's flat-buffer build, sliced per sequence, gives each
    sequence its own build's words (those straddling two sequences are
    dropped), across batch cuts, short and exactly-k sequences."""
    datas = [_random_seq(n, 100 + i, 0.01) for i, n in
             enumerate([900, 3, k, 1_500, 0, 2_000, k - 1, 700])]
    for device in (minimizers.NUMPY, CPU):
        for cap in (chain.SEED_BATCH, 2_500, 1):
            got = list(chain.batched_words(datas, k, device, cap=cap))
            assert len(got) == len(datas)
            for data, (fw, rv) in zip(datas, got):
                want = jax_mini.kmer_words(jax_mini.encode(data), k)
                np.testing.assert_array_equal(fw, want[0])
                np.testing.assert_array_equal(rv, want[1])


@pytest.mark.parametrize("bad", ["dtype", "k0", "k16", "short", "2d",
                                 "device"])
def test_seed_words_rejects_what_the_kernel_does_not_take(bad):
    """The wrapper raises; on a device that is neither the CPU nor a
    card it never gives way to the plain version."""
    codes = torch.zeros(64, dtype=torch.uint8)
    k = 13
    if bad == "dtype":
        codes = codes.to(torch.int32)
    elif bad == "k0":
        k = 0
    elif bad == "k16":
        k = 16
    elif bad == "short":
        codes = codes[:12]
    elif bad == "2d":
        codes = codes.view(8, 8)
    else:
        codes = torch.zeros(64, dtype=torch.uint8, device="meta")
    launches = build.launch_counts()["seed_words"]
    with pytest.raises(ValueError):
        sw.seed_words(codes, k)
    assert build.launch_counts()["seed_words"] == launches


# ---------------------------------------------------------------------------
# minimizers and the index
# ---------------------------------------------------------------------------

EXTRACT_CASES = {
    "random_k13_w5": (_random_seq(5_000, 1), 13, 5),
    "invalid_bases": (b"ACGT" * 30 + b"NNNNN" + b"TTAC" * 30, 13, 5),
    "n_sprinkled_k15_w10": (_random_seq(4_000, 2, 0.01), 15, 10),
    "palindromes_k6": (b"ACGT" * 100 + b"AATT" * 50, 6, 3),
    "short_k5_w1": (_random_seq(300, 3), 5, 1),
    "shorter_than_window": (_random_seq(20, 4), 13, 10),
    "shorter_than_k": (b"ACGTAC", 13, 5),
    "all_invalid": (b"N" * 50, 13, 5),
    "lower_case": (_random_seq(600, 5).lower(), 11, 4),
}


@pytest.mark.parametrize("case", sorted(EXTRACT_CASES))
def test_extract_matches_jax(case):
    data, k, w = EXTRACT_CASES[case]
    want = jax_mini.extract(data, k, w)
    (words,) = chain.batched_words([data], k, CPU)
    for got in (minimizers.extract(data, k, w),
                minimizers.extract(data, k, w, words=words)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_extract_refuses_words_of_another_length():
    data = _random_seq(500, 6)
    fw, rv = minimizers.kmer_words(minimizers.encode(data), 13,
                                   minimizers.NUMPY)
    with pytest.raises(ValueError):
        minimizers.extract(data, 13, 5, words=(fw[1:], rv[1:]))


@pytest.mark.parametrize("occ_cap", [4, 10_000])
def test_index_matches_jax(occ_cap):
    unique = _random_seq(4_000, 4)
    repeat = _random_seq(200, 5)
    targets = [_Seq("t0", repeat * 40 + unique), _Seq("t1", unique[:900]),
               _Seq("t2", b"ACG")]
    want = JaxIndex.build(targets, k=13, w=5, occ_cap=occ_cap)
    got = MinimizerIndex.build(
        targets, k=13, w=5, occ_cap=occ_cap,
        words=chain.batched_words((t.data for t in targets), 13, CPU))
    for name in ("hashes", "tid", "tpos", "tstrand"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("masked_hashes", "masked_entries", "total_entries",
                 "n_targets"):
        assert getattr(got, name) == getattr(want, name)
    assert (got.masked_hashes > 0) == (occ_cap == 4)
    q = _random_seq(800, 7)
    _, h, _ = minimizers.extract(unique[1_000:2_000] + q, 13, 5)
    for a, b in zip(got.lookup(h), want.lookup(h)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The JAX package's mapper test set
    (tests/test_overlap_discovery.py)."""
    out = tmp_path_factory.mktemp("map_sim")
    paths = simulate.simulate(str(out), genome_len=8_000, coverage=5,
                              read_len=800, seed=21, ont=True)
    with open(os.path.join(out, "truth.json")) as fh:
        truth = json.load(fh)
    return dict(reads=paths[0], paf=paths[1], draft=paths[2], truth=truth,
                genome=os.path.join(out, "genome.fasta"))


@pytest.mark.parametrize("seed", ["numpy", "cpu"])
def test_map_files_match_jax(dataset, seed):
    """Every field of every overlap, in order, and the stats; the
    stats' ``map_device_seed`` says where the words were built."""
    want, want_stats = jax_map_files(dataset["reads"], dataset["draft"])
    params = params_from_env(minimizers.NUMPY if seed == "numpy" else CPU)
    got, stats = map_files(dataset["reads"], dataset["draft"],
                           params=params)
    assert len(got) == len(want) > 0
    assert _fields(got) == _fields(want)
    assert stats == {**want_stats,
                     "map_device_seed": int(seed == "cpu")}


@pytest.fixture(scope="module")
def multi_chain_set(tmp_path_factory):
    """100 kb at 30x with 8 kb reads: 12 reads have a second, spurious
    chain, which the contig polisher keeps over the true one when every
    admitted chain is emitted (the JAX package's mapper)."""
    out = tmp_path_factory.mktemp("map_multi")
    reads, _, draft = simulate.simulate(str(out), genome_len=100_000,
                                        coverage=30, read_len=8_000,
                                        seed=7, ont=True)
    with open(os.path.join(out, "truth.json")) as fh:
        truth = json.load(fh)["reads"]
    jax_out, jax_stats = jax_map_files(reads, draft)
    return dict(reads=reads, draft=draft, truth=truth, jax=jax_out,
                jax_stats=jax_stats)


def _kept_misplaced(overlaps, truth):
    """Reads whose overlap the contig polisher keeps (the longest, the
    later one on a tie: ``Polisher._load_overlaps``) lies off their
    true placement (other strand, or a start more than 2 kb away)."""
    kept = {}
    for o in overlaps:
        if o.q_name not in kept or o.length >= kept[o.q_name].length:
            kept[o.q_name] = o
    return sum(1 for rec in truth if rec["name"] in kept and (
        kept[rec["name"]].strand != (rec["strand"] == "-")
        or abs(kept[rec["name"]].t_begin - rec["t_begin"]) > 2000))


def test_all_chains_match_jax_on_multi_chain_set(multi_chain_set):
    got, stats = map_files(multi_chain_set["reads"],
                           multi_chain_set["draft"],
                           params=params_from_env(CPU))
    assert _fields(got) == _fields(multi_chain_set["jax"])
    assert stats == {**multi_chain_set["jax_stats"], "map_device_seed": 1}
    assert stats["overlaps"] > stats["queries"]


def test_primary_only_is_each_reads_first_chain(multi_chain_set):
    """The port's departure, pinned against the JAX package: with
    ``primary_only`` (contig polishing) each read keeps the first of the
    JAX package's overlaps for it, its chain with the most anchors, and
    no read's kept overlap is then misplaced; with every chain emitted,
    12 are."""
    got, stats = chain.map_sequences(
        _load(multi_chain_set["reads"]), _load(multi_chain_set["draft"]),
        params=params_from_env(CPU), primary_only=True)
    first = {}
    for o in multi_chain_set["jax"]:
        first.setdefault(o.q_name, o)
    assert _fields(got) == _fields(first.values())
    assert stats["chains_admitted"] - stats["overlaps"] == \
        len(multi_chain_set["jax"]) - len(first) > 0
    assert _kept_misplaced(multi_chain_set["jax"],
                           multi_chain_set["truth"]) == 12
    assert _kept_misplaced(got, multi_chain_set["truth"]) == 0


def test_planted_reads_match_jax():
    target = _random_seq(20_000, 7)
    rng = np.random.default_rng(8)
    reads, truth = [], []
    for i in range(20):
        b = int(rng.integers(0, 18_000))
        e = b + int(rng.integers(800, 2_000))
        strand = bool(rng.integers(0, 2))
        piece = target[b:e]
        reads.append(_Seq(f"r{i}", _revcomp(piece) if strand else piece))
        truth.append((b, e, strand))
    reads.append(_Seq("junk", _random_seq(1_500, 10)))
    targets = [_Seq("draft", target)]
    want, want_stats = jax_map_sequences(reads, targets)
    got, stats = chain.map_sequences(reads, targets,
                                     params=params_from_env(CPU))
    assert _fields(got) == _fields(want)
    assert stats == {**want_stats, "map_device_seed": 1}
    first = {}
    for o in got:
        first.setdefault(o.q_name, o)
    assert "junk" not in first
    for i, (b, e, strand) in enumerate(truth):
        o = first[f"r{i}"]
        assert o.strand == strand
        assert abs(o.t_begin - b) <= 25 and abs(o.t_end - e) <= 25


def test_mapper_recall_precision_vs_truth(dataset):
    """The JAX package's bar: recall >= 0.95, precision >= 0.90."""
    overlaps, stats = map_files(dataset["reads"], dataset["draft"],
                                params=params_from_env(CPU))
    by_name = {}
    for o in overlaps:
        by_name.setdefault(o.q_name, []).append(o)
    hit = 0
    for rec in dataset["truth"]["reads"]:
        for o in by_name.get(rec["name"], []):
            inter = (min(o.t_end, rec["t_end"])
                     - max(o.t_begin, rec["t_begin"]))
            if o.strand == (rec["strand"] == "-") and \
                    inter >= 0.5 * (rec["t_end"] - rec["t_begin"]):
                hit += 1
                break
    recall = hit / len(dataset["truth"]["reads"])
    precision = hit / max(1, stats["overlaps"])
    assert recall >= 0.95, recall
    assert precision >= 0.90, precision


def test_params_from_env(monkeypatch):
    for knob, value in (("K", "11"), ("W", "8"), ("OCC", "32"),
                        ("MIN_CHAIN", "6"), ("BAND", "400"),
                        ("MAX_GAP", "5000"), ("DEVICE_SEED", "0")):
        monkeypatch.setenv(f"RACON_TPU_TORCH_MAP_{knob}", value)
    p = params_from_env(CPU)
    assert (p.k, p.w, p.occ_cap, p.min_chain, p.band, p.max_gap) == \
        (11, 8, 32, 6, 400, 5000)
    assert p.seed_device == minimizers.NUMPY
    assert p.doc()["device_seed"] == 0
    monkeypatch.delenv("RACON_TPU_TORCH_MAP_DEVICE_SEED")
    assert params_from_env(CPU).seed_device == CPU
    assert params_from_env("cpu").doc()["device_seed"] == 1
    assert params_from_env(minimizers.NUMPY).seed_device == minimizers.NUMPY
    from racon_tpu_torch.obs import provenance

    for knob in ("K", "W", "OCC", "MIN_CHAIN", "BAND", "MAX_GAP"):
        monkeypatch.delenv(f"RACON_TPU_TORCH_MAP_{knob}")
    knobs = provenance.resolved_knobs()
    for knob, default in (("K", "13"), ("W", "5"), ("OCC", "64"),
                          ("MIN_CHAIN", "4"), ("BAND", "500"),
                          ("MAX_GAP", "10000"), ("DEVICE_SEED", "1")):
        name = f"RACON_TPU_TORCH_MAP_{knob}"
        assert provenance.KNOWN_KNOBS[name] == default
        assert knobs[name] == {"value": default, "source": "default"}


@pytest.mark.parametrize("entry", ["map_files", "map_sequences"])
def test_mapper_entry_points_seed_on_the_card_by_default(dataset, entry,
                                                         monkeypatch):
    """With no params the words are built on the card, so without one
    the entry points raise: they never build them on the host instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        if entry == "map_files":
            map_files(dataset["reads"], dataset["draft"])
        else:
            chain.map_sequences(_load(dataset["reads"]),
                                _load(dataset["draft"]))


# ---------------------------------------------------------------------------
# polish over rounds
# ---------------------------------------------------------------------------

def _fasta(seqs) -> bytes:
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in seqs)


def _read_fasta(path):
    with open(path, "rb") as fh:
        return b"".join(l.strip() for l in fh if not l.startswith(b">"))


@pytest.fixture(scope="module")
def jax_rounds(dataset):
    """The JAX package's CPU polish over 1 and 2 rounds, no PAF, each
    from an empty result cache: (bytes, per-round cache hits)."""
    out = {}
    for rounds in (1, 2):
        jax_cache._reset_for_tests()
        seqs, pol = jax_polish_rounds(
            dataset["reads"], None, dataset["draft"],
            jax_polisher.PolisherType.kC, 500, 10.0, 0.3, True, 5, -4, -8,
            2, rounds=rounds)
        pol.close()
        out[rounds] = (_fasta(seqs),
                       [r["cache_hit"] for r in pol.rounds_report])
    jax_cache._reset_for_tests()
    return out


@pytest.mark.parametrize("rounds", [1, 2])
def test_cpu_polisher_rounds_bytes_equal_jax(dataset, jax_rounds, rounds):
    """No read of this set has a second chain in either round, so the
    port's ``primary_only`` departure does not show here; from an empty
    result cache each round hits the cache as often as the JAX
    package's does (windows whose content did not move since round
    1)."""
    seqs, pol = polish_rounds(dataset["reads"], None, dataset["draft"],
                              PolisherType.kC, 500, 10.0, 0.3, True, 5, -4,
                              -8, 2, rounds=rounds)
    pol.close()
    want, want_hits = jax_rounds[rounds]
    assert _fasta(seqs) == want
    report = pol.rounds_report
    assert [r["round"] for r in report] == list(range(1, rounds + 1))
    assert all(r["map_s"] > 0 and r["overlaps"] > 0 for r in report)
    assert [r["cache_hit"] for r in report] == want_hits
    assert "map" in pol.stage_walls


def _write_paf(path, overlaps):
    with open(path, "w") as fh:
        for o in overlaps:
            fh.write(f"{o.q_name}\t{o.q_length}\t{o.q_begin}\t{o.q_end}\t"
                     f"{'-' if o.strand else '+'}\t{o.t_name}\t"
                     f"{o.t_length}\t{o.t_begin}\t{o.t_end}\t0\t0\t255\n")


def test_cpu_polisher_primary_only_bytes_equal_jax_fed_them(
        multi_chain_set, tmp_path):
    """The departure where it shows: the port's contig polish with no
    PAF keeps each read's best chain (``primary_only``) and writes the
    bytes that the JAX package's CPU polish writes from a PAF of those
    overlaps; the JAX package's own mapped polish, which keeps the
    spurious chains, writes other bytes."""
    reads, draft = multi_chain_set["reads"], multi_chain_set["draft"]
    args = (PolisherType.kC, 500, 10.0, 0.3, True, 5, -4, -8, 2)
    seqs, pol = polish_rounds(reads, None, draft, *args, rounds=1)
    pol.close()
    primary, _ = chain.map_sequences(
        _load(reads), _load(draft), params=params_from_env(minimizers.NUMPY),
        primary_only=True)
    paf = str(tmp_path / "primary.paf")
    _write_paf(paf, primary)
    jax_args = (jax_polisher.PolisherType.kC, *args[1:])
    fed, ref = jax_polish_rounds(reads, paf, draft, *jax_args, rounds=1)
    ref.close()
    mapped, ref = jax_polish_rounds(reads, None, draft, *jax_args, rounds=1)
    ref.close()
    assert _fasta(seqs) == _fasta(fed)
    assert _fasta(seqs) != _fasta(mapped)


def _cli(argv):
    buf = io.BytesIO()
    pol = cli.main(argv, out=buf)
    return buf.getvalue(), pol


@pytest.fixture(scope="module")
def kernel_path(tmp_path_factory):
    """The CLI's kernel path on the CPU (plain versions), two rounds,
    reads + draft only, on the slice's set (tests/test_torch_slice.py:
    10 kb at 10x; at the mapper set's 5x both packages' second round
    lands above the draft): twice, then once with the words built by
    numpy; and the JAX package's CPU polish of two rounds."""
    out = tmp_path_factory.mktemp("map_slice")
    reads, _, draft = simulate.simulate(str(out), genome_len=10_000,
                                        coverage=10, read_len=2_000,
                                        seed=5, ont=True)
    argv = ["--device", "cpu", "-t", "2", "-c", "1",
            "--cudaaligner-batches", "1", "--rounds", "2", *SCORES,
            reads, draft]
    # each run from an empty result cache, so every comparison below
    # recomputes every window and pair
    cache.reset()
    first, pol = _cli(argv)
    cache.reset()
    second, _ = _cli(argv)
    cache.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_TORCH_MAP_DEVICE_SEED", "0")
        numpy_seed, _ = _cli(argv)
    cache.reset()
    seqs, ref = jax_polish_rounds(
        reads, None, draft, jax_polisher.PolisherType.kC, 500, 10.0, 0.3,
        True, 5, -4, -8, 2, rounds=2)
    ref.close()
    return dict(first=first, second=second, numpy_seed=numpy_seed, pol=pol,
                jax=seqs[0].data, draft=_read_fasta(draft),
                truth=_read_fasta(os.path.join(out, "genome.fasta")))


def test_cli_rounds_within_slice_tolerance_of_jax(kernel_path):
    """Tolerance (tests/test_torch_slice.py): the POA kernel and the
    native engine break cost-equal ties differently, so the port's
    distance to truth may exceed the JAX CPU polish's by 10% + 10."""
    truth = kernel_path["truth"]
    (port,) = kernel_path["first"].split(b"\n")[1:2]
    d_port = cpu.edit_distance(port, truth)
    d_jax = cpu.edit_distance(kernel_path["jax"], truth)
    d_draft = cpu.edit_distance(kernel_path["draft"], truth)
    assert d_port < d_draft
    assert d_port <= 1.1 * d_jax + 10


def test_cli_rounds_deterministic_and_seed_placement_free(kernel_path):
    assert kernel_path["first"].startswith(b">")
    assert kernel_path["first"] == kernel_path["second"]
    assert kernel_path["first"] == kernel_path["numpy_seed"]


def test_cli_rounds_report(kernel_path):
    pol = kernel_path["pol"]
    report = pol.rounds_report
    assert len(report) == 2
    assert all(r["map_s"] > 0 and r["overlaps"] > 0 for r in report)
    assert pol.poa_engine.windows_on_kernel > 0
    assert int(pol.metrics.value("map_queries")) > 0
    assert float(pol.metrics.value("host.map_s")) > 0
    assert pol.stage_walls["map"] > 0


def test_run_alias_and_rounds_forms_parse_alike(dataset):
    """``run`` drops off, ``--rounds=2`` parses as ``--rounds 2``, and
    two positionals map: the CPU path's bytes are the same all ways."""
    args = [*SCORES, "-t", "2", dataset["reads"], dataset["draft"]]
    a, pol_a = _cli(["run", "--device", "cpu", "--rounds", "2", *args])
    cache.reset()                       # b recomputes, not served warm
    b, pol_b = _cli(["--device", "cpu", "--rounds=2", *args])
    assert a == b and a.startswith(b">")
    assert len(pol_a.rounds_report) == len(pol_b.rounds_report) == 2
    opts, inputs = cli.parse_args(["--rounds=3", "x", "y"])
    assert opts["rounds"] == 3 and inputs == ["x", "y"]


@pytest.mark.parametrize("argv", [["--rounds", "two", "r.fq", "d.fa"],
                                  ["--rounds=1.5", "r.fq", "d.fa"],
                                  ["--rounds"]])
def test_bad_rounds_exits_1(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([*argv, "--device", "cpu"], out=io.BytesIO())
    assert exc.value.code == 1
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["r.fq"], ["run", "r.fq"], []])
def test_one_positional_is_missing_input(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([*argv, "--device", "cpu"], out=io.BytesIO())
    assert exc.value.code == 1
    assert "missing input file(s)!" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 13, 15])
def test_seed_words_kernel_matches_plain_on_card(k):
    """The kernel against its plain version on the card, exact, with an
    unaligned start and a tail shorter than one block's tile, and at
    every ``codes`` offset 0-15 against k-mer counts at the 16-byte
    stores' edges (n - k + 1 = 0-3 mod 4), a thread's run of 16 and a
    tile of 4,096 words, each +- 1, into buffers made before each launch
    (with none the wrapper raises; needs a GPU and nvcc; run with
    ``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codes = jax_mini.encode(_random_seq(1_000_003, k, 0.01))
    dev = torch.from_numpy(codes).cuda()
    launches = build.launch_counts()["seed_words"]
    with pytest.raises(ValueError, match="seed_words_buffers"):
        sw.seed_words(dev, k)
    assert build.launch_counts()["seed_words"] == launches
    edges = [dev[off:off + k - 1 + m] for off in range(16)
             for m in (1, 2, 3, 4, 5, 15, 16, 17, 4_095, 4_096, 4_097,
                       8_193, 100_003)]
    for t in [dev, dev[3:], dev[:k], dev[:2_049 + k]] + edges:
        launches = build.launch_counts()["seed_words"]
        fw, rv = sw.seed_words(t, k, sw.seed_words_buffers(
            int(t.shape[0]), k, t.device))
        torch.cuda.synchronize()
        assert build.launch_counts()["seed_words"] == launches + 1
        pf, pr = sw.seed_words_reference(t, k)
        assert torch.equal(fw, pf) and torch.equal(rv, pr)
    want = jax_mini.kmer_words(codes, k)
    for a, b in zip(minimizers.kmer_words(codes, k, "cuda"), want):
        np.testing.assert_array_equal(a, b)
