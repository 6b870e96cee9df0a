"""The port's overlap formats and CLI options against the JAX package.

* The port's MHAP, SAM and PAF scan parsers (and their line-parser
  fallbacks) give the JAX package's scan parsers' overlap fields, chunk
  rounds and errors on the cases of ``tests/test_fastio.py``.
* On a small simulated set, the port's ``--device cpu`` polish is byte
  for byte the JAX package's CPU polish from the PAF rewritten as MHAP
  (1-based ids), from a SAM written from the native engine's CIGARs
  (soft clips for the unaligned query ends, flag 16 on the reverse
  strand), and with ``-T`` (no trimming).
* ``--window-length=``, ``--quality-threshold=`` and
  ``--error-threshold=`` parse like their two-word forms.
"""

import io
import os

import numpy as np
import pytest

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.io import fastio as jax_fastio
from racon_tpu.tools import simulate
from racon_tpu_torch import cache, cli
from racon_tpu_torch.core.overlap import InvalidInputError
from racon_tpu_torch.io import fastio, parsers
from racon_tpu_torch.ops import cpu
from test_fastio import (MHAP_CASES, PAF_CASES, PAF_ERROR_CASES, SAM_CASES,
                         _drain, _write)


@pytest.fixture(autouse=True)
def cold_result_cache():
    """Every test starts and ends with an empty result cache, as a fresh
    process would: a test here counts launches, rungs or rates, or
    swaps an engine, and must not see what an earlier test filled."""
    cache.reset()
    yield
    cache.reset()


SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]
BUDGETS = (-1, 1, 25, 10 ** 9)
FIELDS = ("q_name", "q_id", "t_name", "t_id", "q_begin", "q_end",
          "q_length", "t_begin", "t_end", "t_length", "strand", "error",
          "length", "is_valid", "cigar")


def _parse(cls, path, budget):
    """(overlaps, rounds) or the (type name, message) of the error."""
    parser = cls(path)
    try:
        return _drain(parser, budget)
    except (ValueError, OverflowError, RuntimeError) as exc:
        return type(exc).__name__, str(exc)
    finally:
        parser.close()


def _assert_same(want, got):
    if isinstance(want[0], str):
        assert got == want
        return
    (wo, wr), (go, gr) = want, got
    assert wr == gr and len(wo) == len(go)
    for x, y in zip(wo, go):
        for attr in FIELDS:
            assert getattr(x, attr) == getattr(y, attr), attr
        assert (x.cigar_runs is None) == (y.cigar_runs is None)
        if x.cigar_runs is not None:
            for a, b in zip(x.cigar_runs, y.cigar_runs):
                assert np.array_equal(a, b)


FORMATS = {"mhap": ("MhapScanParser", "MhapParser"),
           "sam": ("SamScanParser", "SamParser"),
           "paf": ("PafScanParser", "PafParser")}
CASES = ([("mhap", d) for d in MHAP_CASES] + [("sam", d) for d in SAM_CASES]
         + [("paf", d) for d in PAF_CASES + PAF_ERROR_CASES])


@pytest.mark.parametrize("ext,data", CASES)
def test_overlap_parsers_equal_jax(tmp_path, ext, data):
    """Both of the port's parsers of a format give what the JAX
    package's scan parser gives, at every budget."""
    path = _write(tmp_path, f"case.{ext}", data)
    scan, line = FORMATS[ext]
    for budget in BUDGETS:
        want = _parse(getattr(jax_fastio, scan), path, budget)
        _assert_same(want, _parse(getattr(fastio, scan), path, budget))
        _assert_same(want, _parse(getattr(parsers, line), path, budget))


@pytest.mark.parametrize("cls", ["SamScanParser", "SamParser"])
def test_sam_missing_alignment_raises_invalid_input(tmp_path, cls):
    path = _write(tmp_path, "bad.sam",
                  b"q1\t0\tt1\t11\t60\t*\t*\t0\t0\tACGT\tIIII\n")
    parser = getattr(fastio, cls, None) or getattr(parsers, cls)
    with pytest.raises(InvalidInputError):
        parser(path).parse([], -1)


@pytest.mark.parametrize("name", ["o.mhap", "o.mhap.gz", "o.paf",
                                  "o.paf.gz", "o.sam", "o.sam.gz"])
def test_overlap_factory_takes_six_extensions(tmp_path, name):
    path = _write(tmp_path, name, b"")
    kind = name.split(".")[1]
    assert type(parsers.create_overlap_parser(path)).__name__ == \
        FORMATS[kind][0]


def test_overlap_factory_error_lists_six_extensions(tmp_path):
    path = _write(tmp_path, "o.txt", b"")
    with pytest.raises(parsers.UnsupportedFormatError) as ei:
        parsers.create_overlap_parser(path)
    assert str(ei.value).endswith(
        "(valid extensions: .mhap, .mhap.gz, .paf, .paf.gz, .sam, "
        ".sam.gz)")


# ---------------------------------------------------------------------------
# polish from MHAP and SAM, and with -T
# ---------------------------------------------------------------------------

def _fastq(path):
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return [(lines[k][1:].split()[0], lines[k + 1])
            for k in range(0, len(lines) - 3, 4)]


def _fasta(path):
    with open(path, "rb") as fh:
        recs = fh.read().split(b">")[1:]
    return [(r.split(b"\n", 1)[0].split()[0],
             b"".join(r.split(b"\n")[1:])) for r in recs]


def _write_mhap(paf, reads, draft, out):
    """The PAF's records with 1-based read and target ids, by their
    order in the reads and draft files."""
    rid = {name: k + 1 for k, (name, _) in enumerate(reads)}
    tid = {name: k + 1 for k, (name, _) in enumerate(draft)}
    lines = []
    with open(paf, "rb") as fh:
        for line in fh:
            f = line.split(b"\t")
            b_rc = int(f[4] == b"-")
            lines.append(b" ".join(str(x).encode() for x in (
                rid[f[0]], tid[f[5]], 0.1, 100, 0, f[2].decode(),
                f[3].decode(), f[1].decode(), b_rc, f[7].decode(),
                f[8].decode(), f[6].decode())))
    with open(out, "wb") as fh:
        fh.write(b"\n".join(lines) + b"\n")


def _write_sam(paf, reads, draft, out):
    """One SAM record per PAF record: the native engine's CIGAR of the
    (strand-applied) query span against the target span, soft clips
    for the unaligned query ends, flag 16 on the reverse strand."""
    seqs = dict(reads)
    targets = dict(draft)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    lines = [b"@HD\tVN:1.6"]
    with open(paf, "rb") as fh:
        for line in fh:
            f = line.split(b"\t")
            read = seqs[f[0]]
            qb, qe, rev = int(f[2]), int(f[3]), f[4] == b"-"
            tb, te = int(f[7]), int(f[8])
            if rev:
                read = read.translate(comp)[::-1]
                qb, qe = len(read) - qe, len(read) - qb
            cigar = cpu.align(read[qb:qe], targets[f[5]][tb:te])
            clip = (f"{qb}S" if qb else "") + cigar + \
                (f"{len(read) - qe}S" if qe < len(read) else "")
            lines.append(b"\t".join([
                f[0], b"16" if rev else b"0", f[5], str(tb + 1).encode(),
                b"60", clip.encode(), b"*", b"0", b"0", b"*", b"*"]))
    with open(out, "wb") as fh:
        fh.write(b"\n".join(lines) + b"\n")


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    out = tmp_path_factory.mktemp("formats_sim")
    reads, paf, draft = simulate.simulate(
        str(out), genome_len=12_000, coverage=10, read_len=2_000, seed=9,
        ont=True)
    rs, ds = _fastq(reads), _fasta(draft)
    mhap = os.path.join(out, "reads2draft.mhap")
    sam = os.path.join(out, "reads2draft.sam")
    _write_mhap(paf, rs, ds, mhap)
    _write_sam(paf, rs, ds, sam)
    return dict(reads=reads, paf=paf, draft=draft, mhap=mhap, sam=sam)


def _jax_polish(reads, overlaps, draft, trim=True):
    pol = jax_polisher.create_polisher(
        reads, overlaps, draft, jax_polisher.PolisherType.kC, 500, 10.0,
        0.3, trim, 5, -4, -8, 4)
    try:
        pol.initialize()
        out = pol.polish(True)
    finally:
        pol.close()
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in out)


def _port_polish(*argv):
    """The port's CLI polish from an empty result cache."""
    buf = io.BytesIO()
    cache.reset()
    cli.main(["--device", "cpu", "-t", "4", *SCORES, *argv], out=buf)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["mhap", "sam", "no_trimming"])
def test_cpu_polish_identical_to_jax(sim, case):
    overlaps = sim["paf"] if case == "no_trimming" else sim[case]
    trim = case != "no_trimming"
    want = _jax_polish(sim["reads"], overlaps, sim["draft"], trim)
    got = _port_polish(*([] if trim else ["-T"]), sim["reads"], overlaps,
                       sim["draft"])
    assert got == want and got.count(b">") >= 1


def test_no_trimming_changes_the_polish(sim):
    """-T reaches the polisher: its output differs from the trimmed one
    on this set (the windows' ends are not trimmed)."""
    args = (sim["reads"], sim["paf"], sim["draft"])
    assert _port_polish("-T", *args) != _port_polish(*args)


@pytest.mark.parametrize("opt,value,key", [
    ("--window-length", "200", "window_length"),
    ("--quality-threshold", "5", "quality_threshold"),
    ("--error-threshold", "0.2", "error_threshold"),
    ("--cudapoa-batches", "2", "cuda_poa_batches"),
    ("--cudaaligner-batches", "3", "cuda_aligner_batches"),
    ("--trace", "t.json", "trace"),
    ("--metrics-json", "m.json", "metrics_json")])
def test_eq_form_parses_like_two_words(opt, value, key):
    eq, _ = cli.parse_args([f"{opt}={value}", "r", "o", "t"])
    two, pos = cli.parse_args([opt, value, "r", "o", "t"])
    assert eq == two and pos == ["r", "o", "t"]
    assert eq[key] == type(eq[key])(value) != cli.parse_args([])[0][key]


def test_no_trimming_flags():
    for flag in ("-T", "--no-trimming"):
        assert cli.parse_args([flag])[0]["trim"] is False
    assert cli.parse_args([])[0]["trim"] is True
