"""The port's dataset tools (rampler, preprocess, wrapper), on the CPU.

Held to the JAX package with a tolerance of zero (names, records, lines,
bytes):

* rampler ``split`` and ``subsample`` write the same file names and the
  same records as ``racon_tpu.tools.rampler`` on a simulated FASTQ set,
  its FASTA twin, and a FASTQ set whose reads partly carry no qualities
  (all '!', which the parsers drop);
* preprocess writes the same lines as the JAX ``parse_file`` on the
  paired-read case of tests/test_tools.py;
* the port's wrapper (``--device cpu``) writes the same stdout as the
  JAX package's wrapper on tests/test_tools.py's two-target set, split
  and unsplit;
* on four simulated contigs the wrapper's ``--split`` (two chunks of two
  contigs, the kernels' plain versions) writes the port CLI's whole-job
  bytes, and ``--rounds 2`` with a client-side split exits 1;
* each ``racon-tpu-torch*`` console script of pyproject.toml resolves to
  a callable ``main``, and the JAX package's four stay as they were.
"""

import importlib
import io
import os
import subprocess
import sys
import tempfile

import pytest

from racon_tpu.io.parsers import create_sequence_parser as jax_parser
from racon_tpu.tools import preprocess as jax_preprocess
from racon_tpu.tools import rampler as jax_rampler
from racon_tpu_torch import cache
from racon_tpu_torch.io.parsers import create_sequence_parser
from racon_tpu_torch.tools import preprocess, rampler

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the split rates every polish here prices at, the kernel path all on
#: the (plain) device: a whole run and a chunk run price different
#: totals, so a rate split could cut them differently
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
         "RACON_TPU_TORCH_FLIGHT_DUMP", "RACON_TPU_TORCH_COORD",
         "RACON_TPU_TORCH_NPROC", "RACON_TPU_TORCH_RANK",
         "RACON_TPU_TORCH_STAGE", "RACON_TPU_TORCH_PIPELINE")
KERNEL_ARGS = ("-t", "2", "-c", "1", "--cudaaligner-batches", "1")
#: the wrapper's score defaults (the reference wrapper's), which the
#: one-shot CLI (m 3, x -5, g -4) is given to compare
WRAPPER_SCORES = ("-m", "5", "-x", "-4", "-g", "-8")


@pytest.fixture(scope="module")
def tmp_dir():
    with tempfile.TemporaryDirectory(prefix="rttools_", dir="/tmp") as d:
        yield d


def records(path, parser=create_sequence_parser):
    p = parser(path)
    dst = []
    p.parse(dst, -1)
    p.close()
    return [(s.name, s.data, s.quality) for s in dst]


def file_records(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def read_sets(tmp_dir):
    """A simulated FASTQ set, its FASTA twin, and a FASTQ set where
    every third read's qualities are all '!' (dropped by the parsers)."""
    from racon_tpu_torch.tools import simulate

    reads, _, _ = simulate.simulate(os.path.join(tmp_dir, "sim"),
                                    genome_len=6_000, coverage=6,
                                    read_len=700, seed=11, ont=True)
    with open(reads, "rb") as fh:
        lines = fh.read().splitlines()
    fasta = os.path.join(tmp_dir, "reads.fasta")
    noq = os.path.join(tmp_dir, "noq.fastq")
    with open(fasta, "wb") as fa, open(noq, "wb") as fq:
        for j in range(0, len(lines), 4):
            head, seq, _, qual = lines[j:j + 4]
            fa.write(b">" + head[1:] + b"\n" + seq + b"\n")
            if (j // 4) % 3 == 0:
                qual = b"!" * len(seq)
            fq.write(head + b"\n" + seq + b"\n+\n" + qual + b"\n")
    return {"fastq": reads, "fasta": fasta, "noq": noq}


@pytest.mark.parametrize("kind", ["fastq", "fasta", "noq"])
@pytest.mark.parametrize("chunk", [1, 2_500, 10_000, 10 ** 9])
def test_rampler_split_equals_jax(read_sets, tmp_dir, kind, chunk):
    src = read_sets[kind]
    ours = rampler.split(src, chunk,
                         os.path.join(tmp_dir, f"s_{kind}_{chunk}"))
    theirs = jax_rampler.split(src, chunk,
                               os.path.join(tmp_dir, f"j_{kind}_{chunk}"))
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert file_records(a) == file_records(b)
    # the chunks join to the input, in order, each within the bound
    joined = [r for p in ours for r in records(p)]
    assert joined == records(src)
    for p in ours:
        recs = records(p)
        assert len(recs) == 1 or sum(len(d) for _, d, _ in recs) <= chunk
    if kind != "fasta":
        # no-quality reads stay FASTQ records and parse back the same
        assert all(p.endswith(".fastq") for p in ours)


@pytest.mark.parametrize("kind", ["fastq", "fasta", "noq"])
@pytest.mark.parametrize("coverage", [1, 3, 50])
def test_rampler_subsample_equals_jax(read_sets, tmp_dir, kind, coverage):
    src = read_sets[kind]
    ours = rampler.subsample(src, 6_000, coverage,
                             os.path.join(tmp_dir, f"ss_{kind}"))
    theirs = jax_rampler.subsample(src, 6_000, coverage,
                                   os.path.join(tmp_dir, f"js_{kind}"))
    ext = ".fasta" if kind == "fasta" else ".fastq"
    base = os.path.basename(src).split(".")[0]
    assert os.path.basename(ours) == os.path.basename(theirs) == \
        f"{base}_{coverage}x{ext}"
    assert file_records(ours) == file_records(theirs)
    kept = records(ours)
    names = [n for n, _, _ in records(src)]
    assert [n for n, _, _ in kept] == [n for n in names
                                       if n in {k[0] for k in kept}]
    assert records(ours, jax_parser) == records(theirs, jax_parser)


def test_rampler_main_writes_the_named_files(read_sets, tmp_dir):
    out = os.path.join(tmp_dir, "cli_out")
    assert rampler.main(["-o", out, "split", read_sets["fastq"],
                         "5000"]) == 0
    assert rampler.main(["-o", out, "subsample", read_sets["fasta"],
                         "6000", "2"]) == 0
    names = sorted(os.listdir(out))
    assert "reads_2x.fasta" in names and "reads_0.fastq" in names


def test_preprocess_equals_jax(tmp_path):
    fq = tmp_path / "pairs.fastq"
    fq.write_text("@read1 extra\nACGT\n+\nIIII\n"
                  "@read2\nGGCC\n+\nIIII\n")
    fq2 = tmp_path / "pairs2.fastq"
    fq2.write_text("@read1\nTTAA\n+\nIIII\n")
    # a multi-line record too
    fq3 = tmp_path / "wrapped.fastq"
    fq3.write_text("@read3 x\nACGT\nAC\n+\nIIII\nII\n@read2\nA\n+\nI\n")
    ours, theirs = io.StringIO(), io.StringIO()
    seen, jseen = set(), set()
    for f in (fq, fq2, fq3):
        preprocess.parse_file(str(f), seen, ours)
        jax_preprocess.parse_file(str(f), jseen, theirs)
    assert ours.getvalue() == theirs.getvalue()
    lines = ours.getvalue().splitlines()
    assert lines[0] == "@read11" and lines[4] == "@read21"
    assert lines[8] == "@read12" and lines[9] == "TTAA"


def test_preprocess_main_prints_the_renamed_reads(tmp_path):
    fq = tmp_path / "a.fastq"
    fq.write_text("@r\nAC\n+\nII\n")
    fq2 = tmp_path / "b.fastq"
    fq2.write_text("@r\nGT\n+\nII\n")
    out = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.tools.preprocess", str(fq),
         str(fq2)], capture_output=True, cwd=REPO_ROOT, timeout=120)
    assert out.returncode == 0, out.stderr.decode()
    assert out.stdout == b"@r1\nAC\n+\nII\n@r2\nGT\n+\nII\n"


def _env(tmp, extra=None) -> dict:
    env = dict(os.environ)
    env.update(PINS)
    for k in UNSET:
        env.pop(k, None)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = tmp
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra or {})
    return env


def run_wrapper(module, args, cwd, env):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, env=env, cwd=cwd,
                          timeout=600)


@pytest.fixture(scope="module")
def two_targets(tmp_dir):
    """tests/test_tools.py's two-target set."""
    d = os.path.join(tmp_dir, "two")
    os.makedirs(d)
    t1 = b"ACGTTGCAACGTGGCCAATTCCGGACGTACGTTTAACCGGATCGATCGTA"
    t2 = b"TTGACCAGTAGGCCTTAGGCATCGAATTCGGCCAATGGTTACGCGATCAA"
    paths = [os.path.join(d, n) for n in ("reads.fasta", "ovl.paf",
                                          "targets.fasta")]
    with open(paths[2], "wb") as fh:
        fh.write(b">t1\n" + t1 + b"\n>t2\n" + t2 + b"\n")
    with open(paths[0], "wb") as fh:
        fh.write(b">r1\n" + t1 + b"\n>r2\n" + t2 + b"\n")
    with open(paths[1], "wb") as fh:
        fh.write(b"r1\t50\t0\t50\t+\tt1\t50\t0\t50\t50\t50\t255\n"
                 b"r2\t50\t0\t50\t+\tt2\t50\t0\t50\t50\t50\t255\n")
    return d, paths


@pytest.mark.parametrize("split", [None, 50])
def test_wrapper_equals_jax_wrapper(two_targets, split):
    d, paths = two_targets
    env = _env(d)
    base = ["-u", *paths] if split is None else \
        ["--split", str(split), "-u", *paths]
    ours = run_wrapper("racon_tpu_torch.tools.wrapper",
                       ["--device", "cpu", *base], d, env)
    assert ours.returncode == 0, ours.stderr.decode()
    theirs = run_wrapper("racon_tpu.tools.wrapper", base, d, env)
    assert theirs.returncode == 0, theirs.stderr.decode()
    assert ours.stdout == theirs.stdout
    assert ours.stdout.count(b">") == 2
    if split is not None:
        assert b"target split into 2 chunk(s)" in ours.stderr
    # the work directory goes at exit
    assert not [n for n in os.listdir(d)
                if n.startswith("racon_work_directory_")]


@pytest.fixture(scope="module")
def contigs(tmp_dir):
    from test_torch_scatter import four_contigs

    return four_contigs(os.path.join(tmp_dir, "four"))


def pair_split(draft: str) -> int:
    """The chunk size that puts contigs 0-1 in one chunk and 2-3 in the
    other."""
    lens = [len(d) for _, d, _ in records(draft)]
    assert len(lens) == 4
    return max(lens[0] + lens[1], lens[2] + lens[3])


def one_shot(data, *argv) -> bytes:
    from racon_tpu_torch import cli

    mp = pytest.MonkeyPatch()
    try:
        for k, v in PINS.items():
            mp.setenv(k, v)
        for k in UNSET:
            mp.delenv(k, raising=False)
        buf = io.BytesIO()
        cache.reset()
        cli.main(["--device", "cpu", *argv, *data], out=buf)
        return buf.getvalue()
    finally:
        mp.undo()
        cache.reset()


def test_wrapper_split_equals_whole_job(contigs, tmp_dir):
    whole = one_shot(contigs, *KERNEL_ARGS, *WRAPPER_SCORES)
    split = pair_split(contigs[2])
    out = run_wrapper("racon_tpu_torch.tools.wrapper",
                      ["--split", str(split), "-c", "1",
                       "--cudaaligner-batches", "1", "-t", "2", "--device",
                       "cpu", *contigs], tmp_dir, _env(tmp_dir))
    assert out.returncode == 0, out.stderr.decode()
    assert b"target split into 2 chunk(s)" in out.stderr
    assert out.stdout == whole
    assert out.stdout.count(b">") == 4
    # each chunk ran its own process, the kernels' plain versions on it
    assert out.stderr.count(b"pipeline summary:") == 2


def test_wrapper_rounds_with_a_client_split_exits_1(contigs, tmp_dir):
    reads, _, draft = contigs
    out = run_wrapper("racon_tpu_torch.tools.wrapper",
                      ["--split", str(pair_split(draft)), "--rounds", "2",
                       "--device", "cpu", reads, draft], tmp_dir,
                      _env(tmp_dir))
    assert out.returncode == 1
    assert b"--rounds > 1 cannot be combined" in out.stderr


def test_wrapper_chunk_failure_exits_1(tmp_dir, two_targets):
    # a chunk whose process fails (here: no such overlaps file) fails
    # the wrapper, with no fallback
    d, paths = two_targets
    out = run_wrapper("racon_tpu_torch.tools.wrapper",
                      ["--device", "cpu", paths[0],
                       os.path.join(d, "missing.paf"), paths[2]], d,
                      _env(d))
    assert out.returncode == 1


def test_console_scripts_resolve():
    import tomllib

    with open(os.path.join(REPO_ROOT, "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    port = {k: v for k, v in scripts.items()
            if k.startswith("racon-tpu-torch")}
    assert port == {
        "racon-tpu-torch": "racon_tpu_torch.cli:main",
        "racon-tpu-torch-wrapper": "racon_tpu_torch.tools.wrapper:main",
        "racon-tpu-torch-rampler": "racon_tpu_torch.tools.rampler:main",
        "racon-tpu-torch-preprocess":
            "racon_tpu_torch.tools.preprocess:main"}
    jax = {k: v for k, v in scripts.items() if k not in port}
    assert jax == {"racon-tpu": "racon_tpu.cli:main",
                   "racon-tpu-wrapper": "racon_tpu.tools.wrapper:main",
                   "racon-tpu-rampler": "racon_tpu.tools.rampler:main",
                   "racon-tpu-preprocess":
                       "racon_tpu.tools.preprocess:main"}
    for target in scripts.values():
        mod, _, attr = target.partition(":")
        assert callable(getattr(importlib.import_module(mod), attr))


def test_cli_entry_point_returns_an_exit_status(two_targets, monkeypatch):
    # a console script passes main()'s return to sys.exit
    from racon_tpu_torch import cli

    _, paths = two_targets
    for k, v in PINS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "argv", ["racon-tpu-torch", "--device", "cpu",
                                      "-u", *paths])
    buf = io.BytesIO()
    assert cli.main(out=buf) == 0
    assert buf.getvalue().count(b">") == 2
