"""The port's slice end to end: the one-shot CLI with ``--device cpu
-c 1`` (every eligible window through the POA kernel's plain version,
rejects through the native engine) against the JAX package's CPU
polish of the same simulated set, plus the port's device and import
rules."""

import ast
import io
import os

import pytest
import torch

from racon_tpu.core import polisher as jax_polisher
from racon_tpu.tools import simulate
from racon_tpu_torch import cache, cli, resolve_device
from racon_tpu_torch.ops import cpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]


def _read_fasta(path):
    with open(path, "rb") as fh:
        return b"".join(l.strip() for l in fh if not l.startswith(b">"))


def _records(buf: bytes):
    lines = buf.split(b"\n")
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines) - 1, 2)]


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
def polished(tmp_path_factory, device_only_env):
    out = tmp_path_factory.mktemp("slice_sim")
    paths = simulate.simulate(str(out), genome_len=10_000, coverage=10,
                              read_len=2_000, seed=5, ont=True)
    buf = io.BytesIO()
    cache.reset()                       # a module fixture: cold by hand
    pol = cli.main(["--device", "cpu", "-t", "4", "-c", "1", *SCORES,
                    *paths], out=buf)
    ref = jax_polisher.create_polisher(
        *paths, jax_polisher.PolisherType.kC, 500, 10.0, 0.3, True, 5, -4,
        -8, 4)
    ref.initialize()
    jax_out = ref.polish(True)
    ref.close()
    truth = _read_fasta(os.path.join(out, "genome.fasta"))
    return dict(port=_records(buf.getvalue()), jax=jax_out, pol=pol,
                truth=truth, draft=_read_fasta(paths[2]))


@pytest.fixture(autouse=True)
def cold_result_cache():
    """Every test starts and ends with an empty result cache, as a fresh
    process would: a test here counts launches, rungs or rates, or
    swaps an engine, and must not see what an earlier test filled."""
    cache.reset()
    yield
    cache.reset()


def test_cli_polishes_on_cpu_plain_path(polished):
    pol = polished["pol"]
    assert pol.poa_engine is not None
    assert pol.poa_engine.windows_on_kernel > 0
    assert pol.poa_engine.windows_on_kernel \
        + sum(pol.poa_reject_counts.values()) == pol.poa_eligible_windows
    assert set(pol.stage_walls) >= {"parse", "align", "windows", "poa"}


def test_polished_beats_draft_and_matches_jax(polished):
    """Tolerance: the POA kernel and the native engine resolve
    cost-equal alignment ties differently (tests/test_poa_full_device.py),
    so the port's distance to truth may exceed the JAX package's CPU
    polish by at most 10% + 10 edits."""
    (name, data), = polished["port"]
    (jax_seq,) = polished["jax"]
    assert name.split()[0] == jax_seq.name.split()[0].encode()
    d_port = cpu.edit_distance(data, polished["truth"])
    d_jax = cpu.edit_distance(jax_seq.data, polished["truth"])
    d_draft = cpu.edit_distance(polished["draft"], polished["truth"])
    assert d_port < d_draft
    assert d_port <= 1.1 * d_jax + 10


def test_three_quanta_lag_window(tmp_path):
    """Window 35 of this set has a predecessor row lagging three band
    quanta at the stock caps (V 2048, LP 1024, WB 256): the realigned
    row must be cut back to the band (ROADMAP Queue 3)."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher
    from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine

    paths = simulate.simulate(str(tmp_path), genome_len=20_000,
                              coverage=10, read_len=2_000, seed=7,
                              ont=True)
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, 4)
    pol.initialize()
    w = pol.windows[35]
    pol.close()
    (cons, ok), = CudaPoaBatchEngine(5, -4, -8, device="cpu") \
        .consensus_batch([w], True)
    assert ok and cons
    ref = cpu.PoaEngine(5, -4, -8).consensus(w, True)
    assert cpu.edit_distance(cons, ref) <= max(2, len(ref) // 20)


def test_cli_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-c", "1", "r.fastq", "o.paf", "d.fasta"],
                 out=io.BytesIO())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "racon_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "racon_tpu"), (path, mod)
