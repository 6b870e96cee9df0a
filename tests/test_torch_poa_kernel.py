"""The port's POA kernel function (racon_tpu_torch/cuda/poa_full.py)
against the JAX package's Pallas kernel (racon_tpu/tpu/poa_pallas.py).

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
the Pallas kernel runs in interpret mode, as tests/test_poa_full_device.py
runs it.  Both are integer programs, so the consensus characters
(cons[:len]) and mout[:, :5] (length, status, fail code, nodes, DP rank
steps) must be equal, tolerance 0.  Interpret mode costs ~45 s per call
at these shapes, so each case batches all its windows into one call
(module-scoped fixture).  Besides random windows, each case carries
the three constructed windows of racon_tpu_torch/tools/poa_windows.py,
which drive the kernel's device-memory paths (pred slots past its
shared-memory mirror, pred rows older than its shared-memory ring) and
its second pass (a graph larger than the first pass holds).
The CUDA kernel itself is held against the same plain version on the
card by chip_smoke.py and by the ``cuda`` tests below.
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch import convert
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.cuda import build
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.tools.poa_windows import stress_windows

V = LP = WB = 256
SCORES = dict(match=5, mismatch=-4, gap=-8)
# (window type, trim): TGS trimmed, NGS (never trimmed) untrimmed
CASES = [(WindowType.TGS, 1), (WindowType.NGS, 0)]
N_WINDOWS = 9
# the stress windows' indices, just before the forced reject
MANY_PREDS, OLD_PRED_ROW, BIG_GRAPH = range(N_WINDOWS - 4, N_WINDOWS - 1)


def _mutate(s: bytes, rate: float, rng) -> bytes:
    out = bytearray()
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(int(rng.choice(list(b"ACGT"))) if r < 2 * rate / 3
                   else ch)
        if r > 1 - rate / 3:
            out.append(int(rng.choice(list(b"ACGT"))))
    return bytes(out)


def _seq(n: int, rng) -> bytes:
    return bytes(rng.choice(list(b"ACGT"), n).astype(np.uint8))


def make_windows(wtype: WindowType, seed: int):
    """Five small windows (full and partial layers, with and without
    qualities), the three stress windows, and one whose unrelated
    layers overflow the 256-node graph: a forced FAIL_VCAP reject."""
    rng = np.random.default_rng(seed)
    wins, truths = [], []
    for k in range(N_WINDOWS - 4):
        truth = _seq(int(rng.integers(40, 72)), rng)
        bb = _mutate(truth, 0.1, rng)
        w = Window(0, k, wtype, bb, b"!" * len(bb))
        for d in range(int(rng.integers(3, 7))):
            if k % 2 and d % 2:
                lo = int(rng.integers(0, len(truth) // 3))
                hi = int(rng.integers(2 * len(truth) // 3, len(truth)))
                layer = _mutate(truth[lo:hi], 0.1, rng)
                span = (lo, min(hi, len(bb) - 1))
            else:
                layer = _mutate(truth, 0.1, rng)
                span = (0, len(bb) - 1)
            qual = None if k == 2 else bytes(
                (rng.integers(40, 80, len(layer)) + 33).astype(np.uint8))
            w.add_layer(layer, qual, *span)
        wins.append(w)
        truths.append(truth)
    stress, backbones = stress_windows(wtype, seed=seed, rank0=len(wins))
    wins += stress
    truths += backbones
    bad = Window(0, N_WINDOWS - 1, wtype, _seq(120, rng), b"!" * 120)
    for _ in range(4):
        bad.add_layer(_seq(120, rng), None, 0, 119)
    wins.append(bad)
    truths.append(None)
    return wins, truths


def _pallas(pk, wtype, trim):
    from jax.experimental import pallas as pl

    from racon_tpu.tpu import poa_pallas

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(poa_pallas.pl, "pallas_call", interp)
        return poa_pallas.poa_full_batch(
            pk.seqs, pk.wts, pk.meta, pk.nlay, pk.bblen, v=V, lp=LP,
            d1=pk.seqs.shape[1], wb=WB, wtype=wtype.value, trim=trim,
            **SCORES)


@pytest.fixture(scope="module")
def runs():
    """Per case: windows, truths, Pallas (cons, mout), port (cons,
    mout), the port's shared-memory path counts, all as numpy."""
    out = {}
    for seed, (wtype, trim) in enumerate(CASES):
        wins, truths = make_windows(wtype, seed + 7)
        pk = convert.pack_windows(wins, LP, V)
        jc, jm = _pallas(pk, wtype, trim)
        stats = torch.zeros((pk.seqs.shape[0], 3), dtype=torch.int32)
        tc, tm = pf.poa_full(
            *convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                               pk.bblen, "cpu"),
            v=V, lp=LP, wb=WB, wtype=wtype.value, trim=trim, **SCORES,
            stats=stats)
        out[(wtype, trim)] = (wins, truths, (np.asarray(jc), np.asarray(jm)),
                              (tc.numpy(), tm.numpy()), stats.numpy())
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c}")
@pytest.mark.parametrize("idx", range(N_WINDOWS))
def test_plain_equals_pallas(runs, case, idx):
    _, _, (jc, jm), (tc, tm), _ = runs[case]
    assert tm[idx, :5].tolist() == jm[idx, :5].tolist()
    length = int(jm[idx, 0])
    if length > 0:
        assert tc[idx, :length].tolist() == jc[idx, :length].tolist()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c}")
def test_forced_reject(runs, case):
    _, _, (_, jm), (_, tm), _ = runs[case]
    assert tm[N_WINDOWS - 1, 0] == -1
    assert tm[N_WINDOWS - 1, 2] == pf.FAIL_VCAP
    assert (tm[:N_WINDOWS - 1, 0] > 0).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c}")
def test_plain_near_native_engine(runs, case):
    """Like the Pallas kernel vs the CPU engine: cost-equal alignment
    ties resolve differently, so consensus is held within the edit
    tolerance of tests/test_poa_full_device.py."""
    wins, truths, _, (tc, tm), _ = runs[case]
    wtype, trim = case
    eng = cpu.PoaEngine(**SCORES)
    for w, truth, c, m in zip(wins[:-1], truths, tc, tm):
        out = bytes(c[:int(m[0])].astype(np.uint8))
        ref = eng.consensus(w, bool(trim))
        assert cpu.edit_distance(out, ref) <= max(2, len(truth) // 20)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c}")
def test_stress_windows_take_device_paths(runs, case):
    """On the plain version's graph: the first stress window reads pred
    slots past the kernel's shared-memory mirror, the second reads a
    pred row at least RING_ROWS ranks old; the random windows stay in
    shared memory.  (The kernel reports the same counts, held equal on
    the card by chip_smoke.py.)"""
    *_, stats = runs[case]
    ring_hits, ring_misses, overflow = stats.T
    assert overflow[MANY_PREDS] > 0 and ring_misses[MANY_PREDS] == 0
    assert ring_misses[OLD_PRED_ROW] > 0 and overflow[OLD_PRED_ROW] == 0
    assert (ring_hits[:N_WINDOWS - 1] > 0).all()
    assert (ring_misses[:MANY_PREDS] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c}")
def test_big_graph_window_needs_second_pass(runs, case):
    """On the plain version's graph: the third stress window ends with
    more nodes than the kernel's first pass holds at these caps, but
    within the cap, and completes (so on the card it runs in the second
    pass and is held equal to the plain version there)."""
    _, truths, _, (tc, tm), _ = runs[case]
    assert pf.first_pass_nodes(V) < tm[BIG_GRAPH, 3] <= V
    assert tm[BIG_GRAPH, 2] == 0 and tm[BIG_GRAPH, 0] > 0
    assert bytes(tc[BIG_GRAPH, :tm[BIG_GRAPH, 0]].astype(np.uint8)) \
        == truths[BIG_GRAPH]
    assert (tm[:BIG_GRAPH, 3] <= pf.first_pass_nodes(V)).all()


@pytest.mark.parametrize("v, lp, wb, d1", [
    (2048, 1024, 256, 8), (2048, 1024, 256, 256),
    (256, 256, 256, 8), (256, 256, 256, 256)])
def test_fits_stock_and_tiny_caps(v, lp, wb, d1):
    """The stock caps (V 2048, LP 1024, WB 256, D1 up to 256) and the
    tiny caps of these tests fit, in both passes of the kernel."""
    assert pf.fits(v, lp, d1, 16, 16, 8, wb)
    vs = pf.first_pass_nodes(v)
    assert 64 <= vs < v and vs % 16 == 0
    assert pf.smem_bytes(vs, lp, wb) < pf.smem_bytes(v, lp, wb) \
        <= pf.SMEM_MAX


def test_shared_memory_and_scratch_sizes():
    """The stock layout: 65,792 bytes of shared memory for the full
    graph (three blocks per 228 KB SM, 1 KB of it reserved per block),
    45,376 for the first pass's 1,344 nodes (five), and device scratch
    per resident block,
    independent of the batch: 2,048 x (256 + 12 + 16 + 8) words."""
    assert pf.first_pass_nodes(2048) == 1344
    assert pf.smem_bytes(2048, 1024, 256) == 65_792
    assert pf.smem_bytes(1344, 1024, 256) == 45_376
    assert 3 * (65_792 + 1024) <= 233_472 < 4 * (65_792 + 1024)
    assert 5 * (45_376 + 1024) <= 233_472
    assert pf.scratch_words(2048, 1024, 256, 16, 16, 8) == 2048 * 292


def test_batch_size_charges_the_largest_pass(monkeypatch):
    """A launch allocates one scratch slice per block of its largest
    pass grid; the polisher's megabatch sizing charges exactly that
    (the H100's 660 first-pass blocks at the stock caps, not the 396 of
    the second pass), and a small batch needs no more slices than it
    has windows."""
    from types import SimpleNamespace

    from racon_tpu_torch.cuda.polisher import CudaPolisher

    slots = {1344: 660, 2048: 396}
    monkeypatch.setattr(pf, "resident_slots",
                        lambda dev, n, lp, wb: slots[n])
    assert pf.pass_grids("cuda", 4096, 2048, 1024, 256) == [
        (1344, 0, 660), (2048, 1, 396)]
    assert pf.pass_grids("cuda", 100, 2048, 1024, 256) == [
        (1344, 0, 100), (2048, 1, 100)]
    free = 20 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (free, 80 << 30))
    pol = SimpleNamespace(device=torch.device("cuda"), MAX_BATCH=1 << 20,
                          cuda_banded_alignment=False, cuda_poa_batches=1)
    d1 = 64
    per_window = 2 * d1 * 1024 + 32 * d1 + 4 * 2048 + 64
    scratch = 4 * 660 * pf.scratch_words(2048, 1024, 256, 16, 16, 8)
    assert CudaPolisher._poa_batch_size(pol, 2048, 1024, d1) == int(
        (0.9 * free / 2 - scratch) // per_window)


def test_graph_over_shared_memory_raises():
    """A graph cap whose shared-memory graph exceeds what one block may
    opt in to does not fit, and the wrapper raises before any launch."""
    assert pf.smem_bytes(8192, 1024, 256) > pf.SMEM_MAX
    assert not pf.fits(8192, 1024, 8, 16, 16, 8, 256)
    wins, _ = make_windows(WindowType.TGS, 1)
    pk = convert.pack_windows(wins[:2], 1024, 8192)
    args = convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay, pk.bblen,
                             "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        pf.poa_full(*args, v=8192, lp=1024, wb=256, wtype=1, trim=1,
                    **SCORES)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "fits"])
def test_wrapper_rejects_bad_inputs(bad):
    wins, _ = make_windows(WindowType.TGS, 1)
    pk = convert.pack_windows(wins[:2], LP, V)
    args = list(convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                                  pk.bblen, "cpu"))
    kw = dict(v=V, lp=LP, wb=WB, wtype=1, trim=1, **SCORES)
    if bad == "dtype":
        args[2] = args[2].to(torch.int64)
    elif bad == "shape":
        args[3] = args[3][:-1]
    elif bad == "contiguous":
        args[0] = args[0].transpose(0, 1)
    else:
        kw["wb"] = 200
    with pytest.raises(ValueError):
        pf.poa_full(*args, **kw)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, into
    buffers made before the launch; with none the wrapper raises before
    any launch (needs a GPU and nvcc; run with ``pytest -m cuda`` on the
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed, (wtype, trim) in enumerate(CASES):
        wins, _ = make_windows(wtype, seed + 7)
        pk = convert.pack_windows(wins, LP, V)
        args = convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                                 pk.bblen, "cuda")
        kw = dict(v=V, lp=LP, wb=WB, wtype=wtype.value, trim=trim,
                  **SCORES)
        launches = build.launch_counts()["poa_full"]
        with pytest.raises(ValueError, match="poa_full_buffers"):
            pf.poa_full(*args, **kw)
        assert build.launch_counts()["poa_full"] == launches
        kc, km = pf.poa_full(*args, **kw, bufs=pf.poa_full_buffers(
            int(pk.seqs.shape[0]), v=V, lp=LP, wb=WB, device="cuda"))
        pc, pm = pf.poa_full_reference(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(km[:, :5], pm[:, :5])
        for i in range(len(wins)):
            n = max(int(pm[i, 0]), 0)
            assert torch.equal(kc[i, :n], pc[i, :n])


@pytest.mark.cuda
def test_window_alone_equals_window_in_full_batch():
    """A window launched alone equals the same window inside a
    1,000-window batch, which runs through the persistent queue of both
    passes (the batch outnumbers the card's resident blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wins, _ = make_windows(WindowType.TGS, 9)
    kw = dict(v=V, lp=LP, wb=WB, wtype=1, trim=1, **SCORES)

    def run(ws):
        pk = convert.pack_windows(ws, LP, V)
        return pf.poa_full(*convert.to_device(
            pk.seqs, pk.wts, pk.meta, pk.nlay, pk.bblen, "cuda"), **kw,
            bufs=pf.poa_full_buffers(int(pk.seqs.shape[0]), v=V, lp=LP,
                                     wb=WB, device="cuda"))

    batch = (wins * (1000 // len(wins) + 1))[:1000]
    bc, bm = run(batch)
    torch.cuda.synchronize()
    for i, w in enumerate(wins):
        c1, m1 = run([w])
        n = max(int(m1[0, 0]), 0)
        for k in range(i, 1000, len(wins)):
            assert torch.equal(bm[k, :5], m1[0, :5])
            assert torch.equal(bc[k, :n], c1[0, :n])
