"""The port's POA kernel function (racon_tpu_torch/cuda/poa_full.py)
against the JAX package's Pallas kernel (racon_tpu/tpu/poa_pallas.py).

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
the Pallas kernel runs in interpret mode, as tests/test_poa_full_device.py
runs it.  Both are integer programs, so the consensus characters
(cons[:len]) and mout[:, :5] (length, status, fail code, nodes, DP rank
steps) must be equal, tolerance 0.  Interpret mode costs ~45 s per call
at these shapes, so each case batches all its windows into one call
(module-scoped fixture).  The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py and by the ``cuda``
test below.
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch import convert
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.ops import cpu

V = LP = WB = 256
SCORES = dict(match=5, mismatch=-4, gap=-8)
# (window type, trim): TGS trimmed, NGS (never trimmed) untrimmed
CASES = [(WindowType.TGS, 1), (WindowType.NGS, 0)]
N_WINDOWS = 6


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
    qualities) and one whose unrelated layers overflow the 256-node
    graph: a forced FAIL_VCAP reject."""
    rng = np.random.default_rng(seed)
    wins, truths = [], []
    for k in range(N_WINDOWS - 1):
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
    mout), all as numpy."""
    out = {}
    for seed, (wtype, trim) in enumerate(CASES):
        wins, truths = make_windows(wtype, seed + 7)
        pk = convert.pack_windows(wins, LP, V)
        jc, jm = _pallas(pk, wtype, trim)
        tc, tm = pf.poa_full(
            *convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                               pk.bblen, "cpu"),
            v=V, lp=LP, wb=WB, wtype=wtype.value, trim=trim, **SCORES)
        out[(wtype, trim)] = (wins, truths, (np.asarray(jc), np.asarray(jm)),
                              (tc.numpy(), tm.numpy()))
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c}")
@pytest.mark.parametrize("idx", range(N_WINDOWS))
def test_plain_equals_pallas(runs, case, idx):
    _, _, (jc, jm), (tc, tm) = runs[case]
    assert tm[idx, :5].tolist() == jm[idx, :5].tolist()
    length = int(jm[idx, 0])
    if length > 0:
        assert tc[idx, :length].tolist() == jc[idx, :length].tolist()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c}")
def test_forced_reject(runs, case):
    _, _, (_, jm), (_, tm) = runs[case]
    assert tm[N_WINDOWS - 1, 0] == -1
    assert tm[N_WINDOWS - 1, 2] == pf.FAIL_VCAP
    assert (tm[:N_WINDOWS - 1, 0] > 0).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c}")
def test_plain_near_native_engine(runs, case):
    """Like the Pallas kernel vs the CPU engine: cost-equal alignment
    ties resolve differently, so consensus is held within the edit
    tolerance of tests/test_poa_full_device.py."""
    wins, truths, _, (tc, tm) = runs[case]
    wtype, trim = case
    eng = cpu.PoaEngine(**SCORES)
    for w, truth, c, m in zip(wins[:-1], truths, tc, tm):
        out = bytes(c[:int(m[0])].astype(np.uint8))
        ref = eng.consensus(w, bool(trim))
        assert cpu.edit_distance(out, ref) <= max(2, len(truth) // 20)


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
    """The CUDA kernel against its plain version on the card (needs a
    GPU and nvcc; run with ``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed, (wtype, trim) in enumerate(CASES):
        wins, _ = make_windows(wtype, seed + 7)
        pk = convert.pack_windows(wins, LP, V)
        args = convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                                 pk.bblen, "cuda")
        kw = dict(v=V, lp=LP, wb=WB, wtype=wtype.value, trim=trim,
                  **SCORES)
        kc, km = pf.poa_full(*args, **kw)
        pc, pm = pf.poa_full_reference(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(km[:, :5], pm[:, :5])
        for i in range(len(wins)):
            n = max(int(pm[i, 0]), 0)
            assert torch.equal(kc[i, :n], pc[i, :n])
