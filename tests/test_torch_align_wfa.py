"""The port's WFA kernel function (racon_tpu_torch/cuda/align_wfa.py)
against the JAX package's Pallas kernel (racon_tpu/tpu/align_pallas.py:
_wfa_kernel with its pre-pass _wfa_match_words).

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
the Pallas kernel runs in interpret mode, as tests/test_wfa_pallas.py
runs it.  Both are integer programs, so meta (distance, entry count),
tape[:n] and the match words must be equal, tolerance 0.  Interpret
mode costs ~10 s per call at these shapes, so all cases ride one call
(module-scoped fixture).  The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py and by the ``cuda``
test below.
"""

import re

import numpy as np
import pytest
import torch

from racon_tpu_torch.cuda import align_wfa as aw
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.ops import cpu

LQ, EMAX = 512, 128
CASES = ["div05", "div15", "div25", "del60", "past_emax", "empty",
         "len_gap", "n_bases"]


def seq(n: int, rng) -> bytes:
    return bytes(rng.choice(list(b"ACGT"), n).astype(np.uint8))


def mutate(s: bytes, rate: float, rng) -> bytes:
    """Substitutions, insertions and deletions at ``rate`` in thirds."""
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


def make_pairs(rng):
    """One pair per case, in CASES order."""
    qs, ts = [], []
    for n, rate in ((300, 0.05), (420, 0.15), (360, 0.25)):
        q = seq(n, rng)
        qs.append(q)
        ts.append(mutate(q, rate, rng))
    q = seq(400, rng)                       # 60-bp deletion
    qs.append(q)
    ts.append(mutate(q[:150] + q[210:], 0.03, rng))
    qs.append(seq(300, rng))                # unrelated: distance > emax
    ts.append(seq(300, rng))
    qs.append(b"")                          # empty query
    ts.append(b"ACGT")
    qs.append(b"ACGT" * 20)                 # |tl - ql| = 240 > emax
    ts.append(b"ACGT" * 80)
    q = seq(200, rng)                       # N runs on both sides
    qs.append(q[:50] + b"NNNN" + q[50:150] + b"N" + q[150:])
    ts.append(q[:50] + b"NNNN" + mutate(q[50:150], 0.05, rng) + b"N"
              + q[150:])
    return qs, ts


def encode(qs, ts, device="cpu"):
    q = torch.from_numpy(al.encode_batch(qs, LQ, al.QPAD)).to(device)
    t = torch.from_numpy(al.encode_batch(ts, LQ, al.TPAD)).to(device)
    ql = torch.tensor([len(s) for s in qs], dtype=torch.int32,
                      device=device)
    tl = torch.tensor([len(s) for s in ts], dtype=torch.int32,
                      device=device)
    return q, t, ql, tl


@pytest.fixture(scope="module")
def runs():
    """Pairs, the Pallas (tapes, counts, dists) and the port's
    (tape, meta), as numpy."""
    from jax.experimental import pallas as pl

    from racon_tpu.tpu import align_pallas as ap

    qs, ts = make_pairs(np.random.default_rng(11))
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ap.pl, "pallas_call", interp)
        jt, jn, jd = ap.wfa_batch(qs, ts, LQ, EMAX)
    tape, meta = aw.wfa_align(*encode(qs, ts), emax=EMAX)
    return qs, ts, (jt, jn, jd), (tape.numpy().reshape(len(qs), -1),
                                  meta.numpy())


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_pallas(runs, case):
    k = CASES.index(case)
    _, _, (jt, jn, jd), (tape, meta) = runs
    assert int(meta[k, 0]) == int(jd[k])
    assert int(meta[k, 1]) == int(jn[k])
    n = int(jn[k])
    assert tape[k, :n].tolist() == jt[k, :n].tolist()


@pytest.mark.parametrize("case", ["past_emax", "empty", "len_gap"])
def test_rejects(runs, case):
    k = CASES.index(case)
    _, _, _, (tape, meta) = runs
    assert int(meta[k, 0]) == aw.BIG and int(meta[k, 1]) == 0
    assert not tape[k].any()


def merged_m_cigar(cig: str) -> str:
    """Fold =/X runs into 'M' runs (the native engine's alphabet)."""
    ops = "".join(("M" if o in "=X" else o) * int(n)
                  for n, o in re.findall(r"(\d+)([=XID])", cig))
    return "".join(f"{len(m.group(0))}{m.group(0)[0]}"
                   for m in re.finditer(r"(.)\1*", ops))


@pytest.mark.parametrize("case", ["div05", "div15", "div25", "del60",
                                  "n_bases"])
def test_tape_decodes_to_native(runs, case):
    """Ops equal the JAX decoder's, the distance is the exact edit
    distance, and the CIGAR equals the native engine's in M form."""
    from racon_tpu.tpu import align_pallas as ap

    k = CASES.index(case)
    qs, ts, (jt, jn, _), (tape, meta) = runs
    n = int(meta[k, 1])
    ops = aw.wfa_tape_to_ops(tape[k], n)
    assert ops.tolist() == ap.wfa_tape_to_ops(jt[k], int(jn[k])).tolist()
    want = cpu.edit_distance(qs[k], ts[k])
    assert int(meta[k, 0]) == want
    assert int(np.sum(ops != al.OP_EQ)) == want
    cig = al.ops_to_cigar(ops)
    assert merged_m_cigar(cig) == cpu.align(qs[k], ts[k])


def test_match_words_bit_equal():
    import jax.numpy as jnp

    from racon_tpu.tpu import align_pallas as ap

    qs, ts = make_pairs(np.random.default_rng(11))
    q, t, _, _ = encode(qs, ts)
    want = np.asarray(ap._wfa_match_words(
        jnp.asarray(q.numpy()), jnp.asarray(t.numpy()), LQ, EMAX,
        ap._wfa_wd(EMAX)))
    got = aw.wfa_match_words(q, t, EMAX)
    assert got.shape == (len(qs), aw.wfa_nwords(LQ), aw.wfa_wd(EMAX))
    assert np.array_equal(got.reshape(-1, aw.wfa_wd(EMAX)).numpy(), want)


def test_sizes_match_jax():
    from racon_tpu.tpu import align_pallas as ap

    for emax in (64, 512, 1024, 2048):
        assert aw.wfa_wd(emax) == ap._wfa_wd(emax)
        assert aw.wfa_tape_rows(emax) == ap._wfa_tape_rows(emax)
    for lq in (128, 512, 8192, 16384):
        assert aw.wfa_nwords(lq) == ap._wfa_nwords(lq)


def test_pair_alone_equals_pair_in_batch(runs):
    qs, ts, _, (tape, meta) = runs
    for k in (1, 3, 7):
        t1, m1 = aw.wfa_align(*encode([qs[k]], [ts[k]]), emax=EMAX)
        assert m1[0].tolist() == meta[k].tolist()
        assert t1.numpy().reshape(-1).tolist() == tape[k].tolist()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "fits"])
def test_wrapper_rejects_bad_inputs(bad):
    qs, ts = make_pairs(np.random.default_rng(2))
    args = list(encode(qs[:3], ts[:3]))
    emax = EMAX
    if bad == "dtype":
        args[2] = args[2].to(torch.int64)
    elif bad == "shape":
        args[1] = args[1][:, :-1]
    elif bad == "contiguous":
        args[0] = torch.cat([args[0], args[0]], 1)[:, ::2]
    else:
        emax = 0
    with pytest.raises(ValueError):
        aw.wfa_align(*args, emax=emax)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card (needs a
    GPU and nvcc; run with ``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qs, ts = make_pairs(np.random.default_rng(11))
    args = encode(qs, ts, "cuda")
    kt, km = aw.wfa_align(*args, emax=EMAX)
    pt, pm = aw.wfa_align_reference(*args, emax=EMAX)
    torch.cuda.synchronize()
    assert torch.equal(km[:, :2], pm[:, :2])
    for k in range(len(qs)):
        n = int(pm[k, 1])
        assert torch.equal(kt[k].reshape(-1)[:n], pt[k].reshape(-1)[:n])


def test_trailing_ones_exact():
    """The plain version's trailing-ones count is an integer bit count,
    exact for every run length on every device."""
    runs = torch.arange(33, dtype=torch.int64)
    x = (1 << runs) - 1                     # `runs` trailing ones
    assert aw._trailing_ones(x).tolist() == runs.tolist()
    assert aw._trailing_ones(x | (1 << 33)).tolist() == runs.tolist()
