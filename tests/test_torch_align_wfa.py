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
test below.  The constructed pairs of ``tools/wfa_pairs.py`` (the
kernel's rare paths) ride the same call.
"""

import re

import numpy as np
import pytest
import torch

from racon_tpu_torch.cuda import align_wfa as aw
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.tools import wfa_pairs

LQ, EMAX = 512, 128
CASES = ["div05", "div15", "div25", "del60", "past_emax", "empty",
         "len_gap", "n_bases"]
# constructed pairs of tools/wfa_pairs.py, after CASES
WP = ["wp_" + name for name in wfa_pairs.CASES]


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


def all_pairs():
    """CASES, then the constructed pairs: (queries, targets)."""
    qs, ts = make_pairs(np.random.default_rng(11))
    _, wq, wt = wfa_pairs.wfa_pairs(LQ, EMAX, seed=5)
    return qs + wq, ts + wt


def encode(qs, ts, device="cpu", lq=LQ):
    q = torch.from_numpy(al.encode_batch(qs, lq, al.QPAD)).to(device)
    t = torch.from_numpy(al.encode_batch(ts, lq, al.TPAD)).to(device)
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

    qs, ts = all_pairs()
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ap.pl, "pallas_call", interp)
        jt, jn, jd = ap.wfa_batch(qs, ts, LQ, EMAX)
    tape, meta = aw.wfa_align(*encode(qs, ts), emax=EMAX, lmax=LQ)
    return qs, ts, (jt, jn, jd), (tape.numpy().reshape(len(qs), -1),
                                  meta.numpy())


@pytest.mark.parametrize("case", CASES + WP)
def test_plain_equals_pallas(runs, case):
    k = (CASES + WP).index(case)
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
        t1, m1 = aw.wfa_align(*encode([qs[k]], [ts[k]]), emax=EMAX,
                              lmax=LQ)
        assert m1[0].tolist() == meta[k].tolist()
        assert t1.numpy().reshape(-1).tolist() == tape[k].tolist()


def longest(qs, ts) -> int:
    return max(max(map(len, qs)), max(map(len, ts)), 1)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "fits",
                                 "lmax"])
def test_wrapper_rejects_bad_inputs(bad):
    qs, ts = make_pairs(np.random.default_rng(2))
    args = list(encode(qs[:3], ts[:3]))
    emax = EMAX
    if bad == "lmax":
        # below the batch's longest pair, and outside [1, lq]
        for lmax in (longest(qs[:3], ts[:3]) - 1, 0, LQ + 1):
            with pytest.raises(ValueError):
                aw.wfa_align(*args, emax=emax, lmax=lmax)
        return
    if bad == "dtype":
        args[2] = args[2].to(torch.int64)
    elif bad == "shape":
        args[1] = args[1][:, :-1]
    elif bad == "contiguous":
        args[0] = torch.cat([args[0], args[0]], 1)[:, ::2]
    else:
        emax = 0
    with pytest.raises(ValueError):
        aw.wfa_align(*args, emax=emax, lmax=LQ)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,emax,reps", [(LQ, EMAX, 1), (LQ, EMAX, 30),
                                          (16384, 2048, 1)])
def test_kernel_matches_plain_on_card(lq, emax, reps):
    """The CUDA kernel against its plain version on the card (needs a
    GPU and nvcc; run with ``pytest -m cuda`` on the card): the CPU
    cases and the constructed pairs at the tests' lq 512 / emax 128
    (alone, at 16 warps per pair, and 30 times over, at 8), and the
    constructed pairs alone at lq 16,384 / emax 2048, far shorter than
    the padded width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if lq == LQ:
        qs, ts = all_pairs()
    else:
        _, qs, ts = wfa_pairs.wfa_pairs(lq, emax, seed=5)
    qs, ts = qs * reps, ts * reps
    args = encode(qs, ts, "cuda", lq)
    kt, km = aw.wfa_align(*args, emax=emax, lmax=longest(qs, ts))
    pt, pm = aw.wfa_align_reference(*args, emax=emax)
    torch.cuda.synchronize()
    assert torch.equal(km[:, :2], pm[:, :2])
    stepped = (args[2] > 0) & (args[3] > 0) \
        & ((args[3] - args[2]).abs() <= emax)
    assert bool((km[stepped, 2] > 0).all())     # step cycles
    for k in range(len(qs)):
        n = int(pm[k, 1])
        assert torch.equal(kt[k].reshape(-1)[:n], pt[k].reshape(-1)[:n])


@pytest.mark.cuda
def test_kernel_marks_pairs_past_lmax():
    """A pair longer than the launch's ``lmax`` is not aligned but
    marked (meta[:, 0] = TOO_LONG, no tape); the others are unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qs, ts = all_pairs()
    lmax = longest(qs, ts) - 1
    args = encode(qs, ts, "cuda")
    kt, km = aw.wfa_align(*args, emax=EMAX, lmax=lmax)
    pt, pm = aw.wfa_align_reference(*args, emax=EMAX)
    torch.cuda.synchronize()
    over = torch.maximum(args[2], args[3]) > lmax
    assert bool(over.any())
    assert bool((km[over, 0] == aw.TOO_LONG).all())
    assert not bool(km[over, 1].any()) and not bool(kt[over].any())
    assert torch.equal(km[~over, :2], pm[~over, :2])


def _diagonals(tape_row, n):
    """The traceback's diagonal d = j - i after each of its steps, from
    the final diagonal (insertion d + 1, substitution d, deletion
    d - 1), top step first."""
    ops = np.asarray(tape_row[:n - 1]) & 3
    return np.cumsum(np.where(ops == aw.W_INS, 1,
                              np.where(ops == aw.W_DEL, -1, 0)))


@pytest.mark.parametrize("case", wfa_pairs.CASES)
def test_wfa_pairs_take_their_paths(runs, case):
    """Each constructed pair takes the path its name promises, with the
    native engine's distance where it is certified."""
    k = len(CASES) + list(wfa_pairs.CASES).index(case)
    qs, ts, _, (tape, meta) = runs
    q, t = qs[k], ts[k]
    dist, n = int(meta[k, 0]), int(meta[k, 1])
    if case in wfa_pairs.REJECTED:
        assert dist == aw.BIG and cpu.edit_distance(q, t) > EMAX
        return
    assert dist == cpu.edit_distance(q, t) and n == dist + 1
    slides = tape[k, :n] >> 2
    if case in ("del_run", "ins_run"):
        # some 32-step traceback window is crossed from its centre
        # diagonal to its edge
        dg = np.concatenate(([0], _diagonals(tape[k], n)))
        moved = [abs(dg[s + aw.WIN - 1] - dg[s])
                 for s in range(0, n - aw.WIN, aw.WIN)]
        assert max(moved) == aw.WIN - 1
    elif case in ("dist_emax", "len_gap_emax"):
        assert dist == EMAX
        assert (abs(len(t) - len(q)) == EMAX) == (case == "len_gap_emax")
    elif case == "identical":
        assert dist == 0 and slides.tolist() == [len(q)]
    elif case == "sub_at_start":
        # after the substitution at base 0 one slide reaches both ends
        assert dist == 1 and slides.tolist() == [len(q) - 1, 0]
    elif case == "n_runs":
        assert b"N" * 12 in q and dist == 1
    elif case == "ql_one":
        assert len(q) == 1 and dist == len(t) - 1
    elif case == "tl_one":
        assert len(t) == 1 and dist == len(q) - 1
    else:
        assert dist > len(q)


def test_trailing_ones_exact():
    """The plain version's trailing-ones count is an integer bit count,
    exact for every run length on every device."""
    runs = torch.arange(33, dtype=torch.int64)
    x = (1 << runs) - 1                     # `runs` trailing ones
    assert aw._trailing_ones(x).tolist() == runs.tolist()
    assert aw._trailing_ones(x | (1 << 33)).tolist() == runs.tolist()
