"""The port's banded align kernel function (racon_tpu_torch/cuda/
align_band.py) and its host helpers against the JAX package's
(racon_tpu/tpu/align_pallas.py:_kernel, the center-table helpers,
moves_to_ops, and racon_tpu/tpu/aligner.py's codecs).

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
the Pallas kernel runs in interpret mode.  Both are integer programs:
distances must be equal for every pair, and move counts and moves[:len]
wherever the distance is below BIG, tolerance 0.  Interpret mode is
costly (~10 s for the proportional call, ~40 s for the measured-center
call at lq 2048 / wb 1024), so each rides one module-scoped call; the
constructed pairs of ``tools/band_pairs.py`` (forced band steps and
edge cases, on hand-made knots) ride the first.
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.cuda import align_band as ab
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.tools import band_pairs
from test_torch_align_wfa import mutate, seq

LQ, WB = 512, 256
CASES = ["div05", "div15", "div25", "del60", "n_bases", "len_gap",
         "empty_query", "drift"]
# constructed pairs of tools/band_pairs.py (hand-made knots), after CASES
BP = ["bp_" + name for name in band_pairs.CASES]


def make_pairs(rng):
    qs, ts = [], []
    for n, rate in ((300, 0.05), (420, 0.15), (360, 0.25)):
        q = seq(n, rng)
        qs.append(q)
        ts.append(mutate(q, rate, rng))
    q = seq(400, rng)                       # 60-bp deletion
    qs.append(q)
    ts.append(mutate(q[:150] + q[210:], 0.03, rng))
    q = seq(200, rng)                       # N runs on both sides
    qs.append(q[:50] + b"NNNN" + q[50:])
    ts.append(q[:50] + b"NNNN" + mutate(q[50:], 0.05, rng))
    q = seq(480, rng)                       # tl far below ql
    qs.append(q)
    ts.append(q[:100])
    qs.append(b"")                          # empty query: tl left moves
    ts.append(seq(90, rng))
    q = seq(500, rng)                       # 120-bp deletion drifts the
    qs.append(q)                            # path toward the band edge
    ts.append(mutate(q[:200] + q[320:], 0.02, rng))
    return qs, ts


def encode(qs, ts, lq, lt, knots, device="cpu"):
    def lens(ss):
        return torch.tensor([len(s) for s in ss], dtype=torch.int32,
                            device=device)
    return (torch.from_numpy(al.encode_batch(qs, lq, al.QPAD)).to(device),
            torch.from_numpy(al.encode_batch(ts, lt, al.TPAD)).to(device),
            lens(qs), lens(ts),
            torch.from_numpy(np.stack(knots).astype(np.int32)).to(device))


def prop_knots(qs, ts, lq):
    return [ab.proportional_knots(len(q), len(t), lq)
            for q, t in zip(qs, ts)]


def _interp(ap):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(ap.pl, "pallas_call", interp)
    return mp


def all_pairs():
    """CASES on proportional knots, then the constructed pairs on their
    hand-made knots: (queries, targets, knots)."""
    qs, ts = make_pairs(np.random.default_rng(5))
    _, bq, bt, bk = band_pairs.band_pairs(LQ, WB, seed=5)
    return qs + bq, ts + bt, prop_knots(qs, ts, LQ) + bk


@pytest.fixture(scope="module")
def runs():
    """Pairs, Pallas (moves, lens, dists), port (moves, meta)."""
    from racon_tpu.tpu import align_pallas as ap

    qs, ts, knots = all_pairs()
    mp = _interp(ap)
    try:
        jm, jl, jd = ap.align_batch(qs, ts, LQ, LQ, WB, centers=knots)
    finally:
        mp.undo()
    tape, meta = ab.band_align(*encode(qs, ts, LQ, LQ, knots), wb=WB)
    return qs, ts, (jm, jl, jd), (ab.unpack_moves(tape.numpy()),
                                  meta.numpy())


@pytest.mark.parametrize("case", CASES + BP)
def test_plain_equals_pallas(runs, case):
    k = (CASES + BP).index(case)
    _, _, (jm, jl, jd), (moves, meta) = runs
    assert int(meta[k, 0]) == int(jd[k])
    if int(jd[k]) < ab.BIG:
        n = int(jl[k])
        assert int(meta[k, 1]) == n
        assert moves[k, :n].tolist() == jm[k, :n].tolist()


@pytest.mark.parametrize("case", ["div05", "div15", "del60", "n_bases"])
def test_moves_decode_to_exact_distance(runs, case):
    """Where the Ukkonen bound certifies the band, the moves are an
    optimal alignment: the native distance, both sequences consumed."""
    from racon_tpu.tpu import align_pallas as ap

    k = CASES.index(case)
    qs, ts, _, (moves, meta) = runs
    dist, n = int(meta[k, 0]), int(meta[k, 1])
    assert dist + abs(len(qs[k]) - len(ts[k])) <= WB
    ops = ab.moves_to_ops(moves[k], n, qs[k], ts[k])
    assert ops.tolist() == ap.moves_to_ops(moves[k], n, qs[k],
                                           ts[k]).tolist()
    assert int(np.sum(ops != al.OP_EQ)) == dist == cpu.edit_distance(
        qs[k], ts[k])
    assert int(np.sum(ops != al.OP_D)) == len(qs[k])
    assert int(np.sum(ops != al.OP_I)) == len(ts[k])


@pytest.fixture(scope="module")
def measured():
    """Measured knots (estimate_center_knots) at lq 2048 / wb 1024 on a
    pair with a 400-bp deletion, and on a pair whose 700-bp insertion
    past the last measured knot leaves its end outside the band."""
    from racon_tpu.tpu import align_pallas as ap

    rng = np.random.default_rng(9)
    q = seq(1800, rng)
    q2 = seq(1300, rng)
    qs = [q, q2]
    ts = [mutate(q[:600] + q[1000:], 0.04, rng),
          q2[:1100] + seq(700, rng) + q2[1100:]]
    knots = [ab.estimate_center_knots(a, b, 2048) for a, b in zip(qs, ts)]
    mp = _interp(ap)
    try:
        jm, jl, jd = ap.align_batch(qs, ts, 2048, 2048, 1024,
                                    centers=knots)
    finally:
        mp.undo()
    tape, meta = ab.band_align(*encode(qs, ts, 2048, 2048, knots),
                               wb=1024)
    return qs, ts, knots, (jm, jl, jd), (ab.unpack_moves(tape.numpy()),
                                         meta.numpy())


def test_measured_knots_equal_pallas(measured):
    qs, ts, knots, (jm, jl, jd), (moves, meta) = measured
    assert meta[:, 0].tolist() == [int(d) for d in jd]
    assert int(meta[1, 0]) == ab.BIG
    n = int(jl[0])
    assert int(meta[0, 1]) == n
    assert moves[0, :n].tolist() == jm[0, :n].tolist()
    # the measured center holds the drift: margin rule accepts, at the
    # exact distance
    assert ab.path_center_margin(moves[0], n, knots[0], 1024) >= 256
    assert int(meta[0, 0]) == cpu.edit_distance(qs[0], ts[0])


# ---------------------------------------------------------------------------
# host helpers, against the JAX package's on seeded inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_knot_helpers_equal_jax(seed):
    from racon_tpu.tpu import align_pallas as ap

    rng = np.random.default_rng(seed)
    lq = int(rng.choice([1024, 2048, 4096]))
    ql, tl = int(rng.integers(1, lq)), int(rng.integers(1, lq))
    assert ab.n_ctr(lq) == ap._n_ctr(lq)
    assert np.array_equal(ab.proportional_knots(ql, tl, lq),
                          ap.proportional_knots(ql, tl, lq))
    raw = rng.integers(-500, 3 * lq, ab.n_ctr(lq))
    assert np.array_equal(ab.smooth_knots(raw, tl),
                          ap.smooth_knots(raw, tl))
    q = seq(int(rng.integers(1100, lq)), rng)
    cut = int(rng.integers(100, 400))
    t = mutate(q[:500] + q[500 + cut:], 0.05, rng)
    assert np.array_equal(ab.estimate_center_knots(q, t, lq),
                          ap.estimate_center_knots(q, t, lq))
    kn = ab.estimate_center_knots(q, t, lq)
    mv = rng.integers(0, 3, len(q) + len(t)).astype(np.uint8)
    n = int(rng.integers(1, mv.size))
    assert ab.path_center_margin(mv, n, kn, 1024) == \
        ap.path_center_margin(mv, n, kn, 1024)


@pytest.mark.parametrize("seed", range(3))
def test_codecs_equal_jax(seed):
    from racon_tpu.tpu import align_pallas as ap
    from racon_tpu.tpu import aligner as jal

    rng = np.random.default_rng(seed)
    seqs = [seq(int(rng.integers(0, 50)), rng) + b"NRY"
            for _ in range(5)]
    for pad in (al.QPAD, al.TPAD):
        assert np.array_equal(al.encode_batch(seqs, 64, pad),
                              jal.encode_batch(seqs, 64, pad))
    q = seq(80, rng)
    t = mutate(q, 0.2, rng)
    # a valid move row: i diagonal/up steps consume q, j diagonal/left t
    mv = np.concatenate([np.zeros(min(len(q), len(t)), np.uint8),
                         np.full(max(len(q) - len(t), 0), 1, np.uint8),
                         np.full(max(len(t) - len(q), 0), 2, np.uint8)])
    rng.shuffle(mv)
    ops = ab.moves_to_ops(mv[::-1], len(mv), q, t)
    assert np.array_equal(ops, ap.moves_to_ops(mv[::-1], len(mv), q, t))
    row = np.concatenate([ops, np.zeros(7, np.uint8)])
    got, want = al.ops_to_runs(row), jal.ops_to_runs(row)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert al.ops_to_cigar(row) == jal.ops_to_cigar(row)
    assert np.array_equal(ab.unpack_moves(np.array([[0x12345678]])),
                          np.array([[(0x12345678 >> (2 * k)) & 3
                                     for k in range(16)]]))


def test_pair_alone_equals_pair_in_batch(runs):
    qs, ts, _, (moves, meta) = runs
    for k in (2, 3, 6):
        tape, m1 = ab.band_align(*encode(
            [qs[k]], [ts[k]], LQ, LQ, prop_knots([qs[k]], [ts[k]], LQ)),
            wb=WB)
        assert m1[0].tolist() == meta[k].tolist()
        n = int(meta[k, 1])
        assert ab.unpack_moves(tape.numpy())[0, :n].tolist() == \
            moves[k, :n].tolist()


@pytest.mark.parametrize("bad", ["dtype", "knots", "contiguous", "fits",
                                 "warps"])
def test_wrapper_rejects_bad_inputs(bad):
    qs, ts = make_pairs(np.random.default_rng(1))
    args = list(encode(qs[:2], ts[:2], LQ, LQ, prop_knots(qs[:2], ts[:2],
                                                          LQ)))
    wb = WB
    if bad == "dtype":
        args[3] = args[3].to(torch.int64)
    elif bad == "knots":
        args[4] = args[4][:, :-1]
    elif bad == "contiguous":
        args[1] = torch.cat([args[1], args[1]], 1)[:, ::2]
    elif bad == "fits":
        wb = 384
    with pytest.raises(ValueError):
        # 2 warps at wb 256 would leave each thread 4 columns
        ab.band_align(*args, wb=wb, warps=2 if bad == "warps" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,wb", [(LQ, WB), (8192, 4096), (12288, 8192)])
def test_kernel_matches_plain_on_card(lq, wb):
    """The CUDA kernel against its plain version on the card (needs a
    GPU and nvcc; run with ``pytest -m cuda`` on the card): the CPU
    cases and the constructed pairs at the tests' lq 512 / wb 256, and
    the constructed pairs alone at lq 8192 / wb 4096 and at the last
    rung's wb 8192."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if lq == LQ:
        qs, ts, knots = all_pairs()
    else:
        _, qs, ts, knots = band_pairs.band_pairs(lq, wb, seed=5)
    args = encode(qs, ts, lq, lq, knots, "cuda")
    kt, km = ab.band_align(*args, wb=wb)
    pt, pm = ab.band_align_reference(*args, wb=wb)
    torch.cuda.synchronize()
    assert torch.equal(km[:, :2], pm[:, :2])
    assert bool((km[:, 2] > 0).all())          # DP cycles, every pair
    kmv, pmv = (ab.unpack_moves(x.cpu().numpy()) for x in (kt, pt))
    for k in range(len(qs)):
        n = int(pm[k, 1])
        assert np.array_equal(kmv[k, :n], pmv[k, :n])


def _band_steps(q, t, knots, lq, wb):
    """Band starts (in quanta) of rows 0..ql, as the kernel places them."""
    ql, tl = len(q), len(t)
    smax = (max(tl + 1 - wb, 0) + ab.Q - 1) // ab.Q
    ctr = torch.from_numpy(np.asarray(knots, np.int32)[None, :])
    return [int(ab._band_start(ctr, torch.tensor([i], dtype=torch.int32),
                               wb, torch.tensor([smax]))[0])
            for i in range(ql + 1)]


@pytest.mark.parametrize("lq,wb", [(LQ, WB), (8192, 4096)])
@pytest.mark.parametrize("case", band_pairs.CASES)
def test_band_pairs_force_their_paths(case, lq, wb):
    """Each constructed pair takes the band path its name promises."""
    names, qs, ts, knots = band_pairs.band_pairs(lq, wb, seed=5)
    k = names.index(case)
    q, t, kn = qs[k], ts[k], knots[k]
    assert len(q) <= lq and len(t) <= lq
    st = _band_steps(q, t, kn, lq, wb)
    steps = set(np.diff(st).tolist())
    c_end = len(t) - st[-1] * ab.Q
    if case.startswith("adv"):
        assert int(case[3]) in steps and steps <= {0, 1, 2, 3}
    elif case == "backward":
        assert min(steps) < 0
    elif case == "end_out_of_band":
        assert c_end >= wb
    elif case == "short_target":
        assert len(t) < wb and 0 <= c_end < wb
    elif case == "empty_query":
        assert len(q) == 0 and len(t) > 0
    else:
        # the traceback reaches column 0 above row 0 and goes up there
        args = encode([q], [t], lq, lq, [kn])
        tape, meta = ab.band_align(*args, wb=wb)
        n = int(meta[0, 1])
        assert int(meta[0, 0]) < ab.BIG
        mv = ab.unpack_moves(tape.numpy())[0, :n]
        i, j, up_at_zero = len(q), len(t), 0
        for m in mv:
            if j == 0 and i > 0:
                up_at_zero += int(m) == ab.MV_UP
            i -= int(m) != ab.MV_LEFT
            j -= int(m) != ab.MV_UP
        assert up_at_zero > 0 and i == 0 and j == 0
