"""Rounds of the lockstep POA engine, as arrays: captured from real
windows, and one constructed to drive the banded kernel's lag drop.

``capture_rounds`` runs an engine's lockstep batch and keeps a copy of
the arrays each round's launch received (at the round's shape), so the
kernel, its plain version and the JAX kernels can be held against each
other on real exports; ``round_spy`` does the same for every engine of a
run (a CLI polish) while it is open; ``widen`` puts such a round at a wider layer
bucket, so real graphs reach the kernel's wider builds.  ``lag_round`` builds a round whose extra
in-edges reach up to ``k`` ranks back: at a narrow band (wb 32, band
quantum 8) such a pred's band lags 5 or more quanta, a path real
windows at the engine's bands (256 and up) seldom take, where the
kernel reads the pred row as -inf.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Set, Tuple

import numpy as np

Round = Tuple[int, List[np.ndarray], int, int, int]


@contextlib.contextmanager
def round_spy(target, keep: Callable[[int, int, int, int], bool]):
    """While open, copy each round that ``target`` (an engine, or the
    engine class: every engine of the process) dispatches and
    ``keep(round, v_b, l_b, wb)`` accepts into the yielded list, as
    (round, [bases, preds, nrows, sinks, seq, slen] at the round's
    shape, v_b, l_b, wb)."""
    rounds: List[Round] = []
    is_class = isinstance(target, type)
    orig = target._dispatch

    def record(engine, bases, preds, nrows, sinks, seq_arr, slen, st):
        v_b, l_b, wb = engine.round_shape(nrows, slen)
        if keep(st.rounds, v_b, l_b, wb):
            arrs = [np.ascontiguousarray(a).copy() for a in (
                bases[:, :v_b], preds[:, :v_b], nrows, sinks[:, :v_b],
                seq_arr[:, :l_b], slen)]
            rounds.append((st.rounds, arrs, v_b, l_b, wb))

    if is_class:
        def spy(self, bases, preds, nrows, sinks, seq_arr, slen, util, st):
            record(self, bases, preds, nrows, sinks, seq_arr, slen, st)
            return orig(self, bases, preds, nrows, sinks, seq_arr, slen,
                        util, st)
    else:
        def spy(bases, preds, nrows, sinks, seq_arr, slen, util, st):
            record(target, bases, preds, nrows, sinks, seq_arr, slen, st)
            return orig(bases, preds, nrows, sinks, seq_arr, slen, util,
                        st)
    target._dispatch = spy
    try:
        yield rounds
    finally:
        if is_class:
            target._dispatch = orig
        else:
            del target._dispatch


def capture_rounds(engine, windows, keep: Optional[Set[int]] = None
                   ) -> List[Round]:
    """Run ``engine``'s lockstep batch on ``windows`` and return a copy
    of each round of ``keep`` (round indices; None: every round): (round,
    [bases, preds, nrows, sinks, seq, slen] at the round's shape, v_b,
    l_b, wb)."""
    with round_spy(engine, lambda d, *_: keep is None or d in keep) \
            as rounds:
        engine.lockstep_batch(windows, True)
    return rounds


def widen(arrs, l: int) -> List[np.ndarray]:
    """A round's arrays with ``seq`` padded to ``l`` columns: the same
    graphs and layers at a wider layer bucket, as a longer window's
    round would give them (its band, ``poa_band_cols(l)``, is wider
    too)."""
    seq = arrs[4]
    if seq.shape[1] > l:
        raise ValueError(f"seq is {seq.shape[1]} columns, past {l}")
    wide = np.zeros((seq.shape[0], l), np.uint8)
    wide[:, :seq.shape[1]] = seq
    return [*arrs[:4], wide, arrs[5]]


def lag_round(seed: int = 5, b: int = 3, v: int = 256, l: int = 256,
              p: int = 8, k: int = 64):
    """A constructed round: a chain of ``nrows`` ranks per lane, each
    with up to two extra preds 2..k ranks back, two sinks, a random
    layer.  Returns ([bases, preds, nrows, sinks, seq, slen], v, l, p,
    k)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    bases = rng.choice(acgt, (b, v))
    preds = np.full((b, v, p), -1, np.int16)
    nrows = rng.integers(v // 2, v, b).astype(np.int32)
    sinks = np.zeros((b, v), np.uint8)
    for i in range(b):
        preds[i, 0, 0] = 0
        for r in range(1, int(nrows[i])):
            preds[i, r, 0] = r
            for e in range(int(rng.integers(0, 3))):
                back = int(rng.integers(2, k + 1))
                if r + 1 - back >= 1:
                    preds[i, r, 1 + e] = r + 1 - back
        sinks[i, nrows[i] - 1] = 1
        sinks[i, rng.integers(0, nrows[i])] = 1
    slen = rng.integers(l // 2, l + 1, b).astype(np.int32)
    seq = np.zeros((b, l), np.uint8)
    for i in range(b):
        seq[i, :slen[i]] = rng.choice(acgt, slen[i])
    return [bases, preds, nrows, sinks, seq, slen], v, l, p, k


def max_band_lag(arrs, wb: int) -> int:
    """The largest band lag, in quanta, of a real pred row of a round at
    band ``wb`` (the banded kernel's dq)."""
    _, preds, nrows, _, _, slen = arrs
    q, lag = wb // 4, 0
    for i in range(preds.shape[0]):
        nr, sl = max(int(nrows[i]), 1), int(slen[i])
        smax = (max(sl + 1 - wb, 0) + q - 1) // q

        def start(r):
            return min(max(((r * sl) // nr - wb // 2) // q, 0), smax)

        for r in range(1, int(nrows[i]) + 1):
            for pid in preds[i, r - 1]:
                if pid > 0:
                    lag = max(lag, start(r) - start(int(pid)))
    return lag
