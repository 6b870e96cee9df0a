"""Constructed pairs that drive the band kernel's rare paths.

The band kernel (``cuda/csrc/align_band.cu``) places each query row's
band by the pair's knot table and realigns the previous row when the
band start advances by 1 or 2 quanta (128 columns); any other step, a
backward one included, reads the previous row unshifted.  Real pairs
on measured or proportional knots advance by 0 or 1 quantum, so these
pairs force the other paths with hand-made knots (a straight center
line ``c0 + slope * row``, sampled at the knot rows):

* ``adv0``: a flat center at tl, so the band never moves;
* ``adv1``: slope 1, one quantum every 128 rows;
* ``adv2``: slope 256, two quanta a row until the band reaches smax;
* ``adv3``: slope 384, three quanta a row (the unshifted read);
  both with a target of ``lq`` bases, so smax >= 3 at any band;
* ``backward``: one knot 1,536 columns below the proportional
  diagonal, so the band steps back before it (read unshifted) and
  forward after it; where the pair is too short for that knot (``lq``
  512) a line falling one quantum every 128 rows from smax, whose end
  leaves the band;
* ``end_out_of_band``: zero knots and tl >= wb, so the distance cell
  lies outside the band (``BIG``);
* ``short_target``: tl < wb, so most of every row lies past tl;
* ``empty_query``: no rows, the traceback is tl left moves;
* ``j_zero_first``: the query starts with 100 bases the target lacks,
  so the traceback reaches column 0 above row 0 and goes up from there.

Sequences are drawn from a seeded generator; lengths scale with ``lq``
and every pair fits ``lq`` (query) and ``lq`` (target).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from racon_tpu_torch.cuda import align_band as ab

CASES = ("adv0", "adv1", "adv2", "adv3", "backward", "end_out_of_band",
         "short_target", "empty_query", "j_zero_first")


def _seq(rng, n: int) -> bytes:
    return bytes(rng.choice(list(b"ACGT"), n).astype(np.uint8))


def _mutate(rng, s: bytes, rate: float) -> bytes:
    out = bytearray()
    for ch, r, sub, ins in zip(s, rng.random(len(s)),
                               rng.choice(list(b"ACGT"), len(s)),
                               rng.choice(list(b"ACGT"), len(s))):
        if r < rate / 3:
            continue
        out.append(int(sub) if r < 2 * rate / 3 else ch)
        if r > 1 - rate / 3:
            out.append(int(ins))
    return bytes(out)


def _line(lq: int, c0: int, slope: int) -> np.ndarray:
    """Knots of the center line ``c0 + slope * row``."""
    rows = np.arange(ab.n_ctr(lq), dtype=np.int64) * ab.CTR_BLK
    return (c0 + slope * rows).astype(np.int32)


def band_pairs(lq: int, wb: int, seed: int = 0
               ) -> Tuple[List[str], List[bytes], List[bytes],
                          List[np.ndarray]]:
    """(case names, queries, targets, knots) of the constructed pairs at
    query/target capacity ``lq`` and band ``wb`` (``lq`` >= 1.5 ``wb``
    for the out-of-band case to leave its end outside the band)."""
    rng = np.random.default_rng(seed)
    n = lq * 3 // 4
    qs, ts, kn = [], [], []

    def add(q, t, knots=None):
        q, t = q[:lq], t[:lq]
        qs.append(q)
        ts.append(t)
        kn.append(ab.proportional_knots(len(q), len(t), lq)
                  if knots is None else knots)

    q = _seq(rng, n)
    t = _mutate(rng, q, 0.05)
    add(q, t, _line(lq, len(t), 0))
    q = _seq(rng, n)
    add(q, _mutate(rng, q, 0.05), _line(lq, 0, 1))
    # a full-length target, so smax >= 3 even at lq 512 / wb 256
    for slope in (2 * ab.Q, 3 * ab.Q):
        q = _seq(rng, lq - 8)
        t = _mutate(rng, q, 0.05)[:lq]
        add(q, t + _seq(rng, lq - len(t)), _line(lq, wb // 2, slope))
    q = _seq(rng, n)
    t = _mutate(rng, q, 0.05)
    dip = ab.CTR_BLK + 4 * ab.Q
    k = (wb // 2 + dip + 2 * ab.Q) // ab.CTR_BLK + 1
    if (k + 1) * ab.CTR_BLK <= len(q):
        # knot k dips below the diagonal by more than a segment's rise:
        # the band steps back before it, forward after it, and ends in
        # band
        kn_b = ab.proportional_knots(len(q), len(t), lq)
        kn_b[k] -= dip
    else:
        # two knots only: a falling line (its end leaves the band)
        kn_b = _line(lq, len(t) + wb // 2, -1)
    add(q, t, kn_b)
    q = _seq(rng, n)
    add(q, _mutate(rng, q, 0.05), _line(lq, 0, 0))
    t = _seq(rng, wb // 2 - 28)
    add(_mutate(rng, t, 0.05), t)
    add(b"", _seq(rng, 90))
    core = _seq(rng, n // 2)
    add(_seq(rng, 100) + core, _mutate(rng, core, 0.03))
    return list(CASES), qs, ts, kn
