"""Constructed pairs that drive the WFA kernel's rare paths.

The WFA kernel (``cuda/csrc/align_wfa.cu``) steps wavefronts over the
diagonals d = j - i that a pair can reach ([-ql, tl] within [-e, e]),
keeps a 16-bit history of every step, and walks it back in windows of
32 steps x 67 diagonals copied into shared memory.  Real overlaps take
few of its edge paths, so these pairs force them (capacity ``lq``,
step cap ``emax``):

* ``del_run`` / ``ins_run``: a 64-base deletion / insertion, so 64
  traceback steps in a row move the diagonal one way and some 32-step
  window is crossed from its centre column to its edge;
* ``dist_emax``: an A/C query whose target has ``emax`` of its bases
  turned to G/T (no alignment matches a G/T, so the distance is exactly
  ``emax``), certified at the last step; ``dist_emax_plus1``: one more,
  rejected;
* ``len_gap_emax``: the target is the query plus ``emax`` bases, so
  |tl - ql| = emax and the final diagonal first exists at the last step;
* ``identical``: the first slide runs to both sequence ends (distance
  0); ``sub_at_start``: a substitution at base 0, after which one slide
  runs to both ends;
* ``n_runs``: runs of N (code 4) longer than a packed word, matching N
  runs in the target, and an N against a base;
* ``ql_one`` / ``tl_one``: a one-base query / target, so the diagonals
  are clipped to [-1, tl] / [-ql, 1];
* ``short_unrelated``: 12 and 40 unrelated bases, so the steps run
  far past ql and the lower clip holds for most of them.

The short pairs are far below any real ``lq``: they also serve as pairs
whose real length is far below the chunk's padded width.  Sequences are
drawn from a seeded generator; every pair fits ``lq`` (which must be at
least ``emax + 140``) and, for all but the rejected case, ``emax``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

CASES = ("del_run", "ins_run", "dist_emax", "dist_emax_plus1",
         "len_gap_emax", "identical", "sub_at_start", "n_runs", "ql_one",
         "tl_one", "short_unrelated")
#: the cases whose distance exceeds ``emax``
REJECTED = ("dist_emax_plus1",)
RUN = 64                     # indel run: two traceback windows


def _seq(rng, n: int) -> bytes:
    return bytes(rng.choice(list(b"ACGT"), n).astype(np.uint8))


def _substitute(rng, s: bytes, p: int) -> bytes:
    """``s`` with a different base at position ``p``."""
    out = bytearray(s)
    out[p] = int(rng.choice([c for c in b"ACGT" if c != s[p]]))
    return bytes(out)


def wfa_pairs(lq: int, emax: int, seed: int = 0
              ) -> Tuple[List[str], List[bytes], List[bytes]]:
    """(case names, queries, targets) of the constructed pairs at
    capacity ``lq`` and step cap ``emax``."""
    if lq < emax + 140:
        raise ValueError(f"lq={lq} is too small for emax={emax}")
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    n = min(lq - RUN, 400)
    q = _seq(rng, n)
    qs.append(q)
    ts.append(q[:n // 3] + q[n // 3 + RUN:])
    q = _seq(rng, n - RUN)
    qs.append(q)
    ts.append(q[:n // 3] + _seq(rng, RUN) + q[n // 3:])
    # a query of A/C with G/T substitutions: every G/T of the target
    # costs an edit in any alignment, so the distance is exactly k
    m = emax + 40
    q = bytes(rng.choice(list(b"AC"), m).astype(np.uint8))
    pos = np.linspace(5, m - 6, emax + 1).astype(np.int64)
    for k in (emax, emax + 1):
        t = np.frombuffer(q, np.uint8).copy()
        t[pos[:k]] = rng.choice(list(b"GT"), k)
        qs.append(q)
        ts.append(t.tobytes())
    q = _seq(rng, min(lq - emax, 300))
    qs.append(q)
    ts.append(q + _seq(rng, emax))
    q = _seq(rng, 200)
    qs.append(q)
    ts.append(q)
    qs.append(q)
    ts.append(_substitute(rng, q, 0))
    q = _seq(rng, 180)
    n12 = b"N" * 12
    qs.append(q[:40] + n12 + q[40:120] + b"N" + q[120:])
    ts.append(q[:40] + n12 + q[40:120] + q[120:121] + q[120:])
    qs.append(b"A")
    ts.append(_seq(rng, 20) + b"A" + _seq(rng, 19))
    qs.append(_seq(rng, 30))
    ts.append(b"C")
    qs.append(_seq(rng, 12))
    ts.append(_seq(rng, 40))
    return list(CASES), qs, ts
