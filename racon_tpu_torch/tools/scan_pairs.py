"""Constructed pairs for the scan align kernels' edge paths
(``cuda/csrc/align_scan.cu``): identical pairs, N bases, empty sides,
single bases, lengths that differ past a narrow band both ways, and a
divergence whose cost passes a narrow band.  The CPU tests and
chip_smoke.py's ``scan_check`` run them beside real pairs.
"""

from __future__ import annotations

import random
from typing import List, Tuple


def _seq(rng: random.Random, n: int) -> bytes:
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def mutate(s: bytes, rate: float, rng: random.Random) -> bytes:
    """Substitutions, deletions and insertions, each at rate / 3."""
    out = bytearray()
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(rng.choice(b"ACGT") if r < 2 * rate / 3 else ch)
        if r > 1 - rate / 3:
            out.append(rng.choice(b"ACGT"))
    return bytes(out)


def scan_pairs(rng: random.Random, length: int = 300
               ) -> Tuple[List[bytes], List[bytes]]:
    """(queries, targets) of the edge cases at about ``length`` bases."""
    n = length
    base = _seq(rng, n)
    with_n = base[:n // 3] + b"N" * 7 + base[n // 3:]
    qs = [base, base, base, with_n, base[:n // 2], base, b"", base[:40],
          b"A", b"A", b"", _seq(rng, n)]
    ts = [base,                                   # identical
          mutate(base, 0.05, rng),                # 5% divergence
          mutate(base, 0.35, rng),                # cost past a narrow band
          mutate(with_n, 0.03, rng)[:n // 3] + b"N" * 7
          + with_n[n // 3 + 7:],                  # N matches N
          base,                                   # target 2x the query
          base[:n // 2],                          # query 2x the target
          base[:50],                              # empty query
          b"",                                    # empty target
          b"A", b"C",                             # single bases
          b"",                                    # both empty
          _seq(rng, n // 3)]                      # unrelated, unequal
    return qs, ts
