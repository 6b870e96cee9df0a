"""Target-side minimizer hash index with occurrence-cap repeat masking
(JAX package: racon_tpu/overlap/index.py).

One flat sorted table over every target's minimizers: (hash, target
id, target position, target strand), sorted by hash with a stable sort
so same-hash anchors keep (target, position) order: lookups are two
searchsorteds, and iteration order (hence chaining, hence bytes) is
deterministic.  Hashes occurring more than ``occ_cap`` times across
the target set are repeats by definition and are dropped wholesale
before lookup, the same job minimap2's -f/--mask-level does: repeat
seeds explode the anchor count without adding placement information.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence as PySequence, Tuple

import numpy as np

from racon_tpu_torch.overlap import minimizers


class MinimizerIndex:
    """Immutable minimizer table over a target set."""

    __slots__ = ("k", "w", "occ_cap", "hashes", "tid", "tpos",
                 "tstrand", "n_targets", "masked_hashes",
                 "masked_entries", "total_entries")

    def __init__(self, k: int, w: int, occ_cap: int):
        self.k = max(3, min(int(k), minimizers.MAX_K))
        self.w = max(1, int(w))
        self.occ_cap = max(1, int(occ_cap))
        self.hashes = np.empty(0, dtype=np.uint32)
        self.tid = np.empty(0, dtype=np.int32)
        self.tpos = np.empty(0, dtype=np.int64)
        self.tstrand = np.empty(0, dtype=np.uint8)
        self.n_targets = 0
        self.masked_hashes = 0
        self.masked_entries = 0
        self.total_entries = 0

    @classmethod
    def build(cls, targets: PySequence, k: int, w: int, occ_cap: int,
              words: Optional[Iterable[Tuple[np.ndarray, np.ndarray]]]
              = None) -> "MinimizerIndex":
        """Index every target's data buffer.  ``targets`` is any
        sequence of objects with a ``data`` bytes attribute (core
        Sequence) or raw bytes; ``words`` optionally yields each
        target's prebuilt (fw, rv), in order (the mapper's batched
        build), else numpy builds them."""
        idx = cls(k, w, occ_cap)
        hs: List[np.ndarray] = []
        tids: List[np.ndarray] = []
        poss: List[np.ndarray] = []
        strands: List[np.ndarray] = []
        words = iter(words) if words is not None else None
        for t, target in enumerate(targets):
            data = getattr(target, "data", target)
            pos, h, s = minimizers.extract(
                data, idx.k, idx.w,
                words=next(words) if words is not None else None)
            if h.size == 0:
                continue
            hs.append(h)
            tids.append(np.full(h.size, t, dtype=np.int32))
            poss.append(pos)
            strands.append(s)
        idx.n_targets = len(targets)
        if not hs:
            return idx
        h = np.concatenate(hs)
        tid = np.concatenate(tids)
        pos = np.concatenate(poss)
        strand = np.concatenate(strands)
        order = np.argsort(h, kind="stable")
        h, tid, pos, strand = h[order], tid[order], pos[order], strand[order]
        idx.total_entries = int(h.size)
        uniq, inverse, counts = np.unique(h, return_inverse=True,
                                          return_counts=True)
        keep = counts[inverse] <= idx.occ_cap
        idx.masked_hashes = int((counts > idx.occ_cap).sum())
        idx.masked_entries = int(h.size - keep.sum())
        idx.hashes = h[keep]
        idx.tid = tid[keep]
        idx.tpos = pos[keep]
        idx.tstrand = strand[keep]
        return idx

    def lookup(self, query_hashes: np.ndarray):
        """(left, right) bounds into the table for each query hash:
        table rows [left[i], right[i]) match query_hashes[i]."""
        left = np.searchsorted(self.hashes, query_hashes, side="left")
        right = np.searchsorted(self.hashes, query_hashes, side="right")
        return left, right
