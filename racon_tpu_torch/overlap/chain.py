"""Anchor collinear chaining: sorted-diagonal banding + LIS-style DP
(JAX package: racon_tpu/overlap/chain.py).

Per query: extract minimizers, look them up in the target index, and
turn the matching (query pos, target pos) anchor pairs into PAF-shaped
:class:`~racon_tpu_torch.core.overlap.Overlap` records:

1. project reverse-strand anchors onto chain coordinates
   (qT = q_len - k - q_pos) so every colinear match is increasing in
   both axes regardless of orientation,
2. band: sort anchors by (target, strand, diagonal = t_pos - qT) and
   cut a new candidate cluster wherever the diagonal jumps more than
   ``band``, a cheap stand-in for minimap2's chaining heuristic that
   keeps the DP quadratic-free,
3. chain: inside each band run an O(m log m) patience-LIS over
   (qT asc, t_pos desc) for the longest strictly-increasing anchor
   chain, then split it at gaps over ``max_gap`` and keep the longest
   piece,
4. admit chains with at least ``min_chain`` anchors; coordinates are
   the chain's bounding span (approximate, CIGAR-free): downstream
   the polisher re-aligns breaking points per window exactly as it
   does for an external PAF.

Seeding is batched: the k-mer words of many queries (up to
``SEED_BATCH`` bases) are built in one pass over their concatenated
codes, on the seeding device (one kernel launch on a card), and each
query's words are sliced out of it.  Words that straddle two sequences
are built and dropped; each sequence's words are bit-identical to its
own build.  The target index is seeded the same way.

Determinism: numpy sorts are stable, LIS tie-breaks are positional,
and emitted overlaps are ordered (query, -span, target, t_begin): the
same inputs and knobs always produce the same overlap list and
therefore the same FASTA bytes, wherever the words were built.
"""

from __future__ import annotations

import os
from bisect import bisect_left
from typing import (Iterable, Iterator, List, Optional,
                    Sequence as PySequence, Tuple)

import numpy as np

from racon_tpu_torch import resolve_device
from racon_tpu_torch.core.overlap import Overlap
from racon_tpu_torch.overlap import minimizers
from racon_tpu_torch.overlap.index import MinimizerIndex

#: bases of one batched word build: bounds its host memory (the codes
#: and 8 bytes of words a base, ~0.6 GB); a longer sequence is built
#: alone
SEED_BATCH = 1 << 26


class MapParams:
    """Mapper knobs.  k/w/occ_cap/min_chain/band/max_gap change which
    overlaps exist, hence bytes.  ``device`` is where the seed words
    are built: a torch device (default cuda: the seed-word kernel;
    raises when the card is missing) or ``minimizers.NUMPY`` for the
    host build.  Placement only: the words are bit-equal."""

    __slots__ = ("k", "w", "occ_cap", "min_chain", "band", "max_gap",
                 "seed_device")

    def __init__(self, k: int = 13, w: int = 5, occ_cap: int = 64,
                 min_chain: int = 4, band: int = 500,
                 max_gap: int = 10_000, device=None):
        self.k = max(3, min(int(k), minimizers.MAX_K))
        self.w = max(1, int(w))
        self.occ_cap = max(1, int(occ_cap))
        self.min_chain = max(1, int(min_chain))
        self.band = max(1, int(band))
        self.max_gap = max(1, int(max_gap))
        self.seed_device = (minimizers.NUMPY if device == minimizers.NUMPY
                            else resolve_device(device))

    def doc(self) -> dict:
        return {"k": self.k, "w": self.w, "occ_cap": self.occ_cap,
                "min_chain": self.min_chain, "band": self.band,
                "max_gap": self.max_gap,
                "device_seed": int(self.seed_device != minimizers.NUMPY)}


def params_from_env(device=None) -> MapParams:
    """The knobs from ``RACON_TPU_TORCH_MAP_*``; ``device`` is where
    seeding runs (as in :class:`MapParams`) unless
    ``RACON_TPU_TORCH_MAP_DEVICE_SEED=0`` asks for numpy."""
    env = os.environ.get
    if env("RACON_TPU_TORCH_MAP_DEVICE_SEED", "1") != "1":
        device = minimizers.NUMPY
    return MapParams(
        k=int(env("RACON_TPU_TORCH_MAP_K", "13")),
        w=int(env("RACON_TPU_TORCH_MAP_W", "5")),
        occ_cap=int(env("RACON_TPU_TORCH_MAP_OCC", "64")),
        min_chain=int(env("RACON_TPU_TORCH_MAP_MIN_CHAIN", "4")),
        band=int(env("RACON_TPU_TORCH_MAP_BAND", "500")),
        max_gap=int(env("RACON_TPU_TORCH_MAP_MAX_GAP", "10000")),
        device=device)


def _batches(datas: Iterable[bytes], cap: int) -> Iterator[List[bytes]]:
    batch: List[bytes] = []
    total = 0
    for data in datas:
        if batch and total + len(data) > cap:
            yield batch
            batch, total = [], 0
        batch.append(data)
        total += len(data)
    if batch:
        yield batch


def batched_words(datas: Iterable[bytes], k: int, device,
                  cap: int = SEED_BATCH
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield each sequence's (fw, rv) words, in order, built one batch
    of up to ``cap`` bases at a time on ``device`` (a torch device or
    ``minimizers.NUMPY``).  A sequence shorter than k yields empty
    words."""
    empty = np.empty(0, dtype=np.uint32)
    for batch in _batches(datas, cap):
        lens = [len(data) for data in batch]
        if sum(lens) < k:
            for _ in batch:
                yield empty, empty
            continue
        fw, rv = minimizers.kmer_words(
            minimizers.encode(b"".join(batch)), k, device)
        off = 0
        for n in lens:
            nk = max(0, n - k + 1)
            yield fw[off:off + nk], rv[off:off + nk]
            off += n


def _expand_ranges(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Concatenate [left[i], right[i]) ranges into one index vector."""
    cnt = right - left
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    cum = np.cumsum(cnt) - cnt
    return (np.repeat(left, cnt)
            + (np.arange(total, dtype=np.int64) - np.repeat(cum, cnt)))


def _lis(qT: np.ndarray, tpos: np.ndarray) -> List[int]:
    """Longest chain with strictly increasing qT AND tpos.

    Anchors are sorted (qT asc, tpos desc); a strictly-increasing LIS
    on tpos then cannot take two anchors with equal qT, which makes
    the classic patience trick orientation-safe.  Returns anchor
    indices in chain order."""
    order = np.lexsort((-tpos, qT))
    t = tpos[order]
    tails: List[int] = []       # tpos value ending the best chain of len j+1
    tails_at: List[int] = []    # index (into order) of that anchor
    parent = np.full(t.size, -1, dtype=np.int64)
    for i in range(t.size):
        j = bisect_left(tails, t[i])
        if j == len(tails):
            tails.append(int(t[i]))
            tails_at.append(i)
        else:
            tails[j] = int(t[i])
            tails_at[j] = i
        parent[i] = tails_at[j - 1] if j > 0 else -1
    chain: List[int] = []
    at = tails_at[-1]
    while at >= 0:
        chain.append(int(order[at]))
        at = parent[at]
    chain.reverse()
    return chain


def _best_segment(chain: List[int], qT: np.ndarray, tpos: np.ndarray,
                  max_gap: int) -> List[int]:
    """Split the chain at query/target gaps over max_gap, keep the
    longest segment (earliest wins ties)."""
    best_lo = lo = 0
    best_n = 1
    for i in range(1, len(chain)):
        a, b = chain[i - 1], chain[i]
        if (tpos[b] - tpos[a] > max_gap) or (qT[b] - qT[a] > max_gap):
            if i - lo > best_n:
                best_lo, best_n = lo, i - lo
            lo = i
    if len(chain) - lo > best_n:
        best_lo, best_n = lo, len(chain) - lo
    return chain[best_lo:best_lo + best_n]


def chain_query(name: str, data: bytes, idx: MinimizerIndex,
                params: MapParams, target_names: PySequence[str],
                target_lengths: PySequence[int],
                words: Optional[Tuple[np.ndarray, np.ndarray]] = None
                ) -> Tuple[List[Overlap], int, int]:
    """Map one query against the index (``words``: its prebuilt seed
    words, else numpy builds them).  Returns (overlaps,
    admitted_chains, rejected_chains)."""
    q_len = len(data)
    qpos, qh, qstrand = minimizers.extract(data, params.k, params.w,
                                           words=words)
    if qh.size == 0 or idx.hashes.size == 0:
        return [], 0, 0
    left, right = idx.lookup(qh)
    rows = _expand_ranges(left, right)
    if rows.size == 0:
        return [], 0, 0
    qi = np.repeat(np.arange(qh.size, dtype=np.int64), right - left)
    a_tid = idx.tid[rows].astype(np.int64)
    a_tpos = idx.tpos[rows]
    rel = (idx.tstrand[rows] ^ qstrand[qi]).astype(np.int64)
    a_qpos = qpos[qi]
    k = params.k
    qT = np.where(rel == 1, q_len - k - a_qpos, a_qpos)
    diag = a_tpos - qT
    order = np.lexsort((a_tpos, qT, diag, rel, a_tid))
    a_tid, rel, diag = a_tid[order], rel[order], diag[order]
    qT, a_tpos = qT[order], a_tpos[order]
    # band cuts: new (target, strand) group or diagonal jump > band
    cut = np.ones(a_tid.size, dtype=bool)
    if a_tid.size > 1:
        cut[1:] = ((a_tid[1:] != a_tid[:-1]) | (rel[1:] != rel[:-1])
                   | (diag[1:] - diag[:-1] > params.band))
    starts = np.flatnonzero(cut)
    ends = np.append(starts[1:], a_tid.size)
    overlaps: List[tuple] = []
    admitted = rejected = 0
    for lo, hi in zip(starts, ends):
        if hi - lo < params.min_chain:
            rejected += 1
            continue
        c_qT = qT[lo:hi]
        c_tpos = a_tpos[lo:hi]
        chain = _lis(c_qT, c_tpos)
        chain = _best_segment(chain, c_qT, c_tpos, params.max_gap)
        if len(chain) < params.min_chain:
            rejected += 1
            continue
        admitted += 1
        tid = int(a_tid[lo])
        strand = int(rel[lo])
        qT_b, qT_e = int(c_qT[chain[0]]), int(c_qT[chain[-1]])
        t_begin = int(c_tpos[chain[0]])
        t_end = int(c_tpos[chain[-1]]) + k
        # extend the anchor bounding box toward the query ends
        # (clamped by the target): sparse chains on short/noisy reads
        # otherwise cover a fraction of the true span, starving the
        # window router; the breaking-point re-alignment downstream
        # absorbs any over-extension with gaps
        t_len = int(target_lengths[tid])
        ext = min(qT_b, t_begin)
        qT_b -= ext
        t_begin -= ext
        ext = min(q_len - k - qT_e, t_len - t_end)
        qT_e += ext
        t_end += ext
        if strand == 0:
            q_begin, q_end = qT_b, qT_e + k
        else:
            q_begin, q_end = q_len - k - qT_e, q_len - qT_b
        overlaps.append((len(chain), tid, t_begin, Overlap.from_paf(
            name, q_len, q_begin, q_end, "-" if strand else "+",
            target_names[tid], int(target_lengths[tid]), t_begin,
            t_end)))
    # deterministic emission: best span first, then target coordinates
    overlaps.sort(key=lambda rec: (-(rec[0]), rec[1], rec[2]))
    return [rec[3] for rec in overlaps], admitted, rejected


def map_sequences(queries: PySequence, targets: PySequence,
                  params: Optional[MapParams] = None,
                  idx: Optional[MinimizerIndex] = None,
                  primary_only: bool = False
                  ) -> Tuple[List[Overlap], dict]:
    """Map every query against the target set.

    ``queries``/``targets`` are core Sequence objects (or any objects
    with ``name``/``data``); ``params`` default to
    :func:`params_from_env`, seeding on the card.  Returns (overlaps,
    stats); overlaps are
    grouped per query in input order, PAF-shaped, ready for the same
    transmute/error-filter path a parsed PAF takes.

    ``primary_only`` emits each query's best chain alone (the most
    anchors; the first of ``chain_query``'s order), for contig
    polishing.  Departure from the JAX package, which emits every
    admitted chain: each is stretched to the query's ends, so a
    spurious chain's span is about the true one's, and the contig
    polisher, which keeps a query's longest overlap and the later one
    on a tie, then keeps the spurious chain (ROADMAP Queue 3).  Stats
    keep the JAX keys: ``chains_admitted - overlaps`` chains were
    dropped."""
    params = params or params_from_env()
    seed = params.seed_device
    if idx is None:
        idx = MinimizerIndex.build(
            targets, params.k, params.w, params.occ_cap,
            words=batched_words((t.data for t in targets), params.k,
                                seed))
    t_names = [t.name for t in targets]
    t_lens = [len(t.data) for t in targets]
    out: List[Overlap] = []
    admitted = rejected = 0
    words = batched_words((q.data for q in queries), params.k, seed)
    for q, q_words in zip(queries, words):
        ovl, adm, rej = chain_query(q.name, q.data, idx, params,
                                    t_names, t_lens, words=q_words)
        out.extend(ovl[:1] if primary_only else ovl)
        admitted += adm
        rejected += rej
    stats = {"queries": len(queries), "targets": len(targets),
             "overlaps": len(out), "chains_admitted": admitted,
             "chains_rejected": rejected,
             "index_entries": idx.total_entries,
             "masked_entries": idx.masked_entries,
             "masked_hashes": idx.masked_hashes}
    stats.update({"map_" + key: val for key, val in params.doc().items()})
    return out, stats
