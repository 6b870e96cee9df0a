"""Overlap domain object.

Mirrors racon's Overlap (reference: src/overlap.cpp) for the PAF
format: name resolution against the loaded sequence set
(``transmute``), and per-window breaking-point extraction by walking
the alignment CIGAR (``find_breaking_points_from_cigar``, reference:
src/overlap.cpp:226-292), vectorised with numpy.  PAF carries no
CIGAR, so one is produced by a global alignment of the query
span vs the target span: on the card's align kernels, which hand over
``cigar_runs`` (run lengths and op codes) directly, or on the native
CPU aligner.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence as Seq

import numpy as np

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")

#: op alphabet the CIGAR codes index into
_OPS = b"MIDNSHP=X"


class InvalidInputError(RuntimeError):
    """Unrecoverable input inconsistency (reference exits(1))."""


class Overlap:
    __slots__ = ("q_name", "q_id", "q_begin", "q_end", "q_length",
                 "t_name", "t_id", "t_begin", "t_end", "t_length",
                 "strand", "length", "error", "cigar", "cigar_runs",
                 "is_valid", "is_transmuted", "breaking_points")

    def __init__(self):
        self.q_name: Optional[str] = None
        self.q_id: int = 0
        self.q_begin = 0
        self.q_end = 0
        self.q_length = 0
        self.t_name: Optional[str] = None
        self.t_id: int = 0
        self.t_begin = 0
        self.t_end = 0
        self.t_length = 0
        self.strand = False
        self.length = 0
        self.error = 0.0
        self.cigar: str = ""
        self.cigar_runs = None     # (lengths, codes) from the card
        self.is_valid = True
        self.is_transmuted = False
        self.breaking_points: Optional[np.ndarray] = None  # (2k, 2) [t, q]

    # -- PAF constructor (reference: src/overlap.cpp:29-45) -----------------

    @classmethod
    def from_paf(cls, q_name: str, q_length: int, q_begin: int, q_end: int,
                 orientation: str, t_name: str, t_length: int, t_begin: int,
                 t_end: int) -> "Overlap":
        o = cls()
        o.q_name, o.q_length, o.q_begin, o.q_end = \
            q_name, q_length, q_begin, q_end
        o.t_name, o.t_length, o.t_begin, o.t_end = \
            t_name, t_length, t_begin, t_end
        o.strand = orientation == "-"
        o._set_span_error()
        return o

    def _set_span_error(self) -> None:
        q_span = self.q_end - self.q_begin
        t_span = self.t_end - self.t_begin
        self.length = max(q_span, t_span)
        self.error = (1 - min(q_span, t_span) / self.length) if self.length \
            else 0.0

    # -- id resolution (reference: src/overlap.cpp:129-177) -----------------

    def transmute(self, sequences: Seq,
                  name_to_id: Dict[str, int]) -> None:
        if not self.is_valid or self.is_transmuted:
            return

        qid = name_to_id.get(self.q_name + "q")
        if qid is None:
            self.is_valid = False
            return
        self.q_id = qid
        self.q_name = None

        if self.q_length != len(sequences[self.q_id].data):
            raise InvalidInputError(
                "unequal lengths in sequence and overlap file for sequence "
                f"{sequences[self.q_id].name}")

        tid = name_to_id.get(self.t_name + "t")
        if tid is None:
            self.is_valid = False
            return
        self.t_id = tid
        self.t_name = None

        if self.t_length != 0 and \
                self.t_length != len(sequences[self.t_id].data):
            raise InvalidInputError(
                "unequal lengths in target and overlap file for target "
                f"{sequences[self.t_id].name}")

        self.is_transmuted = True

    # -- alignment slices ---------------------------------------------------

    def query_span(self, sequences: Seq) -> bytes:
        """Strand-aware query slice (reference: src/overlap.cpp:193-194)."""
        seq = sequences[self.q_id]
        if not self.strand:
            return seq.data[self.q_begin:self.q_end]
        rc = seq.reverse_complement
        return rc[self.q_length - self.q_end:self.q_length - self.q_begin]

    def target_span(self, sequences: Seq) -> bytes:
        return sequences[self.t_id].data[self.t_begin:self.t_end]

    # -- breaking points ----------------------------------------------------

    def find_breaking_points(self, sequences: Seq, window_length: int,
                             aligner) -> None:
        """Produce (target, query) window breaking points;
        ``aligner(q: bytes, t: bytes) -> str`` supplies the CIGAR
        (reference uses edlib, src/overlap.cpp:205-224)."""
        if not self.is_transmuted:
            raise InvalidInputError("overlap is not transmuted")
        if self.breaking_points is not None:
            return
        if not self.cigar and self.cigar_runs is None:
            self.cigar = aligner(self.query_span(sequences),
                                 self.target_span(sequences))
        self.find_breaking_points_from_cigar(window_length)
        self.cigar = ""
        self.cigar_runs = None

    def find_breaking_points_from_cigar(self, window_length: int) -> None:
        """Vectorised CIGAR walk (reference: src/overlap.cpp:226-292).

        Emits, for every window of the target the alignment spans, the
        (t, q) coordinates of the first match in the window and one past
        the last match.
        """
        w = window_length
        empty = np.empty((0, 2), dtype=np.int64)
        if self.cigar_runs is not None:
            # device-aligned overlaps hand over (lengths, codes) runs in
            # "MIDNSHP=X" indices, skipping the CIGAR string round trip
            lengths, codes = (a.astype(np.int64, copy=False)
                              for a in self.cigar_runs)
        else:
            ops = _CIGAR_RE.findall(self.cigar.encode())
            lengths = np.array([int(n) for n, _ in ops], dtype=np.int64)
            codes = np.array([_OPS.index(op) for _, op in ops],
                             dtype=np.int64)
        if lengths.size == 0:
            self.breaking_points = empty
            return
        # advance masks per op: M(0) = X(8) = '='(7) advance both;
        # I(1) query; D(2)/N(3) target; S/H/P consume nothing.
        advances_t = np.isin(codes, (0, 2, 3, 7, 8))
        advances_q = np.isin(codes, (0, 1, 7, 8))
        matches = np.isin(codes, (0, 7, 8))
        keep = advances_t | advances_q
        lengths, advances_t, advances_q, matches = (
            lengths[keep], advances_t[keep], advances_q[keep], matches[keep])
        if lengths.size == 0:
            self.breaking_points = empty
            return

        t_adv = np.repeat(advances_t, lengths)
        q_adv = np.repeat(advances_q, lengths)
        is_match = np.repeat(matches, lengths)

        q_start = (self.q_length - self.q_end if self.strand
                   else self.q_begin) - 1
        t_pos = self.t_begin - 1 + np.cumsum(t_adv)
        q_pos = q_start + np.cumsum(q_adv)

        boundary = t_adv & (
            (((t_pos + 1) % w == 0) & (t_pos < self.t_end - 1)) |
            (t_pos == self.t_end - 1))
        n_boundaries = int(boundary.sum())
        if n_boundaries == 0:
            self.breaking_points = empty
            return

        seg_id = np.cumsum(boundary) - boundary  # boundary col closes its seg
        m_idx = np.flatnonzero(is_match)
        if m_idx.size == 0:
            self.breaking_points = empty
            return
        m_seg = seg_id[m_idx]
        segs = np.arange(n_boundaries)
        lo = np.searchsorted(m_seg, segs, side="left")
        hi = np.searchsorted(m_seg, segs, side="right")
        has_match = lo < hi
        lo, hi = lo[has_match], hi[has_match]
        first_cols = m_idx[lo]
        last_cols = m_idx[hi - 1]

        points = np.empty((2 * first_cols.size, 2), dtype=np.int64)
        points[0::2, 0] = t_pos[first_cols]
        points[0::2, 1] = q_pos[first_cols]
        points[1::2, 0] = t_pos[last_cols] + 1
        points[1::2, 1] = q_pos[last_cols] + 1
        self.breaking_points = points
