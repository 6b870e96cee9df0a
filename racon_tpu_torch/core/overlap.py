"""Overlap domain object.

Mirrors racon's Overlap (reference: src/overlap.cpp): the MHAP, PAF
and SAM constructors, name/id resolution against the loaded sequence
set (``transmute``), and per-window breaking-point extraction by
walking the alignment CIGAR (``find_breaking_points_from_cigar``,
reference: src/overlap.cpp:226-292), natively (``ops/cpu.py``).  SAM
records carry their CIGAR as ``cigar_runs`` (run lengths and op
codes); PAF and MHAP carry none, so one is produced by a global
alignment of the query span vs the target span: on the card's align
kernels, which hand over ``cigar_runs`` directly, or on the native CPU
aligner.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence as Seq, Tuple

import numpy as np

from racon_tpu_torch.ops import cpu

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")

#: op alphabet the CIGAR codes index into
_OPS = b"MIDNSHP=X"

#: expanded (per-base) columns per slab of the batched breaking-point
#: decode
BP_COLS = 4_000_000

#: routed sentinel: the streaming seam stamps this shared empty
#: breaking-points array on overlaps whose fragments already reached
#: the window ledger, so the fall-through pass sees "done"
#: (find_breaking_points returns early) instead of re-aligning them
ROUTED = np.empty((0, 2), dtype=np.int64)
ROUTED.setflags(write=False)


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

    # -- format constructors (reference: src/overlap.cpp:15-108) -----------

    @classmethod
    def from_mhap(cls, a_id: int, b_id: int, a_rc: int, a_begin: int,
                  a_end: int, a_length: int, b_rc: int, b_begin: int,
                  b_end: int, b_length: int) -> "Overlap":
        o = cls()
        o.q_id = a_id - 1          # MHAP ids are 1-based
        o.q_begin, o.q_end, o.q_length = a_begin, a_end, a_length
        o.t_id = b_id - 1
        o.t_begin, o.t_end, o.t_length = b_begin, b_end, b_length
        o.strand = bool(a_rc ^ b_rc)
        o._set_span_error()
        return o

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

    @classmethod
    def from_sam(cls, q_name: str, flag: int, t_name: str, t_begin: int,
                 cigar: str) -> "Overlap":
        return cls.from_sam_bytes(q_name, flag, t_name, t_begin,
                                  cigar.encode())

    @classmethod
    def from_sam_bytes(cls, q_name: str, flag: int, t_name: str,
                       t_begin: int, cigar: bytes) -> "Overlap":
        """SAM constructor over the raw CIGAR bytes, parsed once into
        ``cigar_runs``."""
        is_valid = not (flag & 0x4)
        if len(cigar) < 2 and is_valid:
            raise InvalidInputError("missing alignment from SAM object")
        ops = _CIGAR_RE.findall(cigar)
        n = len(ops)
        lengths = np.fromiter((int(num) for num, _ in ops),
                              dtype=np.int64, count=n)
        codes = np.fromiter((_OPS.index(op) for _, op in ops),
                            dtype=np.int64, count=n)
        o = cls._from_sam_fields(q_name, flag, t_name, t_begin,
                                 *_sam_run_fields(lengths, codes))
        o.cigar_runs = (lengths, codes)
        return o

    @classmethod
    def _from_sam_fields(cls, q_name: str, flag: int, t_name: str,
                         t_begin: int, q_aln: int, t_aln: int,
                         q_clip: int, lead_clip: int) -> "Overlap":
        """Field assembly shared by ``from_sam_bytes`` and the batched
        SAM scan parser (io/fastio.py); ``lead_clip`` is the query start
        offset (reference: src/overlap.cpp:60-69)."""
        o = cls()
        o.q_name, o.t_name = q_name, t_name
        o.t_begin = t_begin - 1    # SAM POS is 1-based
        o.strand = bool(flag & 0x10)
        o.is_valid = not (flag & 0x4)
        o.q_begin = lead_clip
        o.q_end = lead_clip + q_aln
        o.q_length = q_clip + q_aln
        if o.strand:
            o.q_begin, o.q_end = o.q_length - o.q_end, o.q_length - o.q_begin
        o.t_end = o.t_begin + t_aln
        o.length = max(q_aln, t_aln)
        o.error = (1 - min(q_aln, t_aln) / o.length) if o.length else 0.0
        return o

    def _set_span_error(self) -> None:
        q_span = self.q_end - self.q_begin
        t_span = self.t_end - self.t_begin
        self.length = max(q_span, t_span)
        self.error = (1 - min(q_span, t_span) / self.length) if self.length \
            else 0.0

    # -- id resolution (reference: src/overlap.cpp:129-177) -----------------

    def transmute(self, sequences: Seq, name_to_id: Dict[str, int],
                  id_to_id: Dict[int, int]) -> None:
        """Resolve names (PAF, SAM) or 0-based file ids (MHAP) to
        sequence indices: ``id_to_id`` maps ``id << 1 | 0`` of the
        id-th read and ``id << 1 | 1`` of the id-th target."""
        if not self.is_valid or self.is_transmuted:
            return

        if self.q_name is not None:
            qid = name_to_id.get(self.q_name + "q")
            if qid is None:
                self.is_valid = False
                return
            self.q_id = qid
            self.q_name = None
        else:
            qid = id_to_id.get(self.q_id << 1 | 0)
            if qid is None:
                self.is_valid = False
                return
            self.q_id = qid

        if self.q_length != len(sequences[self.q_id].data):
            raise InvalidInputError(
                "unequal lengths in sequence and overlap file for sequence "
                f"{sequences[self.q_id].name}")

        if self.t_name is not None:
            tid = name_to_id.get(self.t_name + "t")
            if tid is None:
                self.is_valid = False
                return
            self.t_id = tid
            self.t_name = None
        else:
            tid = id_to_id.get(self.t_id << 1 | 1)
            if tid is None:
                self.is_valid = False
                return
            self.t_id = tid

        if self.t_length != 0 and \
                self.t_length != len(sequences[self.t_id].data):
            raise InvalidInputError(
                "unequal lengths in target and overlap file for target "
                f"{sequences[self.t_id].name}")

        # SAM records learn the target length here
        self.t_length = len(sequences[self.t_id].data)
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
        """CIGAR walk (reference: src/overlap.cpp:226-292), natively
        (``cpu.breaking_points``).

        Emits, for every window of the target the alignment spans, the
        (t, q) coordinates of the first match in the window and one past
        the last match.
        """
        # device-aligned overlaps hand over (lengths, codes) runs in
        # "MIDNSHP=X" indices, skipping the CIGAR string round trip
        runs = (self.cigar_runs if self.cigar_runs is not None
                else cpu.cigar_runs(self.cigar))
        self.breaking_points, = _points_of([self], [runs], window_length)


def _points_of(overlaps, runs, window_length: int) -> list:
    """Breaking points of ``overlaps`` from their ``runs``, one native
    call for all of them."""
    n = len(overlaps)
    t_begin = np.fromiter((o.t_begin for o in overlaps), np.int64, n)
    t_end = np.fromiter((o.t_end for o in overlaps), np.int64, n)
    q_start = np.fromiter(
        (((o.q_length - o.q_end) if o.strand else o.q_begin)
         for o in overlaps), np.int64, n)
    return cpu.breaking_points(runs, t_begin, t_end, q_start,
                               window_length)


# ---------------------------------------------------------------------------
# CIGAR runs of SAM records
# ---------------------------------------------------------------------------

def _sam_run_fields(lengths: np.ndarray,
                    codes: np.ndarray) -> Tuple[int, int, int, int]:
    """(q_aln, t_aln, q_clip, lead_clip) of one run list: aligned query
    and target bases, clipped query bases, and the leading clip."""
    q_aln = int(lengths[np.isin(codes, (0, 1, 7, 8))].sum())
    t_aln = int(lengths[np.isin(codes, (0, 2, 3, 7, 8))].sum())
    q_clip = int(lengths[np.isin(codes, (4, 5))].sum())
    lead_clip = int(lengths[0]) if codes.size and codes[0] in (4, 5) else 0
    return q_aln, t_aln, q_clip, lead_clip


def parse_cigar_runs_batch(arr: np.ndarray, starts: np.ndarray,
                           ends: np.ndarray):
    """Parse many CIGAR byte spans of one buffer into per-record
    ``(lengths, codes)`` run arrays in one vectorized pass.

    Follows ``_CIGAR_RE.findall``: a digit run directly followed by an
    op char forms a run, anything else is skipped.  Op positions come
    from one mask over the concatenated spans, each op's number from a
    right-aligned digit matrix.  Returns ``(runs, bad)``: ``runs[i]``
    is record i's (lengths, codes), and ``bad[i]`` flags a record with
    a run length of more than 18 digits (it would overflow the digit
    matrix), which the caller re-parses with the regex."""
    n = int(starts.size)
    bad = np.zeros(n, dtype=bool)
    lens = (ends - starts).astype(np.int64)
    total = int(lens.sum())
    empty = (np.empty(0, np.int64), np.empty(0, np.int64))
    if total == 0:
        return [empty] * n, bad
    off = np.concatenate(([0], np.cumsum(lens)))
    pos = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], lens) \
        + np.repeat(starts.astype(np.int64), lens)
    cat = arr[pos].astype(np.int64)
    rec = np.repeat(np.arange(n, dtype=np.int64), lens)
    is_digit = (cat >= 48) & (cat <= 57)
    op_pos = np.flatnonzero(~is_digit)
    lut = np.full(256, -1, dtype=np.int64)
    for k, ch in enumerate(_OPS):
        lut[ch] = k
    op_code = lut[cat[op_pos]]
    op_rec = rec[op_pos]
    prev_op = np.concatenate(([-1], op_pos[:-1]))
    num_start = np.maximum(prev_op + 1, off[op_rec])
    num_len = op_pos - num_start
    valid = (op_code >= 0) & (num_len > 0)
    too_wide = valid & (num_len > 18)
    if too_wide.any():
        bad[np.unique(op_rec[too_wide])] = True
        valid &= ~too_wide
    v_pos = op_pos[valid]
    v_rec = op_rec[valid]
    v_code = op_code[valid]
    v_ns = num_start[valid]
    v_nl = num_len[valid]
    width = int(v_nl.max()) if v_nl.size else 0
    if width:
        cols = v_pos[:, None] - width + np.arange(width, dtype=np.int64)
        in_num = cols >= v_ns[:, None]
        digits = np.where(in_num, cat[np.maximum(cols, 0)] - 48, 0)
        v_num = digits @ (10 ** np.arange(width - 1, -1, -1,
                                          dtype=np.int64))
    else:
        v_num = np.empty(0, np.int64)
    bounds = np.searchsorted(v_rec, np.arange(n + 1))
    runs = [(np.ascontiguousarray(v_num[bounds[i]:bounds[i + 1]]),
             np.ascontiguousarray(v_code[bounds[i]:bounds[i + 1]]))
            for i in range(n)]
    return runs, bad


# ---------------------------------------------------------------------------
# batched breaking-point decode
# ---------------------------------------------------------------------------

def iter_decode_slabs(overlaps, col_budget: int = None):
    """Partition run-carrying overlaps into slabs whose total expanded
    (per-base) column count stays under ``col_budget`` (default
    ``BP_COLS``), so that the pool decodes slabs side by side."""
    col_budget = max(1, BP_COLS if col_budget is None else col_budget)
    slabs, cur, cols = [], [], 0
    for o in overlaps:
        if o.breaking_points is not None or o.cigar_runs is None:
            continue
        lengths = np.asarray(o.cigar_runs[0])
        c = int(lengths.sum()) if lengths.size else 0
        if cur and cols + c > col_budget:
            slabs.append(cur)
            cur, cols = [], 0
        cur.append(o)
        cols += c
    if cur:
        slabs.append(cur)
    return slabs


def decode_breaking_points_batch(overlaps, window_length: int,
                                 col_budget: int = None) -> None:
    """Breaking points of a batch of run-carrying overlaps, one native
    call per slab of ``iter_decode_slabs``; the points equal the
    single-overlap decode's element for element.  Overlaps without
    runs or with points already present are left alone."""
    for slab in iter_decode_slabs(overlaps, col_budget):
        _decode_bp_slab(slab, window_length)


def _decode_bp_slab(overlaps, window_length: int) -> None:
    points = _points_of(overlaps, [o.cigar_runs for o in overlaps],
                        window_length)
    for o, pts in zip(overlaps, points):
        o.breaking_points = pts
        o.cigar = ""
        o.cigar_runs = None
