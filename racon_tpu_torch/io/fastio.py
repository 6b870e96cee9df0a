"""Vectorized zero-copy parsers for FASTA, FASTQ, PAF, MHAP and SAM.

The scan parsers read the whole file once (mmap for plain files, one
``gzip.decompress`` for compressed ones), build a line-offset table
with a single numpy newline scan, and parse record fields in batched
vector passes; only record construction remains per-row Python.

Chunk boundaries follow the same "raw bytes consumed" arithmetic as
line parsers (FASTA does not count prelude lines, the overlap formats
do not count blank lines).  An overlap row the vector pass cannot
answer for bit-exactly (non-digit int field, missing columns, non-ASCII
strand byte, a CIGAR run of more than 18 digits) falls back to the
matching line parser of :mod:`racon_tpu_torch.io.parsers` for that row,
which reproduces tolerant parses and the exact error text.
"""

from __future__ import annotations

import gzip
import mmap
import os
from typing import List, Optional

import numpy as np

from racon_tpu_torch.core.overlap import (InvalidInputError, Overlap,
                                          _sam_run_fields,
                                          parse_cigar_runs_batch)
from racon_tpu_torch.core.sequence import Sequence
from racon_tpu_torch.io import parsers as _line

#: missing-column sentinel: larger than any file offset, small enough
#: that sentinel arithmetic (+1, +18) stays inside int64
_BIG = np.int64(2) ** 62

#: per-call vector block bounds: line count and summed line bytes
_BLOCK_LINES = 65536
_BLOCK_BYTES = 8_000_000

class _ScanParserBase:
    """Whole-buffer loader + numpy line table shared by every scan
    parser.  ``reset`` drops the buffer so the next parse re-reads the
    file (matching the line parsers' close-and-reopen)."""

    format_label = "Scan"

    def __init__(self, path: str):
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        self.path = path
        self._mm = None
        self._buf = None
        self._arr: Optional[np.ndarray] = None
        self._starts: Optional[np.ndarray] = None
        self._ends: Optional[np.ndarray] = None
        self._rawnext: Optional[np.ndarray] = None
        self._size = 0
        self._post_reset()

    def reset(self) -> None:
        self._release()
        self._post_reset()

    def close(self) -> None:
        self._release()

    def _post_reset(self) -> None:
        """Per-parser cursor state; overridden."""

    def _release(self) -> None:
        self._arr = None
        self._starts = None
        self._ends = None
        self._rawnext = None
        self._buf = None
        mm, self._mm = self._mm, None
        if mm is not None:
            try:
                mm.close()
            except (BufferError, ValueError):
                pass   # a live numpy view defers the unmap to GC

    def _ensure_scanned(self) -> None:
        if self._arr is not None:
            return
        with open(self.path, "rb") as fh:
            magic = fh.read(2)
        if magic == b"\x1f\x8b":
            with open(self.path, "rb") as fh:
                self._buf = gzip.decompress(fh.read())
        else:
            with open(self.path, "rb") as fh:
                if os.fstat(fh.fileno()).st_size:
                    self._mm = mmap.mmap(fh.fileno(), 0,
                                         access=mmap.ACCESS_READ)
                    self._buf = self._mm
                else:
                    self._buf = b""
        arr = np.frombuffer(self._buf, dtype=np.uint8)
        self._arr = arr
        self._size = int(arr.size)
        nl = np.flatnonzero(arr == 10).astype(np.int64)
        starts = np.concatenate(([0], nl + 1))
        raw_ends = np.concatenate((nl, [self._size]))
        if starts.size and starts[-1] == self._size:
            # file ends in a newline: no phantom final line
            starts = starts[:-1]
            raw_ends = raw_ends[:-1]
        # logical line ends strip the trailing \r run (CRLF files; one
        # pass per \r of the longest run, i.e. 2 passes for CRLF)
        ends = raw_ends.copy()
        while True:
            has_cr = (ends > starts) & \
                (arr[np.maximum(ends - 1, 0)] == 13)
            if not has_cr.any():
                break
            ends = ends - has_cr
        self._starts = starts
        self._ends = ends
        rawnext = np.empty(starts.size, dtype=np.int64)
        if starts.size:
            rawnext[:-1] = starts[1:]
            rawnext[-1] = self._size
        self._rawnext = rawnext

    def _line(self, idx: int) -> bytes:
        """Logical (stripped) bytes of line ``idx``."""
        return bytes(self._buf[int(self._starts[idx]):
                               int(self._ends[idx])])


def _gather(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``table[idx]`` with out-of-range entries mapped to the missing
    sentinel (columns a short line does not have)."""
    if table.size == 0:
        return np.full(idx.shape, _BIG, dtype=np.int64)
    return np.where(idx < table.size,
                    table[np.minimum(idx, table.size - 1)], _BIG)


def _parse_int_matrix(arr: np.ndarray, fs: np.ndarray, fe: np.ndarray):
    """Parse an (n, k) matrix of byte spans as base-10 ints via a
    right-aligned digit matrix.  Rows with an empty field, a field
    over 18 digits, or any non-digit byte are flagged bad — the caller
    re-parses those lines in Python, which both accepts the forms
    ``int()`` tolerates (signs, surrounding whitespace) and reproduces
    exact error text for truly malformed input."""
    widths = fe - fs
    bad = (widths <= 0).any(axis=1) | (widths > 18).any(axis=1)
    width = int(min(max(int(widths.max(initial=1)), 1), 18))
    cols = fe[..., None] - width + np.arange(width, dtype=np.int64)
    in_field = cols >= fs[..., None]
    digits = arr[np.clip(cols, 0, arr.size - 1)].astype(np.int64) - 48
    bad |= ~(((digits >= 0) & (digits <= 9)) | ~in_field).all(
        axis=(1, 2))
    vals = np.where(in_field, digits, 0) @ \
        (10 ** np.arange(width - 1, -1, -1, dtype=np.int64))
    return vals, bad


class FastaScanParser(_ScanParserBase):
    """Multi-line FASTA over the line table: headers are the nonempty
    lines starting with '>', each record's data is the join of the
    stripped lines up to the next header."""

    format_label = "Fasta"

    def _post_reset(self) -> None:
        self._next_rec = 0
        self._base_line: Optional[int] = None  # where byte counting starts
        self._hdr_lines: Optional[np.ndarray] = None

    def _ensure_index(self) -> None:
        if self._hdr_lines is not None:
            return
        self._ensure_scanned()
        s, e = self._starts, self._ends
        hdr = np.zeros(s.size, dtype=bool)
        nonempty = np.flatnonzero(e > s)
        hdr[nonempty] = self._arr[s[nonempty]] == 62
        self._hdr_lines = np.flatnonzero(hdr)

    def parse(self, dst: List[Sequence], max_bytes: int) -> bool:
        self._ensure_index()
        hdrs = self._hdr_lines
        rec = self._next_rec
        if rec >= hdrs.size:
            return False
        s, e = self._starts, self._ends
        n_lines = s.size
        if max_bytes < 0:
            stop = int(hdrs.size)
        else:
            # the line parser counts raw bytes from the first header
            # it sees (prelude lines are skipped uncounted) and stops
            # at the first LATER header once over budget
            base_line = (self._base_line if self._base_line is not None
                         else int(hdrs[rec]))
            base = int(s[base_line]) if base_line < n_lines \
                else self._size
            consumed_at = s[hdrs[rec + 1:]] - base
            stop = rec + 1 + int(np.searchsorted(consumed_at, max_bytes,
                                                 side="left"))
        buf = self._buf
        s_l, e_l = s, e
        for j in range(rec, stop):
            h = int(hdrs[j])
            header = bytes(buf[int(s_l[h]) + 1:int(e_l[h])])
            lo = h + 1
            hi = int(hdrs[j + 1]) if j + 1 < hdrs.size else n_lines
            if hi == lo + 1:
                data = bytes(buf[int(s_l[lo]):int(e_l[lo])])
            else:
                data = b"".join(buf[int(s_l[k]):int(e_l[k])]
                                for k in range(lo, hi))
            dst.append(Sequence.from_fasta(header, data))
        if stop < hdrs.size:
            self._next_rec = stop
            self._base_line = int(hdrs[stop]) + 1
            return True
        self._next_rec = int(hdrs.size)
        return False


class FastqScanParser(_ScanParserBase):
    """FASTQ with possibly line-wrapped data/quality sections.  The
    record state machine stays in Python (it is inherently
    sequential: the quality section's extent depends on the data
    length) but runs over plain-int offset tables, not file reads."""

    format_label = "Fastq"

    def _post_reset(self) -> None:
        self._cursor = 0
        self._tab = None

    def _ensure_index(self) -> None:
        if self._tab is not None:
            return
        self._ensure_scanned()
        s, e = self._starts, self._ends
        first = np.full(s.size, -1, dtype=np.int64)
        nonempty = np.flatnonzero(e > s)
        first[nonempty] = self._arr[s[nonempty]]
        self._tab = (s.tolist(), e.tolist(), first.tolist(),
                     self._rawnext.tolist())

    def parse(self, dst: List[Sequence], max_bytes: int) -> bool:
        self._ensure_index()
        s, e, first, rawnext = self._tab
        n = len(s)
        i = self._cursor
        if i >= n:
            return False
        budget = max_bytes if max_bytes >= 0 else float("inf")
        consumed = 0
        buf = self._buf
        while i < n:
            h = i
            consumed += rawnext[i] - s[i]
            i += 1
            if first[h] != 64:      # not an '@' header line
                continue
            data_lines: List[int] = []
            data_len = 0
            while i < n:
                consumed += rawnext[i] - s[i]
                if first[i] == 43:  # '+' separator (consumed)
                    i += 1
                    break
                data_lines.append(i)
                data_len += e[i] - s[i]
                i += 1
            qual_lines: List[int] = []
            qual_len = 0
            while qual_len < data_len and i < n:
                consumed += rawnext[i] - s[i]
                qual_lines.append(i)
                qual_len += e[i] - s[i]
                i += 1
            dst.append(Sequence.from_fastq(
                buf[s[h] + 1:e[h]],
                b"".join(buf[s[k]:e[k]] for k in data_lines),
                b"".join(buf[s[k]:e[k]] for k in qual_lines)))
            if consumed >= budget:
                self._cursor = i
                return True
        self._cursor = i
        return False


class _OverlapScanParser(_ScanParserBase):
    """Chunking and the per-row fallback shared by the overlap formats:
    a parse stops after the first nonempty line that crosses the byte
    budget (blank lines are skipped uncounted, as the line parsers
    count), and the vector passes run over bounded blocks of lines."""

    #: the matching line parser class; supplies ``record_from_line``
    line_parser = None

    def _post_reset(self) -> None:
        self._cursor = 0

    def _select_rows(self, a: int, b: int):
        """Line starts and ends of lines [a, b) and the nonempty rows."""
        s, e = self._starts[a:b], self._ends[a:b]
        return s, e, np.flatnonzero(e > s)

    def parse(self, dst: List[Overlap], max_bytes: int) -> bool:
        self._ensure_scanned()
        n = self._starts.size
        i0 = self._cursor
        if i0 >= n:
            return False
        if max_bytes < 0:
            i1, more = n, False
        else:
            s = self._starts[i0:]
            nonempty = self._ends[i0:] > s
            cum = np.cumsum(np.where(nonempty,
                                     self._rawnext[i0:] - s, 0))
            over = np.flatnonzero(nonempty & (cum >= max_bytes))
            if over.size:
                i1, more = i0 + int(over[0]) + 1, True
            else:
                i1, more = n, False
        self._cursor = i1
        # the field matrices (and the SAM path's expanded CIGAR columns)
        # scale with the block, not the file
        csum = np.cumsum(self._rawnext[i0:i1] - self._starts[i0:i1])
        j = i0
        while j < i1:
            base = int(csum[j - i0 - 1]) if j > i0 else 0
            k = i0 + int(np.searchsorted(csum, base + _BLOCK_BYTES)) + 1
            k = max(j + 1, min(i1, k, j + _BLOCK_LINES))
            self._parse_lines(dst, j, k)
            j = k
        return more

    def _parse_lines(self, dst: List[Overlap], a: int, b: int) -> None:
        raise NotImplementedError

    def _fallback_line(self, dst: List[Overlap], line_idx: int) -> None:
        """Parse one line through the line parser's record factory: the
        rows the vector pass flagged, with tolerant parses and exact
        malformed-input diagnostics."""
        try:
            record = self.line_parser.record_from_line(
                self._line(line_idx))
        except (IndexError, ValueError, UnicodeDecodeError) as exc:
            raise self._malformed(line_idx, exc) from exc
        if record is not None:
            dst.append(record)

    def _malformed(self, line_idx: int, exc: Exception):
        return _line.MalformedInputError(
            f"{self.path}:{line_idx + 1}: malformed "
            f"{self.format_label} record ({exc})")


class PafScanParser(_OverlapScanParser):
    """PAF: 9 leading tab-separated columns; extra columns ignored."""

    format_label = "Paf"
    line_parser = _line.PafParser

    def _parse_lines(self, dst: List[Overlap], a: int, b: int) -> None:
        s, e, rows = self._select_rows(a, b)
        if rows.size == 0:
            return
        ls, le = s[rows], e[rows]
        arr = self._arr
        lo, hi = int(ls[0]), int(le[-1])
        seg = arr[lo:hi]
        tabs = np.flatnonzero(seg == 9).astype(np.int64) + lo
        t0 = np.searchsorted(tabs, ls)
        tab8 = _gather(tabs, t0[:, None] + np.arange(8, dtype=np.int64))
        has9 = tab8[:, 7] < le           # tabs sorted: implies all 8
        tab_after = _gather(tabs, (t0 + 8)[:, None])[:, 0]
        fs = np.empty((ls.size, 9), np.int64)
        fe = np.empty_like(fs)
        fs[:, 0] = ls
        fs[:, 1:] = np.minimum(tab8, _BIG - 2) + 1
        fe[:, :8] = tab8
        fe[:, 8] = np.where(tab_after < le, tab_after, le)
        ints, int_bad = _parse_int_matrix(
            arr, fs[:, (1, 2, 3, 6, 7, 8)], fe[:, (1, 2, 3, 6, 7, 8)])
        # strand: a one-byte '+'/'-' column; any non-ASCII byte there
        # could change .decode() semantics -> per-line fallback
        ascii_cum = np.concatenate(
            ([0], np.cumsum((seg >= 128).astype(np.int64))))
        f4s = np.clip(fs[:, 4] - lo, 0, ascii_cum.size - 1)
        f4e = np.clip(fe[:, 4] - lo, 0, ascii_cum.size - 1)
        strand_bad = (ascii_cum[f4e] - ascii_cum[f4s]) > 0
        minus = (fe[:, 4] - fs[:, 4] == 1) & \
            (arr[np.clip(fs[:, 4], 0, arr.size - 1)] == 45)
        bad = (~has9 | int_bad | strand_bad).tolist()
        minus_l = minus.tolist()
        vals = ints.tolist()
        f0s, f0e = fs[:, 0].tolist(), fe[:, 0].tolist()
        f5s, f5e = fs[:, 5].tolist(), fe[:, 5].tolist()
        lines = (a + rows).tolist()
        buf = self._buf
        for r in range(len(lines)):
            if bad[r]:
                self._fallback_line(dst, lines[r])
                continue
            try:
                q_name = bytes(buf[f0s[r]:f0e[r]]).decode()
                t_name = bytes(buf[f5s[r]:f5e[r]]).decode()
            except UnicodeDecodeError as exc:
                raise self._malformed(lines[r], exc) from exc
            v = vals[r]
            dst.append(Overlap.from_paf(
                q_name, v[0], v[1], v[2],
                "-" if minus_l[r] else "+",
                t_name, v[3], v[4], v[5]))


class MhapScanParser(_OverlapScanParser):
    """MHAP: whitespace-separated columns; ids and coordinates at tokens
    0, 1 and 4-11 (the scores at 2 and 3 are never parsed)."""

    format_label = "Mhap"
    line_parser = _line.MhapParser

    _INT_TOKENS = (0, 1, 4, 5, 6, 7, 8, 9, 10, 11)

    def _parse_lines(self, dst: List[Overlap], a: int, b: int) -> None:
        s, e, rows = self._select_rows(a, b)
        if rows.size == 0:
            return
        ls, le = s[rows], e[rows]
        arr = self._arr
        lo, hi = int(ls[0]), int(le[-1])
        seg = arr[lo:hi]
        ws = ((seg == 32) | (seg == 9) | (seg == 10) | (seg == 13) |
              (seg == 11) | (seg == 12))
        token = ~ws
        tok_s = np.flatnonzero(
            token & np.concatenate(([True], ws[:-1]))).astype(np.int64) + lo
        tok_e = np.flatnonzero(
            token & np.concatenate((ws[1:], [True]))).astype(np.int64) \
            + lo + 1
        t0 = np.searchsorted(tok_s, ls)
        idx = t0[:, None] + np.arange(12, dtype=np.int64)
        starts12 = _gather(tok_s, idx)
        ends12 = _gather(tok_e, idx)
        has12 = ends12[:, 11] <= le       # token 11 ends inside the line
        ints, int_bad = _parse_int_matrix(
            arr, starts12[:, self._INT_TOKENS],
            np.minimum(ends12, _BIG)[:, self._INT_TOKENS])
        bad = (~has12 | int_bad).tolist()
        vals = ints.tolist()
        lines = (a + rows).tolist()
        for r in range(len(lines)):
            if bad[r]:
                self._fallback_line(dst, lines[r])
                continue
            v = vals[r]
            dst.append(Overlap.from_mhap(
                v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8],
                v[9]))


class SamScanParser(_OverlapScanParser):
    """SAM alignment lines: '@' headers skipped, 6 leading tab columns,
    CIGARs parsed in one batched pass straight into ``cigar_runs``."""

    format_label = "Sam"
    line_parser = _line.SamParser

    def _parse_lines(self, dst: List[Overlap], a: int, b: int) -> None:
        s, e, rows = self._select_rows(a, b)
        if rows.size == 0:
            return
        ls, le = s[rows], e[rows]
        arr = self._arr
        record = arr[ls] != 64            # '@' header lines skipped
        rows, ls, le = rows[record], ls[record], le[record]
        if rows.size == 0:
            return
        lo, hi = int(ls[0]), int(le[-1])
        tabs = np.flatnonzero(arr[lo:hi] == 9).astype(np.int64) + lo
        t0 = np.searchsorted(tabs, ls)
        tab5 = _gather(tabs, t0[:, None] + np.arange(5, dtype=np.int64))
        has6 = tab5[:, 4] < le
        tab_after = _gather(tabs, (t0 + 5)[:, None])[:, 0]
        f5_end = np.where(tab_after < le, tab_after, le)
        fs1 = np.minimum(tab5, _BIG - 2) + 1
        ints, int_bad = _parse_int_matrix(
            arr, fs1[:, (0, 2)], tab5[:, (1, 3)])
        cig_s = np.minimum(fs1[:, 4], f5_end)
        cig_e = f5_end
        runs, runs_bad = parse_cigar_runs_batch(
            arr, np.where(has6, cig_s, 0), np.where(has6, cig_e, 0))
        bad = (~has6 | int_bad | runs_bad).tolist()
        flags = ints[:, 0].tolist()
        positions = ints[:, 1].tolist()
        clens = (cig_e - cig_s).tolist()
        f0s, f0e = ls.tolist(), tab5[:, 0].tolist()
        f2s, f2e = fs1[:, 1].tolist(), tab5[:, 2].tolist()
        lines = (a + rows).tolist()
        buf = self._buf
        for r in range(len(lines)):
            if bad[r]:
                self._fallback_line(dst, lines[r])
                continue
            flag = flags[r]
            if clens[r] < 2 and not flag & 0x4:
                # a mapped record must carry an alignment (raised as the
                # line parser raises it)
                raise InvalidInputError(
                    "missing alignment from SAM object")
            try:
                q_name = bytes(buf[f0s[r]:f0e[r]]).decode()
                t_name = bytes(buf[f2s[r]:f2e[r]]).decode()
            except UnicodeDecodeError as exc:
                raise self._malformed(lines[r], exc) from exc
            o = Overlap._from_sam_fields(
                q_name, flag, t_name, positions[r],
                *_sam_run_fields(*runs[r]))
            o.cigar_runs = runs[r]
            dst.append(o)
