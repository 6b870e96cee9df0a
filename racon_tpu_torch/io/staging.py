"""Shard-aware input staging: the one-pass slice index (JAX package:
racon_tpu/io/staging.py).

A scattered sub-job (racon_tpu_torch/serve/scatter.py) owns one
``target_slice`` shard of the targets, yet a full parse would read every
overlap row and drop (K-1)/K of them after transmute.  This module
builds, in one pass over the fastio line table, an index from target
shard to the line and byte ranges of the overlaps file that can
contribute rows to that shard, so shard i maps the same file but
materializes only its slice (``_OverlapScanParser.set_stage`` in
racon_tpu_torch/io/fastio.py).

Byte identity with the full parse for owned targets rests on how
``Polisher._load_overlaps`` filters (racon_tpu_torch/core/polisher.py):
``remove_invalid`` (error threshold, self-overlap, and kC's longest per
query) works over contiguous same-``q_id`` runs, and the ownership drop
comes strictly after it.  Three rules make the staged stream
indistinguishable:

* selection is by whole query-run, never by row: a run (a maximal
  stretch of lines sharing PAF column 0) is staged iff it touches an
  owned target, so longest-per-query sees the same candidates;
* run boundaries are kept: where dropping the runs between two staged
  runs would make two same-name runs adjacent (the cursor in
  ``_load_overlaps`` would fuse them), the separator run right after the
  first is staged too, and its rows die on the ownership mask as in the
  full parse;
* rows nobody can own are staged everywhere: a run that names an
  unknown target is selected for every shard, so its invalid marking
  (or its diagnostics) surface the same.

``build_index`` returns ``None`` (the full parse) whenever a row would
not survive the strict column checks below: a malformed row must raise
the line parser's exact ``path:line`` diagnostics, and the cheapest way
to keep that is not to stage.  PAF only (``.paf``/``.paf.gz``: query
name column 0, target name column 5); MHAP and SAM take the full parse.

Staging is policy, never bytes: ``RACON_TPU_TORCH_STAGE`` (default on;
"0" restores the full parse) is in the cache's EPOCH_EXCLUDE set, and
tests/test_torch_scatter.py holds the staged stream of owned targets to
the full parse's bytes.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, List, Optional

import numpy as np


def stage_enabled() -> bool:
    """RACON_TPU_TORCH_STAGE selects ranged scanning for target-sharded
    parses (default on); "0" restores the full parse.  Read per use so
    tests can flip it between polishes."""
    return os.environ.get("RACON_TPU_TORCH_STAGE", "1") != "0"


#: extensions the v1 index understands (PAF only)
_PAF_EXTENSIONS = (".paf", ".paf.gz")


def fasta_names(path: str) -> List[str]:
    """Target names in file order — the exact ``Sequence.name`` rule
    (first whitespace-separated token of the header), read from the
    fastio header-line table without joining any sequence data.
    Raises on unreadable/undecodable headers; callers treat any
    exception as "cannot stage"."""
    from racon_tpu_torch.io import fastio

    p = fastio.FastaScanParser(path)
    try:
        p._ensure_index()
        names = []
        for h in p._hdr_lines.tolist():
            header = bytes(p._buf[int(p._starts[h]) + 1:
                                  int(p._ends[h])])
            parts = header.split()
            names.append(parts[0].decode() if parts else "")
        return names
    finally:
        p.close()


class StageIndex:
    """Per-(overlaps, targets) slice index: query-runs with their
    line/byte extents and touched target ids.  Built once, answers
    ``ranges_for(mask)`` for every shard of the plan."""

    def __init__(self, path: str, sig: List[int], total_lines: int,
                 total_bytes: int):
        self.path = path
        self.sig = sig                    # [st_size, st_mtime_ns]
        self.total_lines = total_lines
        self.total_bytes = total_bytes    # decompressed buffer size
        self.run_lo: List[int] = []       # first line index of run
        self.run_hi: List[int] = []       # one past last line index
        self.run_blo: List[int] = []      # raw byte extent (buffer
        self.run_bhi: List[int] = []      # coordinates for .gz)
        self.run_q: List[bytes] = []      # the run's query name
        #: per run: sorted target-id tuple, or None = stage everywhere
        #: (a row referenced a target name outside the target set)
        self.run_targets: List[Optional[tuple]] = []

    def ranges_for(self, mask) -> dict:
        """Merged ``[line_lo, line_hi)`` ranges for the shard owning
        the ``True`` targets of ``mask``, plus the staged/total byte
        and line accounting the pricing and telemetry satellites
        consume."""
        owned = {i for i, m in enumerate(mask) if m}
        picked: List[int] = []
        prev = None
        for ri in range(len(self.run_lo)):
            ts = self.run_targets[ri]
            if ts is not None and owned.isdisjoint(ts):
                continue
            if prev is not None and ri > prev + 1 \
                    and self.run_q[ri] == self.run_q[prev]:
                # dropping the gap would fuse two same-query runs in
                # the staged stream; keep the separator run so
                # _load_overlaps sees the same run boundaries
                picked.append(prev + 1)
            picked.append(ri)
            prev = ri
        ranges: List[List[int]] = []
        extents: List[List[int]] = []
        staged_lines = 0
        reads = set()
        for ri in picked:
            reads.add(self.run_q[ri])
            if ranges and ranges[-1][1] == self.run_lo[ri]:
                ranges[-1][1] = self.run_hi[ri]
                extents[-1][1] = self.run_bhi[ri]
            else:
                ranges.append([self.run_lo[ri], self.run_hi[ri]])
                extents.append([self.run_blo[ri], self.run_bhi[ri]])
            staged_lines += self.run_hi[ri] - self.run_lo[ri]
        staged_bytes = sum(b[1] - b[0] for b in extents)
        return {"ranges": ranges,
                "staged_bytes": staged_bytes,
                "total_bytes": self.total_bytes,
                "staged_lines": staged_lines,
                "total_lines": self.total_lines,
                "reads": len(reads)}


def _file_sig(path: str) -> List[int]:
    st = os.stat(path)
    return [int(st.st_size), int(st.st_mtime_ns)]


def build_index(path: str, target_names: List[str]) \
        -> Optional[StageIndex]:
    """One pass over the overlaps file -> :class:`StageIndex`, or
    ``None`` whenever staging cannot be exact (non-PAF extension, a
    row that fails the strict column checks, undecodable names): the
    caller then runs the unchanged full parse, so malformed input
    keeps its exact line-parser diagnostics."""
    if not path.endswith(_PAF_EXTENSIONS):
        return None
    from racon_tpu_torch.io import fastio

    try:
        sig = _file_sig(path)
        scan = fastio._ScanParserBase(path)
    except (OSError, FileNotFoundError):
        return None
    # same later-wins rule as Polisher.initialize's name_to_id
    tmap: Dict[str, int] = {n: i for i, n in enumerate(target_names)}
    try:
        try:
            scan._ensure_scanned()
        except OSError:
            return None
        s, e, rawnext = scan._starts, scan._ends, scan._rawnext
        buf = scan._buf
        idx = StageIndex(path, sig, int(s.size), scan._size)
        lines = np.flatnonzero(e > s).tolist()
        s_l, e_l, rn_l = s.tolist(), e.tolist(), rawnext.tolist()
        cur_q = None
        cur_targets: Optional[set] = set()
        run_lo = run_blo = 0

        def flush(hi_line: int, bhi: int) -> None:
            idx.run_lo.append(run_lo)
            idx.run_hi.append(hi_line)
            idx.run_blo.append(run_blo)
            idx.run_bhi.append(bhi)
            idx.run_q.append(cur_q)
            idx.run_targets.append(
                None if cur_targets is None
                else tuple(sorted(cur_targets)))

        prev_line = None
        for i in lines:
            line = bytes(buf[s_l[i]:e_l[i]])
            f = line.split(b"\t")
            if len(f) < 9:
                return None
            try:
                # the exact fields Overlap.from_paf converts: any row
                # int()/.decode() would reject must not be skippable
                int(f[1]); int(f[2]); int(f[3])          # noqa: E702
                int(f[6]); int(f[7]); int(f[8])          # noqa: E702
                f[0].decode()
                t_name = f[5].decode()
            except (ValueError, UnicodeDecodeError):
                return None
            q = f[0]
            if q != cur_q:
                if prev_line is not None:
                    flush(prev_line + 1, rn_l[prev_line])
                cur_q = q
                cur_targets = set()
                run_lo, run_blo = i, s_l[i]
            tid = tmap.get(t_name)
            if cur_targets is not None:
                if tid is None:
                    cur_targets = None    # unowned: stage everywhere
                else:
                    cur_targets.add(tid)
            prev_line = i
        if prev_line is not None:
            flush(prev_line + 1, rn_l[prev_line])
        return idx
    finally:
        scan.close()


#: small in-process memo: plan-time router builds and per-shard
#: self-builds of the same (overlaps, targets) pair share one index
_MEMO: Dict[tuple, Optional[StageIndex]] = {}
_MEMO_LOCK = threading.Lock()
_MEMO_CAP = 8


def get_index(path: str, target_names: List[str]) \
        -> Optional[StageIndex]:
    """Memoized :func:`build_index`: keyed by the overlaps file's
    identity (realpath + size + mtime) and a digest of the target
    name order (the tid mapping).  A changed file re-keys, so a stale
    index is never served."""
    try:
        sig = _file_sig(path)
        names_digest = hashlib.blake2b(
            "\n".join(target_names).encode(), digest_size=16).hexdigest()
        key = (os.path.realpath(path), sig[0], sig[1], names_digest)
    except (OSError, UnicodeEncodeError):
        return None
    with _MEMO_LOCK:
        if key in _MEMO:
            return _MEMO[key]
    idx = build_index(path, target_names)
    with _MEMO_LOCK:
        if len(_MEMO) >= _MEMO_CAP:
            _MEMO.pop(next(iter(_MEMO)))
        _MEMO[key] = idx
    return idx


def shard_hint(index: StageIndex, shard, n_targets: int) -> dict:
    """The ``spec["stage"]`` document the router ships with a
    fanned-out sub-job: the shard's merged line ranges plus the
    byte/line/read accounting, self-describing enough for the
    receiving daemon to validate (path + file signature + shard
    coordinates) before trusting it."""
    from racon_tpu_torch.parallel import multihost

    index_i, count = shard
    sl = multihost.target_slice(n_targets, count, index_i)
    mask = [sl.start <= t < sl.stop for t in range(n_targets)]
    plan = index.ranges_for(mask)
    plan.update({"v": 1, "format": "paf", "path": index.path,
                 "sig": list(index.sig),
                 "shard": [int(index_i), int(count)]})
    return plan


def plan_from_hint(hint, path: str, shard) -> Optional[dict]:
    """Validate a shipped ``spec["stage"]`` hint against THIS
    daemon's view of the input: same file (realpath + size + mtime),
    same shard coordinates, sane ranges.  Any mismatch returns
    ``None`` — the polisher then self-builds or falls back to the
    full parse; a stale hint must never stage the wrong slice."""
    if not isinstance(hint, dict) or hint.get("v") != 1 \
            or hint.get("format") != "paf":
        return None
    try:
        if list(map(int, hint.get("shard") or [])) \
                != [int(x) for x in (shard or [])]:
            return None
        if os.path.realpath(str(hint["path"])) != os.path.realpath(path):
            return None
        if [int(x) for x in hint["sig"]] != _file_sig(path):
            return None
        ranges = [[int(lo), int(hi)] for lo, hi in hint["ranges"]]
    except (KeyError, TypeError, ValueError, OSError):
        return None
    prev = 0
    for lo, hi in ranges:
        if lo < prev or hi < lo:
            return None
        prev = hi
    out = {"ranges": ranges}
    for k in ("staged_bytes", "total_bytes", "staged_lines",
              "total_lines", "reads"):
        try:
            out[k] = int(hint.get(k, 0))
        except (TypeError, ValueError):
            out[k] = 0
    return out


def validate_stage_field(stage) -> Optional[str]:
    """Schema check for a submitted ``spec["stage"]`` (the scheduler
    rejects malformed ones up front as ``bad_request`` rather than
    failing mid-parse).  Returns an error string or ``None``."""
    if not isinstance(stage, dict):
        return "stage must be an object"
    if stage.get("v") != 1:
        return "stage.v must be 1"
    if not isinstance(stage.get("path"), str):
        return "stage.path must be a string"
    ranges = stage.get("ranges")
    if not isinstance(ranges, list):
        return "stage.ranges must be a list"
    for r in ranges:
        if not (isinstance(r, (list, tuple)) and len(r) == 2
                and all(isinstance(x, int) and x >= 0 for x in r)):
            return "stage.ranges entries must be [lo, hi] int pairs"
    return None
