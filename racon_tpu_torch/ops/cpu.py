"""ctypes bindings to the native CPU compute engines.

The shared library provides the edlib-equivalent global aligner (the
breaking-point re-alignment of overlaps the card does not align), the
breaking-point walk over an alignment's runs and the CIGAR parse that
feeds it, the spoa-equivalent POA consensus engine (windows the CUDA
kernel rejects), and the lockstep POA engine's host graphs
(``poa_batch.cpp``, bound in ``cuda/poa_lockstep.py``).
Calls release the GIL, so the polisher's thread pool runs them in
parallel.

The library is built with ``make`` from ``racon_tpu_torch/native`` into
``racon_tpu_torch/build/native`` the first time it is needed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libracon_native.so")
_SOURCES = ("align.cpp", "poa.cpp", "poa_batch.cpp", "poa_graph.hpp",
            "Makefile")

_lib = None
_lib_lock = threading.Lock()
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build_library() -> None:
    sources = [os.path.join(_NATIVE_DIR, s) for s in _SOURCES]
    if os.path.exists(_LIB_PATH) and all(
            os.path.getmtime(_LIB_PATH) >= os.path.getmtime(s)
            for s in sources):
        return
    from racon_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.add("native_builds")
    proc = subprocess.run(["make", "-C", _NATIVE_DIR, "-j",
                           f"OUT={_BUILD_DIR}"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "[racon_tpu_torch::native] build failed:\n" + proc.stderr)


def get_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        _build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.rt_edit_distance.restype = ctypes.c_int32
        lib.rt_edit_distance.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32]
        lib.rt_align.restype = ctypes.c_int64
        lib.rt_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.rt_poa_consensus.restype = ctypes.c_int64
        lib.rt_poa_consensus.argtypes = [
            ctypes.c_char_p,                        # seqs blob
            np.ctypeslib.ndpointer(np.int64),       # offsets
            ctypes.c_char_p,                        # quals blob
            np.ctypeslib.ndpointer(np.uint8),       # has_qual
            np.ctypeslib.ndpointer(np.int32),       # begins
            np.ctypeslib.ndpointer(np.int32),       # ends
            ctypes.c_int32,                         # n_seqs
            ctypes.c_int32,                         # window_type
            ctypes.c_int32,                         # trim
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # m, x, g
            ctypes.c_char_p, ctypes.c_int64,        # out, out_cap
            ctypes.POINTER(ctypes.c_int32)]         # status
        lib.rt_cigar_runs.restype = ctypes.c_int64
        lib.rt_cigar_runs.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            _I64, _I64, ctypes.c_int64]
        lib.rt_breaking_points.restype = ctypes.c_int64
        lib.rt_breaking_points.argtypes = [ctypes.c_int64] + [_I64] * 6 + [
            ctypes.c_int64, _I64, _I64, _I64]
        _lib = lib
        return _lib


def edit_distance(query: bytes, target: bytes) -> int:
    """Global Levenshtein distance (edlib default-config equivalent)."""
    lib = get_library()
    return lib.rt_edit_distance(query, len(query), target, len(target))


def align(query: bytes, target: bytes) -> str:
    """Global alignment; returns a standard CIGAR (M covers mismatches)."""
    return align_with_distance(query, target)[0]


def align_with_distance(query: bytes, target: bytes) -> Tuple[str, int]:
    """Global alignment; returns (CIGAR, edit distance) -- the distance
    feeds the align ladder's divergence probe."""
    lib = get_library()
    cap = 4 * (len(query) + len(target)) + 16
    buf = ctypes.create_string_buffer(cap)
    dist = ctypes.c_int32(0)
    n = lib.rt_align(query, len(query), target, len(target), buf, cap,
                     ctypes.byref(dist))
    if n < 0:
        raise RuntimeError(
            f"[racon_tpu_torch::align] native aligner failed (code {n}) "
            f"on pair ({len(query)} x {len(target)})")
    return buf.raw[:n].decode(), int(dist.value)


def cigar_runs(cigar: str) -> Tuple[np.ndarray, np.ndarray]:
    """A CIGAR string's (lengths, codes) runs in "MIDNSHP=X" indices,
    parsed natively; anything that is not a count followed by an op
    letter is skipped."""
    raw = cigar.encode()
    cap = len(raw) // 2 + 1
    lengths = np.empty(cap, np.int64)
    codes = np.empty(cap, np.int64)
    n = get_library().rt_cigar_runs(raw, len(raw), lengths, codes, cap)
    return lengths[:n], codes[:n]


def breaking_points(runs, t_begin: np.ndarray, t_end: np.ndarray,
                    q_start: np.ndarray, window_length: int) -> list:
    """Window breaking points of a batch of alignments in one native
    call, which releases the GIL: ``runs[i]`` is alignment i's (lengths,
    codes) in "MIDNSHP=X" indices, its target span starts at
    ``t_begin[i]`` and ends at ``t_end[i]``, its query at
    ``q_start[i]``.  Returns a (2k, 2) int64 array of (target, query)
    points per alignment: the first match of each window segment and
    one past its last (Overlap.find_breaking_points_from_cigar)."""
    n = len(runs)
    if n == 0:
        return []
    lengths = [np.ascontiguousarray(r[0], np.int64) for r in runs]
    run_off = np.zeros(n + 1, np.int64)
    np.cumsum([a.size for a in lengths], out=run_off[1:])
    all_l = np.concatenate(lengths)
    all_c = np.concatenate([np.ascontiguousarray(r[1], np.int64)
                            for r in runs])
    t_begin = np.ascontiguousarray(t_begin, np.int64)
    t_end = np.ascontiguousarray(t_end, np.int64)
    q_start = np.ascontiguousarray(q_start, np.int64)
    # a segment ends at a window boundary or at the span's last column
    seg_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.maximum(t_end - t_begin, 0) // window_length + 2,
              out=seg_off[1:])
    pts = np.empty((2 * int(seg_off[-1]), 2), np.int64)
    n_out = np.empty(n, np.int64)
    rc = get_library().rt_breaking_points(
        n, run_off, all_l, all_c, t_begin, t_end, q_start, window_length,
        seg_off, pts, n_out)
    if rc == -2:
        raise ValueError("[racon_tpu_torch::breaking_points] CIGAR op "
                         "code outside MIDNSHP=X")
    if rc != 0:
        raise RuntimeError(f"[racon_tpu_torch::breaking_points] native "
                           f"decode failed (code {rc})")
    lo = (2 * seg_off[:-1]).tolist()
    return [pts[a:a + k] for a, k in zip(lo, n_out.tolist())]


class PoaEngine:
    """CPU POA consensus engine bound to one set of alignment scores.
    One engine is shared by all threads (the native call is
    reentrant)."""

    def __init__(self, match: int = 3, mismatch: int = -5, gap: int = -4):
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        get_library()  # build/bind eagerly

    def consensus(self, window, trim: bool) -> bytes:
        sequences: List[bytes] = window.sequences
        qualities: List[Optional[bytes]] = window.qualities
        positions: List[Tuple[int, int]] = window.positions
        n = len(sequences)

        offsets = np.zeros(n + 1, dtype=np.int64)
        for i, s in enumerate(sequences):
            offsets[i + 1] = offsets[i] + len(s)
        seqs_blob = b"".join(sequences)
        quals_blob = b"".join(
            q if q is not None else b"\x00" * len(s)
            for s, q in zip(sequences, qualities))
        has_qual = np.array([1 if q is not None else 0 for q in qualities],
                            dtype=np.uint8)
        begins = np.array([p[0] for p in positions], dtype=np.int32)
        ends = np.array([p[1] for p in positions], dtype=np.int32)

        out_cap = 4 * len(sequences[0]) + 4096
        out = ctypes.create_string_buffer(out_cap)
        status = ctypes.c_int32(0)
        lib = get_library()
        length = lib.rt_poa_consensus(
            seqs_blob, offsets, quals_blob, has_qual, begins, ends,
            n, window.type.value, 1 if trim else 0,
            self.match, self.mismatch, self.gap,
            out, out_cap, ctypes.byref(status))
        if length < 0:
            raise RuntimeError(
                f"[racon_tpu_torch::PoaEngine] consensus buffer overflow "
                f"in window {window.id}:{window.rank}")
        if status.value == 2:
            window.warn_chimeric()
        return out.raw[:length]
