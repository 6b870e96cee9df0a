"""ctypes bindings to the native CPU compute engines.

The shared library provides the edlib-equivalent global aligner (the
breaking-point re-alignment of overlaps the card does not align) and the
spoa-equivalent POA consensus engine (windows the CUDA kernel rejects).
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
_SOURCES = ("align.cpp", "poa.cpp", "poa_graph.hpp", "Makefile")

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> None:
    sources = [os.path.join(_NATIVE_DIR, s) for s in _SOURCES]
    if os.path.exists(_LIB_PATH) and all(
            os.path.getmtime(_LIB_PATH) >= os.path.getmtime(s)
            for s in sources):
        return
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
