"""Dispatch halves of the align kernels: encode a chunk of pairs, launch
the kernel, and hand back a collect closure that decodes its results
(the counterparts of ``align_dispatch``/``align_batch`` and
``wfa_dispatch``/``wfa_batch`` in ``racon_tpu/tpu/align_pallas.py``).

A dispatch launches exactly the pairs it is given: each pair's result
depends on that pair alone, never on the batch it rides in.  On the
card the launch is asynchronous, so ``run_pipelined`` keeps two chunks
in flight: chunk k + 1 is encoded and launched before chunk k is
collected.  A collect closure's ``kernel_ms()`` is the chunk's
CUDA-event time once collected (0 on the CPU), and ``device_s()`` its
interval's length on the obs clock (the plain version's host time on
the CPU).  Collecting records that interval in the trace's ``device``
lane as ``device.align_wfa{emax}`` / ``device.align_band{wb}`` and in
the dispatch's ``util`` (default ``obs.DEVICE_UTIL``) under
``align_wfa`` / ``align_band`` (``cuda/devclock.py``).

Everything a launch reads (codes, lengths, band centres) or writes (its
outputs and scratch: ``wfa_buffers`` / ``band_buffers``) is made on the
device before the timer's first mark, so the interval between the two
marks holds the kernel launch alone and ``kernel_ms()`` reads the
kernel, not the host's copies or the allocator.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from racon_tpu_torch.cuda import align_band as ab
from racon_tpu_torch.cuda import align_wfa as aw
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.cuda.devclock import DispatchTimer


def _lengths(seqs, device):
    return _upload(np.array([len(s) for s in seqs], dtype=np.int32), device)


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device)


def _timed(device, launch, util=None):
    """Run ``launch()`` between two marks; returns (outputs, timer)."""
    timer = DispatchTimer(device, util)
    timer.mark()
    out = launch()
    timer.mark()
    return out, timer


def _set_cycles(collect, meta) -> None:
    """The kernel's per-pair [phase 1, phase 2] cycles (``meta[:, 2:4]``,
    0 on the CPU) as ``collect.cycles`` and their sums as
    ``collect.phase_cycles``."""
    collect.cycles = meta[:, 2:4].astype(np.int64)
    collect.phase_cycles = collect.cycles.sum(0).tolist()


def wfa_dispatch(queries, targets, lq: int, emax: int, device,
                 util=None):
    """Launch one WFA chunk; ``collect()`` gives (tapes [n, entries]
    int64, entry counts, distances) with distances exact (<= emax) or
    ``BIG`` for rejected pairs; it also sets ``collect.phase_cycles``,
    the kernel's summed [wavefront steps, traceback] cycles
    (``meta[:, 2:4]``, 0 on the CPU), and ``collect.cycles``, the same
    per pair."""
    n = len(queries)
    q = _upload(al.encode_batch(queries, lq, al.QPAD), device)
    t = _upload(al.encode_batch(targets, lq, al.TPAD), device)
    ql, tl = _lengths(queries, device), _lengths(targets, device)
    lmax = max(max(map(len, queries)), max(map(len, targets)), 1)
    bufs = aw.wfa_buffers(q, t, ql, tl, emax=emax)
    (tape, meta), timer = _timed(device, lambda: aw.wfa_align(
        q, t, ql, tl, emax=emax, lmax=lmax, bufs=bufs), util)

    def collect():
        tp = tape.cpu().numpy().reshape(n, -1).astype(np.int64)
        mt = meta.cpu().numpy()
        timer.record(f"device.align_wfa{emax}", "align_wfa", {"n": n})
        if (mt[:, 0] == aw.TOO_LONG).any():
            raise RuntimeError(f"align_wfa: a pair longer than lmax={lmax}")
        _set_cycles(collect, mt)
        return tp, mt[:, 1], mt[:, 0]

    collect.kernel_ms = timer.kernel_ms
    collect.device_s = timer.device_s
    return collect


def band_dispatch(queries, targets, lq: int, lt: int, wb: int, device,
                  centers=None, util=None):
    """Launch one banded chunk; ``centers`` holds one knot array per
    pair (``estimate_center_knots``) or None for the proportional
    diagonal.  ``collect()`` gives (moves [n, 16 * words] uint8, move
    counts, distances, ``BIG`` out of band); it also sets
    ``collect.phase_cycles``, the kernel's summed [DP, traceback]
    cycles (``meta[:, 2:4]``, 0 on the CPU), and ``collect.cycles``,
    the same per pair."""
    n = len(queries)
    ctr = np.stack([
        centers[k] if centers is not None and centers[k] is not None
        else ab.proportional_knots(len(queries[k]), len(targets[k]), lq)
        for k in range(n)]).astype(np.int32)
    q = _upload(al.encode_batch(queries, lq, al.QPAD), device)
    t = _upload(al.encode_batch(targets, lt, al.TPAD), device)
    ql, tl = _lengths(queries, device), _lengths(targets, device)
    ctr = _upload(ctr, device)
    bufs = ab.band_buffers(q, t, wb=wb)
    (tape, meta), timer = _timed(device, lambda: ab.band_align(
        q, t, ql, tl, ctr, wb=wb, bufs=bufs), util)

    def collect():
        mt = meta.cpu().numpy()
        timer.record(f"device.align_band{wb}", "align_band", {"n": n})
        _set_cycles(collect, mt)
        return ab.unpack_moves(tape.cpu().numpy()), mt[:, 1], mt[:, 0]

    collect.kernel_ms = timer.kernel_ms
    collect.device_s = timer.device_s
    return collect


def run_pipelined(chunks, dispatch, consume, depth: int = 2) -> None:
    """Drive ``dispatch(chunk) -> collect`` over ``chunks`` with up to
    ``depth`` dispatches in flight, consuming in order
    (``consume(chunk, collect)``)."""
    inflight = deque()
    for sub in chunks:
        inflight.append((sub, dispatch(sub)))
        if len(inflight) >= depth:
            consume(*inflight.popleft())
    while inflight:
        consume(*inflight.popleft())
