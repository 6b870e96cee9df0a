"""Batched POA consensus on the card (cudapoa-equivalent).

``CudaPoaBatchEngine`` packs a megabatch of windows
(``racon_tpu_torch.convert.pack_windows``), launches the whole-window
POA kernel once for it (``poa_full.poa_full``) and demultiplexes the
results, the full-device path of the JAX package's
``TPUPoaBatchEngine`` (racon_tpu/tpu/poa.py:389-680).  Windows with
fewer than 3 sequences keep their backbone without device work
(cudabatch.cpp:214-222); a window the kernel rejects comes back as
``None`` for the CPU engine to re-polish (cudabatch.cpp:124-155 ->
cudapolisher.cpp:357-386), counted by fail code in ``reject_counts``
and recorded as a ``poa_reject`` decision.  Each kernel pass of a
launch is a ``device.poa`` span of the trace's ``device`` lane and a
``poa`` interval of the dispatch's ``util`` (default
``obs.DEVICE_UTIL``; ``cuda/devclock.py``).

Each dispatch's collect reports what it measured on its own
(``kernel_ms()``, ``device_s()`` and, once called, ``stats``: a
:class:`DispatchStats` with per-window cells, pred rows, cycles,
skipped layers and rejects), and the engine keeps no result state:
several consumers share one engine -- the device executor's tenants
(``cuda/executor.py``) -- and each counts only its own windows, in a
:class:`PoaCounters` that adds the stats of the collects it made.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

import torch

from racon_tpu_torch import convert
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.cuda.devclock import DispatchTimer
from racon_tpu_torch.obs.decision import DECISIONS
from racon_tpu_torch.utils.tuning import pow2_at_least

Result = Tuple[Optional[bytes], bool]

#: reject-count keys by kernel fail code
FAIL_NAMES = {pf.FAIL_VCAP: "vcap", pf.FAIL_EDGE: "edge",
              pf.FAIL_KCAP: "kcap", pf.FAIL_ALIGNED: "aligned",
              pf.FAIL_PATH: "path"}

#: the kernel's per-window cycle counters, mout[5], mout[6], mout[7]
PHASES = ("dp", "traceback_merge", "other")


class DispatchStats:
    """What one POA dispatch measured: its launches' CUDA-event ms and
    device-lane seconds, and per window (in the dispatch's order) the
    DP cells, pred rows, the kernel's phase cycles (mout[5:8]), the
    layers the packing dropped, whether the kernel polished it, and its
    reject's fail name (None when it was not rejected)."""

    __slots__ = ("kernel_ms", "device_s", "cells", "pred_rows", "cycles",
                 "skipped", "on_kernel", "fails")

    def __init__(self, n: int):
        self.kernel_ms = 0.0
        self.device_s = 0.0
        self.cells = np.zeros(n, np.int64)
        self.pred_rows = np.zeros(n, np.int64)
        self.cycles = np.zeros((n, len(PHASES)), np.int64)
        self.skipped = np.zeros(n, np.int64)
        self.on_kernel = np.zeros(n, bool)
        self.fails: List[Optional[str]] = [None] * n

    def slice(self, lo: int, hi: int, share: float) -> "DispatchStats":
        """The windows ``[lo, hi)``, with ``share`` of the dispatch's
        time (their item share of a fused dispatch)."""
        out = DispatchStats(0)
        out.kernel_ms = self.kernel_ms * share
        out.device_s = self.device_s * share
        for name in ("cells", "pred_rows", "cycles", "skipped",
                     "on_kernel", "fails"):
            setattr(out, name, getattr(self, name)[lo:hi])
        return out


class PoaCounters:
    """Totals of the POA dispatches one consumer collected; :meth:`add`
    is thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reject_counts = {name: 0 for name in FAIL_NAMES.values()}
        self.n_skipped_layers = 0
        self.windows_on_kernel = 0
        self.cells = 0
        #: pred rows the DP folded into its rows (the kernel's ring hits
        #: plus misses, ``stats[:, :2]``): one per real predecessor of
        #: every rank
        self.pred_rows = 0
        self.kernel_ms = 0.0        # CUDA-event time of the launches
        #: the launches' device-lane seconds (the plain version's host
        #: time on the CPU)
        self.device_s = 0.0
        #: the kernel's clock64() cycles summed over windows, by phase
        #: (mout[5:8]; 0 from the plain version)
        self.phase_cycles = dict.fromkeys(PHASES, 0)

    def add(self, st: DispatchStats) -> None:
        with self._lock:
            self.kernel_ms += st.kernel_ms
            self.device_s += st.device_s
            self.cells += int(st.cells.sum())
            self.pred_rows += int(st.pred_rows.sum())
            self.n_skipped_layers += int(st.skipped.sum())
            self.windows_on_kernel += int(st.on_kernel.sum())
            for k, name in enumerate(PHASES):
                self.phase_cycles[name] += int(st.cycles[:, k].sum())
            for code in st.fails:
                if code is not None:
                    self.reject_counts[code] += 1


class CudaPoaBatchEngine:
    """Whole-window POA over megabatches on ``device``.  Caps mirror
    the CUDA batch limits (max sequences per POA = 200,
    src/cuda/cudapolisher.cpp:229)."""

    def __init__(self, match: int, mismatch: int, gap: int, *, device,
                 vcap: int = 2048, pcap: int = 16, lcap: int = 1024,
                 max_depth: int = 200, banded: bool = False):
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.device = torch.device(device)
        self.vcap, self.pcap, self.lcap = vcap, pcap, lcap
        self.max_depth = max_depth
        self.wb = pf.band_width(lcap, banded)

    def depth_cap(self, windows) -> int:
        """D1 bound of a batch from raw layer counts (an upper bound
        on what the packing keeps)."""
        depth = max((min(len(w.sequences) - 1, self.max_depth)
                     for w in windows), default=0)
        return max(8, pow2_at_least(depth + 1, 8))

    def fits(self, windows) -> bool:
        return pf.fits(self.vcap, self.lcap, self.depth_cap(windows),
                       self.pcap, self.pcap, 8, self.wb)

    def consensus_batch(self, windows, trim: bool) -> List[Result]:
        return self.consensus_batch_async(windows, trim)()

    def consensus_batch_async(self, windows, trim: bool, util=None):
        """Launch a batch and return a zero-argument collect closure
        giving one (consensus, polished) pair per window; consensus is
        None for a window the kernel rejected.  The launches' intervals
        go to ``util`` (default ``obs.DEVICE_UTIL``).  The closure's
        ``kernel_ms()`` and ``device_s()`` are this dispatch's alone,
        and calling it sets ``collect.stats`` (:class:`DispatchStats`)."""
        out: List[Result] = [None] * len(windows)
        groups = {}
        for i, w in enumerate(windows):
            if len(w.sequences) < 3:
                out[i] = (w.sequences[0], False)
            else:
                # the window type selects the trim; one launch per type
                groups.setdefault(w.type.value, []).append(i)
        launches = [(idxs, *self._launch([windows[i] for i in idxs], trim,
                                         util))
                    for _, idxs in sorted(groups.items())]
        timers = [timer for _, _, timer in launches]

        def collect():
            st = DispatchStats(len(windows))
            for idxs, coll, _ in launches:
                rows, part = coll()
                for j, i in enumerate(idxs):
                    out[i] = rows[j]
                    st.fails[i] = part.fails[j]
                for name in ("cells", "pred_rows", "cycles", "skipped",
                             "on_kernel"):
                    getattr(st, name)[idxs] = getattr(part, name)
            st.kernel_ms = collect.kernel_ms()
            st.device_s = collect.device_s()
            collect.stats = st
            return out

        collect.kernel_ms = lambda: sum(t.kernel_ms() for t in timers)
        collect.device_s = lambda: sum(t.device_s() for t in timers)
        return collect

    def _launch(self, windows, trim: bool, util):
        """One launch of same-type windows; returns (collect giving
        (results, DispatchStats), its DispatchTimer)."""
        pk = convert.pack_windows(windows, self.lcap, self.vcap,
                                  self.max_depth)
        args = convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                                 pk.bblen, self.device)
        stats = torch.zeros((pk.seqs.shape[0], 3), dtype=torch.int32,
                            device=self.device)
        timer = DispatchTimer(self.device, util)
        timer.mark()
        cons, mout = pf.poa_full(
            *args, v=self.vcap, lp=self.lcap, wb=self.wb,
            match=self.match, mismatch=self.mismatch, gap=self.gap,
            wtype=windows[0].type.value, trim=1 if trim else 0,
            p=self.pcap, s=self.pcap, a=8, stats=stats,
            timer=timer)
        if not timer.cuda:
            timer.mark()

        def collect():
            n = len(windows)
            mo = mout[:n].cpu().numpy()
            st = DispatchStats(n)
            st.pred_rows[:] = stats[:n, :2].sum(1).cpu().numpy()
            cs = cons[:n].cpu().numpy()
            timer.record("device.poa", "poa", {"n": n})
            st.cells[:] = mo[:, 4].astype(np.int64) * self.wb
            st.cycles[:] = mo[:, 5:8]
            st.skipped[:] = pk.skipped
            results: List[Result] = []
            for b, w in enumerate(windows):
                length = int(mo[b, 0])
                if pk.host_fail[b] or length < 0:
                    code = pf.FAIL_VCAP if pk.host_fail[b] \
                        else int(mo[b, 2])
                    st.fails[b] = FAIL_NAMES[code]
                    DECISIONS.record("poa_reject", code=FAIL_NAMES[code],
                                     phase="extract")
                    results.append((None, False))
                    continue
                if int(mo[b, 1]) == 2:
                    w.warn_chimeric()
                st.on_kernel[b] = True
                results.append(
                    (cs[b, :length].astype("uint8").tobytes(), True))
            return results, st

        return collect, timer
