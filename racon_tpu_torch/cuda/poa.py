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

Windows past the whole-window kernel's caps (``fits`` is false: racon's
``-w`` above 512 gives caps that kernel cannot hold) take the lockstep
engine, the JAX package's portable path (racon_tpu/tpu/poa.py:684-858):
the graphs live on the host (``native/poa_batch.cpp``) and each round
exports every window's graph, launches one ``poa_lockstep`` kernel for
every window's next layer (``cuda/poa_lockstep.py``) and applies the
paths.  It runs synchronously at dispatch; each round's launch is a
``device.poa`` span and a ``poa`` interval like the full kernel's.  Its
export rejects (vcap, pcap, kcap) are ``poa_reject`` decisions with
``phase="export"``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

import torch

from racon_tpu_torch import convert
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.cuda import poa_lockstep as pl
from racon_tpu_torch.cuda.devclock import DispatchTimer
from racon_tpu_torch.obs.decision import DECISIONS
from racon_tpu_torch.obs.trace import now as _now
from racon_tpu_torch.utils.tuning import poa_band_cols, pow2_at_least

Result = Tuple[Optional[bytes], bool]

#: reject-count keys by kernel fail code
FAIL_NAMES = {pf.FAIL_VCAP: "vcap", pf.FAIL_EDGE: "edge",
              pf.FAIL_KCAP: "kcap", pf.FAIL_ALIGNED: "aligned",
              pf.FAIL_PATH: "path"}
#: reject-count keys by the lockstep export's codes (rt_poab_export)
EXPORT_FAIL_NAMES = {-1: "vcap", -2: "pcap", -3: "kcap"}
#: the lockstep engine's host and device phases
LOCKSTEP_PHASES = ("export", "dispatch", "apply", "extract")

#: the kernel's per-window cycle counters, mout[5], mout[6], mout[7]
PHASES = ("dp", "traceback_merge", "other")


class DispatchStats:
    """What one POA dispatch measured: its launches' CUDA-event ms and
    device-lane seconds, and per window (in the dispatch's order) the
    DP cells, pred rows, the kernel's phase cycles (mout[5:8]), the
    layers the packing dropped, whether the kernel polished it, and its
    reject's fail name (None when it was not rejected)."""

    __slots__ = ("kernel_ms", "device_s", "cells", "pred_rows", "cycles",
                 "skipped", "on_kernel", "fails", "rounds", "phase_walls")

    def __init__(self, n: int):
        self.kernel_ms = 0.0
        self.device_s = 0.0
        self.cells = np.zeros(n, np.int64)
        self.pred_rows = np.zeros(n, np.int64)
        self.cycles = np.zeros((n, len(PHASES)), np.int64)
        self.skipped = np.zeros(n, np.int64)
        self.on_kernel = np.zeros(n, bool)
        self.fails: List[Optional[str]] = [None] * n
        #: the lockstep engine's rounds and its phase walls (0 for the
        #: whole-window kernel)
        self.rounds = 0
        self.phase_walls = dict.fromkeys(LOCKSTEP_PHASES, 0.0)

    def slice(self, lo: int, hi: int, share: float) -> "DispatchStats":
        """The windows ``[lo, hi)``, with ``share`` of the dispatch's
        time (their item share of a fused dispatch)."""
        out = DispatchStats(0)
        out.kernel_ms = self.kernel_ms * share
        out.device_s = self.device_s * share
        # every window of a lockstep dispatch rode all of its rounds
        out.rounds = self.rounds
        out.phase_walls = {k: w * share for k, w in self.phase_walls.items()}
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
        self.reject_counts.update(
            (name, 0) for name in EXPORT_FAIL_NAMES.values())
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
        #: lockstep rounds, and the lockstep engine's phase walls
        self.n_rounds = 0
        self.phase_walls = dict.fromkeys(LOCKSTEP_PHASES, 0.0)

    def add(self, st: DispatchStats) -> None:
        with self._lock:
            self.n_rounds += st.rounds
            for name, wall in st.phase_walls.items():
                self.phase_walls[name] += wall
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


def lockstep_columns(lcap: int, banded: bool) -> int:
    """DP columns of the lockstep engine's widest round at layer cap
    ``lcap``: the band of that bucket, or the whole row."""
    return pl.columns(lcap, poa_band_cols(lcap, banded))


class CudaPoaBatchEngine:
    """Batched POA over megabatches on ``device``: the whole-window
    kernel for a batch that ``fits`` it, else the lockstep engine.  Caps
    mirror the CUDA batch limits (max sequences per POA = 200,
    src/cuda/cudapolisher.cpp:229)."""

    #: the lockstep kernel's ring of score rows (the JAX engine's): an
    #: in-edge reaching further back rejects the window
    KCAP = 128

    def __init__(self, match: int, mismatch: int, gap: int, *, device,
                 vcap: int = 2048, pcap: int = 16, lcap: int = 1024,
                 max_depth: int = 200, banded: bool = False,
                 lockstep_only: bool = False):
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.device = torch.device(device)
        self.vcap, self.pcap, self.lcap = vcap, pcap, lcap
        self.max_depth = max_depth
        self.banded = banded
        self.lockstep_only = lockstep_only
        self.wb = pf.band_width(lcap, banded)

    def depth_cap(self, windows) -> int:
        """D1 bound of a batch from raw layer counts (an upper bound
        on what the packing keeps)."""
        depth = max((min(len(w.sequences) - 1, self.max_depth)
                     for w in windows), default=0)
        return max(8, pow2_at_least(depth + 1, 8))

    def fits_depth(self, d1: int) -> bool:
        """True when the whole-window kernel takes a batch of depth cap
        ``d1``; else ``consensus_batch_async`` runs the lockstep engine
        at dispatch (a pipelining caller drains first and keeps that
        wall out of the full kernel's rate).  ``lockstep_only`` sends
        every batch to the lockstep engine (the polisher sets it under
        RACON_TPU_TORCH_PORTABLE=1, the JAX package's
        RACON_TPU_NO_PALLAS=1, racon_tpu/tpu/poa_pallas.py:available)."""
        if self.lockstep_only:
            return False
        return pf.fits(self.vcap, self.lcap, d1, self.pcap, self.pcap, 8,
                       self.wb)

    def fits(self, windows) -> bool:
        """``fits_depth`` at this batch's depth cap."""
        return self.fits_depth(self.depth_cap(windows))

    def lockstep_window_bytes(self) -> int:
        """Device bytes one window holds in a lockstep round at the caps'
        worst shape: the direction tape (vcap x the round's columns),
        the kernel's ring (2 KCAP rows of those columns, float32), the
        round's inputs and the two int32 tapes."""
        v, l = self.vcap, self.lcap
        cols = lockstep_columns(l, self.banded)
        return (v * cols + 4 * 2 * self.KCAP * cols + v * (2 + 2 * self.pcap)
                + l + 8 + 8 * (v + l))

    def consensus_batch(self, windows, trim: bool) -> List[Result]:
        return self.consensus_batch_async(windows, trim)()

    def consensus_batch_async(self, windows, trim: bool, util=None,
                              pool=None):
        """Launch a batch and return a zero-argument collect closure
        giving one (consensus, polished) pair per window; consensus is
        None for a window the kernel rejected.  The launches' intervals
        go to ``util`` (default ``obs.DEVICE_UTIL``).  The closure's
        ``kernel_ms()`` and ``device_s()`` are this dispatch's alone,
        and calling it sets ``collect.stats`` (:class:`DispatchStats`).
        A batch the whole-window kernel does not take runs the lockstep
        engine now, its per-window host calls over ``pool``."""
        if not self.fits(windows):
            results, st = self.lockstep_batch(windows, trim, util=util,
                                              pool=pool)

            def collect_lockstep():
                collect_lockstep.stats = st
                return results

            collect_lockstep.kernel_ms = lambda: st.kernel_ms
            collect_lockstep.device_s = lambda: st.device_s
            return collect_lockstep
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
        caps = dict(v=self.vcap, lp=self.lcap, wb=self.wb, p=self.pcap,
                    s=self.pcap, a=8)
        bufs = pf.poa_full_buffers(int(pk.seqs.shape[0]), **caps,
                                   device=self.device)
        timer = DispatchTimer(self.device, util)
        timer.mark()
        cons, mout = pf.poa_full(
            *args, **caps, match=self.match, mismatch=self.mismatch,
            gap=self.gap, wtype=windows[0].type.value,
            trim=1 if trim else 0, stats=stats, timer=timer, bufs=bufs)
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

    # -- the lockstep engine (racon_tpu/tpu/poa.py:684-858) ------------

    def _order_layers(self, w) -> List[int]:
        """The layers a window incorporates, by start position: those no
        longer than lcap, at most max_depth."""
        idx = sorted(range(1, len(w.sequences)),
                     key=lambda i: w.positions[i][0])
        return [i for i in idx
                if len(w.sequences[i]) <= self.lcap][:self.max_depth]

    def lockstep_batch(self, windows, trim: bool, util=None, pool=None
                       ) -> Tuple[List[Result], DispatchStats]:
        """The lockstep engine on a batch, whatever its caps: (one
        (consensus, polished) pair per window, its DispatchStats).  A
        window the export rejects comes back as None."""
        nb = pl._NativeBatch(len(windows))
        try:
            return self._run(nb, windows, trim, util, pool)
        finally:
            nb.close()

    def _run(self, nb, windows, trim, util, pool):
        lib, handle = nb.lib, nb.handle
        n = len(windows)
        st = DispatchStats(n)
        walls = st.phase_walls
        layer_lists = [self._order_layers(w) for w in windows]
        for i, w in enumerate(windows):
            st.skipped[i] = len(w.sequences) - 1 - len(layer_lists[i])

        def seed(i):
            w = windows[i]
            backbone = w.sequences[0]
            qual = w.qualities[0]
            lib.rt_poab_seed(handle, i, backbone, len(backbone),
                             qual if qual else b"\x00" * len(backbone),
                             1 if qual else 0)

        _map(pool, seed, range(n))

        failed = [False] * n
        max_rounds = max((len(ll) for ll in layer_lists), default=0)
        v, l, p = self.vcap, self.lcap, self.pcap
        bases = np.zeros((n, v), dtype=np.uint8)
        preds = np.full((n, v, p), -1, dtype=np.int16)
        sinks = np.zeros((n, v), dtype=np.uint8)
        rank2node = np.zeros((n, v), dtype=np.int32)
        nrows = np.zeros(n, dtype=np.int32)
        seq_arr = np.zeros((n, l), dtype=np.uint8)
        slen = np.zeros(n, dtype=np.int32)

        for d in range(max_rounds):
            active = [i for i in range(n)
                      if not failed[i] and d < len(layer_lists[i])]
            if not active:
                break
            nrows[:] = 0
            slen[:] = 0

            def export(i):
                w = windows[i]
                li = layer_lists[i][d]
                begin, end = w.positions[li]
                blen = len(w.sequences[0])
                offset = int(0.01 * blen)
                full = begin < offset and end > blen - offset
                rows = lib.rt_poab_export(
                    handle, i, begin, end, 1 if full else 0, v, p,
                    self.KCAP, bases[i], preds[i].reshape(-1),
                    sinks[i], rank2node[i])
                if rows < 0:
                    failed[i] = True
                    st.fails[i] = EXPORT_FAIL_NAMES[rows]
                    DECISIONS.record("poa_reject", code=int(rows),
                                     phase="export")
                    return
                nrows[i] = rows
                s = w.sequences[li]
                seq_arr[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
                slen[i] = len(s)

            t0 = _now()
            _map(pool, export, active)
            walls["export"] += _now() - t0
            active = [i for i in active if not failed[i]]
            if not active:
                continue

            t0 = _now()
            node_tape, seq_tape = self._dispatch(
                bases, preds, nrows, sinks, seq_arr, slen, util, st)
            walls["dispatch"] += _now() - t0
            st.rounds += 1

            def apply(i):
                w = windows[i]
                li = layer_lists[i][d]
                nt, stp = node_tape[i], seq_tape[i]
                done = nt == pl.PATH_DONE
                k = int(np.argmax(done)) if done.any() else nt.shape[0]
                # reversed tape -> forward path; ranks -> node ids
                pn = nt[:k][::-1].astype(np.int32)
                ps = np.ascontiguousarray(stp[:k][::-1].astype(np.int32))
                pn = np.ascontiguousarray(np.where(
                    pn >= 0, rank2node[i][np.clip(pn, 0, None)],
                    pl.PATH_NONE).astype(np.int32))
                s = w.sequences[li]
                q = w.qualities[li]
                lib.rt_poab_apply(
                    handle, i, pn, ps, len(pn), s, len(s),
                    q if q else b"\x00" * len(s), 1 if q else 0,
                    int(w.positions[li][0]))

            t0 = _now()
            _map(pool, apply, active)
            walls["apply"] += _now() - t0

        results: List[Result] = [None] * n
        out_cap = 4 * self.lcap + 4096

        def extract(i):
            if failed[i]:
                results[i] = (None, False)
                return
            # the raw sequence count decides, as cudabatch.cpp:214-222:
            # layers skipped for length or depth only reduce coverage
            if len(windows[i].sequences) < 3:
                results[i] = (windows[i].sequences[0], False)
                return
            out = ctypes.create_string_buffer(out_cap)
            status = ctypes.c_int32(0)
            length = lib.rt_poab_consensus(
                handle, i, windows[i].type.value, 1 if trim else 0,
                out, out_cap, ctypes.byref(status))
            if length < 0:
                results[i] = (None, False)
                return
            if status.value == 2:
                windows[i].warn_chimeric()
            st.on_kernel[i] = True
            results[i] = (out.raw[:length], True)

        t0 = _now()
        _map(pool, extract, range(n))
        walls["extract"] += _now() - t0
        return results, st

    def round_shape(self, nrows, slen) -> Tuple[int, int, int]:
        """(v_b, l_b, wb) of a round: the ranks and the layer length
        bucketed to the round's maxima (at least 128, at most the caps)
        and the band of that layer bucket (0 = unbanded)."""
        v_b = min(pow2_at_least(int(nrows.max()), 128), self.vcap)
        l_b = min(pow2_at_least(int(slen.max()), 128), self.lcap)
        return v_b, l_b, poa_band_cols(l_b, self.banded)

    def _dispatch(self, bases, preds, nrows, sinks, seq_arr, slen, util,
                  st: DispatchStats):
        """One round's launch on every lane of the batch; returns the
        tapes as numpy arrays and adds its time and cells to ``st``."""
        v_b, l_b, wb = self.round_shape(nrows, slen)
        # the cells the kernel computes: each lane's own ranks (it stops
        # at nrows) x the round's columns
        st.cells += np.minimum(nrows, v_b).astype(np.int64) \
            * pl.columns(l_b, wb)
        dev = self.device
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (bases[:, :v_b], preds[:, :v_b], nrows,
                          sinks[:, :v_b], seq_arr[:, :l_b], slen)]
        # the launch's buffers (and its kernels loaded) before the first
        # mark: the event window holds the launch alone
        bufs = pl.lockstep_buffers(int(bases.shape[0]), v_b, l_b,
                                   self.KCAP, wb, dev)
        timer = DispatchTimer(dev, util)
        timer.mark()
        node_tape, seq_tape = pl.poa_round(
            *args, v=v_b, l=l_b, p=self.pcap, k=self.KCAP, wb=wb,
            match=self.match, mismatch=self.mismatch, gap=self.gap,
            timer=timer, bufs=bufs)
        if not timer.cuda:
            timer.mark()
        nt, stp = node_tape.cpu().numpy(), seq_tape.cpu().numpy()
        timer.record("device.poa", "poa",
                     {"n": int(bases.shape[0]), "v": v_b, "l": l_b,
                      "wb": wb})
        st.kernel_ms += timer.kernel_ms()
        st.device_s += timer.device_s()
        return nt, stp


def _map(pool, fn, items):
    if pool is None:
        for it in items:
            fn(it)
    else:
        list(pool.map(fn, items))
