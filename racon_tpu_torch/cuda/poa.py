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
``poa`` interval of the engine's ``util`` (default
``obs.DEVICE_UTIL``; ``cuda/devclock.py``);
``device_s`` sums their lengths.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

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


class CudaPoaBatchEngine:
    """Whole-window POA over megabatches on ``device``.  Caps mirror
    the CUDA batch limits (max sequences per POA = 200,
    src/cuda/cudapolisher.cpp:229)."""

    def __init__(self, match: int, mismatch: int, gap: int, *, device,
                 vcap: int = 2048, pcap: int = 16, lcap: int = 1024,
                 max_depth: int = 200, banded: bool = False,
                 util=None):
        self.match, self.mismatch, self.gap = match, mismatch, gap
        #: where the launches' device intervals go (``DispatchTimer``)
        self.util = util
        self.device = torch.device(device)
        self.vcap, self.pcap, self.lcap = vcap, pcap, lcap
        self.max_depth = max_depth
        self.wb = pf.band_width(lcap, banded)
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
        self._lock = threading.Lock()

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

    def consensus_batch_async(self, windows, trim: bool):
        """Launch a batch and return a zero-argument collect closure
        giving one (consensus, polished) pair per window; consensus is
        None for a window the kernel rejected."""
        out: List[Result] = [None] * len(windows)
        groups = {}
        for i, w in enumerate(windows):
            if len(w.sequences) < 3:
                out[i] = (w.sequences[0], False)
            else:
                # the window type selects the trim; one launch per type
                groups.setdefault(w.type.value, []).append(i)
        collects = [(idxs, self._launch([windows[i] for i in idxs], trim))
                    for _, idxs in sorted(groups.items())]

        def collect():
            for idxs, coll in collects:
                for i, r in zip(idxs, coll()):
                    out[i] = r
            return out

        return collect

    def _launch(self, windows, trim: bool):
        pk = convert.pack_windows(windows, self.lcap, self.vcap,
                                  self.max_depth)
        args = convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                                 pk.bblen, self.device)
        stats = torch.zeros((pk.seqs.shape[0], 3), dtype=torch.int32,
                            device=self.device)
        timer = DispatchTimer(self.device, self.util)
        timer.mark()
        cons, mout = pf.poa_full(
            *args, v=self.vcap, lp=self.lcap, wb=self.wb,
            match=self.match, mismatch=self.mismatch, gap=self.gap,
            wtype=windows[0].type.value, trim=1 if trim else 0,
            p=self.pcap, s=self.pcap, a=8, stats=stats,
            timer=timer)
        if not timer.cuda:
            timer.mark()
        with self._lock:
            self.n_skipped_layers += pk.n_skipped

        def collect() -> List[Result]:
            n = len(windows)
            mo = mout[:n].cpu().numpy()
            rows = int(stats[:n, :2].sum())
            cs = cons[:n].cpu().numpy()
            timer.record("device.poa", "poa", {"n": n})
            results: List[Result] = []
            with self._lock:
                self.kernel_ms += timer.kernel_ms()
                self.device_s += timer.device_s()
                self.cells += int(mo[:, 4].sum()) * self.wb
                self.pred_rows += rows
                for k, name in enumerate(PHASES):
                    self.phase_cycles[name] += int(mo[:, 5 + k].sum())
                for b, w in enumerate(windows):
                    length = int(mo[b, 0])
                    if pk.host_fail[b] or length < 0:
                        code = pf.FAIL_VCAP if pk.host_fail[b] \
                            else int(mo[b, 2])
                        self.reject_counts[FAIL_NAMES[code]] += 1
                        DECISIONS.record("poa_reject", code=FAIL_NAMES[code],
                                         phase="extract")
                        results.append((None, False))
                        continue
                    if int(mo[b, 1]) == 2:
                        w.warn_chimeric()
                    self.windows_on_kernel += 1
                    results.append(
                        (cs[b, :length].astype("uint8").tobytes(), True))
            return results

        return collect
