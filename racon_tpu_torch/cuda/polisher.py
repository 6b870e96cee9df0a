"""CudaPolisher: the POA stage on the card (reference:
src/cuda/cudapolisher.cpp:219-421; JAX package:
racon_tpu/tpu/polisher.py:TPUPolisher).

Every window with at least 3 sequences goes to the whole-window POA
kernel in megabatches, two in flight (megabatch k+1 is packed and
launched before k is collected).  A window the kernel rejects is
re-polished by the native CPU engine, racon-gpu's own contract
(cudabatch.cpp:124-155 -> cudapolisher.cpp:357-386); rejections are
counted by fail code in ``poa_reject_counts``.  Overlap alignment stays
on the CPU aligner in this configuration, as with racon-gpu's
--cudapoa-batches without --cudaaligner-batches.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List

import torch

from racon_tpu_torch import resolve_device
from racon_tpu_torch.core.polisher import Polisher
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine
from racon_tpu_torch.utils.tuning import pow2_at_least


class CudaPolisher(Polisher):
    # depth cap per window (src/cuda/cudapolisher.cpp:229)
    MAX_DEPTH_PER_WINDOW = 200
    # windows per launch are capped: a batch far past the card's
    # resident blocks only delays the first collect
    MAX_BATCH = 4096
    CPU_BATCH = 64

    def __init__(self, *args, cuda_poa_batches: int = 1,
                 cuda_banded_alignment: bool = False, device=None):
        super().__init__(*args)
        self.cuda_poa_batches = max(1, cuda_poa_batches)
        self.cuda_banded_alignment = cuda_banded_alignment
        self.device = resolve_device(device)
        self.poa_engine = None
        self.poa_reject_counts = {}
        self.poa_eligible_windows = 0
        self.poa_batch_size = 0

    def _poa_caps(self):
        """Power-of-two graph/layer caps scaled from the window length:
        4x for graph nodes (30x windows need ~2.5-3x), 2x for layers."""
        w = self.window_length
        return pow2_at_least(4 * w, 512), pow2_at_least(2 * w, 512)

    def _poa_batch_size(self, vcap: int, lcap: int, d1: int) -> int:
        """Windows per launch from free device memory split across the
        batches, cudapoa's 0.9 * free / batches
        (src/cuda/cudapolisher.cpp:231-242), two launches in flight."""
        if self.device.type != "cuda":
            return self.CPU_BATCH
        free, _ = torch.cuda.mem_get_info(self.device)
        wb = pf.band_width(lcap, self.cuda_banded_alignment)
        per_window = 4 * pf.scratch_words(vcap, lcap, wb, 16, 16, 8) \
            + 2 * d1 * lcap + 32 * d1 + 4 * vcap + 64
        budget = 0.9 * free / self.cuda_poa_batches / 2
        return max(1, min(self.MAX_BATCH, int(budget // per_window)))

    def generate_consensuses(self) -> List[bool]:
        vcap, lcap = self._poa_caps()
        engine = CudaPoaBatchEngine(
            self.match, self.mismatch, self.gap, device=self.device,
            vcap=vcap, pcap=16, lcap=lcap,
            max_depth=self.MAX_DEPTH_PER_WINDOW,
            banded=self.cuda_banded_alignment)
        self.poa_engine = engine
        flags = [False] * len(self.windows)
        for w in self.windows:
            if len(w.sequences) < 3:
                w.consensus = w.sequences[0]
        # deepest windows first, so every megabatch has a narrow depth
        # range (the packing pads to the deepest window)
        eligible = sorted((i for i, w in enumerate(self.windows)
                           if len(w.sequences) >= 3),
                          key=lambda i: -len(self.windows[i].sequences))
        self.poa_eligible_windows = len(eligible)
        failed: List[int] = []
        if eligible:
            batch = [self.windows[i] for i in eligible]
            if not engine.fits(batch):
                raise RuntimeError(
                    f"[racon_tpu_torch::CudaPolisher] window caps "
                    f"v={vcap} lp={lcap} do not fit the POA kernel")
            size = self._poa_batch_size(vcap, lcap, engine.depth_cap(batch))
            self.poa_batch_size = size
            pipe = deque()

            def apply(idxs, collect):
                for i, (cons, ok) in zip(idxs, collect()):
                    if cons is None:
                        failed.append(i)
                    else:
                        self.windows[i].consensus = cons
                        flags[i] = ok
                self.logger.bar("[racon_tpu_torch::CudaPolisher::polish] "
                                "generating consensus (device)")

            for k in range(0, len(eligible), size):
                idxs = eligible[k:k + size]
                pipe.append((idxs, engine.consensus_batch_async(
                    [self.windows[i] for i in idxs], self.trim)))
                while len(pipe) >= 2:
                    apply(*pipe.popleft())
            while pipe:
                apply(*pipe.popleft())
        if failed:
            rc = engine.reject_counts
            self.logger.log(
                f"[racon_tpu_torch::CudaPolisher::polish] {len(failed)} "
                "window(s) fell back to the CPU engine (" + ", ".join(
                    f"{k} {v}" for k, v in rc.items() if v) + ")")
            t0 = time.perf_counter()
            cpu_flags = list(self._pool.map(
                lambda i: self.windows[i].generate_consensus(
                    self.engine, self.trim), failed))
            for i, f in zip(failed, cpu_flags):
                flags[i] = f
            self._wall("cpu_repolish", t0)
        if engine.n_skipped_layers:
            self.logger.log(
                f"[racon_tpu_torch::CudaPolisher::polish] skipped "
                f"{engine.n_skipped_layers} over-long layer(s)")
        self.poa_reject_counts = dict(engine.reject_counts)
        return flags
