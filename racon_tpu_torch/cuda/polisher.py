"""CudaPolisher: overlap alignment and POA on the card (reference:
src/cuda/cudapolisher.cpp; JAX package: racon_tpu/tpu/polisher.py:
TPUPolisher).

Alignment (``cuda_aligner_batches > 0``, racon-gpu's
--cudaaligner-batches): every overlap without a CIGAR whose spans are
non-empty and at most 16,384 bases goes to the device ladder of the JAX
package (``_pallas_align``), cheapest engine first: WFA rungs (e-step
caps 512/1024/2048), then banded rungs (2048/4096/8192) whose retries
follow measured centers.  A certified pair hands its alignment over as
``cigar_runs``; whatever the ladder leaves (over-length pairs, the few
probe pairs, final-rung failures) is aligned by the native CPU engine
in the base class's pass (cudapolisher.cpp:212-216).  Every eligible
pair goes to the device first: the JAX package's rate-model split and
concurrent CPU tail workers are not ported, which is its own behaviour
under RACON_TPU_ALIGN_DEVICE_ONLY=1; the run logs this as a policy line.

POA (``cuda_poa_batches > 0``, --cudapoa-batches): every window with at
least 3 sequences goes to the whole-window POA kernel in megabatches,
two in flight (megabatch k+1 is packed and launched before k is
collected).  A window the kernel rejects is re-polished by the native
CPU engine, racon-gpu's own contract (cudabatch.cpp:124-155 ->
cudapolisher.cpp:357-386); rejections are counted by fail code in
``poa_reject_counts``.  With ``cuda_poa_batches == 0`` the POA stage
runs on the CPU engine.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List

import torch

from racon_tpu_torch import resolve_device
from racon_tpu_torch.core.overlap import Overlap
from racon_tpu_torch.core.polisher import Polisher
from racon_tpu_torch.cuda import align
from racon_tpu_torch.cuda import align_band as ab
from racon_tpu_torch.cuda import align_wfa as aw
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.utils.tuning import pow2_at_least

_LOG = "[racon_tpu_torch::CudaPolisher::align]"


class CudaPolisher(Polisher):
    # depth cap per window (src/cuda/cudapolisher.cpp:229)
    MAX_DEPTH_PER_WINDOW = 200
    # windows per launch are capped: a batch far past the card's
    # resident blocks only delays the first collect
    MAX_BATCH = 4096
    CPU_BATCH = 64
    # longest span the align kernels take; longer pairs go to the CPU
    # (cudaaligner.cpp:64-72)
    MAX_ALIGN_DIM = 16384
    MAX_ALIGNMENTS_PER_BATCH = 1024
    # pairs per plain-version call on the CPU (its arrays grow with the
    # batch)
    CPU_ALIGN_BATCH = 64
    # the ladder's rungs: WFA e-step caps, then band widths
    WFA_RUNGS = (512, 1024, 2048)
    BAND_RUNGS = (2048, 4096, 8192)

    def __init__(self, *args, cuda_poa_batches: int = 0,
                 cuda_banded_alignment: bool = False,
                 cuda_aligner_batches: int = 0, device=None):
        super().__init__(*args)
        self.cuda_poa_batches = cuda_poa_batches
        self.cuda_banded_alignment = cuda_banded_alignment
        self.cuda_aligner_batches = cuda_aligner_batches
        self.device = resolve_device(device)
        self.poa_engine = None
        self.poa_reject_counts = {}
        self.poa_eligible_windows = 0
        self.poa_batch_size = 0
        # align ladder counters
        self.align_probe_ratio = 1 / 3      # p75 of the probe
        self.align_probe_p50 = 1 / 5
        self.align_eligible = 0             # pairs the ladder may take
        self.align_probed = 0               # of those, probed on the CPU
        self.align_over_length = 0          # > MAX_ALIGN_DIM: CPU
        self.align_cpu_fallthrough = 0      # left by the ladder: CPU
        #: per rung ("wfa512", "band2048", ...): admitted, certified,
        #: retried (passed to a later rung or to the CPU)
        self.align_rungs = {}
        #: per kernel: dispatches and their CUDA-event milliseconds
        self.align_dispatches = {"align_wfa": 0, "align_band": 0}
        self.align_kernel_ms = {"align_wfa": 0.0, "align_band": 0.0}
        #: per kernel: DP cells its dispatches computed, (min(d, emax)
        #: + 1)^2 per WFA pair and query rows x band per band pair
        self.align_cells = {"align_wfa": 0, "align_band": 0}
        #: per kernel: summed clock64() cycles per phase (meta[:, 2:4]):
        #: wavefront steps or DP rows, then traceback
        self.align_cycles = {"align_wfa": [0, 0], "align_band": [0, 0]}

    def _poa_caps(self):
        """Power-of-two graph/layer caps scaled from the window length:
        4x for graph nodes (30x windows need ~2.5-3x), 2x for layers."""
        w = self.window_length
        return pow2_at_least(4 * w, 512), pow2_at_least(2 * w, 512)

    def _poa_batch_size(self, vcap: int, lcap: int, d1: int) -> int:
        """Windows per launch from free device memory split across the
        batches, cudapoa's 0.9 * free / batches
        (src/cuda/cudapolisher.cpp:231-242), two launches in flight.
        Each launch holds one scratch slice per block of its largest
        pass grid (``pf.pass_grids``), whatever its window count, and
        per window its packed inputs and outputs."""
        if self.device.type != "cuda":
            return self.CPU_BATCH
        free, _ = torch.cuda.mem_get_info(self.device)
        wb = pf.band_width(lcap, self.cuda_banded_alignment)
        slots = max(g for *_, g in pf.pass_grids(
            self.device, self.MAX_BATCH, vcap, lcap, wb))
        scratch = 4 * slots * pf.scratch_words(vcap, lcap, wb, 16, 16, 8)
        per_window = 2 * d1 * lcap + 32 * d1 + 4 * vcap + 64
        budget = 0.9 * free / self.cuda_poa_batches / 2 - scratch
        return max(1, min(self.MAX_BATCH, int(budget // per_window)))

    def generate_consensuses(self) -> List[bool]:
        if self.cuda_poa_batches <= 0:
            return super().generate_consensuses()
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

    # ------------------------------------------------------------------
    # overlap alignment (racon_tpu/tpu/polisher.py:1203-1905)
    # ------------------------------------------------------------------

    def find_overlap_breaking_points(self, overlaps: List[Overlap]) -> None:
        """The device ladder first, then the base class's pass, which
        decodes breaking points and CPU-aligns whatever is left."""
        if self.cuda_aligner_batches > 0:
            t0 = time.perf_counter()
            self._device_align_overlaps(overlaps)
            self._wall("device_align", t0)
        super().find_overlap_breaking_points(overlaps)

    def _device_align_overlaps(self, overlaps: List[Overlap]) -> None:
        pending = []  # (dim, overlap), dim = max span side
        for o in overlaps:
            if o.cigar or o.cigar_runs is not None \
                    or o.breaking_points is not None:
                continue
            lq = o.q_end - o.q_begin
            lt = o.t_end - o.t_begin
            if max(lq, lt) > self.MAX_ALIGN_DIM:
                self.align_over_length += 1
                continue
            if min(lq, lt) == 0:
                continue
            pending.append((max(lq, lt), o))
        self.align_eligible = len(pending)
        self.logger.log(
            f"{_LOG} policy: all {len(pending)} eligible overlap(s) go to "
            f"the device ladder first (no device/CPU split); "
            f"{self.align_over_length} over {self.MAX_ALIGN_DIM} bases "
            "stay on the CPU")
        if not pending:
            return
        pending.sort(key=lambda x: -x[0])
        self._probe_divergence(pending)
        self._align_ladder([o for _, o in pending])
        if self.device.type == "cuda":
            # hand the ladder's cached scratch back, so the POA stage
            # sizes its megabatches from the card's real free memory
            torch.cuda.empty_cache()

    def _probe_divergence(self, pending) -> None:
        """CPU-align a deterministic spread of 9 pending pairs; their p50
        and p75 of edit distance / dimension price the rungs.  Probed
        pairs keep their breaking points and leave ``pending``."""
        n = len(pending)
        if n < 4:
            return
        idxs = sorted({min(n - 1, int(q * n))
                       for q in (0.1, 0.2, 0.3, 0.4, 0.5,
                                 0.6, 0.7, 0.8, 0.9)})

        def one(i):
            d, o = pending[i]
            o.cigar, dist = cpu.align_with_distance(
                o.query_span(self.sequences), o.target_span(self.sequences))
            o.find_breaking_points(self.sequences, self.window_length,
                                   aligner=cpu.align)
            return dist / max(d, 1)

        ratios = sorted(self._pool.map(one, idxs))
        for i in reversed(idxs):
            del pending[i]
        self.align_probed = len(idxs)
        self.align_probe_p50 = ratios[(len(ratios) - 1) // 2]
        self.align_probe_ratio = min(max(
            ratios[int(0.75 * (len(ratios) - 1))], 0.05), 0.67)

    @staticmethod
    def _wfa_need(o: Overlap, ratio: float) -> int:
        """Estimated edit distance of one overlap at divergence
        ``ratio``: the WFA rung admission estimate."""
        lq = o.q_end - o.q_begin
        lt = o.t_end - o.t_begin
        return abs(lq - lt) + int(max(lq, lt) * ratio)

    def _chunk_pairs(self, per_pair: int) -> int:
        """Pairs per dispatch: 0.9 x free device memory over two chunks
        in flight (cudapoa's rule, as for the POA megabatches), capped
        at MAX_ALIGNMENTS_PER_BATCH; CPU_ALIGN_BATCH on the CPU."""
        if self.device.type != "cuda":
            return self.CPU_ALIGN_BATCH
        free, _ = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) \
            - torch.cuda.memory_allocated(self.device)
        return max(8, min(self.MAX_ALIGNMENTS_PER_BATCH,
                          int(0.9 * free / 2 // per_pair)))

    def _run_rung(self, name: str, idx, per_pair: int, dispatch,
                  accept) -> set:
        """Dispatch ``idx`` in chunks, two in flight; ``accept(i, k,
        results)`` decides and records each pair.  Returns the pairs
        not certified."""
        size = self._chunk_pairs(per_pair)
        chunks = [idx[c:c + size] for c in range(0, len(idx), size)]
        kernel = "align_wfa" if name.startswith("wfa") else "align_band"
        still = set()

        def consume(sub, collect):
            res = collect()
            self.align_kernel_ms[kernel] += collect.kernel_ms()
            for k, c in enumerate(getattr(collect, "phase_cycles", ())):
                self.align_cycles[kernel][k] += c
            for k, i in enumerate(sub):
                if not accept(i, k, res):
                    still.add(i)

        self.align_dispatches[kernel] += len(chunks)
        align.run_pipelined(chunks, dispatch, consume)
        self.align_rungs[name] = {"admitted": len(idx),
                                  "certified": len(idx) - len(still),
                                  "retried": len(still)}
        return still

    def _align_ladder(self, overlaps: List[Overlap]) -> None:
        """Device alignment ladder (racon_tpu/tpu/polisher.py:
        _pallas_align): WFA rungs, then banded rungs with measured-center
        retries; survivors keep no CIGAR and take the CPU pass."""
        queries = [o.query_span(self.sequences) for o in overlaps]
        targets = [o.target_span(self.sequences) for o in overlaps]
        dim = max(max(len(s) for s in queries),
                  max(len(s) for s in targets))
        bd = min((dim + 127) // 128 * 128, self.MAX_ALIGN_DIM)
        ratio = min(max(self.align_probe_p50, 0.05), 0.67)
        ratio75 = min(max(self.align_probe_ratio, 0.05), 0.67)
        n = len(overlaps)
        dabs = [abs(len(queries[i]) - len(targets[i])) for i in range(n)]
        # banded cost estimate (median divergence) and the measured-center
        # admission estimate (cost only: the center absorbs the drift)
        needc = [int(max(len(queries[i]), len(targets[i])) * ratio)
                 for i in range(n)]
        need = [max(dabs[i], needc[i]) for i in range(n)]
        # WFA admission at p75: a pair past its rung wastes a pass
        wfa_need = [self._wfa_need(o, ratio75) for o in overlaps]
        pending = list(range(n))
        rungs = list(self.WFA_RUNGS)
        groups = {}
        for i in pending:
            for e in rungs:
                if wfa_need[i] <= e - 32:
                    groups.setdefault(e, []).append(i)
                    break
        # a group under 16 pairs rides the next rung up
        for e in rungs[:-1]:
            if 0 < len(groups.get(e, ())) < 16:
                nxt = rungs[rungs.index(e) + 1]
                groups.setdefault(nxt, [])[:0] = groups.pop(e)
        use_emp = set()             # pairs on measured-center retry
        knots = {}

        def emp_knots(i):
            if i not in knots:
                knots[i] = ab.estimate_center_knots(queries[i], targets[i],
                                                    bd)
            return knots[i]

        def sub_pairs(sub):
            return [queries[i] for i in sub], [targets[i] for i in sub]

        for emax in sorted(groups):
            idx = groups[emax]

            def accept_wfa(i, k, res, emax=emax):
                tapes, nents, dists = res
                d = int(dists[k])
                self.align_cells["align_wfa"] += (min(d, emax) + 1) ** 2
                if d > emax:
                    return False
                overlaps[i].cigar_runs = al.ops_to_runs(
                    aw.wfa_tape_to_ops(tapes[k], int(nents[k])))
                return True

            still = self._run_rung(
                f"wfa{emax}", idx, aw.wfa_per_pair_bytes(bd, emax),
                lambda sub, emax=emax: align.wfa_dispatch(
                    *sub_pairs(sub), bd, emax, self.device), accept_wfa)
            idx_set = set(idx)
            pending = [i for i in pending if i in still or i not in idx_set]
            use_emp.update(still)       # WFA rejects retry on measured centers
            self.logger.log(f"{_LOG} wfa-aligned {len(idx) - len(still)}/"
                            f"{len(idx)} overlaps (emax {emax}"
                            + (f", {len(still)} to band" if still else "")
                            + ")")

        last = self.BAND_RUNGS[-1]
        for wb in self.BAND_RUNGS:
            if not pending:
                break
            # admission: the Ukkonen certificate bound for proportional
            # pairs; cost only for measured-center pairs; the last rung
            # still skips pairs that provably cannot certify
            idx = [i for i in pending
                   if need[i] + dabs[i] <= wb - 512
                   or (i in use_emp and needc[i] <= wb - 512)
                   or (wb == last and 2 * dabs[i] <= wb - 512)]
            if not idx or (len(idx) < 16 and wb != last):
                continue

            def accept_band(i, k, res, wb=wb):
                moves, lens, dists = res
                self.align_cells["align_band"] += len(queries[i]) * wb
                if i in use_emp:
                    ok = int(dists[k]) < ab.BIG and ab.path_center_margin(
                        moves[k], int(lens[k]), knots[i], wb) >= 256
                else:
                    ok = int(dists[k]) + dabs[i] <= wb - 512
                if ok:
                    overlaps[i].cigar_runs = al.ops_to_runs(ab.moves_to_ops(
                        moves[k], int(lens[k]), queries[i], targets[i]))
                return ok

            still = self._run_rung(
                f"band{wb}", idx, ab.band_per_pair_bytes(bd, bd, wb),
                lambda sub, wb=wb: align.band_dispatch(
                    *sub_pairs(sub), bd, bd, wb, self.device,
                    centers=[emp_knots(i) if i in use_emp else None
                             for i in sub]), accept_band)
            idx_set = set(idx)
            pending = [i for i in pending if i in still or i not in idx_set]
            use_emp.update(still)       # a failure retries on measured centers
            tag = (f", {len(still)} " + ("retries" if wb != last else "cpu")
                   if still else "")
            self.logger.log(f"{_LOG} device-aligned {len(idx) - len(still)}"
                            f"/{len(idx)} overlaps (band {wb}{tag})")
        # survivors keep no CIGAR and take the CPU pass (the reference's
        # exceeded_max_alignment_difference skip)
        self.align_cpu_fallthrough = len(pending)
