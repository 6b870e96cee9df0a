"""CudaPolisher: overlap alignment and POA on the card (reference:
src/cuda/cudapolisher.cpp; JAX package: racon_tpu/tpu/polisher.py:
TPUPolisher).

Alignment (``cuda_aligner_batches > 0``, racon-gpu's
--cudaaligner-batches): overlaps without a CIGAR whose spans are
non-empty and at most ``max_align_dim`` bases (16,384 unless
RACON_TPU_TORCH_MAX_ALIGN_DIM says otherwise; a pair past the WFA
kernel's 16,384 rows takes only the band rungs) are sorted longest
first and split
between the card and the CPU (``_hybrid_align``): the device ladder of
the JAX package (``_pallas_align``) takes a prefix, cheapest engine
first -- WFA rungs (e-step caps 512/1024/2048), then banded rungs
(2048/4096/8192) whose retries follow measured centers -- while
``num_threads - 1`` CPU workers align the tail on the native engine at
the same time.  The cut is the deterministic rate-model argmin
``_rate_split`` at the measured rates of ``utils/calibrate.py``, so the
assignment (and the output bytes) is a pure function of the input and
the rates.  A certified pair hands its alignment over as
``cigar_runs``.  The over-length pairs are aligned by the native CPU
engine on those workers beside the ladder (device-only: in the base
class's pass after it, cudapolisher.cpp:212-216); the few probe pairs
and final-rung failures take that pass too.

POA (``cuda_poa_batches > 0``, --cudapoa-batches): windows with at
least 3 sequences are sorted deepest first and split the same way: the
device prefix goes to the whole-window POA kernel in megabatches, two
in flight, while CPU workers run the native engine on the tail.  A
window the kernel rejects is re-polished by the native CPU engine,
racon-gpu's own contract (cudabatch.cpp:124-155 ->
cudapolisher.cpp:357-386); rejections are counted by fail code in
``poa_reject_counts``.  With ``cuda_poa_batches == 0`` the POA stage
runs on the CPU engine.

Mapping (no overlaps file): the mapper builds its seed words on this
polisher's device (``_map_device``): the seed-word kernel on a card,
its plain version with ``device="cpu"``;
``RACON_TPU_TORCH_MAP_DEVICE_SEED=0`` builds them with numpy.  The
words, and so the bytes, are the same everywhere.

Streaming (``RACON_TPU_TORCH_PIPELINE``, default on with -c): windows
are created before the align stage and a ``WindowLedger`` routes each
overlap's fragments as soon as its breaking points exist; a speculative
consumer thread runs POA megabatches of fully routed windows on the
card once the align stage's last device dispatch is done, while the
CPU still aligns.  Speculative results are adopted only for windows
the stage's split assigns to the device, so the bytes equal the staged
path's.  An error in the consumer is raised to the caller; it never
turns into a CPU re-polish.

Dispatch: every POA megabatch and align chunk goes through the
process-wide device executor (``cuda/executor.py``), as the JAX
package's TPUPolisher does: the result cache serves windows and pairs
it already holds, and with two or more registered tenants in one
process (``_executor_tenant``) their launches fuse.  A one-shot run is
a passthrough.  A batch or chunk with any cache hit feeds no rate and
no calhealth record.  The CPU engine's windows (the split's tail, the
kernel's rejects) go through ``Polisher._consensus_cached``.

Observability (the JAX package's counters and records,
racon_tpu/tpu/polisher.py:183-193): the run's counters are
``MetricAttr`` entries of the per-run registry ``metrics``; the ladder
counts rung admissions, retries and CPU fall-throughs there, with a
histogram of chunk device seconds per engine; every split, ladder chunk,
retry and fall-through is a decision record (``obs.DECISIONS``), and
every align chunk and POA megabatch folds its measured busy time against
the rate model's prediction into ``obs.calhealth``.  The two device
stages are ``device_span``s, and the run's per-engine device busy and
idle time (the polisher's own ``DeviceUtil``, ``device_util``, fed by
the dispatch wrappers from CUDA events) is published into ``metrics``
when the polish ends.

Durability (the serve tier's hooks, racon_tpu/tpu/polisher.py:268-285;
``serve/session.py`` wires them for a served job, a one-shot run leaves
them unset and its bytes unchanged): ``_checkpoint_cb`` is called with
``[(window, consensus or None, ok)]`` after each committed POA
megabatch (and once for the adopted speculative windows);
``_resume_windows`` holds the windows a dead daemon's journal committed,
adopted like speculative results (device-assigned windows only, the
split untouched; a ``None`` consensus takes the CPU re-polish its
launch took); ``_calib_pin`` is the job's admission-time calibration
snapshot, passed to every ``get_rates``.  The crash sites
``mid-megabatch`` and ``pre-demux`` (``obs/faultinject.py``) sit at the
same points of the staged loop and the speculative consumer.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List

import torch

from racon_tpu_torch import resolve_device
from racon_tpu_torch.core import overlap as overlap_mod
from racon_tpu_torch.core.overlap import Overlap
from racon_tpu_torch.core.polisher import Polisher
from racon_tpu_torch.core.window import WindowLedger
from racon_tpu_torch.cuda import align
from racon_tpu_torch.cuda import align_band as ab
from racon_tpu_torch.cuda import align_wfa as aw
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.cuda import devclock
from racon_tpu_torch.cuda import executor
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.obs import MetricAttr
from racon_tpu_torch.obs import calhealth as obs_calhealth
from racon_tpu_torch.obs import faultinject
from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.obs.decision import DECISIONS
from racon_tpu_torch.obs.devutil import DeviceUtil
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.utils import calibrate
from racon_tpu_torch.utils.tuning import pow2_at_least

_now = obs_trace.now
_LOG = "[racon_tpu_torch::CudaPolisher::align]"
_PLOG = "[racon_tpu_torch::CudaPolisher::polish]"


def _busy_s(kernel_ms: float, host_cpu_s: float) -> float:
    """Device time of one dispatch for its stage's rate: the larger of
    its kernels' CUDA-event time and the CPU time the issuing thread
    spent from the previous collect to this one (two dispatches are in
    flight, so the two overlap).  Thread CPU time leaves out the waits
    for the interpreter lock, so host work running beside the stage
    does not inflate the rate that prices the next split."""
    return max(kernel_ms / 1e3, host_cpu_s)


def _rate_split(dev_costs, cpu_costs, cpu_base: float = 0.0) -> int:
    """Deterministic rate-model boundary: the k minimizing max(device
    time of the first k items, ``cpu_base`` plus CPU time of the rest),
    a pure function of the input."""
    dev_pre = 0.0
    suf = cpu_base + sum(cpu_costs)
    best, cut = None, len(dev_costs)
    for k in range(len(dev_costs) + 1):
        if k:
            dev_pre += dev_costs[k - 1]
            suf -= cpu_costs[k - 1]
        t = max(dev_pre, suf)
        if best is None or t < best:
            best, cut = t, k
    return cut


def _split_cut(weights, share: float) -> int:
    """Deterministic boundary: the first index where the weight prefix
    reaches ``share`` of the total (the device owns [0, cut))."""
    total = sum(weights) or 1
    acc = 0
    for k, w in enumerate(weights):
        if acc >= share * total:
            return k
        acc += w
    return len(weights)


class CudaPolisher(Polisher):
    # depth cap per window (src/cuda/cudapolisher.cpp:229)
    MAX_DEPTH_PER_WINDOW = 200
    # windows per launch are capped: a batch far past the card's
    # resident blocks only delays the first collect
    MAX_BATCH = 4096
    CPU_BATCH = 64
    # longest span the align ladder takes by default; longer pairs go to
    # the CPU (cudaaligner.cpp:64-72); RACON_TPU_TORCH_MAX_ALIGN_DIM
    # sets another cap, and a pair past the WFA kernel's rows
    # (align_wfa.MAX_DIM) then takes only the band rungs
    MAX_ALIGN_DIM = 16384
    MAX_ALIGNMENTS_PER_BATCH = 1024
    # pairs per plain-version call on the CPU (its arrays grow with the
    # batch)
    CPU_ALIGN_BATCH = 64
    # the ladder's rungs: WFA e-step caps, then band widths
    WFA_RUNGS = (512, 1024, 2048)
    BAND_RUNGS = (2048, 4096, 8192)
    # the divergence probe (_probe_divergence): a target with n pending
    # pairs CPU-aligns min(PROBE_PAIRS, n // PROBE_EVERY) of them, and
    # one left with fewer than PROBE_MIN prices at the fixed priors
    PROBE_PAIRS = 9
    PROBE_EVERY = 32
    PROBE_MIN = 3
    # POA megabatches in flight, in the stage and in the speculative
    # consumer
    PIPE_DEPTH = 2
    # fewest ready windows a speculative megabatch takes
    PIPE_MIN = 32
    # windows per POA megabatch at most (0: the memory-sized
    # _poa_batch_size alone)
    MEGABATCH_CAP = 0

    # Split rates used until a run has stored measured ones
    # (utils/calibrate.py; RACON_TPU_TORCH_RATE_* pin them), busy time
    # per unit as the store keeps it, measured by chip_smoke.py on an
    # NVIDIA H100 80GB HBM3, 700.00 W, with 8 host CPUs (-t 8).  WFA
    # and band: the staged polish's ladder chunks, with no host work
    # beside them; CPU and POA: what polish_default's second run stored.
    DEV_NS_PER_ROW = 19.1          # band ladder, ns per query row
    CPU_NS_PER_CELL = 9.6356       # native aligner, ns per modeled cell
    WFA_DEV_NS_PER_STEP = 220.2    # WFA ladder, ns per wavefront step
    POA_DEV_US_PER_UNIT = 1.0769   # POA megabatches, us per cost unit
    POA_CPU_US_PER_UNIT = 941.2902     # native POA, us per cost unit

    # the run's counters, entries of the per-run registry
    align_cells = MetricAttr("align_cells")
    poa_cells = MetricAttr("poa_cells")
    poa_device_windows = MetricAttr("poa_device_windows")
    poa_eligible_windows = MetricAttr("poa_eligible_windows")
    poa_device_s = MetricAttr("poa_device_s")
    align_device_s = MetricAttr("align_device_s")
    align_wfa_device_s = MetricAttr("align_wfa_device_s")
    align_band_device_s = MetricAttr("align_band_device_s")
    pipeline_overlap_s = MetricAttr("pipeline_overlap_s")
    poa_spec_used = MetricAttr("poa_spec_used")
    poa_spec_wasted = MetricAttr("poa_spec_wasted")

    def __init__(self, *args, cuda_poa_batches: int = 0,
                 cuda_banded_alignment: bool = False,
                 cuda_aligner_batches: int = 0, device=None):
        super().__init__(*args)
        self.cuda_poa_batches = cuda_poa_batches
        self.cuda_banded_alignment = cuda_banded_alignment
        self.cuda_aligner_batches = cuda_aligner_batches
        self.device = resolve_device(device)
        self.max_align_dim = int(os.environ.get(
            "RACON_TPU_TORCH_MAX_ALIGN_DIM", self.MAX_ALIGN_DIM))
        # this polisher's device intervals; on the card a fresh anchor
        # maps its CUDA events onto the obs clock
        self.device_util = DeviceUtil()
        if self.device.type == "cuda":
            devclock.anchor(self.device)
        # every counter is in the report, 0 until the run sets it
        for attr in vars(CudaPolisher).values():
            if isinstance(attr, MetricAttr):
                self.metrics.set(attr.name, 0)
        #: the device executor's tenant (None: a one-shot run's
        #: passthrough); a caller running several polishers in one
        #: process sets it and registers it with
        #: ``executor.get_executor().register_tenant``
        self._executor_tenant = None
        self.poa_engine = None
        self.poa_reject_counts = {}
        self.poa_batch_size = 0
        # align ladder counters
        self.align_probe_ratio = 1 / 3      # p75 of the probe
        self.align_probe_p50 = 1 / 5
        #: target id -> (p50, p75) of its own probe (``_probe_divergence``)
        self._probe_by_target = {}
        self.align_eligible = 0             # pairs the ladder may take
        self.align_probed = 0               # of those, probed on the CPU
        self.align_over_length = 0          # > max_align_dim: CPU
        self.align_cpu_fallthrough = 0      # left by the ladder: CPU
        #: pairs the concurrent CPU workers aligned (the split's tail)
        self.align_cpu_tail = 0
        #: the align split: mode, cut, rates and their source
        self.align_split_detail = {}
        #: per rung ("wfa512", "band2048", ...): admitted, certified,
        #: retried (passed to a later rung or to the CPU)
        self.align_rungs = {}
        #: per rung with a later rung: pairs passed on to it
        self.align_retry_counts = {}
        #: per kernel: dispatches and their CUDA-event milliseconds
        self.align_dispatches = {"align_wfa": 0, "align_band": 0}
        self.align_kernel_ms = {"align_wfa": 0.0, "align_band": 0.0}
        #: per kernel: DP cells its dispatches computed, (min(d, emax)
        #: + 1)^2 per WFA pair and query rows x band per band pair
        #: (``align_cells`` is their sum)
        self.align_kernel_cells = {"align_wfa": 0, "align_band": 0}
        #: per kernel: summed clock64() cycles per phase (meta[:, 2:4]):
        #: wavefront steps or DP rows, then traceback
        self.align_cycles = {"align_wfa": [0, 0], "align_band": [0, 0]}
        #: per align chunk: (kernel, rung, wall s collect to collect,
        #: busy s (``_busy_s``), units: WFA steps or band query rows);
        #: busy over units is the device rate the store keeps
        self.align_chunks = []
        # POA split and streaming state
        self.poa_split_detail = {}
        #: the consumer's host walls: packing + launch, and collect
        self.spec_walls = {"dispatch": 0.0, "collect": 0.0}
        self.ready_high_water = 0
        # streaming pipeline state
        self._pipeline_mode = False
        self._ledger = None
        self._spec_results = {}
        self._spec_d1 = 8
        self._spec_cap = 0
        self._consumer = None
        self._consumer_stop = False
        self._decode_futs = []
        self._decode_buf = []
        self._decode_buf_cols = 0
        self._stream_errors = []
        self._stream_lock = threading.Lock()
        self._align_device_free = threading.Event()
        self._poa_first_dispatch_t = None
        self._align_end_t = None
        # the serve tier's durability hooks (module docstring)
        self._checkpoint_cb = None
        self._resume_windows = None
        self._calib_pin = None
        #: windows adopted from ``_resume_windows``
        self.poa_resumed_windows = 0

    @property
    def poa_spec_megabatches(self) -> int:
        """Megabatches the speculative consumer launched."""
        return int(self.metrics.value("poa_spec_megabatches"))

    def _map_device(self):
        """The mapper seeds on this polisher's device: the seed-word
        kernel on a card, its plain version on the CPU."""
        return self.device

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

    def _megabatch_size(self, d1: int) -> int:
        """``_poa_batch_size``, capped by ``MEGABATCH_CAP`` or, when that
        is 0, by ``RACON_TPU_TORCH_POA_MEGABATCH``."""
        vcap, lcap = self._poa_caps()
        size = self._poa_batch_size(vcap, lcap, d1)
        cap = self.MEGABATCH_CAP or int(
            os.environ.get("RACON_TPU_TORCH_POA_MEGABATCH") or 0)
        return min(size, cap) if cap > 0 else size

    def _make_poa_engine(self) -> executor.PoaEngineHandle:
        """A handle on the device executor's shared engine of this
        configuration (racon_tpu/tpu/polisher.py:365-384).  Its
        counters are this polisher's windows alone, its launches'
        intervals go to ``device_util``, each submission carries the
        megabatch size it was sized for, and ``_megabatch_size`` bounds
        a fused batch at its own depth."""
        vcap, lcap = self._poa_caps()
        return executor.get_executor().poa_handle(
            self.match, self.mismatch, self.gap, vcap=vcap, pcap=16,
            lcap=lcap, max_depth=self.MAX_DEPTH_PER_WINDOW,
            banded=self.cuda_banded_alignment, device=self.device,
            tenant=self._executor_tenant, cap=self.MAX_BATCH,
            util=self.device_util, size_at=self._megabatch_size)

    def _tail_workers(self, device_only_env: str) -> int:
        """CPU workers of a hybrid stage: all threads but one, none
        when the env forces device-only execution."""
        if os.environ.get(device_only_env):
            return 0
        return max(0, self.num_threads - 1)

    # ------------------------------------------------------------------
    # streaming pipeline (racon_tpu/tpu/polisher.py:357-660)
    # ------------------------------------------------------------------

    def _pipeline_enabled(self) -> bool:
        """On whenever the POA stage runs on the card;
        RACON_TPU_TORCH_PIPELINE=0 restores the staged order.  The bytes
        are the same either way."""
        return (os.environ.get("RACON_TPU_TORCH_PIPELINE", "1") != "0"
                and self.cuda_poa_batches > 0)

    def _pipeline_begin(self, overlaps: List[Overlap]) -> None:
        """Before the align stage: create the windows, register every
        overlap's window range with the ledger, count coverage, and
        start the speculative POA consumer."""
        self._create_windows(self._targets_size, self.window_type)
        led = WindowLedger(len(self.windows), metrics=self.metrics)
        w = self.window_length
        for idx, o in enumerate(overlaps):
            # counted here over the whole overlap list, so the residual
            # _build_windows pass does not count again
            self.targets_coverages[o.t_id] += 1
            first = self._first_window_id[o.t_id]
            led.register(id(o), idx, first + o.t_begin // w,
                         first + max(o.t_end - 1, o.t_begin) // w)
        self._coverage_counted = True
        led.seal()
        self._ledger = led
        # a window gets at most one layer per overlap covering it, so
        # the deepest registration bounds every speculative megabatch's
        # depth cap
        depth = min(int(led.pending.max(initial=0)),
                    self.MAX_DEPTH_PER_WINDOW)
        self._spec_d1 = max(8, pow2_at_least(depth + 1, 8))
        self._spec_cap = 0
        self._spec_results = {}
        self._stream_errors = []
        self._decode_futs = []
        self._decode_buf = []
        self._decode_buf_cols = 0
        self._consumer_stop = False
        self._poa_first_dispatch_t = None
        self._align_end_t = None
        self.poa_engine = self._make_poa_engine()
        self._consumer = threading.Thread(
            target=self._poa_consumer_loop, daemon=True,
            name="racon-torch-poa-stream")
        self._consumer.start()

    def _record_stream_error(self, exc: BaseException) -> None:
        with self._stream_lock:
            self._stream_errors.append(exc)

    def _notify_overlap_done(self, o: Overlap) -> None:
        led = self._ledger
        if led is None or not self._pipeline_mode:
            return
        try:
            if o.breaking_points is not None \
                    and o.breaking_points is not overlap_mod.ROUTED:
                with self.metrics.timer("host.fragment_s"):
                    frags = [(self._ledger_ordinal(o), wid, data, qual, b,
                              e) for wid, data, qual, b, e
                             in self._overlap_window_fragments(o)]
                # the fall-through pass now sees this overlap as done
                # (find_breaking_points returns early) instead of
                # aligning it again
                o.breaking_points = overlap_mod.ROUTED
            else:
                frags = []
            newly = led.complete(id(o), frags)
        except Exception as exc:
            self._record_stream_error(exc)
            return
        ready = []
        for wid, wfrags in newly:
            win = self.windows[wid]
            for _, _, data, qual, begin, end in wfrags:
                win.add_layer(data, qual, begin, end)
            # trivial windows (< 3 sequences) keep their backbone
            if len(win.sequences) >= 3:
                ready.append(wid)
        led.push_ready(ready)

    def _ledger_ordinal(self, o: Overlap) -> int:
        with self._ledger.cond:
            reg = self._ledger._reg.get(id(o))
        return reg[0] if reg else 0

    def _finish_overlap_batch(self, batch: List[Overlap]) -> None:
        """Pool task: decode a chunk's breaking points in one vectorized
        pass while the card runs the next chunk, then complete every
        member in the ledger."""
        try:
            with self.metrics.timer("host.bp_decode_s"):
                overlap_mod.decode_breaking_points_batch(
                    batch, self.window_length)
        except Exception:
            # the per-overlap path below raises for the record at fault
            pass
        for o in batch:
            try:
                if o.breaking_points is None:
                    o.find_breaking_points(self.sequences,
                                           self.window_length,
                                           aligner=cpu.align)
                self._notify_overlap_done(o)
            except Exception as exc:
                self._record_stream_error(exc)

    def _stream_decode(self, o: Overlap) -> None:
        """Buffer the decode and ledger completion of an overlap whose
        alignment just came from the card (a no-op with the pipeline
        off: the fall-through pass decodes it).  The buffer goes to the
        pool at ``BP_COLS`` expanded columns and at every
        chunk boundary (``_stream_decode_flush``)."""
        if not self._pipeline_mode:
            return
        runs = o.cigar_runs
        cols = int(runs[0].sum()) if runs is not None else 0
        with self._stream_lock:
            self._decode_buf.append(o)
            self._decode_buf_cols += cols
            if self._decode_buf_cols < overlap_mod.BP_COLS \
                    and len(self._decode_buf) < 4096:
                return
            batch, self._decode_buf = self._decode_buf, []
            self._decode_buf_cols = 0
        self._decode_futs.append(
            self._pool.submit(self._finish_overlap_batch, batch))

    def _stream_decode_flush(self) -> None:
        if not self._pipeline_mode:
            return
        with self._stream_lock:
            batch, self._decode_buf = self._decode_buf, []
            self._decode_buf_cols = 0
        if batch:
            self._decode_futs.append(
                self._pool.submit(self._finish_overlap_batch, batch))

    def _drain_stream_decodes(self) -> None:
        self._stream_decode_flush()
        for f in self._decode_futs:
            f.result()   # the tasks record their errors; this joins
        self._decode_futs = []

    def _mark_align_device_free(self) -> None:
        """The align stage's last device dispatch has completed (and
        its cached blocks went back to the card): speculative POA
        megabatches may run from here."""
        self._align_device_free.set()

    def _note_poa_dispatch(self) -> None:
        if self._poa_first_dispatch_t is None:
            self._poa_first_dispatch_t = _now()

    def _poa_consumer_loop(self) -> None:
        """Speculative POA consumer: while the align stage drains, run
        megabatches of ready windows through the stage's engine.  The
        results land in ``_spec_results``; the stage adopts them only
        for windows its split assigns to the device."""
        led = self._ledger
        eng = self.poa_engine
        min_take = self.PIPE_MIN
        depth = self.PIPE_DEPTH
        inflight = deque()

        def collect_one():
            idxs, coll = inflight.popleft()
            t0 = _now()
            try:
                results = coll()
                # crash site: results on the host, not yet stored
                faultinject.hit("pre-demux")
                for i, r in zip(idxs, results):
                    self._spec_results[i] = r
            except Exception as exc:
                self._record_stream_error(exc)
            t1 = _now()
            self.spec_walls["collect"] += t1 - t0
            obs_trace.TRACER.add_span("poa.spec_megabatch_collect", t0, t1,
                                      cat="poa", args={"n": len(idxs)})

        while True:
            stop = self._consumer_stop
            take = []
            if not stop and self._align_device_free.is_set():
                if not self._spec_cap:
                    # sized now: the align stage has handed its cached
                    # device memory back
                    self._spec_cap = self._megabatch_size(self._spec_d1)
                take = led.pop_ready(self._spec_cap, min_take)
            if take:
                # deepest first, as the stage orders its megabatches
                take.sort(key=lambda i: -len(self.windows[i].sequences))
                batch = [self.windows[i] for i in take]
                self._note_poa_dispatch()
                self.metrics.add("poa_spec_megabatches")
                obs_trace.TRACER.add_instant(
                    "poa.spec_megabatch_dispatch", cat="poa",
                    args={"n": len(take)})
                t0 = _now()
                try:
                    if eng.fits(batch):
                        inflight.append(
                            (take, eng.consensus_batch_async(
                                batch, self.trim, cap=self._spec_cap)))
                except Exception as exc:
                    self._record_stream_error(exc)
                self.spec_walls["dispatch"] += _now() - t0
                while len(inflight) >= depth:
                    collect_one()
                # crash site: a megabatch in flight, none of it stored
                faultinject.hit("mid-megabatch")
                continue
            if stop:
                while inflight:
                    collect_one()
                return
            with led.cond:
                led.cond.wait(0.02)

    def _pipeline_align_done(self) -> list:
        """End of the align stage: every overlap must have reached the
        ledger; stop the consumer and return the errors recorded so
        far."""
        self._align_end_t = _now()
        self._mark_align_device_free()
        led = self._ledger
        if led is not None and led.remaining():
            self._record_stream_error(RuntimeError(
                f"streaming seam left {len(led.remaining())} overlap(s) "
                "unrouted"))
        self._consumer_stop = True
        if led is not None:
            with led.cond:
                led.cond.notify_all()
        with self._stream_lock:
            return list(self._stream_errors)

    def _join_consumer(self) -> None:
        if self._consumer is not None:
            self._consumer_stop = True
            if self._ledger is not None:
                with self._ledger.cond:
                    self._ledger.cond.notify_all()
            self._consumer.join()
            self._consumer = None

    def close(self) -> None:
        """Stop the speculative consumer if an error path left it
        running, then release the pool and the parsers."""
        self._join_consumer()
        super().close()

    # ------------------------------------------------------------------
    # POA stage (racon_tpu/tpu/polisher.py:662-1128)
    # ------------------------------------------------------------------

    def generate_consensuses(self) -> List[bool]:
        if self.cuda_poa_batches <= 0:
            return super().generate_consensuses()
        t0 = _now()
        with obs_trace.device_span("racon_tpu_torch.device_poa",
                                   device=self.device):
            flags = self._device_generate_consensuses()
        start = t0
        if self._poa_first_dispatch_t is not None:
            # under the pipeline the stage's first dispatch precedes
            # the stage: the overlap is the wall the pipeline removed
            start = min(start, self._poa_first_dispatch_t)
            if self._align_end_t is not None:
                self.pipeline_overlap_s = max(
                    0.0, self._align_end_t - self._poa_first_dispatch_t)
        self.metrics.set("stage_wall_s.device_poa", _now() - start)
        return flags

    def polish(self, drop_unpolished_sequences: bool):
        """The base class's polish; then the run's per-engine device
        utilization goes into ``metrics``."""
        dst = super().polish(drop_unpolished_sequences)
        self.device_util.publish(self.metrics)
        return dst

    def _device_generate_consensuses(self) -> List[bool]:
        engine = self.poa_engine or self._make_poa_engine()
        self.poa_engine = engine
        # the consumer must be done with the engine before the stage
        # uses it, and whatever it recorded after the align stage
        # ended is raised here
        self._join_consumer()
        with self._stream_lock:
            errs = list(self._stream_errors)
        if errs:
            raise errs[0]
        if self._ledger is not None:
            self.ready_high_water = self._ledger.ready_high_water
        spec = self._spec_results
        if self.device.type == "cuda":
            # size the megabatches from what the card really has free:
            # the speculative megabatches' blocks go back first
            torch.cuda.empty_cache()

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
        self.poa_device_windows = 0
        if eligible and not engine.fits(
                [self.windows[i] for i in eligible]):
            vcap, lcap = self._poa_caps()
            raise RuntimeError(
                f"[racon_tpu_torch::CudaPolisher] window caps v={vcap} "
                f"lp={lcap} do not fit the POA kernel")

        # per-window cost units depth * (1 + depth/48) * (len/500):
        # superlinear in depth because inserts grow the graph
        unit_of = {}
        for i in eligible:
            w0 = self.windows[i]
            depth = min(len(w0.sequences) - 1, self.MAX_DEPTH_PER_WINDOW)
            unit_of[i] = depth * (1 + depth / 48.0) \
                * (len(w0.sequences[0]) / 500.0)
        n_workers = self._tail_workers("RACON_TPU_TORCH_POA_DEVICE_ONLY")
        r_dev, r_cpu, r_src = calibrate.get_rates(
            "poa", self.device, self.POA_DEV_US_PER_UNIT,
            self.POA_CPU_US_PER_UNIT, pin=self._calib_pin)
        n_priced = calibrate.host_reserved_workers(n_workers, r_src)
        if not n_workers:
            mode, dev_left = "device_only", len(eligible)
        elif "RACON_TPU_TORCH_POA_SPLIT" in os.environ:
            # device share of the depth^2 weight
            mode = "env_split"
            dev_left = _split_cut(
                [len(self.windows[i].sequences) ** 2 for i in eligible],
                float(os.environ["RACON_TPU_TORCH_POA_SPLIT"]))
        else:
            mode = "rate_model"
            dev_left = _rate_split(
                [unit_of[i] * r_dev for i in eligible],
                [unit_of[i] * r_cpu / n_priced for i in eligible])
        units = [unit_of[i] for i in eligible]
        total_u = sum(units) or 1.0
        self.poa_split_detail = {
            "mode": mode, "rate_dev_us_per_unit": r_dev,
            "rate_cpu_us_per_unit": r_cpu, "rate_source": r_src,
            "n_cpu_workers": n_workers, "n_cpu_workers_priced": n_priced,
            "cut": dev_left, "n_eligible": len(eligible),
            "dev_unit_share": round(sum(units[:dev_left]) / total_u, 4)}
        DECISIONS.record(
            "poa_split", mode=mode, rate_dev=round(r_dev, 4),
            rate_cpu=round(r_cpu, 4), source=r_src, cut=dev_left,
            n_eligible=len(eligible),
            dev_unit_share=self.poa_split_detail["dev_unit_share"])
        self.logger.log(
            f"{_PLOG} poa split ({mode}): device {dev_left}/"
            f"{len(eligible)} windows, cpu {len(eligible) - dev_left} "
            f"({r_src} rates {r_dev:g}/{r_cpu:g} us/unit, "
            f"{n_priced}/{n_workers} cpu workers priced)")

        # speculative results: adopted only for device-assigned windows
        # (assignment never follows speculation); a speculative reject
        # takes the CPU re-polish, as a stage launch of it would
        work = deque(eligible)
        assigned = set(eligible[:dev_left])
        failed: List[int] = []
        # the windows committed before the stage's launches, journaled
        # in one checkpoint below
        adopted = []
        if spec:
            resolved = [i for i in eligible[:dev_left] if i in spec]
            for i in resolved:
                cons, ok = spec[i]
                adopted.append((i, cons, bool(ok) and cons is not None))
                if cons is None:
                    failed.append(i)
                else:
                    self.windows[i].consensus = cons
                    flags[i] = ok
                    self.poa_device_windows += 1
            self.poa_spec_used = len(resolved)
            self.poa_spec_wasted = len(spec) - len(resolved)
            if resolved:
                rset = set(resolved)
                work = deque(i for i in eligible if i not in rset)
                dev_left -= len(resolved)
            self.logger.log(
                f"{_PLOG} poa stream: {self.poa_spec_used}/{len(spec)} "
                f"speculative window(s) adopted ({self.poa_spec_wasted} "
                "recomputed on the CPU)")
        resume = self._resume_windows
        if resume:
            # a dead daemon's committed windows, adopted as speculative
            # results are: device-assigned windows only, so the split
            # and the bytes are the uninterrupted run's
            resumed = [i for i in work if i in resume and i in assigned]
            for i in resumed:
                cons, ok = resume[i]
                if cons is None:
                    failed.append(i)
                else:
                    self.windows[i].consensus = cons
                    flags[i] = bool(ok)
                    self.poa_device_windows += 1
            self.poa_resumed_windows = len(resumed)
            self.metrics.set("poa_resumed_windows", len(resumed))
            if resumed:
                rs = set(resumed)
                work = deque(i for i in work if i not in rs)
                dev_left -= len(resumed)
            DECISIONS.record("poa_resume", used=len(resumed),
                             replayed=len(resume))
            self.logger.log(
                f"{_PLOG} poa resume: {len(resumed)}/{len(resume)} "
                "checkpointed window(s) adopted from the journal")
        if adopted and self._checkpoint_cb is not None:
            self._checkpoint_cb(adopted)

        lock = threading.Lock()
        meas = {"dev": [], "cpu_w": 0.0, "cpu_u": 0.0}
        stop = []
        epoch = self._cache_epoch()

        def cpu_worker():
            while True:
                with lock:
                    if stop or len(work) <= dev_left:
                        return
                    i = work.pop()
                t1 = time.thread_time()
                flags[i], hit = self._consensus_cached(self.windows[i],
                                                       epoch)
                if hit:
                    # a lookup's time says nothing of the CPU engine's
                    # rate
                    continue
                with lock:
                    meas["cpu_w"] += time.thread_time() - t1
                    meas["cpu_u"] += unit_of[i]

        workers = [self._pool.submit(cpu_worker) for _ in range(n_workers)]
        size = self._megabatch_size(
            engine.depth_cap([self.windows[i] for i in eligible]))
        self.poa_batch_size = size
        pipe = deque()
        cpu_mark = time.thread_time()
        mark = _now()

        def apply(idxs, collect):
            nonlocal cpu_mark, mark
            results = collect()
            # crash site: results on the host, not yet committed, so a
            # restart replays this whole megabatch
            faultinject.hit("pre-demux")
            now = time.thread_time()
            busy = _busy_s(collect.kernel_ms(), now - cpu_mark)
            u_batch = sum(unit_of[i] for i in idxs)
            cpu_mark = now
            # a megabatch the cache served in part ran fewer windows
            # than its units claim: it feeds neither the rate nor
            # calhealth (racon_tpu/tpu/polisher.py:975)
            record = not collect.cache_hits
            if record:
                meas["dev"].append((busy, u_batch))
                # the busy time against what the split's rate predicted
                obs_calhealth.observe(
                    "poa", calibrate.predict_chunk_wall("poa", u_batch,
                                                        r_dev),
                    busy, registry=self.metrics)
            t1 = _now()
            obs_trace.TRACER.add_span("poa.megabatch", mark, t1, cat="poa",
                                      args={"n": len(idxs),
                                            "recorded": record})
            mark = t1
            ckpt = []
            for i, (cons, ok) in zip(idxs, results):
                ckpt.append((i, cons, bool(ok) and cons is not None))
                if cons is None:
                    failed.append(i)
                else:
                    self.windows[i].consensus = cons
                    flags[i] = ok
                    self.poa_device_windows += 1
            if self._checkpoint_cb is not None:
                # journaled after the commit: a crash between the two
                # replays one megabatch, never uncommitted state
                self._checkpoint_cb(ckpt)
            self._poll_cancel()
            self.logger.bar(f"{_PLOG} generating consensus (device)")

        depth = self.PIPE_DEPTH
        try:
            while True:
                self._poll_cancel()
                with lock:
                    take = min(size, len(work), dev_left)
                    idxs = [work.popleft() for _ in range(take)]
                    dev_left -= take
                if not idxs:
                    break
                self._note_poa_dispatch()
                pipe.append((idxs, engine.consensus_batch_async(
                    [self.windows[i] for i in idxs], self.trim, cap=size)))
                while len(pipe) >= depth:
                    apply(*pipe.popleft())
                # crash site: this megabatch in flight, none of it
                # journaled (the older ones are, by apply)
                faultinject.hit("mid-megabatch")
            while pipe:
                apply(*pipe.popleft())
        except BaseException:
            # a failed launch raises; no window moves to the CPU
            stop.append(True)
            raise
        finally:
            for fut in workers:
                fut.result()

        if failed:
            rc = engine.reject_counts
            self.logger.log(
                f"{_PLOG} {len(failed)} window(s) fell back to the CPU "
                "engine (" + ", ".join(f"{k} {v}" for k, v in rc.items()
                                       if v) + ")")
            t0 = _now()
            cpu_flags = list(self._pool.map(
                lambda i: self._consensus_cached(self.windows[i],
                                                 epoch)[0], failed))
            for i, f in zip(failed, cpu_flags):
                flags[i] = f
            self._wall("cpu_repolish", t0)
        if engine.n_skipped_layers:
            self.logger.log(f"{_PLOG} skipped {engine.n_skipped_layers} "
                            "over-long layer(s)")
        self.poa_reject_counts = dict(engine.reject_counts)
        self.poa_device_s = engine.device_s
        self.poa_cells = engine.cells
        for code, cnt in engine.reject_counts.items():
            if cnt:
                self.metrics.add(f"poa_reject.{code}", cnt)
        # the first megabatch pays one-time costs: drop it when later
        # ones exist; a single megabatch stores provisionally
        recorded = meas["dev"][1:] if len(meas["dev"]) > 1 else meas["dev"]
        dev_w = sum(w for w, _ in recorded)
        dev_u = sum(u for _, u in recorded)
        if dev_u > 0 and meas["cpu_u"] > 0 and r_src != "env":
            calibrate.store_rates(
                "poa", self.device, dev_w * 1e6 / dev_u,
                meas["cpu_w"] * 1e6 / meas["cpu_u"],
                provisional=len(meas["dev"]) <= 1)
        return flags

    # ------------------------------------------------------------------
    # overlap alignment (racon_tpu/tpu/polisher.py:1203-1905)
    # ------------------------------------------------------------------

    def find_overlap_breaking_points(self, overlaps: List[Overlap]) -> None:
        """The device/CPU split of the eligible overlaps, then the base
        class's pass, which decodes breaking points and CPU-aligns
        whatever is left.  Under the pipeline the windows fill as the
        overlaps complete; an error the streaming seam recorded raises
        here."""
        self._align_device_free.clear()
        self._pipeline_mode = (self._pipeline_enabled()
                               and self._targets_size > 0)
        if self._pipeline_mode:
            self._pipeline_begin(overlaps)
        try:
            if self.cuda_aligner_batches > 0:
                t0 = _now()
                with obs_trace.device_span("racon_tpu_torch.device_align",
                                           device=self.device):
                    self._device_align_overlaps(overlaps)
                self._wall("device_align", t0)
                self.metrics.set("stage_wall_s.device_align",
                                 self.stage_walls["device_align"])
            else:
                # no device align work: speculative megabatches may run
                # beside the CPU aligner at once
                self._mark_align_device_free()
            if self._pipeline_mode:
                self._drain_stream_decodes()
            super().find_overlap_breaking_points(overlaps)
        finally:
            # never leaves the consumer running on an error path; a
            # recorded error is raised outside the finally, so that it
            # does not mask one already propagating
            errs = (self._pipeline_align_done() if self._pipeline_mode
                    else [])
        if errs:
            raise errs[0]

    def _device_align_overlaps(self, overlaps: List[Overlap]) -> None:
        pending = []  # (dim, overlap), dim = max span side
        over = []     # the same, past MAX_ALIGN_DIM: CPU only
        for o in overlaps:
            if o.cigar or o.cigar_runs is not None \
                    or o.breaking_points is not None:
                continue
            lq = o.q_end - o.q_begin
            lt = o.t_end - o.t_begin
            if max(lq, lt) > self.max_align_dim:
                self.align_over_length += 1
                over.append((max(lq, lt), o))
                continue
            if min(lq, lt) == 0:
                continue
            pending.append((max(lq, lt), o))
        self.align_eligible = len(pending)
        if pending:
            pending.sort(key=lambda x: -x[0])
            over.sort(key=lambda x: -x[0])
            self._hybrid_align(pending, over)
        self._mark_align_device_free()

    def _cpu_tail_align(self, o: Overlap) -> None:
        """One pair of the split's CPU tail: native CIGAR and breaking
        points."""
        o.find_breaking_points(self.sequences, self.window_length,
                               aligner=cpu.align)
        self._notify_overlap_done(o)

    def _hybrid_align(self, pending, over=()) -> None:
        """The device ladder takes the longest-first prefix of
        ``pending`` while ``num_threads - 1`` CPU workers align the
        over-length pairs ``over`` (longest first; the CPU's by the
        reference's contract), then the tail
        (racon_tpu/tpu/polisher.py:_hybrid_pallas_align, which leaves
        the over-length pairs to the pass after the ladder).  The cut is
        the ``_rate_split`` argmin of device time (WFA e-steps at the
        ``align_wfa`` rate when the pair's estimate fits a WFA rung,
        else rows at the ``align`` rate) against CPU time (``d + (ratio
        * d)^2`` modeled cells at the ``align_cpu`` rate over the
        workers, the over-length pairs' included);
        RACON_TPU_TORCH_ALIGN_SPLIT sets the device's share of the
        dimension weight instead, RACON_TPU_TORCH_ALIGN_DEVICE_ONLY (or
        -t 1) gives the device everything and leaves the over-length
        pairs to the pass after the ladder."""
        n_workers = self._tail_workers("RACON_TPU_TORCH_ALIGN_DEVICE_ONLY")
        r_dev, r_cpu, r_src = calibrate.get_rates(
            "align", self.device, self.DEV_NS_PER_ROW,
            self.CPU_NS_PER_CELL, pin=self._calib_pin)
        cpu_src = r_src
        if r_src != "env":
            # the CPU rate calibrates as a stage of its own
            r_cpu, _, cpu_src = calibrate.get_rates(
                "align_cpu", self.device, self.CPU_NS_PER_CELL,
                pin=self._calib_pin)
        r_wfa, _, wfa_src = calibrate.get_rates(
            "align_wfa", self.device, self.WFA_DEV_NS_PER_STEP,
            pin=self._calib_pin)
        self._probe_divergence(pending)
        ratio = self.align_probe_ratio
        dims = [d for d, _ in pending]
        wfa_cap = self.WFA_RUNGS[-1]

        def dev_cost(d, o):
            est = self._wfa_need(o, ratio)
            return est * r_wfa if est <= wfa_cap and d <= aw.MAX_DIM \
                else d * r_dev

        def cpu_cells(d):
            return d + (ratio * d) ** 2

        over = list(over) if n_workers else []
        if not n_workers:
            mode, cut = "device_only", len(pending)
        elif "RACON_TPU_TORCH_ALIGN_SPLIT" in os.environ:
            mode = "env_split"
            cut = _split_cut(
                dims, float(os.environ["RACON_TPU_TORCH_ALIGN_SPLIT"]))
        else:
            mode = "rate_model"
            cut = _rate_split(
                [dev_cost(d, o) for d, o in pending],
                [r_cpu * cpu_cells(d) / n_workers for d in dims],
                sum(r_cpu * cpu_cells(d) for d, _ in over) / n_workers)
        DECISIONS.record(
            "align_split", mode=mode, cut=cut, n_pending=len(pending),
            rate_dev=round(r_dev, 4), rate_wfa=round(r_wfa, 4),
            rate_cpu=round(r_cpu, 4), source=r_src,
            n_over_length=len(over) or None)
        self.align_split_detail = {
            "mode": mode, "cut": cut, "n_pending": len(pending),
            "rate_band_ns_per_row": r_dev,
            "rate_wfa_ns_per_step": r_wfa,
            "rate_cpu_ns_per_cell": r_cpu, "rate_source": r_src,
            "rate_wfa_source": wfa_src, "rate_cpu_source": cpu_src,
            "n_cpu_workers": n_workers, "n_over_length_on_workers":
                len(over), "ratio": ratio}
        self.logger.log(
            f"{_LOG} align split ({mode}): device {cut}/{len(pending)} "
            f"overlap(s), cpu {len(pending) - cut} on {n_workers} "
            f"worker(s) ({r_src} rates: band {r_dev:g} ns/row, wfa "
            f"{r_wfa:g} ns/step, cpu {r_cpu:g} ns/cell); "
            f"{self.align_over_length} over {self.max_align_dim} bases "
            "on the CPU" + (" workers beside the ladder" if over else ""))

        long_work = deque(over)
        work = deque(pending[cut:])
        lock = threading.Lock()
        meas = {"cpu_w": 0.0, "cpu_u": 0.0, "n": 0, "n_tail": 0}
        stop = []

        def cpu_worker():
            while True:
                with lock:
                    if stop:
                        return
                    if long_work:
                        d, o = long_work.popleft()
                    elif work:
                        d, o = work.pop()
                        meas["n_tail"] += 1
                    else:
                        return
                    meas["n"] += 1
                t1 = time.thread_time()
                self._cpu_tail_align(o)
                with lock:
                    meas["cpu_w"] += time.thread_time() - t1
                    meas["cpu_u"] += cpu_cells(float(d))

        workers = [self._pool.submit(cpu_worker) for _ in range(n_workers)]
        self.align_chunks = []
        rates = {"align_wfa": ("align_wfa", r_wfa),
                 "align_band": ("align", r_dev)}
        try:
            if cut:
                self._align_ladder([o for _, o in pending[:cut]], rates)
            if self.device.type == "cuda":
                # hand the ladder's cached blocks back before anything
                # sizes a megabatch from the card's free memory
                torch.cuda.empty_cache()
            self._mark_align_device_free()
        except BaseException:
            stop.append(True)
            raise
        finally:
            for f in workers:
                f.result()
        self.align_cpu_tail = meas["n_tail"]
        if meas["n"]:
            self.logger.log(f"{_LOG} cpu-aligned {meas['n']} overlaps "
                            "concurrently")
        # a pinned stage stores nothing
        if cpu_src != "env" and meas["cpu_u"] > 0 and meas["n"] >= 16:
            calibrate.store_rates("align_cpu", self.device,
                                  meas["cpu_w"] * 1e9 / meas["cpu_u"])
        # drop the first chunk of every (kernel, rung): it pays one-time
        # costs
        by_rung = {}
        for kernel, rung, _, busy, units in self.align_chunks:
            by_rung.setdefault((kernel, rung), []).append((busy, units))
        for kernel, stage, src in (("align_band", "align", r_src),
                                   ("align_wfa", "align_wfa", wfa_src)):
            if src == "env":
                continue
            chunks = [c for k, ch in by_rung.items() if k[0] == kernel
                      for c in ch[1:]]
            dev_u = sum(u for _, u in chunks)
            if dev_u > 0:
                calibrate.store_rates(
                    stage, self.device,
                    sum(w for w, _ in chunks) * 1e9 / dev_u)

    def _probe_divergence(self, pending) -> None:
        """CPU-align a deterministic spread of each target's pending
        pairs: one for every ``PROBE_EVERY``, at most ``PROBE_PAIRS``,
        none below ``PROBE_MIN``.  Each target's p50 and p75 of edit
        distance / dimension price its pairs' rungs
        (``_probe_by_target``), and all the probes' the split.  Probed
        pairs keep their breaking points and leave ``pending``.

        Per target, and not over the whole set as in the JAX package
        (racon_tpu/tpu/polisher.py:_pallas_align): a pair's WFA or band
        rung then depends on its own target's overlaps alone, and the
        two engines' CIGARs differ, so a target-sharded job
        (serve/scatter.py, parallel/multihost.py) writes the unsharded
        bytes on the card too.  The budget keeps the probe under 1/32 of
        the pairs however fragmented the draft: 9 probes over 100
        contigs' targets would take 900 pairs off the card.  A target of
        288 pairs or more probes 9, as the JAX package's whole job
        does."""
        by_target = {}
        for k, (_, o) in enumerate(pending):
            by_target.setdefault(o.t_id, []).append(k)
        picks = []
        for t, ks in by_target.items():
            n = len(ks)
            k = min(self.PROBE_PAIRS, n // self.PROBE_EVERY)
            if k >= self.PROBE_MIN:
                # the k-quantile positions: 0.1, ..., 0.9 for 9 picks
                picks.extend((t, ks[j]) for j in sorted(
                    {min(n - 1, int((j + 1) / (k + 1) * n))
                     for j in range(k)}))
        if not picks:
            return

        def one(pick):
            d, o = pending[pick[1]]
            o.cigar, dist = cpu.align_with_distance(
                o.query_span(self.sequences), o.target_span(self.sequences))
            o.find_breaking_points(self.sequences, self.window_length,
                                   aligner=cpu.align)
            self._notify_overlap_done(o)
            return dist / max(d, 1)

        ratios = list(self._pool.map(one, picks))
        for k in sorted((k for _, k in picks), reverse=True):
            del pending[k]
        self.align_probed = len(picks)

        def quantiles(rs):
            rs = sorted(rs)
            return rs[(len(rs) - 1) // 2], min(max(
                rs[int(0.75 * (len(rs) - 1))], 0.05), 0.67)

        for t in by_target:
            rs = [r for (pt, _), r in zip(picks, ratios) if pt == t]
            if rs:
                self._probe_by_target[t] = quantiles(rs)
        self.align_probe_p50, self.align_probe_ratio = quantiles(ratios)

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
                  accept, units, rates) -> set:
        """Dispatch ``idx`` in chunks of ``_chunk_pairs(per_pair)``, two
        in flight (``dispatch(sub, chunk size)``); ``accept(i, k,
        results)`` decides and records each pair.  Every chunk's busy
        time against the prediction at ``rates[kernel]`` (stage, rate)
        goes to its decision record, and, unless the cache served some
        of its pairs, with its wall and ``units(sub, results)`` to
        ``align_chunks`` for the device rates and to calhealth.
        Returns the pairs not certified."""
        size = self._chunk_pairs(per_pair)
        chunks = [idx[c:c + size] for c in range(0, len(idx), size)]
        engine = "wfa" if name.startswith("wfa") else "band"
        kernel, rung = f"align_{engine}", int(name[len(engine):])
        stage, rate = rates[kernel]
        still = set()
        t_rung = mark = _now()
        cpu_mark = time.thread_time()
        self.metrics.add(f"align_rung_admit.{name}", len(idx))

        def consume(sub, collect):
            nonlocal mark, cpu_mark
            res = collect()
            now, cpu_now = _now(), time.thread_time()
            busy = _busy_s(collect.kernel_ms(), cpu_now - cpu_mark)
            n_units = float(units(sub, res))
            pred = calibrate.predict_chunk_wall(stage, n_units, rate)
            hits = getattr(collect, "cache_hits", 0)
            if not hits:
                # a chunk the cache served in part ran fewer units than
                # it claims: no rate, no calhealth
                # (racon_tpu/tpu/polisher.py:1738, :1840)
                self.align_chunks.append((kernel, name, now - mark, busy,
                                          n_units))
                obs_calhealth.observe(kernel, pred, busy,
                                      registry=self.metrics)
            DECISIONS.record("align_chunk", engine=engine, rung=rung,
                             n=len(sub), predicted_s=round(pred, 6),
                             measured_s=round(busy, 6),
                             cache_hits=hits or None)
            obs_trace.TRACER.add_span(f"align.chunk.{name}", mark, now,
                                      cat="align", args={"n": len(sub)})
            dev_s = collect.device_s()
            self.align_device_s += dev_s
            setattr(self, f"{kernel}_device_s",
                    getattr(self, f"{kernel}_device_s") + dev_s)
            if dev_s > 0:
                self.metrics.observe(f"align_chunk_device_s.{engine}", dev_s)
            mark, cpu_mark = now, cpu_now
            self.align_kernel_ms[kernel] += collect.kernel_ms()
            for k, c in enumerate(getattr(collect, "phase_cycles", ())):
                self.align_cycles[kernel][k] += c
            for k, i in enumerate(sub):
                if not accept(i, k, res):
                    still.add(i)
            # decode this chunk's pairs on the pool while the card runs
            # the next one
            self._stream_decode_flush()

        self.align_dispatches[kernel] += len(chunks)
        align.run_pipelined(chunks, lambda sub: dispatch(sub, size),
                            consume)
        obs_trace.TRACER.add_span(f"align.rung.{name}", t_rung, _now(),
                                  cat="align", args={"n": len(idx),
                                                     "chunks": len(chunks)})
        self.align_rungs[name] = {"admitted": len(idx),
                                  "certified": len(idx) - len(still),
                                  "retried": len(still)}
        return still

    def _rung_left(self, name: str, still, last: bool) -> None:
        """Count and record the pairs a rung did not certify: retries
        when a later rung exists, CPU fall-throughs after the last."""
        if not still:
            return
        if last:
            self.metrics.add("align_rung_cpu_fallthrough", len(still))
            DECISIONS.record("align_cpu_fallthrough", pairs=len(still))
            return
        self.align_retry_counts[name] = \
            self.align_retry_counts.get(name, 0) + len(still)
        self.metrics.add(f"align_rung_retry.{name}", len(still))
        engine = "wfa" if name.startswith("wfa") else "band"
        DECISIONS.record("align_retry", engine=engine,
                         rung=int(name[len(engine):]), pairs=len(still))

    def _align_ladder(self, overlaps: List[Overlap], rates) -> None:
        """Device alignment ladder (racon_tpu/tpu/polisher.py:
        _pallas_align): WFA rungs, then banded rungs with measured-center
        retries; survivors keep no CIGAR and take the CPU pass.
        ``rates`` prices each chunk for its records (``_run_rung``)."""
        queries = [o.query_span(self.sequences) for o in overlaps]
        targets = [o.target_span(self.sequences) for o in overlaps]
        dim = max(max(len(s) for s in queries),
                  max(len(s) for s in targets))
        bd = min((dim + 127) // 128 * 128, self.max_align_dim)
        # the WFA rungs' padded length: a cap past the kernel's rows
        # leaves the longer pairs to the band rungs
        wbd = min(bd, aw.MAX_DIM)
        n = len(overlaps)
        # every decision below is taken per target, with its own probe's
        # ratios (_probe_divergence), and the chunks pool the targets:
        # a pair's rungs depend on its target's overlaps alone
        tgt = [o.t_id for o in overlaps]
        # a target too small to probe prices at the fixed priors, never
        # at the other targets' probes
        prior = (1 / 5, 1 / 3)
        p50, p75 = {}, {}
        for t in set(tgt):
            r50, r75 = self._probe_by_target.get(t, prior)
            p50[t] = min(max(r50, 0.05), 0.67)
            p75[t] = min(max(r75, 0.05), 0.67)
        dabs = [abs(len(queries[i]) - len(targets[i])) for i in range(n)]
        # banded cost estimate (median divergence) and the measured-center
        # admission estimate (cost only: the center absorbs the drift)
        needc = [int(max(len(queries[i]), len(targets[i])) * p50[tgt[i]])
                 for i in range(n)]
        need = [max(dabs[i], needc[i]) for i in range(n)]
        # WFA admission at p75: a pair past its rung wastes a pass
        wfa_need = [self._wfa_need(o, p75[o.t_id]) for o in overlaps]
        pending = list(range(n))
        rungs = list(self.WFA_RUNGS)
        by_target = {}
        for i in pending:
            if max(len(queries[i]), len(targets[i])) > wbd:
                continue
            for e in rungs:
                if wfa_need[i] <= e - 32:
                    by_target.setdefault(tgt[i], {}).setdefault(
                        e, []).append(i)
                    break
        for tg in by_target.values():
            # a target's group under 16 pairs rides the next rung up
            for e in rungs[:-1]:
                if 0 < len(tg.get(e, ())) < 16:
                    nxt = rungs[rungs.index(e) + 1]
                    tg.setdefault(nxt, [])[:0] = tg.pop(e)
        groups = {}
        for e in rungs:
            idx = [i for tg in by_target.values() for i in tg.get(e, ())]
            if idx:
                groups[e] = idx
        use_emp = set()             # pairs on measured-center retry
        knots = {}

        def emp_knots(i):
            if i not in knots:
                knots[i] = ab.estimate_center_knots(queries[i], targets[i],
                                                    bd)
            return knots[i]

        def sub_pairs(sub):
            return [queries[i] for i in sub], [targets[i] for i in sub]

        # every chunk through the device executor (result cache,
        # fusion across tenants; racon_tpu/tpu/polisher.py:1704-1714)
        ex = executor.get_executor()

        for emax in sorted(groups):
            idx = groups[emax]

            def accept_wfa(i, k, res, emax=emax):
                tapes, nents, dists = res
                d = int(dists[k])
                self.align_kernel_cells["align_wfa"] += \
                    (min(d, emax) + 1) ** 2
                if d > emax:
                    return False
                overlaps[i].cigar_runs = al.ops_to_runs(
                    aw.wfa_tape_to_ops(tapes[k], int(nents[k])))
                self._stream_decode(overlaps[i])
                return True

            still = self._run_rung(
                f"wfa{emax}", idx, aw.wfa_per_pair_bytes(wbd, emax),
                lambda sub, cap, emax=emax: ex.align_wfa(
                    *sub_pairs(sub), wbd, emax, self.device,
                    tenant=self._executor_tenant, util=self.device_util,
                    cap=cap), accept_wfa,
                lambda sub, res, emax=emax: sum(
                    min(int(d), emax) for d in res[2]), rates)
            # WFA rejects go on to the band rungs
            self._rung_left(f"wfa{emax}", still, last=False)
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
            admit = {}
            for i in pending:
                if need[i] + dabs[i] <= wb - 512 \
                        or (i in use_emp and needc[i] <= wb - 512) \
                        or (wb == last and 2 * dabs[i] <= wb - 512):
                    admit.setdefault(tgt[i], []).append(i)
            # a target under 16 admitted pairs waits for a wider rung
            idx = sorted(i for ti in admit.values()
                         if len(ti) >= 16 or wb == last for i in ti)
            if not idx:
                continue

            def accept_band(i, k, res, wb=wb):
                moves, lens, dists = res
                self.align_kernel_cells["align_band"] += \
                    len(queries[i]) * wb
                if i in use_emp:
                    ok = int(dists[k]) < ab.BIG and ab.path_center_margin(
                        moves[k], int(lens[k]), knots[i], wb) >= 256
                else:
                    ok = int(dists[k]) + dabs[i] <= wb - 512
                if ok:
                    overlaps[i].cigar_runs = al.ops_to_runs(ab.moves_to_ops(
                        moves[k], int(lens[k]), queries[i], targets[i]))
                    self._stream_decode(overlaps[i])
                return ok

            still = self._run_rung(
                f"band{wb}", idx, ab.band_per_pair_bytes(bd, bd, wb),
                lambda sub, cap, wb=wb: ex.align_band(
                    *sub_pairs(sub), bd, bd, wb, self.device,
                    centers=[emp_knots(i) if i in use_emp else None
                             for i in sub], tenant=self._executor_tenant,
                    util=self.device_util, cap=cap),
                accept_band,
                lambda sub, res: sum(len(queries[i]) for i in sub), rates)
            self._rung_left(f"band{wb}", still, last=wb == last)
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
        self.align_cells = sum(self.align_kernel_cells.values())
