"""Polisher: the pipeline orchestrator (reference: src/polisher.{hpp,cpp}).

Drives parse -> overlap filtering -> breaking points -> windowing ->
consensus -> stitching, in the stage order of the JAX package's
``racon_tpu/core/polisher.py``: ``initialize`` (:174),
``find_overlap_breaking_points`` (:523), ``_build_windows`` (:646),
``generate_consensuses`` (:697) and ``polish`` (:709).  The accelerator
seam is the reference's (src/polisher.hpp:55,74): the CUDA subclass
(racon_tpu_torch.cuda.polisher) overrides
``find_overlap_breaking_points`` to run the align kernels and
``generate_consensuses`` to run the POA kernel, with the CPU engines for
whatever the kernels leave.  A third hook, ``_notify_overlap_done``,
fires once per overlap as its breaking points exist; the subclass's
streaming pipeline routes the overlap's fragments into windows created
before the align stage (``_create_windows``), and ``_build_windows``
then routes only what that left.  Stage walls land in ``stage_walls``;
each stage is also a trace span named as in the JAX package
(``racon_tpu_torch.load_targets`` ... ``racon_tpu_torch.consensus_stage``)
and the host stages' seconds are the ``host.*`` budget of the per-run
registry ``metrics`` (racon_tpu/core/polisher.py:_finish_host_budget).
"""

from __future__ import annotations

import concurrent.futures
import enum
from typing import Dict, List, Optional

import numpy as np

from racon_tpu_torch.core import overlap as overlap_mod
from racon_tpu_torch.core.overlap import InvalidInputError, Overlap
from racon_tpu_torch.core.sequence import Sequence
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.io.parsers import (create_overlap_parser,
                                        create_sequence_parser)
from racon_tpu_torch.obs import REGISTRY, Registry
from racon_tpu_torch.obs import calhealth as obs_calhealth
from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.ops import cpu
from racon_tpu_torch.utils.logger import Logger

CHUNK_SIZE = 1024 * 1024 * 1024  # reference kChunkSize (polisher.cpp:26)


class PolisherType(enum.Enum):
    kC = 0  # contig polishing
    kF = 1  # fragment (read) error correction


def create_polisher(sequences_path: str, overlaps_path: Optional[str],
                    target_path: str, type_: PolisherType,
                    window_length: int, quality_threshold: float,
                    error_threshold: float, trim: bool, match: int,
                    mismatch: int, gap: int, num_threads: int,
                    cuda_poa_batches: int = 0,
                    cuda_banded_alignment: bool = False,
                    cuda_aligner_batches: int = 0,
                    device=None) -> "Polisher":
    """Factory mirroring racon::createPolisher (src/polisher.cpp:55-159):
    ``cuda_poa_batches > 0`` offloads the POA stage and
    ``cuda_aligner_batches > 0`` the overlap alignment to the card
    (``device``, default cuda), the reference's --cudapoa-batches and
    --cudaaligner-batches.  ``overlaps_path=None`` selects internal
    overlap discovery: ``initialize`` maps the reads against the
    targets (``racon_tpu_torch/overlap``) and feeds the overlaps through
    the same filter and align path as a parsed file's."""
    if not isinstance(type_, PolisherType):
        raise InvalidInputError("invalid polisher type!")
    if window_length == 0:
        raise InvalidInputError("invalid window length!")
    sparser = create_sequence_parser(sequences_path)
    oparser = (create_overlap_parser(overlaps_path)
               if overlaps_path is not None else None)
    tparser = create_sequence_parser(target_path)
    args = (sparser, oparser, tparser, type_, window_length,
            quality_threshold, error_threshold, trim, match, mismatch, gap,
            num_threads)
    if cuda_poa_batches > 0 or cuda_aligner_batches > 0:
        from racon_tpu_torch.cuda.polisher import CudaPolisher
        return CudaPolisher(*args, cuda_poa_batches=cuda_poa_batches,
                            cuda_banded_alignment=cuda_banded_alignment,
                            cuda_aligner_batches=cuda_aligner_batches,
                            device=device)
    return Polisher(*args)


class _MappedOverlapSource:
    """Parser-shaped view over internally discovered overlaps, so that
    ``_load_overlaps`` runs its transmute/filter loop unchanged over
    the mapper's output: one chunk, then done."""

    def __init__(self, records: List[Overlap]):
        self._records = records
        self._done = False

    def reset(self) -> None:
        self._done = False

    def close(self) -> None:
        self._records = []

    def parse(self, dst: List[Overlap], max_bytes: int) -> bool:
        if not self._done:
            dst.extend(self._records)
            self._done = True
        return False


class Polisher:
    def __init__(self, sparser, oparser, tparser, type_: PolisherType,
                 window_length: int, quality_threshold: float,
                 error_threshold: float, trim: bool, match: int,
                 mismatch: int, gap: int, num_threads: int):
        self.sparser = sparser
        self.oparser = oparser
        self.tparser = tparser
        self.type = type_
        self.window_length = window_length
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        self.trim = trim
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.num_threads = max(1, num_threads)
        self.sequences: List[Sequence] = []
        self.windows: List[Window] = []
        self.targets_coverages: List[int] = []
        self.window_type = WindowType.TGS
        self._targets_size = 0
        # first window id of each target (``_create_windows``)
        self._first_window_id: List[int] = []
        # set when the streaming pipeline counted coverage already
        self._coverage_counted = False
        self.stage_walls: Dict[str, float] = {}
        # per-run metrics registry: every write also reaches the
        # process-wide REGISTRY; the --metrics-json report reads it
        self.metrics = Registry(parent=REGISTRY)
        self._t_run_start = None
        self.dummy_quality = b"!" * window_length
        self.engine = cpu.PoaEngine(match, mismatch, gap)
        self.logger = Logger()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.num_threads)

    def _wall(self, stage: str, t0: float) -> None:
        self.stage_walls[stage] = self.stage_walls.get(stage, 0.0) \
            + obs_trace.now() - t0

    # ------------------------------------------------------------------
    # initialize: reference src/polisher.cpp:191-459
    # ------------------------------------------------------------------

    def initialize(self) -> None:
        if self.windows:
            print("[racon_tpu_torch::Polisher::initialize] warning: "
                  "object already initialized!")
            return
        self.logger.log()
        t0 = self._t_run_start = obs_trace.now()
        with obs_trace.span("racon_tpu_torch.load_targets", cat="stage",
                            metric="host.parse_s", registry=self.metrics):
            self.tparser.reset()
            self.tparser.parse(self.sequences, -1)
        targets_size = len(self.sequences)
        if targets_size == 0:
            raise InvalidInputError("empty target sequences set!")
        self._targets_size = targets_size

        # names (PAF, SAM) and 0-based file ids (MHAP): id_to_id keys
        # are id << 1 | 1 for targets, id << 1 | 0 for reads
        name_to_id: Dict[str, int] = {}
        id_to_id: Dict[int, int] = {}
        for i in range(targets_size):
            name_to_id[self.sequences[i].name + "t"] = i
            id_to_id[i << 1 | 1] = i
        has_name = [True] * targets_size
        has_data = [True] * targets_size
        has_reverse_data = [False] * targets_size
        self.logger.log("[racon_tpu_torch::Polisher::initialize] loaded "
                        "target sequences")
        self.logger.log()

        # reads, with duplicate read-as-target dedup
        # (reference: src/polisher.cpp:228-263)
        sequences_size = 0
        total_sequences_length = 0
        with obs_trace.span("racon_tpu_torch.load_sequences", cat="stage",
                            metric="host.parse_s", registry=self.metrics):
            self.sparser.reset()
            while True:
                chunk_start = len(self.sequences)
                status = self.sparser.parse(self.sequences, CHUNK_SIZE)
                kept: List[Sequence] = []
                n_dropped = 0
                for i in range(chunk_start, len(self.sequences)):
                    seq = self.sequences[i]
                    total_sequences_length += len(seq.data)
                    existing = name_to_id.get(seq.name + "t")
                    if existing is not None:
                        if len(seq.data) != \
                                len(self.sequences[existing].data) or \
                                len(seq.quality) != \
                                len(self.sequences[existing].quality):
                            raise InvalidInputError(
                                f"duplicate sequence {seq.name} with unequal "
                                "data")
                        name_to_id[seq.name + "q"] = existing
                        id_to_id[sequences_size << 1 | 0] = existing
                        n_dropped += 1
                    else:
                        new_id = i - n_dropped
                        name_to_id[seq.name + "q"] = new_id
                        id_to_id[sequences_size << 1 | 0] = new_id
                        kept.append(seq)
                    sequences_size += 1
                del self.sequences[chunk_start:]
                self.sequences.extend(kept)
                if not status:
                    break
        if sequences_size == 0:
            raise InvalidInputError("empty sequences set!")

        n_total = len(self.sequences)
        has_name += [False] * (n_total - targets_size)
        has_data += [False] * (n_total - targets_size)
        has_reverse_data += [False] * (n_total - targets_size)
        window_type = (WindowType.NGS
                       if total_sequences_length / sequences_size <= 1000
                       else WindowType.TGS)
        self.window_type = window_type
        self.logger.log("[racon_tpu_torch::Polisher::initialize] loaded "
                        "sequences")
        self.logger.log()

        # parsed overlaps bill the parse budget; mapped ones the map
        # stage (host.map_s and stage_walls["map"], out of "parse")
        mapping = self.oparser is None
        with obs_trace.span("racon_tpu_torch.load_overlaps", cat="stage",
                            metric=("host.map_s" if mapping
                                    else "host.parse_s"),
                            registry=self.metrics):
            overlaps = self._load_overlaps(name_to_id, id_to_id, has_data,
                                           has_reverse_data)
        if mapping:
            self.stage_walls["map"] = float(
                self.metrics.value("host.map_s", 0.0))
        if not overlaps:
            raise InvalidInputError("empty overlap set!")
        self.logger.log("[racon_tpu_torch::Polisher::initialize] loaded "
                        "overlaps")
        self.logger.log()
        # materialise reverse complements in the pool
        # (reference: src/polisher.cpp:368-377)
        with obs_trace.span("racon_tpu_torch.transmute", cat="stage"):
            list(self._pool.map(
                lambda args: args[0].transmute(*args[1:]),
                [(s, has_name[j], has_data[j], has_reverse_data[j])
                 for j, s in enumerate(self.sequences)]))
        self._wall("parse", t0 + self.stage_walls.get("map", 0.0))

        t0 = obs_trace.now()
        with obs_trace.span("racon_tpu_torch.align_stage", cat="stage",
                            metric="stage_wall_s.align",
                            registry=self.metrics):
            self.find_overlap_breaking_points(overlaps)
        self._wall("align", t0)

        self.logger.log()
        t0 = obs_trace.now()
        with obs_trace.span("racon_tpu_torch.build_windows", cat="stage"):
            self._build_windows(targets_size, window_type, overlaps)
        self._wall("windows", t0)
        self.logger.log("[racon_tpu_torch::Polisher::initialize] "
                        "transformed data into windows")

    def _map_device(self):
        """Where the mapper builds its seed words: numpy on the host,
        as the JAX package does.  The CUDA polisher seeds on its own
        device."""
        from racon_tpu_torch.overlap import minimizers

        return minimizers.NUMPY

    def _discover_overlaps(self) -> List[Overlap]:
        """Internal mapping: run the minimap-lite mapper over the
        loaded reads and targets and return PAF-shaped Overlap records
        for the transmute/filter loop a parsed file takes.  Reads
        deduplicated into targets are not mapped: their only admissible
        overlap (self vs self) is what the ``q_id == t_id`` filter drops
        anyway."""
        from racon_tpu_torch.obs import decision as obs_decision
        from racon_tpu_torch.overlap import chain as overlap_chain

        params = overlap_chain.params_from_env(self._map_device())
        targets = self.sequences[:self._targets_size]
        queries = self.sequences[self._targets_size:]
        # contig polishing keeps one overlap per read: the mapper's best
        # chain, not the longest stretched span (overlap/chain.py)
        raw, stats = overlap_chain.map_sequences(
            queries, targets, params=params,
            primary_only=self.type == PolisherType.kC)
        dropped = stats["chains_admitted"] - len(raw)
        self.metrics.add("map_queries", len(queries))
        self.metrics.add("map_overlaps", len(raw))
        self.metrics.add("map_chains_admitted", stats["chains_admitted"])
        self.metrics.add("map_chains_rejected", stats["chains_rejected"])
        self.metrics.add("map_secondary_dropped", dropped)
        obs_decision.DECISIONS.record(
            "map_chain", queries=len(queries), targets=len(targets),
            overlaps=len(raw), admitted=stats["chains_admitted"],
            rejected=stats["chains_rejected"], secondary_dropped=dropped,
            masked_entries=stats["masked_entries"], knobs=params.doc(),
            seed_device=str(params.seed_device))
        self.logger.log(
            f"[racon_tpu_torch::Polisher::initialize] mapped "
            f"{len(queries)} reads -> {len(raw)} overlaps "
            f"({stats['chains_rejected']} chains rejected)")
        return raw

    def _load_overlaps(self, name_to_id, id_to_id, has_data,
                       has_reverse_data) -> List[Overlap]:
        """Stream overlaps, transmute, and filter (polisher.cpp:283-354)."""
        if self.oparser is None:
            # internal mapping: the same loop, fed from an in-memory
            # single-chunk source instead of a file parser
            self.oparser = _MappedOverlapSource(self._discover_overlaps())
        overlaps: List[Optional[Overlap]] = []

        def remove_invalid(begin: int, end: int) -> None:
            for i in range(begin, end):
                if overlaps[i] is None:
                    continue
                o = overlaps[i]
                if o.error > self.error_threshold or o.q_id == o.t_id:
                    overlaps[i] = None
                    continue
                if self.type == PolisherType.kC:
                    # keep only the longest overlap per query
                    for j in range(i + 1, end):
                        if overlaps[j] is None:
                            continue
                        if o.length > overlaps[j].length:
                            overlaps[j] = None
                        else:
                            overlaps[i] = None
                            break

        self.oparser.reset()
        l = 0
        while True:
            status = self.oparser.parse(overlaps, CHUNK_SIZE)
            c = l
            for i in range(l, len(overlaps)):
                overlaps[i].transmute(self.sequences, name_to_id, id_to_id)
                if not overlaps[i].is_valid:
                    overlaps[i] = None
                    continue
                while overlaps[c] is None:
                    c += 1
                if overlaps[c].q_id != overlaps[i].q_id:
                    remove_invalid(c, i)
                    c = i
            if not status:
                remove_invalid(c, len(overlaps))
                c = len(overlaps)
            for i in range(l, c):
                if overlaps[i] is None:
                    continue
                if overlaps[i].strand:
                    has_reverse_data[overlaps[i].q_id] = True
                else:
                    has_data[overlaps[i].q_id] = True
            # compact nulls from l onward (reference shrinkToFit,
            # src/polisher.cpp:348-349)
            n_removed_before_c = sum(1 for o in overlaps[l:c] if o is None)
            overlaps[l:] = [o for o in overlaps[l:] if o is not None]
            l = c - n_removed_before_c
            if not status:
                break
        return overlaps  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # breaking points (reference: src/polisher.cpp:461-483)
    # ------------------------------------------------------------------

    def _batch_decode_breaking_points(self,
                                      overlaps: List[Overlap]) -> None:
        """Decode the breaking points of every overlap that already
        carries ``cigar_runs`` (SAM input, the device ladder's pairs)
        in slab-sized vectorized batches over the pool; ``work(o)``
        then finds its points set.  A slab that fails is left
        undecoded, so the per-overlap path raises for the record at
        fault alone."""
        slabs = overlap_mod.iter_decode_slabs(overlaps)

        def one(slab):
            try:
                with self.metrics.timer("host.bp_decode_s"):
                    overlap_mod.decode_breaking_points_batch(
                        slab, self.window_length)
            except Exception:
                pass

        if len(slabs) > 1 and self.num_threads > 1:
            list(self._pool.map(one, slabs))
        else:
            for slab in slabs:
                one(slab)

    def find_overlap_breaking_points(self, overlaps: List[Overlap]) -> None:
        self._batch_decode_breaking_points(overlaps)

        def work(o: Overlap) -> None:
            o.find_breaking_points(self.sequences, self.window_length,
                                   aligner=cpu.align)
            self._notify_overlap_done(o)

        self._run_pooled([(work, (o,)) for o in overlaps],
                         "[racon_tpu_torch::Polisher::initialize] "
                         "aligning overlaps",
                         "[racon_tpu_torch::Polisher::initialize] "
                         "aligned overlaps")

    def _run_pooled(self, tasks, bar_message: str,
                    done_message: str) -> list:
        """Fan tasks over the pool with the reference's 20-bin bar."""
        futures = [self._pool.submit(fn, *args) for fn, args in tasks]
        results = []
        step = len(futures) // 20
        for i, f in enumerate(futures):
            results.append(f.result())
            if step != 0 and (i + 1) % step == 0 and (i + 1) // step < 20:
                self.logger.bar(bar_message)
        if step != 0:
            self.logger.bar(bar_message)
        else:
            self.logger.log(done_message)
        return results

    def _notify_overlap_done(self, o: Overlap) -> None:
        """Per-overlap completion hook, fired (possibly from a pool
        thread) once ``o.breaking_points`` exists.  The base pipeline
        does nothing; the CUDA polisher's streaming pipeline routes the
        overlap's fragments through its window ledger."""

    # ------------------------------------------------------------------
    # windowing (reference: src/polisher.cpp:383-456)
    # ------------------------------------------------------------------

    def _create_windows(self, targets_size: int,
                        window_type: WindowType) -> None:
        """Backbone windows of every target.  Idempotent: the streaming
        pipeline creates them before the align stage, the staged path
        here."""
        if self.windows:
            return
        w = self.window_length
        first_window_id = [0] * (targets_size + 1)
        for i in range(targets_size):
            data = self.sequences[i].data
            quality = self.sequences[i].quality
            k = 0
            for j in range(0, len(data), w):
                length = min(j + w, len(data)) - j
                q = (self.dummy_quality[:length] if not quality
                     else quality[j:j + length])
                self.windows.append(Window(i, k, window_type,
                                           data[j:j + length], q))
                k += 1
            first_window_id[i + 1] = first_window_id[i] + k
        self._first_window_id = first_window_id
        self.targets_coverages = [0] * targets_size

    def _overlap_window_fragments(self, o: Overlap):
        """Yield ``(window_id, data, quality, begin, end)`` for every
        breaking-point pair of ``o`` that passes the length and quality
        filters: the staged routing rule, per overlap, so that the
        streaming seam can route overlaps as they complete.  The caller
        clears ``o.breaking_points``."""
        points = o.breaking_points
        if points is None or len(points) == 0:
            return
        w = self.window_length
        sequence = self.sequences[o.q_id]
        # reverse_quality exists iff transmute materialised it
        has_quality = bool(sequence.quality) or \
            bool(sequence._reverse_quality)
        quality_src = (sequence.reverse_quality if o.strand
                       else sequence.quality)
        data_src = (sequence.reverse_complement if o.strand
                    else sequence.data)
        pts = np.asarray(points, dtype=np.int64)
        t_first, q_first = pts[0::2, 0], pts[0::2, 1]
        t_last, q_last = pts[1::2, 0], pts[1::2, 1]
        keep = (q_last - q_first) >= 0.02 * w
        if has_quality and quality_src:
            idx = np.flatnonzero(keep)
            if idx.size:
                # mean fragment quality from prefix sums (exact: sums
                # stay far below 2^53)
                prefix = np.concatenate(([0], np.cumsum(
                    np.frombuffer(quality_src, np.uint8)
                    .astype(np.int64))))
                total = prefix[q_last[idx]] - prefix[q_first[idx]]
                count = q_last[idx] - q_first[idx]
                keep[idx] = ~((total / count - 33)
                              < self.quality_threshold)
        first_wid = self._first_window_id[o.t_id]
        for j in np.flatnonzero(keep).tolist():
            tf, tl = int(t_first[j]), int(t_last[j])
            qf, ql = int(q_first[j]), int(q_last[j])
            window_start = (tf // w) * w
            yield (first_wid + tf // w, data_src[qf:ql],
                   quality_src[qf:ql] if quality_src else None,
                   tf - window_start, tl - window_start - 1)

    def _build_windows(self, targets_size: int, window_type: WindowType,
                       overlaps: List[Overlap]) -> None:
        """Create the windows (unless the streaming pipeline did) and
        route every overlap it has not routed; coverage is counted
        here unless the pipeline counted it."""
        self._create_windows(targets_size, window_type)
        with self.metrics.timer("host.fragment_s"):
            for o in overlaps:
                if not self._coverage_counted:
                    self.targets_coverages[o.t_id] += 1
                if o.breaking_points is None or \
                        len(o.breaking_points) == 0:
                    # routed by the streaming seam (the ROUTED sentinel)
                    # or no points at all
                    continue
                for wid, data, quality, begin, end in \
                        self._overlap_window_fragments(o):
                    self.windows[wid].add_layer(data, quality, begin, end)
                o.breaking_points = None

    # ------------------------------------------------------------------
    # consensus + polish (reference: src/polisher.cpp:485-547)
    # ------------------------------------------------------------------

    def _consensus_cached(self, window, epoch=None):
        """One window's consensus on the CPU engine through the result
        cache (racon_tpu_torch/cache): a hit adopts the cached bytes, a
        miss computes and fills.  Returns ``(polished flag, hit)``.
        Windows under 3 layers bypass the cache (the backbone copy is
        cheaper than a lookup).  The "cpu" key space is disjoint from
        the POA kernel's: the two engines break ties independently."""
        from racon_tpu_torch import cache as rcache

        if len(window.sequences) < 3 or not rcache.enabled():
            return window.generate_consensus(self.engine, self.trim), False
        with REGISTRY.timer(rcache.HOST_S):
            c = rcache.result_cache()
            if epoch is None:
                epoch = rcache.keying.engine_epoch()
            key = rcache.keying.poa_key(
                "cpu", (self.match, self.mismatch, self.gap), self.trim,
                window, epoch)
            v = c.get(key)
        if v is not rcache.MISS:
            cons, ok = v
            window.consensus = cons
            return bool(ok), True
        ok = window.generate_consensus(self.engine, self.trim)
        with REGISTRY.timer(rcache.HOST_S):
            c.put(key, (window.consensus, ok))
        return ok, False

    @staticmethod
    def _cache_epoch():
        """The result cache's epoch, fetched once per stage (None when
        the cache is off)."""
        from racon_tpu_torch import cache as rcache

        return rcache.keying.engine_epoch() if rcache.enabled() else None

    def generate_consensuses(self) -> List[bool]:
        """Consensus of every window on the CPU engine, through the
        result cache; returns the polished flags."""
        epoch = self._cache_epoch()
        return self._run_pooled(
            [(lambda w=w: self._consensus_cached(w, epoch)[0], ())
             for w in self.windows],
            "[racon_tpu_torch::Polisher::polish] generating consensus",
            "[racon_tpu_torch::Polisher::polish] generated consensus")

    def polish(self, drop_unpolished_sequences: bool) -> List[Sequence]:
        self.logger.log()
        t0 = obs_trace.now()
        with obs_trace.span("racon_tpu_torch.consensus_stage", cat="stage",
                            metric="stage_wall_s.consensus",
                            registry=self.metrics):
            polished_flags = self.generate_consensuses()
        self._wall("poa", t0)

        t0 = obs_trace.now()
        dst: List[Sequence] = []
        start = 0
        with self.metrics.timer("host.stitch_s"):
            for i in range(len(self.windows)):
                if i != len(self.windows) - 1 and \
                        self.windows[i + 1].rank != 0:
                    continue
                lo, hi = start, i + 1
                start = i + 1
                window = self.windows[hi - 1]
                n_polished = sum(1 for k in range(lo, hi)
                                 if polished_flags[k])
                polished_ratio = n_polished / (window.rank + 1)
                if drop_unpolished_sequences and not polished_ratio > 0:
                    continue
                data = b"".join(self.windows[k].consensus
                                for k in range(lo, hi))
                tags = "r" if self.type == PolisherType.kF else ""
                tags += f" LN:i:{len(data)}"
                tags += f" RC:i:{self.targets_coverages[window.id]}"
                tags += f" XC:f:{polished_ratio:.6f}"
                dst.append(Sequence(self.sequences[window.id].name + tags,
                                    data))
        self._wall("stitch", t0)
        self._finish_host_budget()
        self.windows = []
        self.sequences = []
        return dst

    def _finish_host_budget(self) -> None:
        """The run's host budget gauges (racon_tpu/core/polisher.py:
        755-781): ``host.stage_s``, the host stages' seconds (CPU
        seconds: stages on the pool can sum past the wall), and
        ``host.share``, their share of the run wall; and each host
        stage's drift against its own learned per-unit rate."""
        host_s = sum(float(self.metrics.value(k, 0.0))
                     for k in ("host.parse_s", "host.map_s",
                               "host.bp_decode_s", "host.fragment_s",
                               "host.stitch_s"))
        self.metrics.set("host.stage_s", round(host_s, 6))
        units = {"host.parse": len(self.sequences),
                 "host.map": int(self.metrics.value("map_queries", 0)),
                 "host.bp_decode": len(self.sequences),
                 "host.fragment": len(self.windows),
                 "host.stitch": self._targets_size}
        for stage, n in units.items():
            wall = float(self.metrics.value(stage + "_s", 0.0))
            if wall > 0:
                obs_calhealth.observe_units(stage, max(1, n), wall,
                                            registry=self.metrics)
        if self._t_run_start is not None:
            wall = obs_trace.now() - self._t_run_start
            if wall > 0:
                self.metrics.set("host.share",
                                 round(min(1.0, host_s / wall), 6))

    def total_log(self) -> None:
        self.logger.total("[racon_tpu_torch::Polisher::] total =")

    def close(self) -> None:
        """Release the worker pool and the parsers' file handles."""
        self._pool.shutdown(wait=True)
        for parser in (self.sparser, self.oparser, self.tparser):
            if parser is not None:
                parser.close()
