#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (racon_tpu_torch).

    python3 chip_smoke.py [--genome-len N] [--threads T] [--work DIR]
                          [--only band|wfa|default|traced|map|cache|
                                  fusion|serve|fleet|lockstep|scan]
                          [--keep DIR]

Needs one CUDA card.  Phases, one JSON line each:

1. env          card name and power limit, torch and CUDA versions;
2. build        nvcc builds every kernel from the checkout's sources,
                all started together while the dataset is simulated
                (a thread waits on them), with ptxas registers and spills
                (a missing report or a spill in any kernel fails the
                run), the POA kernel's dynamic shared memory and
                resident blocks per pass, and the band kernel's shared
                memory and resident pairs at wb 2048 and 4096;
3. dataset      simulates an E. coli-sized ONT set (4,641,652 bp,
                30x, 8 kb reads, seed 7) and cuts a 120 kb region of
                it whose windows and overlaps feed the checks below;
4. kernel_check 32 real windows at stock caps (V 2048, LP 1024,
                WB 256), timed, 3 of them spread over the depth
                range (evenly by layer count, the deepest among them)
                also alone, plus
                tiny windows (a forced reject and the three
                stress windows of tools/poa_windows.py, which take the
                kernel's device-memory pred and row paths and its
                second pass): the POA
                kernel and its plain PyTorch version on the card must
                agree exactly on cons[:len], mout[:, :5] and the
                shared-memory path counts on the 3 and the tiny
                windows, and the 3's kernel rows must equal theirs in
                the batch of 32; then a full-card batch, the
                region's fitting windows tiled to >= 4x the kernel's
                resident blocks, every replica equal to its original,
                with ms, windows/s, ring hit rate and phase shares; and
                the same for the windows of a deeper set (50 kb at
                60x), with the share of windows past the first pass or
                the cap and one second-pass window held against the
                plain version;
5. align_check  32 real overlaps of the region at their real lengths:
                the WFA kernel (emax 2048) and the banded kernel (wb
                2048, proportional knots, its plain version on 11 of
                them spread over the shorter half; wb 4096 on measured
                knots for 8 of them spread over all lengths up to the
                longest) against their plain versions, plus
                tiny edge cases and the constructed pairs of
                tools/wfa_pairs.py (WFA edge paths, emax 128) and
                tools/band_pairs.py (forced band steps); WFA meta and
                tape[:n], band distance and, below BIG, move count and
                moves must agree exactly, and every certified WFA
                distance must be the native edit distance; both
                kernels' two-phase cycle splits and the band kernel's
                time at 1-8 warps per pair;
   band_card    the band-only cell: the region's overlap pairs on
                measured knots at wb 4096, replicated to 1,024 pairs in
                one launch; ms, pairs/s, cells, bound, phase split and
                the warps sweep; every replica must equal its original
                and 8 originals the plain version;
   wfa_card     the WFA-only cell: the region's overlap pairs at emax
                2048, replicated to 1,024 pairs (one main-path chunk)
                in one launch; ms, pairs/s, wavefront cells, bound, the
                history-bytes floor and the step/traceback split; every
                replica must equal its original and 8 originals the
                plain version;
6. polish       (the cache phase's cold run, below) the port's CLI
                (-m 5 -x -4 -g -8 -c 1
                --cudaaligner-batches 1) on the whole set, staged and
                all on the card (RACON_TPU_TORCH_PIPELINE=0 and both
                *_DEVICE_ONLY=1): all three kernels launched, CPU
                fall-through <= 10% of the device-eligible overlaps,
                POA rejects <= 10% of eligible windows, polished
                distance to truth <= draft distance / 10; with every
                kernel's summed phase cycles and main-path bound;
   traced       the staged polish again with --trace and --metrics-json:
                the FASTA must equal phase 6's; per engine (poa,
                align_wfa, align_band) the report's device busy, idle,
                util and dispatches, which must equal the engine's
                launches, and the summed device-lane intervals of the
                trace, which must agree with the polisher's CUDA-event
                kernel ms within 1% or 0.1 ms; every lane span inside
                the run span and between its launch's and its
                collect's host times (1 ms + 100 ppm); each engine's and
                all engines' idle share of the racon_tpu_torch.run span
                (1 - union of the lane intervals / the span); the
                traced wall against phase 6's;
   long_cap     a 20,000-base pair among 12 short ones, the align stage
                on the card, at the default cap (pair on the CPU) and at
                RACON_TPU_TORCH_MAX_ALIGN_DIM=32768 (pair on a band
                rung): identical FASTA, the pair certified on the card;
   lockstep_check  the lockstep POA kernel (windows past the whole-
                window kernel's caps) against its plain version on the
                card: the rounds a -w 1000 batch of 8 region windows
                (spread over depth) exports, the first, middle and last,
                at the auto band (wb 512) and with -b (wb 256), the
                middle auto round widened (its layers at bands of 1,024
                to 16,384 columns, walked tile by tile; its lanes of
                layers up to 1,024 bases at 1,025 columns unbanded),
                both middle rounds' lanes tiled to 500 in one launch
                (kernel only, each lane held to its plain tapes), every
                round of the tiny windows at caps that take the
                unbanded kernel (l_b 128), and a constructed round whose
                preds lag 5 or more band quanta (wb 32); node and seq
                tapes must agree exactly; per round the CUDA-event ms
                (median of 5), the plain ms, the DP cells, the bound
                and the kernel's phase split (a timed launch's clock64()
                cycles per phase, cycles a rank, the deepest lane's);
   polish_w1000 the port's CLI at -w 1000 (caps V 4096, LP 2048: every
                megabatch takes the lockstep engine), staged, all on the
                card, cache off, on the first 500 kb, then with -b:
                walls, stage walls, lockstep rounds and
                phase walls, launches (the lockstep kernel's > 0, the
                whole-window kernel's 0), rejects by code (vcap, pcap,
                kcap), distance to the truth <= draft / 10; phase 6's
                -w 500 polish must have run 0 lockstep rounds;
   polish_wlong the port's CLI at -w 20000 -T (refused before the
                kernel walked a row tile by tile), staged, all on the
                card, cache off, on a 41.5 kb 7x set of 25 kb reads:
                launches, rounds, every round's columns (one past 4,096
                at least), rejects by code, the kernel's ms, the lane of
                fewest rows of the rounds past 4,096 columns held
                against its plain version, distance to the truth below
                the draft's and <= the native CPU engine's at the same
                flags x 1.01 (its polish a process on the host beside
                lockstep_check; racon's POA does not reach draft / 10 at
                that -w on these sets);
   scan_check   the scan ladder's two kernels (align_scan.cu; the JAX
                package's scan kernels, its device path off a TPU)
                against their plain versions on the card: the banded
                kernel at the ladder's rungs (hw 512 on 6 region pairs
                of at most 4,096 bases spread over length, bucket 8,192;
                hw 2,048 on 2 of those and hw 8,192 on the 6, bucket
                16,384) and the full kernel (the 6, bucket
                8,192), at their real lengths, the lanes padded to a
                power of two as the ladder pads them, plus the edge
                pairs of tools/scan_pairs.py (bucket 1,024; hw 0, 7 and
                512); op tapes must agree exactly, some lane must run
                past its band; per row the CUDA-event ms (median of 5),
                the plain ms, the cells, the bound, the direction
                tape's bytes and the banded or full kernel's sweep /
                traceback clock64() cycle split;
   scan_card    kernel only: scan_check's hw 2,048 region pairs tiled
                to 64 lanes (a main-path launch) and to 1,024 in one
                launch; every lane's tape must equal its pair's tape
                checked in scan_check (no new plain run); the ms
                (median of 3) against the tiled cells' bound, and the
                cycle split;
   scan_full_card  the same for scan_check's full-kernel region row
                tiled to 1,024 lanes in one launch (the bound from the
                full kernel's Myers word steps);
   polish_scan  the CLI (-c 1 --cudaaligner-batches 1) on the first Mb
                with RACON_TPU_TORCH_SCAN_ALIGN=1 and the align stage
                all on the card: distance to the cut's truth <= draft /
                10, stage walls, launches of both scan kernels (when the
                set sends no pair to the full kernel, a short-pair
                bucket through ``CudaBatchAligner`` does, a path of its
                own with its counts set to 0 just before it: 8 region
                pairs cut to 1,500 bases and 8 unrelated ones, every
                distance the native engine's; the kernels line's
                align_scan_full launches are then that run's), no WFA
                or band launch, the main path's cells and bound;
   polish_portable  the same CLI with RACON_TPU_TORCH_PORTABLE=1 on the
                first 250 kb, both stages all on the card: scan and
                lockstep launches together, no whole-window POA launch,
                distance <= draft / 10;
   polish_default  the same CLI at the port's defaults (streaming
                pipeline, device/CPU splits of both stages), twice, in
                a fresh calibration store under the work directory:
                the first run, on the whole set at the built-in rates,
                stores generation 1, the second, on the first 1 Mb,
                reads it and is traced (a ``traced`` line with the same
                lane checks and idle shares); a third run as the second
                but
                with the align stage all on the card
                (RACON_TPU_TORCH_ALIGN_DEVICE_ONLY=1), which splits the
                default path's wall between its parts.  Each: walls,
                both cuts, the rates and their source, per-rung chunk
                walls, speculative windows used and wasted, the
                ledger's ready high-water, the pipeline overlap, the
                stored rates and the distance (<= draft / 10); every
                kernel launched; the second and third runs' first 1 Mb
                is the cut pipeline_bytes polishes at the same rates,
                their distance against that cut's truth;
   cache        the result cache on the staged polish of the whole
                set: cold (``cache_host_s`` the keying, lookups and
                fills) and a warm repeat in the same process: each
                run's wall, launches, cache counters and bytes; both
                byte-identical at the staged distance, the warm run
                hits; then (after fusion, on its first 500 kb cut, a
                ``cache`` line with ``part: persist``) a cold fill
                with RACON_TPU_TORCH_CACHE_PERSIST=<work>/results and,
                after ``cache.reset()``, a restart that reads the
                segments: both byte-identical to fusion's solo run of
                that cut (staged, cache off), the restart hits the disk
                (the cache off against on: ``--only cache`` and the
                persistent part);
   fusion       the device executor on the card: two 500 kb cuts of
                the set (its first two 500 kb), staged, cache off,
                each alone, then both in threads as two registered
                tenants, fused: each one's bytes equal to its solo run,
                fused_cross_tenant > 0, the fused launches against the
                solo launches summed, the walls, the occupancy
                histogram, and the process DEVICE_UTIL's dispatches equal
                to the launches; then a poisoned unit: tenant b submits a
                WFA chunk with a pair past the rung's length beside
                tenant a's first chunk, the fused dispatch fails, a's
                unit retries alone on the card and a's polish keeps its
                bytes, and only b's collect raises;
   serve        the port's serve daemon (``serve --jobs 2``) in a
                subprocess on the card, one ``serve`` line per part:
                ``cold_warm``, the fusion phase's first 500 kb cut
                submitted twice, staged, cache off, at the polish's
                megabatch size (RACON_TPU_TORCH_POA_MEGABATCH): both
                jobs' bytes equal the fusion phase's solo run of the
                cut, job 2 reports 0 kernel builds and 0 loads, each
                job's wall and launches beside the one-shot's;
                ``tenants``, the fusion phase's two 500 kb cuts alone, then
                submitted together as two tenants: each one's bytes
                equal its solo job's, with the fused dispatches, the
                occupancy and the per-tenant waits; ``default``, a
                default-path job on the first cut at the built-in rates,
                pinned, whose bytes equal a one-shot run of the same
                pins; ``sigkill``, a journaled daemon armed with
                RACON_TPU_TORCH_FAULT=mid-megabatch:2 dies by SIGKILL on
                the first cut (megabatches of SERVE_KILL_MEGABATCH
                windows), a restart on the same socket and journal
                answers the keyed resubmit with the cut's staged
                cache-off bytes, recovered_jobs 1 and
                poa_resumed_windows > 0.  A failed job fails the phase;
   fleet        the fleet: the set's first 2 Mb cut into four contiguous
                draft regions of 500 kb with their reads, joined into one
                four-contig job (tools/simulate.py:concat_sets); two
                backend daemons on the card (``--jobs 1``, staged, cache
                off, RACON_TPU_TORCH_POA_MEGABATCH pinned), a third armed
                with RACON_TPU_TORCH_FAULT=mid-megabatch:1, and routers
                (``route``, straggler replacements off) in front of two of
                them, one ``fleet`` line per part: ``routed``, the job
                whole through the router (distance <= draft / 10, its
                backend and the ``route`` event that placed it, wall,
                launches); ``scattered``, the failover part's two-contig
                job as two staged target shards (bytes equal the routed
                job's first two records, each shard's backend, wall and
                skipped parse bytes, the gather's wall); ``failover``,
                the first two contigs as one job (their own concat_sets
                job) through the armed backend and a survivor (the armed
                one dies after its first megabatch, route_failover >= 1,
                the survivor's journal holds the dead shard under its
                key, the bytes equal the routed job's first two
                records);
                ``ranks``, the one-shot CLI on that two-contig job as two
                processes at once with RACON_TPU_TORCH_NPROC=2 (rank 0
                then rank 1 equal the same records); ``fleet_metrics``,
                ``metrics --fleet A,B --json``: the merged kernel launch
                counters equal the two daemons' summed, every merged
                histogram's p50/p90/p99 equal ``merge_snapshots``'s;
                ``wrapper_split``, the port's wrapper
                (racon_tpu_torch/tools/wrapper.py) in a subprocess under
                the backends' staged environment, on the failover part's
                two-contig job, ``--split`` at the larger contig's bytes
                (two chunks of one contig), ``-c 1
                --cudaaligner-batches 1 -t <threads>``: one one-shot CLI
                process per chunk, its bytes equal the routed job's
                first two records, each chunk's device poa and align
                seconds from its stderr > 0, no read with overlaps on
                two contigs, the wall; ``wrapper_served``, the wrapper
                with ``--server <router>`` on the failover part's
                two-contig job, ``--split`` at the larger contig's
                bytes: the router scatters it (shards=auto, two winners
                on its flight), the bytes equal the routed job's first
                two records, then the same invocation again, answered by
                the backends' journals (0 jobs run, 2 dedup hits) with
                the same bytes; ``inspect_fleet``,
                ``inspect --fleet <failover router> --job-key
                fleet-failover --json --trace-out``: a complete lineage
                (the root, both shard keys, the failover edge of shard
                0, both gathers), each daemon's clock offset and
                confidence, the merged trace's flow events > 0, and the
                text timeline's lane per daemon (3); ``top_fleet``,
                ``top --fleet <router> --once --json``: the router's row
                with both backends under it, and merged counters equal
                to ``metrics --fleet <router>,A,B --json`` taken next;
                ``explain``, ``explain --socket <backend> --job <the
                routed job>`` (JSON and text) and ``explain
                --metrics-json`` on a wrapper chunk's run report: each
                waterfall's stage walls within 1% of its report's;
                ``fleet_card``, each backend's max_memory_reserved, the
                card's compute processes as nvidia-smi lists them, and
                the processes with a /dev/nvidia<N> node open, sampled
                through the phase: both backends, never a router;
   pipeline_bytes  the first 1 Mb of the set at the second run's
                stored rates, pinned: pipeline off, then on, then on and
                traced; the FASTA must be byte-identical;
   map_rounds   reads + draft with no PAF (the mapper):
                ``seed_words``: the seed-word kernel, its plain version
                on the card and numpy on every buffer the mapper seeds
                at k 13 (the reads in batches of up to 2^26 bases, then
                the draft) and on a 1 Mb cut at k 5 and 15, 0
                mismatches, with the kernel's ms (its buffers made
                before the timing), bound, the conv1d
                yardstick, the copies and numpy; then (``--only map``
                alone) the CLI at the
                defaults with no PAF, --rounds 2 with --metrics-json on
                the whole set: per round wall,
                map_s, overlaps, recall >= 0.95 and precision >= 0.90
                against truth.json, distance <= draft / 10, stage
                walls, launches and result-cache hits (round 2 reuses
                round 1's unmoved windows and pairs), every kernel
                launched, and the seed kernel's main-path ms from its
                device lane and its bound on round 1's buffers
                (``seed_round1_bound``); then on the
                first 500 kb --rounds 1 with the words built on the card
                and --rounds 2 with them built by numpy, whose round 1
                must map the same overlaps and write the same bytes
                (``map_seed_bytes``); ``--only map`` also maps the whole
                set with every chain emitted, as the JAX package does
                (``map_quality``);
7. native_compare  200 region windows on the POA kernel and on the
                native CPU engine: summed edit distance between the two;
8. kernels      every ported kernel with its launches in phase 6 (the
                seed-word kernel's in map_rounds' 500 kb --rounds 1
                run, the lockstep kernel's in polish_w1000's first
                run; its ms, plain ms and bound summed over
                lockstep_check's three auto-band rounds; the scan
                kernels' in polish_scan, their ms, plain ms and bound
                from scan_check's hw 2,048 row and its full-kernel
                region row).

Then the card's line as nvidia-smi prints it and the result line.  Any
failure raises and the script exits non-zero without a result line.
``--only band`` (``--only wfa``) runs phases 1-3, align_check and
band_card (wfa_card), then exits 0 without the result line (a few
minutes: a trial of one align kernel); ``--only default`` runs phases
1-3, polish_default and pipeline_bytes the same way, ``--only traced``
phases 1-3, the staged polish, traced and long_cap, ``--only map``
phases 1-3 and map_rounds, ``--only cache`` phases 1-3, cache, its
persistent part (against the cut's own cache-off run) and
``cache_default`` (the default path with the cache off, on, on, off,
twice; the same bytes), ``--only fusion`` phases 1-3 and fusion,
``--only serve`` phases 1-3, the staged polish and serve, ``--only
fleet`` phases 1-3 and fleet, ``--only lockstep`` phases 1-3,
lockstep_check, polish_w1000 and polish_wlong, ``--only scan`` phases 1-3,
scan_check, scan_card, scan_full_card, polish_scan and polish_portable.
``--keep DIR``
copies the traced runs' traces and reports to DIR (open a trace in
Perfetto).  The
calibration store is off (``RACON_TPU_TORCH_CACHE_DIR=""``) outside
polish_default.  The result cache is on (the default), and every
counted polish starts from an empty in-process cache with the
persistent tier off, as a fresh process would (inside one ``--rounds
2`` run the cache carries from round 1 to round 2); the cache phase
alone sets it otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the script's start: every line carries its seconds since then (at_s)
T0 = time.perf_counter()
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# H100 SXM ceilings: HBM bytes/s from NVIDIA's data sheet; int32 ALU
# operations/s from the Hopper architecture white paper's SM (64 INT32
# lanes of 132 SMs at the 1.98 GHz boost clock: 16.7 T ops/s); float32
# operations/s from its 128 FP32 lanes (33.5 T ops/s: an add, a max or
# a compare is one; the data sheet's 67 TFLOP/s counts an FMA as two)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9
# The operation counts below are the least int32 ALU work of each
# function per DP cell, whatever kernel computes it: no loads, stores,
# address arithmetic or scan overhead.
# POA (score H[j] of a graph node at band column j): substitution 2
# (compare, select), the diagonal and vertical candidates 2 (adds),
# their max 1, the gap chain max(M[j], H[j-1] + gap) 2, the direction
# code 4 (two compares, two selects), clip and pack 4 (min, max, shift,
# or)
OPS_PER_CELL = 15
# POA, per cell and per pred row past a rank's first: the compare and
# the selects of the max and of its slot
OPS_PER_EXTRA_PRED = 3
# lockstep POA (one rank's float32 score at one column, as the JAX
# kernels; a plain uint8 direction code, nothing clipped or packed):
# int32, the substitution 2 (compare, select) and the direction code's
# two selects 2; float32, the diagonal and vertical candidates 2
# (adds), their max 1, the gap chain max(T[j], H[j-1] + gap) 2 and the
# direction code's two compares 2
LOCKSTEP_INT_OPS_PER_CELL = 4
LOCKSTEP_FP32_OPS_PER_CELL = 7
# lockstep POA, per cell and per pred row past a rank's first: its two
# candidates (adds) and their two maxes, float32
LOCKSTEP_FP32_OPS_PER_EXTRA_PRED = 4
# WFA (one diagonal at one step): the substitution and gap candidates 2
# (adds), their max 2, the clip to both sequence ends 2, one compare
# that ends the extension 1
OPS_PER_WFA_CELL = 7
# band (one query row at one band column): substitution compare 1, the
# diagonal and vertical candidates 2, their min 1, the in-row chain
# min(H[j], H[j-1] + 1) 2, the 2-bit direction 4 (two compares, two
# selects) and its packing 2 (shift, or)
OPS_PER_BAND_CELL = 12
# seed words (one k-mer start, built by rolling from its neighbour): the
# code's & 3 1, fw's shift, or and mask 3, rv's subtract, two shifts and
# or 4
OPS_PER_SEED_WORD = 8


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "at_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card_state() -> str:
    """SM clock, power draw, temperature and active throttle reasons,
    as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def read_fasta(path: str) -> bytes:
    with open(path, "rb") as fh:
        return b"".join(l.strip() for l in fh if not l.startswith(b">"))


def chunked_distance(seq: bytes, truth: bytes, cpu, step: int = 50_000,
                     k: int = 32) -> int:
    """Edit distance of ``seq`` to ``truth`` summed over segments cut
    at shared anchors: a 32-mer of the truth every ``step`` bases that
    occurs exactly once in the truth and once in ``seq`` within +-5% of
    the proportional position.  An upper bound of the global distance
    (equal when the optimal alignment runs through the anchors), at
    O(segment * D) instead of O(D^2) for a genome-sized D."""
    cuts_t, cuts_s = [0], [0]
    scale = len(seq) / max(1, len(truth))
    slack = max(1000, int(0.05 * step))
    for pos in range(step, len(truth) - step, step):
        kmer = truth[pos:pos + k]
        if truth.count(kmer) != 1:
            continue
        guess = int(pos * scale)
        lo = max(cuts_s[-1], guess - slack)
        hit = seq.find(kmer, lo, guess + slack + k)
        if hit < 0 or seq.find(kmer, hit + 1, guess + slack + k) >= 0:
            continue
        cuts_t.append(pos)
        cuts_s.append(hit)
    cuts_t.append(len(truth))
    cuts_s.append(len(seq))
    return sum(cpu.edit_distance(seq[cuts_s[i]:cuts_s[i + 1]],
                                 truth[cuts_t[i]:cuts_t[i + 1]])
               for i in range(len(cuts_t) - 1))


def cut_region(src: str, dst: str, length: int, start: int = 0) -> tuple:
    """The draft's ``length`` bases from ``start`` with the reads whose
    PAF records fall inside them (target coordinates shifted by
    ``start``), as (reads, paf, draft) paths."""
    os.makedirs(dst, exist_ok=True)
    draft = read_fasta(os.path.join(src, "draft.fasta"))[start:start
                                                          + length]
    names, paf_lines = set(), []
    with open(os.path.join(src, "reads2draft.paf"), "rb") as fh:
        for line in fh:
            f = line.split(b"\t")
            if int(f[7]) >= start and int(f[8]) <= start + length:
                f[6] = b"%d" % length
                f[7] = b"%d" % (int(f[7]) - start)
                f[8] = b"%d" % (int(f[8]) - start)
                names.add(f[0])
                paf_lines.append(b"\t".join(f))
    paths = tuple(os.path.join(dst, n) for n in
                  ("reads.fastq", "reads2draft.paf", "draft.fasta"))
    with open(os.path.join(src, "reads.fastq"), "rb") as fh, \
            open(paths[0], "wb") as out:
        while True:
            rec = [fh.readline() for _ in range(4)]
            if not rec[0]:
                break
            if rec[0][1:].strip() in names:
                out.write(b"".join(rec))
    with open(paths[1], "wb") as out:
        out.write(b"".join(paf_lines))
    with open(paths[2], "wb") as out:
        out.write(b">draft\n" + draft + b"\n")
    return paths


def tiny_windows(rng: random.Random, wtype):
    """Small synthetic windows, plus one whose unrelated layers
    overflow a 256-node graph (a forced FAIL_VCAP reject)."""
    from racon_tpu_torch.core.window import Window

    def seq(n):
        return bytes(rng.choice(b"ACGT") for _ in range(n))

    def mutate(s, rate):
        out = bytearray()
        for ch in s:
            r = rng.random()
            if r < rate / 3:
                continue
            out.append(rng.choice(b"ACGT") if r < 2 * rate / 3 else ch)
            if r > 1 - rate / 3:
                out.append(rng.choice(b"ACGT"))
        return bytes(out)

    wins = []
    for k in range(6):
        truth = seq(rng.randrange(40, 80))
        bb = mutate(truth, 0.1)
        w = Window(0, k, wtype, bb, b"!" * len(bb))
        for d in range(rng.randrange(3, 7)):
            if k % 2 and d % 2:
                lo = rng.randrange(len(truth) // 3)
                hi = rng.randrange(2 * len(truth) // 3, len(truth))
                layer = mutate(truth[lo:hi], 0.1)
                span = (lo, min(hi, len(bb) - 1))
            else:
                layer = mutate(truth, 0.1)
                span = (0, len(bb) - 1)
            w.add_layer(layer, bytes(rng.randrange(40, 80)
                                     for _ in layer), *span)
        wins.append(w)
    bad = Window(0, 6, wtype, seq(120), b"!" * 120)
    for _ in range(4):
        bad.add_layer(seq(120), None, 0, 119)
    wins.append(bad)
    return wins


def cuda_ms(fn, reps: int, setup=None) -> list:
    """CUDA-event ms of ``reps`` calls of ``fn``; with ``setup``, each
    call is ``fn(setup())``, the setup (buffers) made before its first
    event."""
    import torch
    times = []
    for _ in range(reps):
        arg = setup() if setup is not None else None
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn() if setup is None else fn(arg)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def compare(kernel_out, plain_out) -> tuple:
    """(mismatching windows, max |difference|) over mout[:, :5] and
    cons[:len]."""
    kc, km = (t.cpu().numpy().astype("int64") for t in kernel_out)
    pc, pm = (t.cpu().numpy().astype("int64") for t in plain_out)
    bad, err = 0, 0
    for i in range(km.shape[0]):
        length = max(int(pm[i, 0]), 0)
        d = max(int(abs(km[i, :5] - pm[i, :5]).max()),
                int(abs(kc[i, :length] - pc[i, :length]).max(initial=0)))
        bad += d != 0
        err = max(err, d)
    return bad, err


def region_pairs(region, n: int, max_dim: int) -> list:
    """The first ``n`` overlaps of the region (PAF order) as (query span,
    target span) byte pairs at their real lengths, strand applied."""
    reads_path, paf_path, draft_path = region
    draft = read_fasta(draft_path)
    reads = {}
    with open(reads_path, "rb") as fh:
        while True:
            rec = [fh.readline() for _ in range(4)]
            if not rec[0]:
                break
            reads[rec[0][1:].strip()] = rec[1].strip()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    pairs = []
    with open(paf_path, "rb") as fh:
        for line in fh:
            f = line.split(b"\t")
            q = reads[f[0]][int(f[2]):int(f[3])]
            if f[4] == b"-":
                q = q.translate(comp)[::-1]
            t = draft[int(f[7]):int(f[8])]
            if 0 < min(len(q), len(t)) and max(len(q), len(t)) <= max_dim:
                pairs.append((q, t))
            if len(pairs) == n:
                break
    return pairs


def tiny_pairs(rng: random.Random):
    """Edge cases at lq 512: 5% and 15% divergence, a 60-bp deletion, N
    bases, a distance past emax 128, an empty query, |tl - ql| > 128,
    and (last) a pair whose zero knots leave its end outside a 256
    band."""
    def seq(n):
        return bytes(rng.choice(b"ACGT") for _ in range(n))

    def mutate(s, rate):
        out = bytearray()
        for ch in s:
            r = rng.random()
            if r < rate / 3:
                continue
            out.append(rng.choice(b"ACGT") if r < 2 * rate / 3 else ch)
            if r > 1 - rate / 3:
                out.append(rng.choice(b"ACGT"))
        return bytes(out)

    qs, ts = [], []
    for n, rate in ((300, 0.05), (420, 0.15)):
        q = seq(n)
        qs.append(q)
        ts.append(mutate(q, rate))
    q = seq(400)
    qs.append(q)
    ts.append(mutate(q[:150] + q[210:], 0.03))
    q = seq(200)
    qs.append(q[:50] + b"NNNN" + q[50:])
    ts.append(q[:50] + b"NNNN" + mutate(q[50:], 0.05))
    qs += [seq(300), b"", b"ACGT" * 20, seq(100)]
    ts += [seq(300), b"ACGT", b"ACGT" * 80, seq(480)]
    return qs, ts


def align_inputs(qs, ts, lq, dev, knots=None):
    """Encoded pairs on the card: q, t, ql, tl (and ctr when ``knots``)."""
    import numpy as np
    import torch
    from racon_tpu_torch.cuda import aligner as al

    def lens(ss):
        return torch.tensor([len(x) for x in ss], dtype=torch.int32,
                            device=dev)
    out = [torch.from_numpy(al.encode_batch(qs, lq, al.QPAD)).to(dev),
           torch.from_numpy(al.encode_batch(ts, lq, al.TPAD)).to(dev),
           lens(qs), lens(ts)]
    if knots is not None:
        out.append(torch.from_numpy(np.stack(knots).astype(np.int32))
                   .to(dev))
    return out


def compare_wfa(kernel_out, plain_out) -> tuple:
    """(mismatching pairs, max |difference|) over meta[:, :2] and
    tape[:n]."""
    kt, km = (t.cpu().numpy().astype("int64") for t in kernel_out)
    pt, pm = (t.cpu().numpy().astype("int64") for t in plain_out)
    bad, err = 0, 0
    for k in range(pm.shape[0]):
        n = int(pm[k, 1])
        d = max(int(abs(km[k, :2] - pm[k, :2]).max()),
                int(abs(kt[k].reshape(-1)[:n]
                        - pt[k].reshape(-1)[:n]).max(initial=0)))
        bad += d != 0
        err = max(err, d)
    return bad, err


def compare_band(kernel_out, plain_out) -> tuple:
    """(mismatching pairs, max |difference|) over the distance and,
    below BIG, the move count and moves[:len]."""
    from racon_tpu_torch.cuda import align_band as ab

    km, pm = (t.cpu().numpy().astype("int64") for t in
              (kernel_out[1], plain_out[1]))
    kmv, pmv = (ab.unpack_moves(t.cpu().numpy()).astype("int64") for t in
                (kernel_out[0], plain_out[0]))
    bad, err = 0, 0
    for k in range(pm.shape[0]):
        d = abs(int(km[k, 0]) - int(pm[k, 0]))
        if pm[k, 0] < ab.BIG:
            n = int(pm[k, 1])
            d = max(d, abs(int(km[k, 1]) - n),
                    int(abs(kmv[k, :n] - pmv[k, :n]).max(initial=0)))
        bad += d != 0
        err = max(err, d)
    return bad, err


def cycle_split(cycles, names=("dp", "traceback")) -> dict:
    """Cycle sums and shares of an align kernel's two phase counters
    (meta[:, 2:4] summed, or a two-entry list): the band kernel's DP
    rows and traceback, or the WFA kernel's wavefront steps and
    traceback."""
    if hasattr(cycles, "shape"):
        cycles = cycles[:, 2:4].to("cpu").long().sum(0).tolist()
    tot = max(1, sum(cycles))
    return {name: {"cycles": int(c), "share": c / tot}
            for name, c in zip(names, cycles)}


def wfa_split(cycles) -> dict:
    return cycle_split(cycles, ("steps", "traceback"))


def timed_pair(kernel, plain, reps: int = 5) -> tuple:
    """(kernel outputs, plain outputs, kernel ms as the median of
    ``reps`` CUDA-event timings after one warm call, plain ms of one
    call on the host clock with a synchronize)."""
    import torch
    out = kernel()
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(kernel, reps))
    t0 = time.perf_counter()
    ref = plain()
    torch.cuda.synchronize()
    return out, ref, ms, 1e3 * (time.perf_counter() - t0)


def bound(in_bytes: int, out_bytes: int, ops: int,
          fp32_ops: int = 0) -> tuple:
    """(bound ms, what binds): bytes over the HBM rate vs operations,
    int32 over the ALU rate and float32 over the FP32 rate (two pipes
    that run side by side: the slower one binds)."""
    bytes_ms = 1e3 * (in_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_ms = 1e3 * max(ops / ALU_OPS_PER_S, fp32_ops / FP32_OPS_PER_S)
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def poa_ops(cells: int, pred_rows: int, wb: int) -> int:
    """int32 operations of the POA DP over ``cells`` band cells (rank
    steps x wb) that folded ``pred_rows`` pred rows in all: every rank
    past its first pred pays OPS_PER_EXTRA_PRED per column (a lower
    bound where a rank has no pred)."""
    return cells * OPS_PER_CELL + \
        max(0, pred_rows * wb - cells) * OPS_PER_EXTRA_PRED


def lockstep_ops(cells: int, pred_rows: int = 0, cols: int = 0) -> tuple:
    """(int32, float32) operations of lockstep rounds over ``cells``
    cells (ranks x ``cols`` columns) that folded ``pred_rows`` pred rows
    in all; with no pred rows given, one a rank (a lower bound)."""
    extra = max(0, pred_rows * cols - cells)
    return (cells * LOCKSTEP_INT_OPS_PER_CELL,
            cells * LOCKSTEP_FP32_OPS_PER_CELL
            + extra * LOCKSTEP_FP32_OPS_PER_EXTRA_PRED)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


#: pairs of align_check's 32 that the band kernel's plain version runs
#: at wb 2048 (of the shorter half) and at wb 4096 (of all, the longest
#: among them)
BAND_PLAIN_PAIRS = 11
BAND_MEASURED_PAIRS = 8


def spread(order: list, n: int) -> list:
    """``n`` entries of ``order`` evenly spaced and ending at its last,
    sorted."""
    return sorted({order[round((k + 1) * len(order) / n) - 1]
                   for k in range(n)})


def align_check(region, dev, cpu) -> dict:
    """Phase 5: the align kernels against their plain versions."""
    import torch
    from racon_tpu_torch.cuda import align_band as ab
    from racon_tpu_torch.cuda import align_wfa as aw
    from racon_tpu_torch.cuda import build
    from racon_tpu_torch.tools.band_pairs import band_pairs
    from racon_tpu_torch.tools.wfa_pairs import wfa_pairs

    pairs = region_pairs(region, 32, aw.MAX_DIM)
    if len(pairs) < 32:
        raise RuntimeError(f"only {len(pairs)} region overlaps fit")
    qs, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    lq = (max(max(map(len, qs)), max(map(len, ts))) + 127) // 128 * 128
    res = {"pairs": len(pairs), "lq": lq}
    # WFA, emax 2048
    emax = 2048
    args = align_inputs(qs, ts, lq, dev)
    lmax = longest(qs, ts)
    wk, wp, ms, plain_ms = timed_pair(
        lambda: aw.wfa_align(*args, emax=emax, lmax=lmax),
        lambda: aw.wfa_align_reference(*args, emax=emax))
    bad, err = compare_wfa(wk, wp)
    dists = wp[1][:, 0].cpu().tolist()
    native_bad = sum(d != cpu.edit_distance(q, t)
                     for q, t, d in zip(qs, ts, dists) if d <= emax)
    cells = sum((d + 1) ** 2 for d in dists if d <= emax)
    bms, by = bound(nbytes(*args), nbytes(*wk), cells * OPS_PER_WFA_CELL)
    res["wfa"] = {"emax": emax, "mismatches": bad, "max_abs_err": err,
                  "certified": sum(d <= emax for d in dists),
                  "native_mismatches": native_bad, "wavefront_cells": cells,
                  "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                  "bound_by": by, "library_ms": None,
                  "phases": wfa_split(wk[1]),
                  "warps_per_pair": build.load("align_wfa")
                  .align_wfa_warps(len(qs))}
    # banded, wb 2048 on proportional knots
    wb = 2048
    knots = [ab.proportional_knots(len(q), len(t), lq)
             for q, t in zip(qs, ts)]
    bargs = align_inputs(qs, ts, lq, dev, knots)
    # the plain version on BAND_PLAIN_PAIRS of them, spread over the
    # shorter half by query length: its time follows the longest pair's
    # rows, whatever the number of pairs, so the long pairs are held to
    # it once, in band_measured
    by_len = sorted(range(len(qs)), key=lambda i: (len(qs[i]), i))
    prow = torch.tensor(spread(by_len[:len(qs) // 2], BAND_PLAIN_PAIRS),
                        device=dev)
    pargs = [a[prow].contiguous() for a in bargs]
    bk, bp, bms_k, bplain = timed_pair(
        lambda: ab.band_align(*bargs, wb=wb),
        lambda: ab.band_align_reference(*pargs, wb=wb))
    bbad, berr = compare_band([t[prow] for t in bk], bp)
    bcells = sum(map(len, qs)) * wb
    bbound, bby = bound(nbytes(*bargs), nbytes(*bk),
                        bcells * OPS_PER_BAND_CELL)
    res["band"] = {"wb": wb, "mismatches": bbad, "max_abs_err": berr,
                   "plain_pairs": prow.tolist(),
                   "in_band": int((bk[1][:, 0] < ab.BIG).sum()),
                   "cells": bcells, "kernel_ms": bms_k, "plain_ms": bplain,
                   "bound_ms": bbound, "bound_by": bby, "library_ms": None,
                   "phases": cycle_split(bk[1]),
                   "warps_per_pair": build.load("align_band")
                   .align_band_warps(len(qs), wb),
                   "warps_sweep_ms": warps_sweep(bargs, wb),
                   "dp_cycles_per_row": dp_cycles_per_row(bk[1], bargs[2])}
    # banded, wb 4096 on measured knots for BAND_MEASURED_PAIRS pairs
    # spread over all lengths, the longest among them
    mrow = spread(by_len, BAND_MEASURED_PAIRS)
    mq, mt = [qs[i] for i in mrow], [ts[i] for i in mrow]
    mk = [ab.estimate_center_knots(q, t, lq) for q, t in zip(mq, mt)]
    margs = align_inputs(mq, mt, lq, dev, mk)
    mbad, merr = compare_band(ab.band_align(*margs, wb=4096),
                              ab.band_align_reference(*margs, wb=4096))
    res["band_measured"] = {"wb": 4096, "pairs": mrow,
                            "longest": max(map(len, mq)),
                            "mismatches": mbad, "max_abs_err": merr}
    # tiny edge cases: WFA at emax 128 with the constructed pairs of
    # tools/wfa_pairs.py, band at wb 256 (zero knots for the last pair
    # put its end outside the band)
    tq, tt = tiny_pairs(random.Random(5))
    _, wq, wt = wfa_pairs(512, 128, seed=5)
    targs = align_inputs(tq + wq, tt + wt, 512, dev)
    tw = aw.wfa_align(*targs, emax=128, lmax=longest(tq + wq, tt + wt))
    tbad, terr = compare_wfa(tw, aw.wfa_align_reference(*targs, emax=128))
    tdist = tw[1][:, 0].cpu().tolist()
    native_bad += sum(d != cpu.edit_distance(q, t)
                      for q, t, d in zip(tq + wq, tt + wt, tdist)
                      if d <= 128)
    tkn = [ab.proportional_knots(len(q), len(t), 512)
           for q, t in zip(tq, tt)]
    tkn[-1] = tkn[-1] * 0
    # the constructed pairs of tools/band_pairs.py: forced band steps
    _, bq, bt, bk = band_pairs(512, 256, seed=5)
    tbargs = align_inputs(tq + bq, tt + bt, 512, dev, tkn + bk)
    tb = ab.band_align(*tbargs, wb=256)
    tbbad, tberr = compare_band(tb, ab.band_align_reference(*tbargs,
                                                             wb=256))
    res["tiny"] = {"pairs": len(tq), "wfa_pairs": len(tq) + len(wq),
                   "band_pairs": len(tq) + len(bq),
                   "wfa_mismatches": tbad,
                   "wfa_max_abs_err": terr,
                   "wfa_rejected": sum(d > 128 for d in tdist),
                   "band_mismatches": tbbad, "band_max_abs_err": tberr,
                   "band_out_of_band": int((tb[1][:, 0] >= ab.BIG).sum())}
    res["native_mismatches"] = native_bad
    res["mismatches"] = bad + bbad + mbad + tbad + tbbad
    res["max_abs_err"] = max(err, berr, merr, terr, tberr)
    return res


def band_card(region, dev, wb: int = 4096, n_pairs: int = 1024,
              plain_checked: int = 8) -> dict:
    """The band-only cell: the region's overlap pairs on measured-center
    knots at ``wb``, replicated to ``n_pairs`` in one launch; median of
    5 CUDA-event runs.  Every replica must equal its original's kernel
    output, and the first ``plain_checked`` originals the plain
    version."""
    import numpy as np
    import torch
    from racon_tpu_torch.cuda import align_band as ab
    from racon_tpu_torch.cuda import build

    pairs = region_pairs(region, n_pairs, 16384)
    qs, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    lq = (max(max(map(len, qs)), max(map(len, ts))) + 127) // 128 * 128
    knots = [ab.estimate_center_knots(q, t, lq) for q, t in zip(qs, ts)]
    n = len(pairs)
    idx = [k % n for k in range(n_pairs)]
    oargs = align_inputs(qs, ts, lq, dev, knots)
    otape, ometa = ab.band_align(*oargs, wb=wb)
    args = align_inputs([qs[k] for k in idx], [ts[k] for k in idx], lq, dev,
                        [knots[k] for k in idx])
    tape, meta = ab.band_align(*args, wb=wb)
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(lambda: ab.band_align(*args, wb=wb), 5))
    om, km = ometa.cpu().numpy(), meta.cpu().numpy()
    omv = ab.unpack_moves(otape.cpu().numpy())
    kmv = ab.unpack_moves(tape.cpu().numpy())
    bad = 0
    for r, k in enumerate(idx):
        length = int(om[k, 1])
        bad += not ((km[r, :2] == om[k, :2]).all()
                    and (kmv[r, :length] == omv[k, :length]).all())
    sub = slice(0, min(plain_checked, n))
    pargs = align_inputs(qs[sub], ts[sub], lq, dev, knots[sub])
    pbad, perr = compare_band(ab.band_align(*pargs, wb=wb),
                              ab.band_align_reference(*pargs, wb=wb))
    cells = sum(len(qs[k]) for k in idx) * wb
    bms, by = bound(nbytes(*args), nbytes(tape, meta),
                    cells * OPS_PER_BAND_CELL)
    return {"wb": wb, "lq": lq, "originals": n, "pairs": n_pairs,
            "warps_per_pair": build.load("align_band").align_band_warps(
                n_pairs, wb),
            "warps_sweep_ms": warps_sweep(args, wb),
            "dp_cycles_per_row": dp_cycles_per_row(meta, args[2]),
            "in_band": int((om[:, 0] < ab.BIG).sum()),
            "replica_mismatches": bad, "plain_checked": sub.stop,
            "plain_mismatches": pbad, "max_abs_err": perr,
            "mismatches": bad + pbad, "cells": cells, "kernel_ms": ms,
            "pairs_per_s": n_pairs / (ms / 1e3), "bound_ms": bms,
            "bound_by": by, "share_of_bound": bms / ms,
            "rows_p50_max": [int(x) for x in np.percentile(
                [len(q) for q in qs], [50, 100])],
            "phases": cycle_split(meta)}


def wfa_cells(meta, ql, tl, emax: int) -> int:
    """Wavefront cells of a WFA launch: (min(d, emax) + 1)^2 per pair
    that the kernel stepped (0 for an empty pair or |tl - ql| > emax)."""
    cells = 0
    for d, a, b in zip(meta[:, 0].tolist(), ql.tolist(), tl.tolist()):
        if a > 0 and b > 0 and abs(b - a) <= emax:
            cells += (min(d, emax) + 1) ** 2
    return cells


def wfa_card(region, dev, emax: int = 2048, n_pairs: int = 1024,
             plain_checked: int = 8) -> dict:
    """The WFA-only cell: the region's overlap pairs at ``emax``,
    replicated to ``n_pairs`` (one main-path chunk) in one launch;
    median of 5 CUDA-event runs.  Every replica must equal its
    original's kernel output (meta[:, :2], tape[:n]), and the first
    ``plain_checked`` originals the plain version."""
    import numpy as np
    import torch
    from racon_tpu_torch.cuda import align_wfa as aw
    from racon_tpu_torch.cuda import build

    pairs = region_pairs(region, n_pairs, aw.MAX_DIM)
    qs, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    lq = (max(max(map(len, qs)), max(map(len, ts))) + 127) // 128 * 128
    n = len(pairs)
    idx = [k % n for k in range(n_pairs)]
    lmax = longest(qs, ts)
    otape, ometa = aw.wfa_align(*align_inputs(qs, ts, lq, dev), emax=emax,
                                lmax=lmax)
    args = align_inputs([qs[k] for k in idx], [ts[k] for k in idx], lq,
                        dev)
    tape, meta = aw.wfa_align(*args, emax=emax, lmax=lmax)
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(
        lambda: aw.wfa_align(*args, emax=emax, lmax=lmax), 5))
    om, km = ometa.cpu().numpy(), meta.cpu().numpy()
    ot = otape.cpu().numpy().reshape(n, -1)
    kt = tape.cpu().numpy().reshape(n_pairs, -1)
    bad = 0
    for r, k in enumerate(idx):
        length = int(om[k, 1])
        bad += not ((km[r, :2] == om[k, :2]).all()
                    and (kt[r, :length] == ot[k, :length]).all())
    sub = slice(0, min(plain_checked, n))
    pargs = align_inputs(qs[sub], ts[sub], lq, dev)
    pbad, perr = compare_wfa(aw.wfa_align(*pargs, emax=emax, lmax=lmax),
                             aw.wfa_align_reference(*pargs, emax=emax))
    cells = wfa_cells(km, args[2].cpu(), args[3].cpu(), emax)
    bms, by = bound(nbytes(*args), nbytes(tape, meta),
                    cells * OPS_PER_WFA_CELL)
    dists = om[:, 0]
    return {"emax": emax, "lq": lq, "lmax": lmax, "originals": n,
            "pairs": n_pairs, "certified": int((dists <= emax).sum()),
            "warps_per_pair": build.load("align_wfa").align_wfa_warps(
                n_pairs),
            "resident_pairs": aw.resident_slots(dev, lmax, emax, n_pairs),
            "distance_p50_max": [int(x) for x in np.percentile(
                dists[dists <= emax], [50, 100])],
            "replica_mismatches": bad, "plain_checked": sub.stop,
            "plain_mismatches": pbad, "max_abs_err": perr,
            "mismatches": bad + pbad, "wavefront_cells": cells,
            "kernel_ms": ms, "pairs_per_s": n_pairs / (ms / 1e3),
            "bound_ms": bms, "bound_by": by, "share_of_bound": bms / ms,
            "history_floor_ms": {
                "int32": 1e3 * 4 * cells / HBM_BYTES_PER_S,
                "int16": 1e3 * 2 * cells / HBM_BYTES_PER_S},
            "phases": wfa_split(meta)}


def longest(qs, ts) -> int:
    """The longest sequence of a batch (the WFA kernel's ``lmax``)."""
    return max(max(map(len, qs)), max(map(len, ts)), 1)


def warps_sweep(args, wb: int) -> dict:
    """Median CUDA-event ms of the band kernel at each legal number of
    warps per pair (outputs held equal to the kernel's own choice)."""
    import torch
    from racon_tpu_torch.cuda import align_band as ab

    ref = ab.band_align(*args, wb=wb)
    out = {}
    nw = 1
    while nw <= 8 and wb % (256 * nw) == 0:
        got = ab.band_align(*args, wb=wb, warps=nw)
        if not (torch.equal(got[0], ref[0])
                and torch.equal(got[1][:, :2], ref[1][:, :2])):
            raise RuntimeError(f"band kernel at {nw} warps per pair "
                               "differs from its default launch")
        out[nw] = statistics.median(cuda_ms(
            lambda: ab.band_align(*args, wb=wb, warps=nw), 3))
        nw *= 2
    return out


def dp_cycles_per_row(meta, ql) -> dict:
    """DP cycles per query row of each pair (meta[:, 2] / ql): p50, and
    the longest pair's."""
    import numpy as np
    cyc = meta[:, 2].cpu().numpy().astype(np.float64)
    rows = ql.cpu().numpy().astype(np.float64)
    ok = rows > 0
    longest = int(np.argmax(rows))
    return {"p50": float(np.median(cyc[ok] / rows[ok])),
            "longest_pair": float(cyc[longest] / rows[longest]),
            "longest_rows": int(rows[longest])}


def poa_resources(dev, sms: int) -> dict:
    """Dynamic shared memory and resident blocks of the POA kernel's
    two passes at the stock caps (one warp per block)."""
    from racon_tpu_torch.cuda import poa_full as pf

    wb = pf.band_width(1024)
    out = {"threads_per_block": 32}
    for name, nodes in (("first_pass", pf.first_pass_nodes(2048)),
                        ("second_pass", 2048)):
        slots = pf.resident_slots(dev, nodes, 1024, wb)
        out[name] = {"graph_nodes": nodes,
                     "dynamic_smem_bytes": pf.smem_bytes(nodes, 1024, wb),
                     "resident_blocks": slots, "blocks_per_sm": slots / sms}
    return out


def band_resources(dev, sms: int, ptxas: str) -> dict:
    """The band kernel's registers (ptxas, per instantiation), and its
    shared memory and resident pairs at the main path's rungs (lt
    16,384; one warp per pair)."""
    from racon_tpu_torch.cuda import align_band as ab
    from racon_tpu_torch.cuda import build

    out = {"threads_per_pair": 32, "registers": [
        int(n) for n in re.findall(r"Used (\d+) registers", ptxas)]}
    lib = build.load("align_band")
    for wb in (2048, 4096):
        slots = ab.resident_slots(dev, 16384, wb)
        smem = ab.smem_bytes(16384, wb)
        if smem != lib.align_band_smem(16384, wb):
            raise RuntimeError("align_band.smem_bytes disagrees with the "
                               "kernel's layout")
        out[f"wb{wb}"] = {"smem_bytes_per_pair": smem,
                          "resident_pairs": slots,
                          "pairs_per_sm": slots / sms}
    return out


def wfa_resources(dev, sms: int, ptxas: str) -> dict:
    """The WFA kernel's registers (ptxas), and its shared memory and
    resident pairs at the main path's rungs for a chunk of 1,024 pairs
    of up to 16,384 bases."""
    from racon_tpu_torch.cuda import align_wfa as aw
    from racon_tpu_torch.cuda import build

    lib = build.load("align_wfa")
    out = {"registers": [int(n) for n in
                         re.findall(r"Used (\d+) registers", ptxas)],
           "warps_per_pair": lib.align_wfa_warps(1024)}
    for emax in (512, 1024, 2048):
        smem = aw.smem_bytes(aw.MAX_DIM, emax)
        if smem != lib.align_wfa_smem(aw.MAX_DIM, emax):
            raise RuntimeError("align_wfa.smem_bytes disagrees with the "
                               "kernel's layout")
        slots = aw.resident_slots(dev, aw.MAX_DIM, emax, 1024)
        out[f"emax{emax}"] = {"smem_bytes_per_pair": smem,
                              "resident_pairs": slots,
                              "pairs_per_sm": slots / sms}
    return out


def phase_split(mout) -> dict:
    """Cycle sums and shares of the kernel's phase counters
    (mout[:, 5:8]) over a batch."""
    from racon_tpu_torch.cuda.poa import PHASES
    tot = mout[:, 5:8].to("cpu").long().sum(0).tolist()
    return {name: {"cycles": c, "share": c / max(1, sum(tot))}
            for name, c in zip(PHASES, tot)}


def ring_hit_rate(stats) -> float:
    hits, misses = (int(x) for x in stats[:, :2].long().sum(0).tolist())
    return hits / max(1, hits + misses)


#: of kernel_check's 32 real windows, how many its plain version also
#: computes (~7 s a window on the card's host): spread evenly by depth,
#: the deepest among them (see plain_subset)
def poa_bufs(inputs, stock) -> dict:
    """Buffers of one POA launch on these packed inputs at the stock
    caps, made before a timed call (poa_full_buffers)."""
    from racon_tpu_torch.cuda import poa_full as pf
    return pf.poa_full_buffers(int(inputs[0].shape[0]), v=stock["v"],
                               lp=stock["lp"], wb=stock["wb"],
                               device=inputs[0].device)


def poa_ms(inputs, stock, reps: int) -> float:
    """The POA kernel's CUDA-event ms on these inputs, the median of
    ``reps`` calls, each into fresh buffers made before its events."""
    from racon_tpu_torch.cuda import poa_full as pf
    return statistics.median(cuda_ms(
        lambda bufs: pf.poa_full(*inputs, **stock, bufs=bufs), reps,
        setup=lambda: poa_bufs(inputs, stock)))


PLAIN_WINDOWS = 3


def plain_subset(windows, n: int = PLAIN_WINDOWS) -> list:
    """Indices of ``n`` windows spread over the depth range: sorted by
    layer count, evenly spaced, ending at the deepest, so the plain
    version meets the deep, pred-row-heavy windows as well as the
    shallow ones."""
    return spread(sorted(range(len(windows)),
                         key=lambda i: (len(windows[i].sequences), i)), n)


def poa_check(fitting, dev, stock) -> tuple:
    """Phase 4a: the POA kernel timed on 32 real windows, and held
    against its plain version on PLAIN_WINDOWS of them (plain_subset) and on
    the tiny windows; returns (check dict, kernel ms of the 32, plain
    ms of the PLAIN_WINDOWS)."""
    import torch
    from racon_tpu_torch import convert
    from racon_tpu_torch.core.window import WindowType
    from racon_tpu_torch.cuda import poa_full as pf
    from racon_tpu_torch.tools.poa_windows import stress_windows

    def stats_for(inputs):
        return torch.zeros((inputs[0].shape[0], 3), dtype=torch.int32,
                           device=inputs[0].device)

    windows32 = fitting[:32]
    if len(windows32) < 32:
        raise RuntimeError(f"only {len(windows32)} region windows fit")
    pk = convert.pack_windows(windows32, 1024, 2048)
    inputs = convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                               pk.bblen, dev)
    kst = stats_for(inputs)
    kern = pf.poa_full(*inputs, **stock, stats=kst,
                       bufs=poa_bufs(inputs, stock))
    torch.cuda.synchronize()
    ms = poa_ms(inputs, stock, 5)
    sub = plain_subset(windows32)
    head = convert.pack_windows([windows32[i] for i in sub], 1024, 2048)
    hin = convert.to_device(head.seqs, head.wts, head.meta, head.nlay,
                            head.bblen, dev)
    hk, hp = stats_for(hin), stats_for(hin)
    hkern = pf.poa_full(*hin, **stock, stats=hk, bufs=poa_bufs(hin, stock))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pf.poa_full_reference(*hin, **stock, stats=hp)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    mismatches, max_err = compare(hkern, plain)
    # the subset's kernel rows in the batch of 32 equal those in its own
    # batch (each window's result is its own)
    rows = torch.tensor(sub, device=kern[0].device)
    batch_bad, _ = compare([t[rows] for t in kern], hkern)
    mismatches += batch_bad
    stats_bad = int((hk != hp).any(dim=1).sum())
    rank_steps = int(kern[1][:, 4].sum())
    pred_rows = int(kst[:, :2].sum())
    bms, by = bound(nbytes(*inputs), nbytes(*kern),
                    poa_ops(rank_steps * stock["wb"], pred_rows,
                            stock["wb"]))
    depths = [len(w.sequences) for w in windows32]
    check = {"windows": len(windows32), "plain_windows": sub,
             "plain_depths": [depths[i] for i in sub],
             "depths_min_median_max": [min(depths),
                                       int(statistics.median(depths)),
                                       max(depths)],
             "batch": int(inputs[0].shape[0]), "mismatches": mismatches,
             "stats_mismatches": stats_bad, "max_abs_err": max_err,
             "kernel_ms": round(ms, 4), "plain_ms": round(plain_ms, 1),
             "rank_steps": rank_steps, "pred_rows": pred_rows,
             "bound_ms": bms, "bound_by": by,
             "ring_hit_rate": ring_hit_rate(kst[:32]),
             "ring_misses": int(kst[:32, 1].sum()),
             "pred_overflow_reads": int(kst[:32, 2].sum()),
             "phases": phase_split(kern[1][:32])}
    rng = random.Random(3)
    for wtype, trim in ((WindowType.TGS, 1), (WindowType.NGS, 0)):
        tiny = tiny_windows(rng, wtype)
        stress, _ = stress_windows(wtype, seed=3, rank0=len(tiny))
        # many preds, an old pred row, a graph past the first pass
        tiny += stress
        tp = convert.pack_windows(tiny, 256, 256)
        targs = convert.to_device(tp.seqs, tp.wts, tp.meta, tp.nlay,
                                  tp.bblen, dev)
        kw = dict(v=256, lp=256, wb=256, match=5, mismatch=-4, gap=-8,
                  wtype=wtype.value, trim=trim)
        tk, tpl = stats_for(targs), stats_for(targs)
        kout = pf.poa_full(*targs, **kw, stats=tk, bufs=poa_bufs(targs, kw))
        bad, err = compare(kout, pf.poa_full_reference(*targs, **kw,
                                                       stats=tpl))
        sbad = int((tk != tpl).any(dim=1).sum())
        rejected = int((kout[1][:, 0] < 0).sum())
        n = len(tiny)
        big_nodes, big_len = (int(x) for x in kout[1][n - 1, [3, 0]])
        check[f"tiny_{wtype.name}_trim{trim}"] = {
            "windows": n, "mismatches": bad, "stats_mismatches": sbad,
            "rejected": rejected,
            "stress_pred_overflow_reads": int(tk[n - 3, 2]),
            "stress_ring_misses": int(tk[n - 2, 1]),
            "stress_second_pass_nodes": big_nodes}
        mismatches += bad
        stats_bad += sbad
        max_err = max(max_err, err)
        if rejected < 1:
            raise RuntimeError("the forced reject window was not rejected")
        if int(tk[n - 3, 2]) < 1 or int(tk[n - 2, 1]) < 1:
            raise RuntimeError("a stress window missed its device-memory "
                               "path")
        if big_nodes <= pf.first_pass_nodes(256) or big_len <= 0:
            raise RuntimeError("the big-graph stress window did not "
                               "complete in the second pass")
    check["mismatches"], check["max_abs_err"] = mismatches + stats_bad, \
        max_err
    return check, ms, plain_ms


def full_card(fitting, dev, stock, plain_second_pass: int = 0) -> dict:
    """Phase 4b: the region's fitting windows tiled to >= 4x the
    kernel's resident blocks (first pass) in one call; every replica
    must equal its original's kernel output (cons[:len], mout[:, :5]).
    With ``plain_second_pass``, up to that many originals that completed
    in the second pass are also held against the plain version.  The
    batch is timed again with the kernel in one pass at the whole cap
    (the first pass's graph made as large as the second's), outputs
    held equal, to weigh the two-pass split on this traffic."""
    import numpy as np
    import torch
    from racon_tpu_torch import convert
    from racon_tpu_torch.cuda import poa_full as pf
    from racon_tpu_torch.cuda.poa import FAIL_NAMES

    # the first pass holds the most windows at once
    slots = pf.resident_slots(dev, pf.first_pass_nodes(stock["v"]),
                              stock["lp"], stock["wb"])
    n = len(fitting)
    tiled = fitting * (-(-4 * slots // n))

    def packed(ws):
        pk = convert.pack_windows(ws, stock["lp"], stock["v"])
        return convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                                 pk.bblen, dev)

    orig = packed(fitting)
    oc, om = (t.cpu().numpy() for t in pf.poa_full(
        *orig, **stock, bufs=poa_bufs(orig, stock)))
    inputs = packed(tiled)
    st = torch.zeros((inputs[0].shape[0], 3), dtype=torch.int32,
                     device=dev)
    kc, km = pf.poa_full(*inputs, **stock, stats=st,
                         bufs=poa_bufs(inputs, stock))
    torch.cuda.synchronize()
    ms = poa_ms(inputs, stock, 3)
    keep = pf.first_pass_nodes
    pf.first_pass_nodes = lambda v: v
    try:
        one = pf.poa_full(*inputs, **stock, bufs=poa_bufs(inputs, stock))
        torch.cuda.synchronize()
        one_ms = poa_ms(inputs, stock, 3)
    finally:
        pf.first_pass_nodes = keep
    bad, _ = compare(one, (kc, km))
    kc, km_h = kc.cpu().numpy(), km.cpu().numpy()
    for i in range(len(tiled)):
        j = i % n
        length = max(int(om[j, 0]), 0)
        bad += not ((km_h[i, :5] == om[j, :5]).all()
                    and (kc[i, :length] == oc[j, :length]).all())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    vs = pf.first_pass_nodes(stock["v"])
    second = [j for j in range(n) if om[j, 3] > vs and om[j, 0] >= 0]
    plain_checked = second[:plain_second_pass]
    if plain_checked:
        ppk = convert.pack_windows([fitting[j] for j in plain_checked],
                                   stock["lp"], stock["v"])
        pin = convert.to_device(ppk.seqs, ppk.wts, ppk.meta, ppk.nlay,
                                ppk.bblen, dev)
        pbad, _ = compare(pf.poa_full(*pin, **stock,
                                      bufs=poa_bufs(pin, stock)),
                          pf.poa_full_reference(*pin, **stock))
        bad += pbad
    codes = [int(c) for c in om[:n, 2][om[:n, 0] < 0]]
    return {"slots": slots, "blocks_per_sm": slots / sms,
            "first_pass_nodes": vs,
            "second_pass_windows": int((km_h[:len(tiled), 3] > vs).sum()),
            "originals": n, "originals_past_first_pass": int(
                (om[:n, 3] > vs).sum()),
            "originals_rejected": {FAIL_NAMES[c]: codes.count(c)
                                   for c in sorted(set(codes))},
            "second_pass_plain_checked": len(plain_checked),
            "originals_nodes_pct": [int(x) for x in np.percentile(
                om[:n, 3], [50, 90, 99, 100])],
            "windows": len(tiled),
            "batch": int(inputs[0].shape[0]), "mismatches": bad,
            "rejected": int((km_h[:len(tiled), 0] < 0).sum()),
            "kernel_ms": round(ms, 3),
            "windows_per_s": len(tiled) / (ms / 1e3),
            "one_pass_kernel_ms": round(one_ms, 3),
            "ring_hit_rate": ring_hit_rate(st[:len(tiled)]),
            "ring_misses": int(st[:len(tiled), 1].sum()),
            "pred_overflow_reads": int(st[:len(tiled), 2].sum()),
            "phases": phase_split(km[:len(tiled)])}


def deep_windows(work: str, threads: int, engine) -> list:
    """The POA windows (>= 3 sequences, fitting the engine's caps) of a
    deeper set: 50 kb simulated as the dataset is (ONT model, 8 kb
    reads) but at 60x coverage, seed 11."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher
    from racon_tpu_torch.tools import simulate

    paths = simulate.simulate(os.path.join(work, "deep"),
                              genome_len=50_000, coverage=60,
                              read_len=8000, seed=11, ont=True)
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, threads)
    pol.initialize()
    wins = [w for w in pol.windows
            if len(w.sequences) >= 3 and engine.fits([w])]
    pol.close()
    return wins


def align_phases(region, dev, cpu, only=None) -> dict:
    """Phase 5: align_check, then band_card and wfa_card (one of them
    with ``only``); returns the align_check dict."""
    acheck = align_check(region, dev, cpu)
    emit("align_check", **acheck)
    if acheck["mismatches"]:
        raise RuntimeError(f"an align kernel disagrees with its plain "
                           f"version on {acheck['mismatches']} pair(s)")
    if acheck["native_mismatches"]:
        raise RuntimeError(f"{acheck['native_mismatches']} certified WFA "
                           "distance(s) differ from the native engine")
    if acheck["tiny"]["band_out_of_band"] < 1 or \
            acheck["tiny"]["wfa_rejected"] < 5:
        raise RuntimeError("a forced align reject was not rejected")
    cells = (("band_card", band_card), ("wfa_card", wfa_card))
    for name, fn in cells:
        if only is not None and name != f"{only}_card":
            continue
        card = fn(region, dev)
        emit(name, **card)
        if card["mismatches"]:
            raise RuntimeError(f"{name}: {card['replica_mismatches']} "
                               "replica(s) differ from their originals, "
                               f"{card['plain_mismatches']} original(s) "
                               "from the plain version")
    return acheck


@contextlib.contextmanager
def env_set(**kw):
    """Set environment variables for a block (None unsets), restoring
    them after."""
    saved = {k: os.environ.get(k) for k in kw}

    def put(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(kw)
    try:
        yield
    finally:
        put(saved)


#: the port's knobs of the default path, all unset there
DEFAULT_PATH_KNOBS = (
    "RACON_TPU_TORCH_PIPELINE", "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY",
    "RACON_TPU_TORCH_POA_DEVICE_ONLY", "RACON_TPU_TORCH_ALIGN_SPLIT",
    "RACON_TPU_TORCH_POA_SPLIT", "RACON_TPU_TORCH_RECALIBRATE") + tuple(
    f"RACON_TPU_TORCH_RATE_{pin}"
    for pin in ("POA_DEV", "POA_CPU", "ALIGN_DEV", "ALIGN_CPU",
                "ALIGN_WFA_DEV", "ALIGN_CPU_DEV"))


def chunk_rates(chunks) -> dict:
    """Per align rung: chunks, summed wall and busy time (collect to
    collect; busy is what the rate store keeps), units, and ns per unit
    of each, the first chunk included."""
    out = {}
    for kernel, rung, wall, busy, units in chunks:
        r = out.setdefault(rung, {"chunks": 0, "wall_s": 0.0,
                                  "busy_s": 0.0, "units": 0})
        r["chunks"] += 1
        r["wall_s"] += wall
        r["busy_s"] += busy
        r["units"] += int(units)
    for r in out.values():
        r["ns_per_unit"] = round(r["wall_s"] * 1e9 / max(1, r["units"]), 1)
        r["busy_ns_per_unit"] = round(
            r["busy_s"] * 1e9 / max(1, r["units"]), 1)
        r["wall_s"] = round(r["wall_s"], 3)
        r["busy_s"] = round(r["busy_s"], 3)
    return out


def launch_counts(mapped: bool = False, lockstep: bool = False,
                  scan: bool = False) -> dict:
    """Every kernel's launch count now (``seed_words`` too when the run
    maps its overlaps, ``poa_lockstep`` when its windows are past the
    whole-window POA kernel's caps, ``-w 1000``, or under
    RACON_TPU_TORCH_PORTABLE, ``align_scan_full`` and
    ``align_scan_band`` under the scan ladder's switches)."""
    from racon_tpu_torch.cuda import build

    out = build.launch_counts()
    if not mapped:
        del out["seed_words"]
    if not lockstep:
        del out["poa_lockstep"]
    if not scan:
        del out["align_scan_full"], out["align_scan_band"]
    return out


def counted_polish(cli, argv, out_path, mapped: bool = False,
                   cold: bool = True, lockstep: bool = False,
                   scan: bool = False):
    """One CLI polish with every kernel's launch count set to 0 just
    before it, from an empty in-process result cache unless ``cold`` is
    False; returns (polisher, wall s, launches)."""
    from racon_tpu_torch import cache
    from racon_tpu_torch.cuda import build

    if cold:
        cache.reset()
    before = card_state()
    build.zero_launch_counts()
    t0 = time.perf_counter()
    with open(out_path, "wb") as out:
        polisher = cli.main(argv, out=out)
    wall = time.perf_counter() - t0
    polisher.card_states = (before, card_state())
    return polisher, wall, launch_counts(mapped, lockstep, scan)


#: the staged, all-device path of phase 6 (and of the traced phase)
STAGED_ENV = {"RACON_TPU_TORCH_PIPELINE": "0",
              "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "1",
              "RACON_TPU_TORCH_POA_DEVICE_ONLY": "1"}
#: device_util engine -> launch counter
ENGINE_KERNEL = {"poa": "poa_full", "align_wfa": "align_wfa",
                 "align_band": "align_band"}


def trace_args(work, tag) -> tuple:
    """(argv flags, trace path, report path) of a traced run."""
    tpath = os.path.join(work, f"{tag}.trace.json")
    mpath = os.path.join(work, f"{tag}.metrics.json")
    return ["--trace", tpath, "--metrics-json", mpath], tpath, mpath


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def lane_stats(pol, launches, tpath, mpath) -> dict:
    """Device lanes of a traced run: per engine, the report's
    ``device_util`` (busy, idle, util, dispatches) beside the engine's
    launches, the summed lengths of its device-lane spans beside the
    polisher's CUDA-event kernel ms, and its idle share of the run;
    then the all-engine idle share: 1 - union of every device-lane
    interval / the ``racon_tpu_torch.run`` span, and each stage span's
    wall beside the device time inside it.  The mapping of the CUDA
    events onto the host clock is held to the host: every device-lane
    span must lie inside the run span and between the host times of its
    launch and of its collect (``launch_ts``, ``collect_ts``), within
    1 ms plus 100 ppm of the run span for the two clocks' drift.
    Raises when an engine is missing, its dispatches differ from its
    launches, its lanes and kernel ms differ by more than 1% and
    0.1 ms, or a span breaks those bounds."""
    with open(tpath) as fh:
        events = json.load(fh)["traceEvents"]
    with open(mpath) as fh:
        report = json.load(fh)
    kernel_ms = {**pol.align_kernel_ms, "poa": pol.poa_engine.kernel_ms}
    lanes, run, stages, device = {}, None, {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        iv = (ev["ts"], ev["ts"] + ev["dur"])
        if ev["name"] == "racon_tpu_torch.run":
            run = iv
        elif ev.get("cat") in ("stage", "device_stage"):
            stages[ev["name"][len("racon_tpu_torch."):]] = iv
        elif ev.get("cat") == "device":
            eng = re.sub(r"\d+$", "", ev["name"][len("device."):])
            lanes.setdefault(eng, []).append(iv)
            device.append((iv, ev["args"]))
    if run is None:
        raise RuntimeError(f"{tpath}: no racon_tpu_torch.run span")
    run_us = run[1] - run[0]
    # how far a span reaches before its launch, past its collect and out
    # of the run span (negative: inside, by that margin)
    slack_us = 1e3 + 1e-4 * run_us
    clock = {
        "start_before_launch_us": max(a["launch_ts"] - s
                                      for (s, _), a in device),
        "end_after_collect_us": max(e - a["collect_ts"]
                                    for (_, e), a in device),
        "outside_run_us": max(max(run[0] - s, e - run[1])
                              for (s, e), _ in device)}
    clock = {k: round(v, 1) for k, v in clock.items()}
    if max(clock.values()) > slack_us:
        raise RuntimeError(f"device lanes off the host clock by more than "
                           f"{slack_us:.0f} us: {clock}")
    clock["slack_us"] = round(slack_us, 1)
    util = report["device_util"]
    if set(util) != set(ENGINE_KERNEL) or set(lanes) != set(ENGINE_KERNEL):
        raise RuntimeError(f"device_util {sorted(util)} / lanes "
                           f"{sorted(lanes)}: not the three engines")
    engines = {}
    for eng, u in util.items():
        lane_ms = sum(b - a for a, b in lanes[eng]) / 1e3
        e = engines[eng] = {
            **u, "launches": launches[ENGINE_KERNEL[eng]],
            "lane_ms": round(lane_ms, 3),
            "kernel_ms": round(kernel_ms[eng], 3),
            "run_idle_share": round(1 - union_us(lanes[eng]) / run_us, 6)}
        if e["n_dispatches"] != e["launches"]:
            raise RuntimeError(f"{eng}: {e['n_dispatches']} dispatches in "
                               f"the device lane, {e['launches']} launches")
        if abs(lane_ms - kernel_ms[eng]) > max(0.01 * kernel_ms[eng], 0.1):
            raise RuntimeError(f"{eng}: device lanes {lane_ms:.3f} ms, "
                               f"CUDA events {kernel_ms[eng]:.3f} ms")
    every = [iv for ivs in lanes.values() for iv in ivs]
    busy_us = union_us(every)

    def inside(a, b):
        return union_us([(max(x, a), min(y, b)) for x, y in every
                         if y > a and x < b])

    return {"run_span_s": round(run_us / 1e6, 3), "engines": engines,
            "lane_clock": clock,
            "all_engine_busy_s": round(busy_us / 1e6, 3),
            "all_engine_idle_share": round(1 - busy_us / run_us, 6),
            "stages": {name: {"wall_s": round((b - a) / 1e6, 3),
                              "device_busy_s": round(inside(a, b) / 1e6, 3)}
                       for name, (a, b) in sorted(stages.items(),
                                                  key=lambda kv: kv[1])},
            "trace_events": len(events),
            "host": {k: round(v, 3) for k, v in
                     report["run"]["counters"].items()
                     if k.startswith("host.")}}


def keep_files(keep, *paths) -> None:
    """Copy a traced run's trace and report to ``keep`` (if given)."""
    if keep:
        os.makedirs(keep, exist_ok=True)
        for p in paths:
            shutil.copy(p, keep)


def traced_phase(cli, work, argv, untraced_path, untraced_wall,
                 keep=None) -> None:
    """The staged polish again with --trace and --metrics-json: the
    FASTA must equal the untraced run's; the device lanes (lane_stats)
    and the traced wall beside the untraced one."""
    flags, tpath, mpath = trace_args(work, "staged")
    out_path = os.path.join(work, "traced.fasta")
    with env_set(**STAGED_ENV):
        pol, wall, launches = counted_polish(cli, argv[:-3] + flags
                                             + argv[-3:], out_path)
    same = read_bytes(out_path) == read_bytes(untraced_path)
    stats = lane_stats(pol, launches, tpath, mpath)
    keep_files(keep, tpath, mpath)
    emit("traced", path="staged", identical=same, launches=launches,
         wall_s=round(wall, 3), untraced_wall_s=round(untraced_wall, 3),
         overhead=round(wall / untraced_wall - 1, 4),
         stage_walls_s={k: round(v, 3) for k, v in pol.stage_walls.items()},
         align_kernel_ms={k: round(v, 3) for k, v in
                          pol.align_kernel_ms.items()},
         **stats)
    if not same:
        raise RuntimeError("the traced staged polish gave other FASTA")


def long_cap_phase(cli, work, threads) -> None:
    """The align length cap lifted (RACON_TPU_TORCH_MAX_ALIGN_DIM):
    simulate.long_pair's set, a 20,000-base pair past the WFA kernel's
    rows among 12 short ones, polished with the align stage all on the
    card at the default cap (the long pair on the CPU aligner) and at
    32,768 (the long pair on a band rung, the short ones on a WFA rung
    of the same ladder).  The FASTA must be identical, and the band rung
    must certify the long pair."""
    from racon_tpu_torch.tools import simulate

    paths = simulate.long_pair(os.path.join(work, "long_pair"))
    argv = ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8",
            "--cudaaligner-batches", "1", *paths]
    runs = {}
    for cap in (None, "32768"):
        out_path = os.path.join(work, f"long_pair.{cap}.fasta")
        with env_set(RACON_TPU_TORCH_ALIGN_DEVICE_ONLY="1",
                     RACON_TPU_TORCH_MAX_ALIGN_DIM=cap):
            pol, wall, launches = counted_polish(cli, argv, out_path)
        band = sum(r["certified"] for k, r in pol.align_rungs.items()
                   if k.startswith("band"))
        runs[cap or "default"] = {
            "wall_s": round(wall, 3), "launches": launches,
            "over_length": pol.align_over_length, "band_certified": band,
            "fallthrough": pol.align_cpu_fallthrough,
            "rungs": pol.align_rungs,
            "kernel_ms": {k: round(v, 3)
                          for k, v in pol.align_kernel_ms.items()},
            "bytes": read_bytes(out_path)}
    same = runs["default"].pop("bytes") == runs["32768"].pop("bytes")
    emit("long_cap", identical=same, **runs)
    want = {"default": (1, 0), "32768": (0, 1)}
    got = {k: (r["over_length"], r["band_certified"])
           for k, r in runs.items()}
    if not same or got != want or runs["32768"]["launches"]["align_wfa"] < 1:
        raise RuntimeError(f"long_cap: identical={same}, (over-length, "
                           f"band-certified) {got}, want {want}")


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


#: the result cache's process counters a cache run reads (deltas)
CACHE_COUNTERS = ("cache_hit", "cache_miss", "cache_fill", "cache_evict",
                  "cache_host_s")


def cache_runs(cli, work, argv, plan) -> tuple:
    """The staged polish under each ``(tag, env, cold)`` of ``plan``;
    returns ({tag: run line}, {tag: FASTA bytes}, {tag: (polisher, wall
    s, launches)})."""
    from racon_tpu_torch import cache
    from racon_tpu_torch.obs import REGISTRY

    runs, outs, pols = {}, {}, {}
    for tag, env, cold in plan:
        out_path = os.path.join(work, f"cache_{tag}.fasta")
        before = {k: REGISTRY.value(k, 0) for k in CACHE_COUNTERS}
        with env_set(**STAGED_ENV, **env):
            pol, wall, launches = counted_polish(cli, argv, out_path,
                                                 cold=cold)
            st = cache.stats()
        outs[tag] = read_bytes(out_path)
        pols[tag] = (pol, wall, launches)
        runs[tag] = {
            "wall_s": round(wall, 3), "launches": launches,
            **{k: round(REGISTRY.value(k, 0) - before[k], 6)
               for k in CACHE_COUNTERS},
            "cache_bytes": st.get("bytes", 0),
            "entries": st.get("entries", 0),
            "disk_hits": st.get("disk_hits", 0),
            "stage_walls_s": {k: round(v, 3)
                              for k, v in pol.stage_walls.items()},
            "host": {k: round(v, 3) for k, v in
                     pol.metrics.snapshot()["counters"].items()
                     if k.startswith("host.")}}
    return runs, outs, pols


def cache_phase(cli, cpu, work, argv, truth, off: bool = False) -> tuple:
    """The result cache on the staged polish of the whole set (see the
    module docstring): cold and warm (with ``off``, the cache off first,
    as ``--only cache`` runs it), each with its wall, launches, cache
    counters and bytes held; all byte-identical, at the staged distance;
    the warm run must hit.  Returns the cold run, the main path's
    counted staged polish: (polisher, wall s, launches, FASTA path,
    distance to the truth)."""
    plan = ((("off", {"RACON_TPU_TORCH_CACHE": "0"}, True),) if off
            else ()) + (("cold", {}, True), ("warm", {}, False))
    runs, outs, pols = cache_runs(cli, work, argv, plan)
    same = all(o == outs["cold"] for o in outs.values())
    d_pol = chunked_distance(read_fasta(os.path.join(
        work, "cache_cold.fasta")), truth, cpu)
    keying = {"keying_wall_s": round(runs["cold"]["wall_s"]
                                     - runs["off"]["wall_s"], 3)} \
        if off else {}
    emit("cache", argv=argv[:-3], identical=same, polished_distance=d_pol,
         **keying, runs=runs)
    if not same:
        raise RuntimeError(f"cache: {', '.join(outs)} gave different "
                           "FASTA")
    if runs["warm"]["cache_hit"] <= 0:
        raise RuntimeError(f"cache: warm hits {runs['warm']['cache_hit']}")
    return (*pols["cold"], os.path.join(work, "cache_cold.fasta"), d_pol)


def cache_persist(cli, work, cut, threads, off_bytes=None) -> None:
    """The persistent tier on the first 500 kb of the set (``cut``, the
    fusion phase's cut a), staged: a cold fill with
    RACON_TPU_TORCH_CACHE_PERSIST=<work>/results and, after
    ``cache.reset()``, a restart that reads the segments; both
    byte-identical to the cut's staged cache-off bytes (``off_bytes``,
    the fusion phase's solo run of cut a, or a run here when None), and
    the restart must hit the disk."""
    argv = ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8", "-c",
            "1", "--cudaaligner-batches", "1", *cut]
    results = os.path.join(work, "results")
    shutil.rmtree(results, ignore_errors=True)
    plan = [("persist_fill", {"RACON_TPU_TORCH_CACHE_PERSIST": results},
             True),
            ("restart", {"RACON_TPU_TORCH_CACHE_PERSIST": results}, True)]
    if off_bytes is None:
        plan.insert(0, ("cut_off", {"RACON_TPU_TORCH_CACHE": "0"}, True))
    runs, outs, _ = cache_runs(cli, work, argv, plan)
    off_bytes = outs.pop("cut_off", off_bytes)
    same = all(o == off_bytes for o in outs.values())
    emit("cache", part="persist", cut_bp=FUSE_CUT_BP, identical=same,
         segments=sorted(os.listdir(results)), runs=runs)
    if not same:
        raise RuntimeError("cache: the persistent fill and the restart "
                           "differ from the cut's cache-off bytes")
    if runs["restart"]["disk_hits"] <= 0:
        raise RuntimeError(f"cache: restart disk hits "
                           f"{runs['restart']['disk_hits']}")


#: off-on-on-off blocks of cache_default
CACHE_DEFAULT_BLOCKS = 2


def cache_default(cli, work, argv) -> None:
    """``--only cache``: the default path (built-in rates) with the
    result cache off, on, on, off in turns, CACHE_DEFAULT_BLOCKS times,
    each from an empty cache: walls, stage walls, ``cache_host_s`` and
    ``host.*``; the same bytes every time.  Each adjacent off/on pair
    gives one on-minus-off wall (the keying cost of a one-shot run),
    reported with their mean and spread."""
    from racon_tpu_torch.obs import REGISTRY

    runs, outs = [], set()
    modes = ("0", "1", "1", "0") * CACHE_DEFAULT_BLOCKS
    for k, mode in enumerate(modes):
        out_path = os.path.join(work, f"cache_default{k}.fasta")
        before = REGISTRY.value("cache_host_s", 0)
        with env_set(RACON_TPU_TORCH_CACHE=mode,
                     **dict.fromkeys(DEFAULT_PATH_KNOBS)):
            pol, wall, launches = counted_polish(cli, argv, out_path)
        outs.add(read_bytes(out_path))
        runs.append({
            "cache": mode, "wall_s": round(wall, 3), "launches": launches,
            "cache_host_s": round(REGISTRY.value("cache_host_s", 0)
                                  - before, 3),
            "stage_walls_s": {a: round(b, 3)
                              for a, b in pol.stage_walls.items()},
            "host": {a: round(b, 3) for a, b in
                     pol.metrics.snapshot()["counters"].items()
                     if a.startswith("host.")}})
    walls = [r["wall_s"] for r in runs]
    diffs = [round(walls[k + 1] - walls[k] if modes[k] == "0"
                   else walls[k] - walls[k + 1], 3)
             for k in range(0, len(walls), 2)]
    emit("cache_default", identical=len(outs) == 1, runs=runs,
         on_minus_off_s=diffs,
         on_minus_off_mean_s=round(statistics.mean(diffs), 3),
         on_minus_off_sd_s=round(statistics.stdev(diffs), 3))
    if len(outs) != 1:
        raise RuntimeError("cache_default: cache off and on gave "
                           "different FASTA")


#: draft bases of each of the fusion phase's two cuts
FUSE_CUT_BP = 500_000
#: the fused run's fusion window (RACON_TPU_TORCH_FUSE_WAIT_MS)
FUSE_WAIT_MS = 200


def fusion_phase(work, data, threads) -> tuple:
    """The device executor on the card (see the module docstring): two
    500 kb cuts alone, then fused as two tenants, then a poisoned unit
    beside tenant a's first WFA chunk.  Returns cut a's paths, its
    solo (staged, cache off) FASTA bytes and wall s."""
    import threading

    from racon_tpu_torch.core.polisher import PolisherType, create_polisher
    from racon_tpu_torch.cuda import build
    from racon_tpu_torch.cuda import executor
    from racon_tpu_torch.cuda.polisher import CudaPolisher
    from racon_tpu_torch.obs import REGISTRY
    from racon_tpu_torch.obs.devutil import DEVICE_UTIL
    from racon_tpu_torch.obs.flight import FLIGHT

    cuts = fuse_cuts(work, data)

    def polish(name, tenant=None):
        pol = create_polisher(*cuts[name], PolisherType.kC, 500, 10.0, 0.3,
                              True, 5, -4, -8, threads, cuda_poa_batches=1,
                              cuda_aligner_batches=1)
        pol._executor_tenant = tenant
        t0 = time.perf_counter()
        try:
            pol.initialize()
            out = b"".join(b">" + q.name.encode() + b"\n" + q.data + b"\n"
                           for q in pol.polish(True))
        finally:
            pol.close()
        return out, time.perf_counter() - t0

    def zero():
        build.zero_launch_counts()

    fused_keys = ("fusion_dispatches", "fusion_units_fused",
                  "fused_megabatches", "fused_cross_tenant")
    ex = executor.get_executor()
    solo, fused, errors = {}, {}, []
    with env_set(**STAGED_ENV, RACON_TPU_TORCH_CACHE="0"):
        for name in cuts:
            zero()
            out, wall = polish(name)
            solo[name] = {"bytes": out, "wall_s": round(wall, 3),
                          "launches": launch_counts()}

        def job(name):
            try:
                fused[name] = polish(name, tenant=name)
            except BaseException as exc:      # raised below
                errors.append(exc)

        # the tenants enter the POA stage together, as concurrent jobs
        # at one stage do, so their megabatches meet in the executor
        barrier = threading.Barrier(len(cuts), timeout=300)
        stage = CudaPolisher.generate_consensuses

        def together(self):
            barrier.wait()
            return stage(self)

        before = {k: REGISTRY.value(k, 0) for k in fused_keys}
        for name in cuts:
            ex.register_tenant(name)
        zero()
        DEVICE_UTIL.reset()
        t0 = time.perf_counter()
        try:
            # a full chunk or megabatch dispatches at once (it is at its
            # cap); a partial one waits up to this window for the other
            # tenant's unit of the same geometry
            CudaPolisher.generate_consensuses = together
            with env_set(RACON_TPU_TORCH_FUSE_WAIT_MS=str(FUSE_WAIT_MS)):
                workers = [threading.Thread(target=job, args=(n,))
                           for n in cuts]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(900)
                    if w.is_alive():
                        raise RuntimeError("fusion: a tenant's polish "
                                           "hung")
        finally:
            CudaPolisher.generate_consensuses = stage
            for name in cuts:
                ex.release_tenant(name)
        fused_wall = time.perf_counter() - t0
        launches = launch_counts()
        if errors:
            raise errors[0]
        lanes = {e: u["n_dispatches"]
                 for e, u in DEVICE_UTIL.snapshot().items()}
        counters = {k: REGISTRY.value(k, 0) - before[k] for k in fused_keys}
        occupancy = REGISTRY.snapshot()["histograms"].get(
            "fusion_occupancy")
        same = {n: fused[n][0] == solo[n]["bytes"] for n in cuts}
        solo_sum = {k: sum(solo[n]["launches"][k] for n in cuts)
                    for k in launches}

        # a poisoned unit: tenant b's WFA chunk holds a pair longer than
        # the rung's padded length (encoding it raises), submitted just
        # before tenant a's first chunk, with a window that keeps b's
        # unit waiting for a's
        seen = FLIGHT.stats()["recorded"]
        poisoned = {}
        orig = ex.align_wfa

        def spy(queries, targets, lq, emax, device, tenant=None, **kw):
            if tenant == "a" and not poisoned:
                bad = b"A" * (lq + 1)
                # a cap past a's chunk, so the one batch takes both
                poisoned["collect"] = orig([bad], [bad[:lq]], lq, emax,
                                           device, tenant="b",
                                           cap=kw.get("cap", 0) + 1)
                coll = orig(queries, targets, lq, emax, device,
                            tenant=tenant, **kw)
                # the fused dispatch has formed: b leaves, so a's later
                # submissions pass through
                while ex.pending_units():
                    time.sleep(0.001)
                ex.release_tenant("b")
                return coll
            return orig(queries, targets, lq, emax, device, tenant=tenant,
                        **kw)

        for name in cuts:
            ex.register_tenant(name)
        ex.align_wfa = spy
        cross0 = REGISTRY.value("fused_cross_tenant", 0)
        try:
            with env_set(RACON_TPU_TORCH_FUSE_WAIT_MS=str(FUSE_WAIT_MS)):
                out_a, wall_a = polish("a", tenant="a")
        finally:
            del ex.align_wfa
            ex.release_tenant("a")
        raised = None
        try:
            poisoned["collect"]()
        except ValueError as exc:
            raised = f"{type(exc).__name__}: {exc}"
        retries = sorted(e.get("tenant") for e in FLIGHT.snapshot(
            last=FLIGHT.stats()["recorded"] - seen)
            if e["kind"] == "unit_retry")
    poison = {"a_identical": out_a == solo["a"]["bytes"],
              "a_wall_s": round(wall_a, 3), "b_raised": raised,
              "unit_retries": retries,
              "fused_cross_tenant": REGISTRY.value("fused_cross_tenant", 0)
              - cross0}
    emit("fusion", cut_bp=FUSE_CUT_BP, identical=same,
         solo={n: {k: v for k, v in r.items() if k != "bytes"}
               for n, r in solo.items()},
         fused_wall_s=round(fused_wall, 3),
         fused_walls_s={n: round(fused[n][1], 3) for n in cuts},
         fused_launches=launches, solo_launches_summed=solo_sum,
         device_util_dispatches=lanes, counters=counters,
         fusion_occupancy=occupancy, poison=poison)
    if not all(same.values()) or counters["fused_cross_tenant"] <= 0:
        raise RuntimeError(f"fusion: identical {same}, cross-tenant fused "
                           f"dispatches {counters['fused_cross_tenant']}")
    for eng, kernel in ENGINE_KERNEL.items():
        if lanes.get(eng, 0) != launches[kernel]:
            raise RuntimeError(f"fusion: {eng} {lanes.get(eng, 0)} "
                               f"DEVICE_UTIL dispatches, {launches[kernel]} "
                               "launches")
    if not (poison["a_identical"] and raised and retries == ["a", "b"]
            and poison["fused_cross_tenant"] == 1):
        raise RuntimeError(f"fusion: poisoned unit {poison}")
    return cuts["a"], solo["a"]["bytes"], solo["a"]["wall_s"]


#: the serve daemon's start-up limit, and a served job's answer limit
SERVE_START_S = 300
SERVE_JOB_S = 900
#: the SIGKILL part's POA megabatch: ~4 of the first cut's ~1,000 windows
SERVE_KILL_MEGABATCH = 256


def daemon_socket(work, name) -> str:
    """``<work>/<name>.sock``, or one in a fresh temporary directory
    where that path is too long for a unix socket (~108 bytes)."""
    sock = os.path.join(work, name + ".sock")
    if len(sock) > 100:
        sock = os.path.join(tempfile.mkdtemp(prefix="rts"), name + ".sock")
    return sock


def start_daemon(work, name, env, jobs: int = 2, sock: str = None):
    """The port's daemon in a subprocess on the card (``serve --jobs``),
    its output to ``<work>/<name>.log``; returns (process, socket path,
    log path) once the socket answers."""
    sock = sock or daemon_socket(work, name)
    return await_daemon(*spawn(work, name, env, ["serve", "--socket", sock,
                                                 "--jobs", str(jobs)],
                               sock), name)


def spawn(work, name, env, argv, sock):
    """Start ``python -m racon_tpu_torch.cli <argv>`` with its output to
    ``<work>/<name>.log``; returns (process, socket path, log path)
    without waiting."""
    log = os.path.join(work, name + ".log")
    with open(log, "ab") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch.cli", *argv], cwd=ROOT,
            env=env, stdout=fh, stderr=fh)
    return proc, sock, log


def await_daemon(proc, sock, log, name):
    """Wait until the daemon (or router) at ``sock`` answers ``health``;
    returns (process, socket path, log path)."""
    from racon_tpu_torch.serve import client

    deadline = time.perf_counter() + SERVE_START_S
    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"serve: daemon {name} exited "
                               f"{proc.returncode}: {tail(log)}")
        try:
            if client.health(sock, timeout=5)["ok"]:
                return proc, sock, log
        except client.ServeError:
            pass
        time.sleep(0.2)
    proc.kill()
    raise RuntimeError(f"serve: daemon {name} never answered: {tail(log)}")


def stop_daemon(proc, sock) -> None:
    """Drain and stop a daemon (killed if it does not exit in 2 min)."""
    from racon_tpu_torch.serve import client

    if proc.poll() is None:
        try:
            client.admin(sock, "shutdown", timeout=30)
        except client.ServeError:
            proc.terminate()
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as fh:
            return fh.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def serve_spec(paths, threads: int, **kw) -> dict:
    """A job spec of the main path's options (-m 5 -x -4 -g -8 -c 1
    --cudaaligner-batches 1)."""
    reads, paf, draft = paths
    return {"sequences": reads, "overlaps": paf, "targets": draft,
            "threads": threads, "match": 5, "mismatch": -4, "gap": -8,
            "cuda_poa_batches": 1, "cuda_aligner_batches": 1, **kw}


def served(sock, spec, tag, **kw) -> tuple:
    """Submit one job and wait for it; (FASTA bytes, response, client
    wall s).  A failed job fails the phase."""
    import base64

    from racon_tpu_torch.serve import client

    t0 = time.perf_counter()
    resp = client.submit(sock, spec, timeout=SERVE_JOB_S, **kw)
    wall = time.perf_counter() - t0
    if not resp.get("ok"):
        raise RuntimeError(f"serve {tag}: {resp.get('error')}")
    return base64.b64decode(resp["fasta_b64"]), resp, wall


def job_line(resp, client_wall) -> dict:
    """What a served job's line reports: walls, per-job build and load
    deltas, launches, resumed windows and stage walls."""
    g = resp["report"]["run"]["gauges"]
    d = resp["report"]["details"]
    return {"job_id": resp["job_id"], "wall_s": resp["wall_s"],
            "client_wall_s": round(client_wall, 3),
            "builds": g.get("cuda_kernel_builds"),
            "loads": g.get("cuda_kernel_loads"),
            "native_builds": g.get("native_builds"),
            "launches": d["launches"],
            "poa_resumed_windows": d.get("poa_resumed_windows", 0),
            "stage_walls_s": {k: round(v, 3)
                              for k, v in d["stage_walls"].items()},
            "predicted_wall_s": (resp.get("estimate") or {}).get(
                "predicted_wall_s")}


#: the executor's counters the concurrent-tenant run reads (deltas)
FUSION_COUNTERS = ("fusion_dispatches", "fusion_units_fused",
                   "fused_megabatches", "fused_cross_tenant")


def fuse_cuts(work, data) -> dict:
    """The fusion phase's two FUSE_CUT_BP cuts of the set (its first
    two)."""
    return {name: cut_region(data, os.path.join(work, f"fuse_{name}"),
                             FUSE_CUT_BP, start=k * FUSE_CUT_BP)
            for k, name in enumerate("ab")}


def serve_tenants(work, data, sock, threads) -> None:
    """The serve phase's ``tenants`` part: the two 500 kb cuts alone, then
    together as two tenants on the daemon at ``sock``; each one's bytes
    must be as alone."""
    import threading

    from racon_tpu_torch.serve import client

    cuts = fuse_cuts(work, data)
    solo = {}
    for name, cut in cuts.items():
        out, resp, wall = served(sock, serve_spec(cut, threads,
                                                  tenant=name), name)
        solo[name] = (out, job_line(resp, wall))
    before = client.metrics(sock)["snapshot"]
    both, errors = {}, []

    def run(name):
        try:
            out, resp, wall = served(
                sock, serve_spec(cuts[name], threads, tenant=name),
                "tenant " + name)
            both[name] = (out, job_line(resp, wall))
        except BaseException as exc:      # raised below
            errors.append(exc)

    t0 = time.perf_counter()
    workers = [threading.Thread(target=run, args=(n,)) for n in cuts]
    for w in workers:
        w.start()
    for w in workers:
        w.join(SERVE_JOB_S)
    together = time.perf_counter() - t0
    if errors:
        raise errors[0]
    after = client.metrics(sock)["snapshot"]
    hists = after["histograms"]
    waits = {n: {k: hists.get(f"{k}.{n}", {}).get("percentiles")
                 for k in ("serve_queue_wait_s", "serve_tenant_wait_s")}
             for n in cuts}
    counters = {k: after["counters"].get(k, 0)
                - before["counters"].get(k, 0) for k in FUSION_COUNTERS}
    same = {n: both[n][0] == solo[n][0] for n in cuts}
    emit("serve", part="tenants", cut_bp=FUSE_CUT_BP, identical=same,
         solo={n: solo[n][1] for n in cuts},
         concurrent={n: both[n][1] for n in cuts},
         concurrent_wall_s=round(together, 3), counters=counters,
         fusion_occupancy=(hists.get("fusion_occupancy") or {}).get(
             "percentiles"), waits=waits)
    if not all(same.values()):
        raise RuntimeError(f"serve: concurrent tenants {same}")


def serve_default(cli, work, data, base, threads) -> None:
    """The serve phase's ``default`` part: a default-path job on the
    first 500 kb cut at the built-in rates, pinned, on a daemon of its
    own, against its one-shot twin."""
    from racon_tpu_torch.cuda.polisher import CudaPolisher

    cuts = fuse_cuts(work, data)
    pins = {"RACON_TPU_TORCH_RATE_POA_DEV":
            str(CudaPolisher.POA_DEV_US_PER_UNIT),
            "RACON_TPU_TORCH_RATE_POA_CPU":
            str(CudaPolisher.POA_CPU_US_PER_UNIT),
            "RACON_TPU_TORCH_RATE_ALIGN_DEV":
            str(CudaPolisher.DEV_NS_PER_ROW),
            "RACON_TPU_TORCH_RATE_ALIGN_CPU":
            str(CudaPolisher.CPU_NS_PER_CELL),
            "RACON_TPU_TORCH_RATE_ALIGN_WFA_DEV":
            str(CudaPolisher.WFA_DEV_NS_PER_STEP)}
    argv = ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8", "-c",
            "1", "--cudaaligner-batches", "1"]
    one_path = os.path.join(work, "serve_default_one_shot.fasta")
    with env_set(**{**dict.fromkeys(DEFAULT_PATH_KNOBS), **pins}):
        _, one_wall, one_launches = counted_polish(
            cli, argv + list(cuts["a"]), one_path)
    proc, sock, log = start_daemon(work, "serve_b", {**base, **pins})
    try:
        out, resp, wall = served(sock, serve_spec(cuts["a"], threads),
                                 "default")
    finally:
        stop_daemon(proc, sock)
    same = out == read_bytes(one_path)
    emit("serve", part="default", cut_bp=FUSE_CUT_BP, pins=pins,
         identical=same, job=job_line(resp, wall),
         one_shot_wall_s=round(one_wall, 3),
         one_shot_launches=one_launches,
         poa_split=resp["report"]["details"]["poa_split_detail"])
    if not same:
        raise RuntimeError("serve: the default-path job's bytes differ "
                           "from its one-shot twin's")


def serve_phase(cli, work, data, batch, threads, cut=None, cut_bytes=None,
                cut_wall=None) -> None:
    """The serve daemon on the card (module docstring): cold and warm
    jobs, two concurrent tenants, a default-path job and one SIGKILL
    resume, at the main path's POA megabatch ``batch``.  The cold, warm
    and SIGKILL jobs polish ``cut`` (fusion's first 500 kb), whose staged
    cache-off bytes are ``cut_bytes`` in a one-shot run of ``cut_wall``
    s; all three are made here when None."""
    import signal
    import threading

    import torch

    from racon_tpu_torch.serve import client

    # the daemons size their megabatches from the card's free memory
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("RACON_TPU_TORCH_") or k in (
                "RACON_TPU_TORCH_CACHE_DIR",)}
    # staged, all on the card, cache off, the main path's megabatches
    staged = {**base, **STAGED_ENV, "RACON_TPU_TORCH_CACHE": "0",
              "RACON_TPU_TORCH_POA_MEGABATCH": str(batch)}
    if cut is None:
        cut = fuse_cuts(work, data)["a"]
    if cut_bytes is None:
        cut_path = os.path.join(work, "serve_cut.fasta")
        with env_set(**STAGED_ENV, RACON_TPU_TORCH_CACHE="0"):
            _, cut_wall, _ = counted_polish(
                cli, ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8",
                      "-c", "1", "--cudaaligner-batches", "1", *cut],
                cut_path)
        cut_bytes = read_bytes(cut_path)
    live = []
    try:
        # ---- a: a cold and a warm job of the first cut; c: two tenants
        proc, sock, log = start_daemon(work, "serve_a", staged)
        live.append((proc, sock))
        jobs = {}
        for tag in ("cold", "warm"):
            out, resp, wall = served(sock, serve_spec(cut, threads), tag)
            jobs[tag] = {**job_line(resp, wall),
                         "identical": out == cut_bytes}
        emit("serve", part="cold_warm", jobs=jobs, cut_bp=FUSE_CUT_BP,
             one_shot_wall_s=round(cut_wall, 3), megabatch=batch)
        if not all(j["identical"] for j in jobs.values()):
            raise RuntimeError("serve: a served job's bytes differ from "
                               "the one-shot polish's")
        if jobs["warm"]["builds"] != 0 or jobs["warm"]["loads"] != 0:
            raise RuntimeError(f"serve: warm job {jobs['warm']}")
        for tag, j in jobs.items():
            for name in ("poa_full", "align_wfa", "align_band"):
                if j["launches"][name] <= 0:
                    raise RuntimeError(f"serve {tag}: no {name} launch")
        serve_tenants(work, data, sock, threads)
        stop_daemon(proc, sock)
        live.pop()
        serve_default(cli, work, data, base, threads)

        # ---- d: SIGKILL mid-megabatch, restart, keyed resubmit
        from racon_tpu_torch.serve import journal as serve_journal

        kill_sock = daemon_socket(work, "serve_kill")
        for old in (kill_sock, serve_journal.journal_path(kill_sock)):
            if os.path.exists(old):
                os.remove(old)
        # the first cut in megabatches of SERVE_KILL_MEGABATCH windows:
        # the kill comes with some of them committed
        kill_env = {**staged, "RACON_TPU_TORCH_POA_MEGABATCH":
                    str(SERVE_KILL_MEGABATCH)}
        proc, sock, log = start_daemon(
            work, "serve_kill", {**kill_env, "RACON_TPU_TORCH_FAULT":
                                 "mid-megabatch:2"}, sock=kill_sock)
        live.append((proc, sock))
        key, held = "chip-smoke-kill", {}

        def doomed():
            try:
                held["resp"] = client.submit(sock, serve_spec(cut, threads),
                                             job_key=key,
                                             timeout=SERVE_JOB_S)
            except client.ServeError as exc:
                held["err"] = str(exc)

        t0 = time.perf_counter()
        killer = threading.Thread(target=doomed)
        killer.start()
        rc = proc.wait(timeout=SERVE_JOB_S)
        killed_after = time.perf_counter() - t0
        killer.join(60)
        live.pop()
        if rc != -signal.SIGKILL or "resp" in held:
            raise RuntimeError(f"serve: the armed daemon exited {rc}, "
                               f"answered {held}: {tail(log)}")
        proc, sock, log = start_daemon(work, "serve_kill", kill_env,
                                       sock=kill_sock)
        live.append((proc, sock))
        t0 = time.perf_counter()
        resp = client.submit_with_retry(sock, serve_spec(cut, threads),
                                        retries=4, job_key=key,
                                        timeout=SERVE_JOB_S)
        wall = time.perf_counter() - t0
        if not resp.get("ok"):
            raise RuntimeError(f"serve resume: {resp.get('error')}")
        import base64

        same = base64.b64decode(resp["fasta_b64"]) == cut_bytes
        health = client.health(sock)
        job = job_line(resp, wall)
        emit("serve", part="sigkill", site="mid-megabatch:2",
             cut_bp=FUSE_CUT_BP, megabatch=SERVE_KILL_MEGABATCH,
             killed_after_s=round(killed_after, 3), identical=same,
             recovered_jobs=health["recovered_jobs"],
             journal=health["journal"], job=job)
        if not same or health["recovered_jobs"] != 1 \
                or job["poa_resumed_windows"] <= 0:
            raise RuntimeError(f"serve: SIGKILL resume identical {same}, "
                               f"recovered {health['recovered_jobs']}, "
                               f"resumed {job['poa_resumed_windows']}")
        stop_daemon(proc, sock)
        live.pop()
    finally:
        for proc, sock in live:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit("serve", part="done",
         phase_s=round(time.perf_counter() - t_phase, 3))


#: contigs of the fleet phase's job: contiguous cuts of the set's first
#: FLEET_BP bases
FLEET_CONTIGS = 4
FLEET_BP = 2_000_000
#: the contigs of the failover part's job: the first two of the four
FAILOVER_CONTIGS = 2
#: every fleet process's POA megabatch: part c kills a backend after its
#: first one, and a pinned size makes each shard's megabatches alike
FLEET_MEGABATCH = 2048
#: the routers' knobs: a probe every half second, and no straggler
#: replacements, so that each part pins which backend runs each shard
FLEET_ROUTE_ENV = {"RACON_TPU_TORCH_ROUTE_PROBE_S": "0.5",
                   "RACON_TPU_TORCH_SCATTER_REBALANCE": "0"}


def fleet_data(work, data, truth, cpu) -> tuple:
    """The set's first FLEET_BP draft bases cut into FLEET_CONTIGS
    contiguous regions with their reads, joined into one job
    (``tools/simulate.py:concat_sets``);
    returns (paths, the paths of the job of the first FAILOVER_CONTIGS
    regions, the truth segment of each contig, the draft's summed
    distance to them)."""
    from racon_tpu_torch.tools import simulate

    draft = read_fasta(os.path.join(data, "draft.fasta"))
    scale = len(draft) / len(truth)
    total = min(FLEET_BP, len(draft))
    step = total // FLEET_CONTIGS
    bounds = [i * step for i in range(FLEET_CONTIGS)] + [total]
    cuts = [cut_region(data, os.path.join(work, f"fleet_cut{i}"),
                       bounds[i + 1] - bounds[i], start=bounds[i])
            for i in range(FLEET_CONTIGS)]
    ends = [0] + [len(truth) if b == len(draft) else
                  len(truth_prefix(truth, draft[:b], scale))
                  for b in bounds[1:]]
    segs = [truth[ends[i]:ends[i + 1]] for i in range(FLEET_CONTIGS)]
    d_draft = sum(chunked_distance(draft[bounds[i]:bounds[i + 1]], segs[i],
                                   cpu) for i in range(FLEET_CONTIGS))
    return simulate.concat_sets(cuts, os.path.join(work, "fleet")), \
        simulate.concat_sets(cuts[:FAILOVER_CONTIGS],
                             os.path.join(work, "fleet_failover")), segs, \
        d_draft


def fasta_head(fa: bytes, n: int) -> bytes:
    """The first ``n`` records of a FASTA byte string, as they were."""
    return b"".join(b">" + rec for rec in fa.split(b">")[1:n + 1])


def reads_on_two_contigs(paf: str) -> int:
    """The reads with PAF records on more than one target: where a split
    run's per-chunk overlap filter could keep another overlap than the
    whole run's."""
    targets = {}
    with open(paf, "rb") as fh:
        for line in fh:
            f = line.split(b"\t", 6)
            targets.setdefault(f[0], set()).add(f[5])
    return sum(1 for t in targets.values() if len(t) > 1)


def waterfall_sum(text: str) -> float:
    """The summed stage walls of an ``explain`` waterfall as rendered
    (``serve/explain.py:_fmt_s``); the "(other)" row has no bar."""
    unit = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}
    return sum(float(v) * unit[u] for v, u in re.findall(
        r"(?m)^  \S+\s+([0-9.]+)(ms|s|m|h)\s+#+", text))


def read_side(argv) -> tuple:
    """``python -m racon_tpu_torch.cli <argv>`` in this process, with no
    interpreter start (the read side's subcommands open no CUDA
    context): (exit code, standard output)."""
    import io

    from racon_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(list(argv))
            code = 0
        except SystemExit as exc:
            code = exc.code if isinstance(exc.code, int) else \
                (0 if exc.code is None else 1)
    return code, buf.getvalue()


def run_wrapper(work, argv, env, log):
    """The port's wrapper (``racon_tpu_torch.tools.wrapper``) from
    ``work`` (its work directory goes there); (completed process, wall
    s), its stderr also to ``<work>/<log>.log``."""
    env = {**env, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)}
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "racon_tpu_torch.tools.wrapper", *argv], cwd=work,
                         env=env, capture_output=True, timeout=SERVE_JOB_S)
    wall = time.perf_counter() - t
    with open(os.path.join(work, log + ".log"), "wb") as fh:
        fh.write(out.stderr)
    return out, wall


def fasta_records(fa: bytes) -> list:
    """(name, sequence) of every record of a FASTA byte string."""
    out = []
    for rec in fa.split(b">")[1:]:
        head, _, seq = rec.partition(b"\n")
        out.append((head.split()[0].decode(), seq.replace(b"\n", b"")))
    return out


def compute_apps() -> dict:
    """pid -> used memory of the card's compute processes, as
    ``nvidia-smi --query-compute-apps=pid,used_memory`` lists them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = mem.strip()
    return apps


def card_holders(pids) -> set:
    """The pids among ``pids`` with a card's device node (/dev/nvidia<N>)
    open: the processes that hold a CUDA context on it."""
    out = set()
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                out.add(pid)
                break
    return out


def fleet_phase(cpu, work, data, truth, threads) -> None:
    """The fleet on the card (module docstring): two backends and a
    router, a routed and a scattered job, a failover, two ranks, the
    fleet scrape, the wrapper split and served, the read side (inspect,
    top, explain) and the card's processes."""
    import base64
    import hashlib
    import signal

    import torch

    from racon_tpu_torch.obs import aggregate, export
    from racon_tpu_torch.serve import client

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("RACON_TPU_TORCH_") or k in (
                "RACON_TPU_TORCH_CACHE_DIR",)}
    # staged, all on the card, cache off, pinned megabatches
    staged = {**base, **STAGED_ENV, "RACON_TPU_TORCH_CACHE": "0",
              "RACON_TPU_TORCH_POA_MEGABATCH": str(FLEET_MEGABATCH)}
    live, apps_seen, holders = [], {}, set()

    def sample_apps():
        for pid, mem in compute_apps().items():
            apps_seen.setdefault(pid, mem)
        holders.update(card_holders(p.pid for p, _ in live))

    def distance(fa: bytes) -> int:
        recs = fasta_records(fa)
        if [n for n, _ in recs] != [f"ctg{i}" for i in range(FLEET_CONTIGS)]:
            raise RuntimeError(f"fleet: contigs {[n for n, _ in recs]}")
        return sum(chunked_distance(seq, segs[i], cpu)
                   for i, (_, seq) in enumerate(recs))

    def job(sock, key, job_paths=None, **kw):
        """One job's (FASTA, response, client wall); the FASTA also goes
        to ``<work>/<key>.fasta`` for a post-mortem."""
        t = time.perf_counter()
        resp = client.submit(sock, serve_spec(job_paths or paths, threads),
                             job_key=key, timeout=SERVE_JOB_S, **kw)
        wall = time.perf_counter() - t
        if not resp.get("ok"):
            raise RuntimeError(f"fleet {key}: {resp.get('error')}")
        fa = base64.b64decode(resp["fasta_b64"])
        with open(os.path.join(work, key + ".fasta"), "wb") as fh:
            fh.write(fa)
        return fa, resp, wall

    try:
        # backends a and b, and k armed to die after its first megabatch,
        # started together
        procs = [spawn(work, f"fleet_{n}", env, ["serve", "--socket",
                                                 daemon_socket(work,
                                                               f"fleet_{n}"),
                                                 "--jobs", "1"],
                       daemon_socket(work, f"fleet_{n}"))
                 for n, env in (("a", staged), ("b", staged),
                                ("k", {**staged, "RACON_TPU_TORCH_FAULT":
                                       "mid-megabatch:1"}))]
        live.extend((p[0], p[1]) for p in procs)
        # the data is cut while the daemons start
        t0 = time.perf_counter()
        paths, paths_fo, segs, d_draft = fleet_data(work, data, truth, cpu)
        emit("fleet", part="data", contigs=FLEET_CONTIGS,
             draft_bp=[len(q) for _, q in fasta_records(
                 read_bytes(paths[2]))],
             failover_contigs=FAILOVER_CONTIGS, draft_distance=d_draft,
             seconds=round(time.perf_counter() - t0, 3))
        (pa, sa, _), (pb, sb, _), (pk, sk, _) = [
            await_daemon(*p, f"fleet_{n}") for p, n in zip(procs, "abk")]
        route_env = {**base, **FLEET_ROUTE_ENV}
        # the two routers, started together
        rsock = daemon_socket(work, "fleet_r")
        ksock = daemon_socket(work, "fleet_rk")
        routers = [spawn(work, name, route_env, ["route", "--socket", sock,
                                                 "--backends", backends],
                         sock)
                   for name, sock, backends in (
                       ("fleet_r", rsock, f"{sa},{sb}"),
                       ("fleet_rk", ksock, f"{sk},{sb}"))]
        live.extend((p[0], p[1]) for p in routers)
        pr, prk = [await_daemon(*p, name)[0] for p, name in
                   zip(routers, ("fleet_r", "fleet_rk"))]
        sample_apps()

        # ---- a: the job whole, through the router
        whole, resp, wall_a = job(rsock, "fleet-routed")
        routed = resp
        d_pol = distance(whole)
        why = [e for e in client.flight(rsock, job_key="fleet-routed")[
            "events"] if e["kind"] == "route"]
        launches = resp["report"]["details"]["launches"]
        emit("fleet", part="routed", bytes=len(whole),
             sha1=hashlib.sha1(whole).hexdigest(),
             draft_distance=d_draft, polished_distance=d_pol,
             backend=resp["routed_backend"],
             why=[{k: e.get(k) for k in ("backend", "round", "load",
                                         "predicted_wall_s")}
                  for e in why], wall_s=resp["wall_s"],
             client_wall_s=round(wall_a, 3), launches=launches)
        if d_pol > d_draft / 10:
            raise RuntimeError(f"fleet routed: distance {d_pol} > draft "
                               f"{d_draft} / 10")
        if launches["poa_full"] <= 0 or launches["align_wfa"] <= 0:
            raise RuntimeError(f"fleet routed: launches {launches}")

        # ---- b: the first two contigs as two target shards, staged,
        # one on each backend (their bytes: whole's first two)
        whole_fo = fasta_head(whole, FAILOVER_CONTIGS)
        fa, resp, wall_b = job(rsock, "fleet-scatter", job_paths=paths_fo,
                               shards=2)
        rep = resp["report"]
        shards = [{"backend": ps["backend"], "wall_s": ps["wall_s"],
                   "parse_skipped_bytes": sr["run"]["gauges"].get(
                       "host.parse_skipped_bytes"),
                   "staged_bytes": sr["run"]["gauges"].get(
                       "host.staged_bytes"),
                   "launches": sr["details"]["launches"]}
                  for ps, sr in zip(rep["per_shard"], rep["shard_reports"])]
        emit("fleet", part="scattered", contigs=FAILOVER_CONTIGS,
             identical=fa == whole_fo, shards=shards,
             gather_wall_s=resp["wall_s"], client_wall_s=round(wall_b, 3))
        if fa != whole_fo or {s["backend"] for s in shards} != {sa, sb}:
            raise RuntimeError(f"fleet scattered: identical "
                               f"{fa == whole_fo}, backends "
                               f"{[s['backend'] for s in shards]}")
        if any(not s["parse_skipped_bytes"] for s in shards):
            raise RuntimeError(f"fleet scattered: a shard parsed it all "
                               f"{shards}")

        # ---- c: the first two contigs as two shards, with shard 0's
        # backend killed mid-shard (their bytes: whole's first two)
        fa, resp, wall_c = job(ksock, "fleet-failover", job_paths=paths_fo,
                               shards=2)
        rc = pk.wait(timeout=60)
        counters = client.route_status(ksock)["counters"]
        events = client.flight(ksock, job_key="fleet-failover")["events"]
        key0 = "fleet-failover-shard-0of2"
        failed = [e for e in events if e["kind"] == "route_failover"]
        won = [e for e in events if e["kind"] == "route_scatter_shard"
               and e.get("key") == key0 and e.get("winner")]
        done = [r for r in client.journal_query(sb, job_key=key0)["records"]
                if r.get("kind") == "done"]
        emit("fleet", part="failover", contigs=FAILOVER_CONTIGS,
             identical=fa == whole_fo,
             killed_rc=rc, route_failover=counters.get("route_failover", 0),
             failover_keys=[e.get("job_key") for e in failed],
             survivor=won[0]["backend"] if won else None,
             survivor_done_records=len(done),
             backends=resp["scatter"]["backends"],
             wall_s=resp["wall_s"], client_wall_s=round(wall_c, 3))
        if fa != whole_fo or rc != -signal.SIGKILL \
                or counters.get("route_failover", 0) < 1 \
                or key0 not in [e.get("job_key") for e in failed] \
                or not won or won[0]["backend"] != sb or not done:
            raise RuntimeError("fleet failover: the survivor did not run "
                               "the dead backend's shard under its key, or "
                               "the bytes differ")

        # ---- d: the one-shot CLI as two ranks at once, on the failover
        # part's two contigs (one each)
        argv = ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8", "-c",
                "1", "--cudaaligner-batches", "1", *paths_fo]
        ranks = []
        for r in range(2):
            out = open(os.path.join(work, f"fleet_part{r}.fasta"), "wb")
            err = open(os.path.join(work, f"fleet_part{r}.log"), "wb")
            env = {**staged, "RACON_TPU_TORCH_COORD": "localhost:0",
                   "RACON_TPU_TORCH_NPROC": "2",
                   "RACON_TPU_TORCH_RANK": str(r)}
            ranks.append((subprocess.Popen(
                [sys.executable, "-m", "racon_tpu_torch.cli", *argv],
                cwd=ROOT, env=env, stdout=out, stderr=err),
                out, err, time.perf_counter()))
            live.append((ranks[-1][0], None))
        rank_walls = [None, None]
        while any(w is None for w in rank_walls):
            sample_apps()
            for r, (proc, out, err, t) in enumerate(ranks):
                if rank_walls[r] is None and proc.poll() is not None:
                    rank_walls[r] = round(time.perf_counter() - t, 3)
                    out.close()
                    err.close()
            time.sleep(0.5)
        parts = [read_bytes(os.path.join(work, f"fleet_part{r}.fasta"))
                 for r in range(2)]
        rcs = [proc.returncode for proc, _, _, _ in ranks]
        emit("fleet", part="ranks", identical=parts[0] + parts[1] == whole_fo,
             rcs=rcs, walls_s=rank_walls,
             contigs=[[n for n, _ in fasta_records(p)] for p in parts])
        if rcs != [0, 0] or parts[0] + parts[1] != whole_fo:
            raise RuntimeError(f"fleet ranks: rcs {rcs}, "
                               f"{[len(p) for p in parts]} bytes")

        # ---- e: the fleet scrape against the daemons' own registries
        snaps = {}
        for sock in (sa, sb):
            m = client.metrics(sock)
            snaps[m["identity"]["daemon_id"]] = m
        rc, out = read_side(["metrics", "--fleet", f"{sa},{sb}", "--json"])
        if rc != 0:
            raise RuntimeError(f"fleet metrics: exit {rc}")
        doc = json.loads(out)
        merged = aggregate.merge_snapshots(
            {k: m["snapshot"] for k, m in snaps.items()})
        keys = sorted({k for m in snaps.values()
                       for k in m["snapshot"]["counters"]
                       if k.startswith("cuda_kernel_launches.")})
        counters = {k: {"fleet": doc["merged"]["counters"].get(k, 0),
                        "daemons": [m["snapshot"]["counters"].get(k, 0)
                                    for m in snaps.values()]}
                    for k in keys}
        q_bad = [name for name, h in doc["merged"]["histograms"].items()
                 if {q: export.percentiles(h).get(q) for q in
                     ("p50", "p90", "p99")} != {
                         q: export.percentiles(
                             merged["histograms"][name]).get(q)
                         for q in ("p50", "p90", "p99")}]
        emit("fleet", part="fleet_metrics", alive=doc["alive"],
             launch_counters=counters,
             histograms=len(doc["merged"]["histograms"]),
             quantile_mismatches=q_bad)
        if doc["alive"] != 2 or not keys or q_bad or any(
                c["fleet"] != sum(c["daemons"]) or c["fleet"] <= 0
                for c in counters.values()):
            raise RuntimeError(f"fleet metrics: {counters}, {q_bad}")

        # ---- g: the wrapper, one one-shot process per chunk, on the
        # failover part's two contigs: two chunks of one contig (the
        # chunk size of the larger one)
        flags = ["-c", "1", "--cudaaligner-batches", "1", "-t",
                 str(threads)]
        lens = [len(q) for _, q in fasta_records(read_bytes(paths_fo[2]))]
        split = max(lens)
        report = os.path.join(work, "wrapper_chunk.metrics.json")
        out, wall_w = run_wrapper(
            work, ["--split", str(split), *flags, *paths_fo],
            {**staged, "RACON_TPU_TORCH_METRICS_JSON": report},
            "wrapper_split")
        chunks = re.findall(rb"target split into (\d+) chunk", out.stderr)
        device = [{"poa_s": float(p), "align_s": float(a)}
                  for p, a in re.findall(rb"device poa ([0-9.]+) s / align "
                                         rb"([0-9.]+) s", out.stderr)]
        two = reads_on_two_contigs(paths_fo[1])
        emit("fleet", part="wrapper_split", rc=out.returncode,
             contigs=FAILOVER_CONTIGS, identical=out.stdout == whole_fo,
             split_bytes=split,
             chunks=int(chunks[0]) if chunks else None, chunk_device=device,
             reads_on_two_contigs=two, wall_s=round(wall_w, 3))
        if out.returncode != 0 or out.stdout != whole_fo \
                or chunks != [b"2"] \
                or len(device) != 2 or two != 0 \
                or any(d["poa_s"] <= 0 or d["align_s"] <= 0
                       for d in device):
            raise RuntimeError(f"fleet wrapper_split: rc {out.returncode}, "
                               f"{chunks} chunks, device {device}, "
                               f"{two} reads on two contigs: "
                               f"{out.stderr[-2000:]}")

        # ---- h: the wrapper against the router on the failover part's
        # two contigs, two chunks of one contig (the chunk size of the
        # larger one), which it scatters; then the same invocation again,
        # answered by the backends' journals
        def done_counts():
            return {sock: client.metrics(sock)["snapshot"]["counters"]
                    for sock in (sa, sb)}

        def delta(after, before, name):
            return sum(after[k].get(name, 0) - before[k].get(name, 0)
                       for k in after)

        sargs = ["--server", rsock, "--split", str(split), *flags,
                 *paths_fo]
        c0 = done_counts()
        out, wall_s = run_wrapper(work, sargs, base, "wrapper_served")
        c1 = done_counts()
        again, wall_r = run_wrapper(work, sargs, base, "wrapper_served2")
        c2 = done_counts()
        scat = [e for e in client.flight(rsock)["events"]
                if e["kind"] == "route_scatter"
                and str(e.get("job_key", "")).startswith("wrap-")]
        wkey = scat[-1]["job_key"] if scat else None
        # the winners of both runs: the repeat's are the same two keys
        won = sorted({e.get("key") for e in client.flight(
            rsock, job_key=wkey)["events"] if wkey
            and e["kind"] == "route_scatter_shard" and e.get("winner")})
        taken = b"scatter-capable router" in out.stderr
        emit("fleet", part="wrapper_served", rc=[out.returncode,
                                                 again.returncode],
             scatter_taken=taken, job_key=wkey,
             shard_keys=scat[-1]["keys"] if scat else None,
             shard_winners=won, contigs=FAILOVER_CONTIGS,
             identical=out.stdout == whole_fo, wall_s=round(wall_s, 3),
             wrapper_split_wall_s=round(wall_w, 3),
             repeat={"identical": again.stdout == whole_fo,
                     "wall_s": round(wall_r, 3),
                     "jobs_run": delta(c2, c1, "serve_jobs_completed"),
                     "dedup_hits": delta(c2, c1, "serve_dedup_hits")},
             jobs_run=delta(c1, c0, "serve_jobs_completed"))
        if out.returncode or again.returncode or not taken \
                or out.stdout != whole_fo or again.stdout != whole_fo \
                or won != sorted(scat[-1]["keys"]) \
                or delta(c2, c1, "serve_jobs_completed") \
                or delta(c2, c1, "serve_dedup_hits") != 2:
            raise RuntimeError(f"fleet wrapper_served: {out.stderr[-2000:]}"
                               f" {again.stderr[-1000:]}")

        # ---- i: the failover job's lineage across the router, the dead
        # backend and the survivor
        tpath = os.path.join(work, "lineage_trace.json")
        out = subprocess.run(
            [sys.executable, "-m", "racon_tpu_torch.cli", "inspect",
             "--fleet", ksock, "--job-key", "fleet-failover", "--json",
             "--trace-out", tpath], cwd=ROOT, env=base, capture_output=True,
            timeout=300)
        lin = json.loads(out.stdout) if out.stdout.strip() else {}
        with open(tpath) as fh:
            flows = sum(1 for e in json.load(fh)["traceEvents"]
                        if e.get("ph") in ("s", "f"))
        keys = {n["key"] for n in lin.get("nodes", ())}
        edges = {(e["kind"], e["from"], e["to"])
                 for e in lin.get("edges", ())}
        shard_keys = [f"fleet-failover-shard-{i}of2" for i in range(2)]
        complete = bool(lin.get("complete")) \
            and {"fleet-failover", *shard_keys} <= keys \
            and ("failover", key0, key0) in edges \
            and all(("gather", k, "fleet-failover") in edges
                    for k in shard_keys)
        text_rc, text = read_side(["inspect", "--fleet", ksock,
                                   "--job-key", "fleet-failover"])
        lanes = [l for l in text.splitlines() if l.startswith("lane ")]
        emit("fleet", part="inspect_fleet", rc=[out.returncode, text_rc],
             complete=complete, nodes=sorted(keys),
             edges=sorted(edges), warnings=lin.get("warnings"),
             offsets=[{"target": d["target"],
                       "offset_s": d["clock_offset_s"],
                       "confidence_s": d["offset_confidence_s"],
                       "ok": d["ok"]} for d in lin.get("daemons", ())],
             flow_events=flows, lanes=lanes)
        if out.returncode or text_rc or not complete \
                or flows <= 0 or len(lanes) != 3:
            raise RuntimeError(f"fleet inspect_fleet: {out.stderr[-2000:]}"
                               f" {text[-3000:]}")

        # ---- j: top of the router's fleet against a scrape of the same
        # daemons, no job in between
        top_rc, out = read_side(["top", "--fleet", rsock, "--once",
                                 "--json"])
        top = json.loads(out)
        scrape_rc, out = read_side(["metrics", "--fleet",
                                    f"{rsock},{sa},{sb}", "--json"])
        mdoc = json.loads(out)
        rows = {d["target"]: d for d in top["daemons"]}
        route = (rows.get(rsock) or {}).get("route") or {}
        same = top["merged"]["counters"] == mdoc["merged"]["counters"]
        emit("fleet", part="top_fleet", rc=[top_rc, scrape_rc],
             targets=list(rows), alive=top["alive"],
             router_backends=[b.get("target")
                              for b in route.get("backends", ())],
             route_counters=route.get("counters"),
             counters_equal=same,
             counters=len(top["merged"]["counters"]))
        if top_rc or scrape_rc or not same \
                or list(rows) != [rsock, sa, sb] or top["alive"] != 3 \
                or sorted(b.get("target") for b in route.get(
                    "backends", ())) != sorted([sa, sb]):
            raise RuntimeError(f"fleet top_fleet: {list(rows)}, counters "
                               f"equal {same}")

        # ---- k: the routed job's waterfall from its backend, and a
        # wrapper chunk's from its run report
        jid, bsock = routed["job_id"], routed["routed_backend"]
        rcs, texts = zip(*(read_side(a) for a in (
            ["explain", "--socket", bsock, "--job", str(jid), "--json"],
            ["explain", "--socket", bsock, "--job", str(jid)],
            ["explain", "--metrics-json", report])))
        stages = [e for e in json.loads(texts[0])["events"]
                  if e["kind"] == "job_stages"]
        with open(report) as fh:
            rep_walls = json.load(fh)["details"]["stage_walls"]
        want = sum(routed["report"]["details"]["stage_walls"].values())
        got = {"job_stages": sum(stages[-1]["stage_walls"].values())
               if stages else None,
               "rendered": waterfall_sum(texts[1]),
               "report": sum(rep_walls.values()),
               "report_rendered": waterfall_sum(texts[2])}
        emit("fleet", part="explain", rc=list(rcs),
             job=jid, backend=bsock, routed_stage_walls_sum=round(want, 6),
             sums={k: None if v is None else round(v, 6)
                   for k, v in got.items()})
        ok = (got["job_stages"] is not None
              and abs(got["job_stages"] - want) <= 0.01 * want
              and abs(got["rendered"] - want) <= 0.01 * want
              and abs(got["report_rendered"] - got["report"])
              <= 0.01 * got["report"])
        if any(rcs) or not ok:
            raise RuntimeError(f"fleet explain: {got} against {want}: "
                               f"{texts[1][-2000:]}")

        # ---- f: the card's processes and each backend's memory
        sample_apps()
        memory = {sock: client.metrics(sock)["device_memory"]
                  for sock in (sa, sb)}
        pids = {"a": pa.pid, "b": pb.pid, "k": pk.pid, "router": pr.pid,
                "router_k": prk.pid,
                "ranks": [proc.pid for proc, _, _, _ in ranks],
                "chip_smoke": os.getpid()}
        emit("fleet", part="fleet_card", card=card_line(),
             max_memory_reserved={s: m["max_reserved_bytes"]
                                  for s, m in memory.items()},
             compute_apps={str(p): m for p, m in apps_seen.items()},
             pids=pids, card_holders=sorted(holders))
        if {pr.pid, prk.pid} & (holders | set(apps_seen)):
            raise RuntimeError("fleet: a router holds a CUDA context")
        if not {pa.pid, pb.pid} <= holders:
            raise RuntimeError(f"fleet: a backend holds no card device "
                               f"node: {sorted(holders)}")
        for proc, sock in reversed(live):
            if sock is not None:
                stop_daemon(proc, sock)
        live.clear()
    finally:
        for proc, sock in live:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit("fleet", part="done",
         phase_s=round(time.perf_counter() - t_phase, 3))


def default_path(cli, cpu, work, reads, paf, draft, truth, d_draft,
                 threads, keep=None) -> None:
    """polish_default (twice, fresh calibration store; the second run,
    on the first Mb, traced) and pipeline_bytes (pipeline off vs on,
    then on and traced, at the stored rates, pinned)."""
    from racon_tpu_torch.cuda.polisher import CudaPolisher

    store = os.path.join(work, "calib")
    shutil.rmtree(store, ignore_errors=True)
    argv = ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8", "-c",
            "1", "--cudaaligner-batches", "1"]
    knobs = dict.fromkeys(DEFAULT_PATH_KNOBS)
    doc = {}
    # the first Mb, for runs 2 and 3 and pipeline_bytes
    region_bp = min(1_000_000, len(read_fasta(draft)))
    region = cut_region(os.path.dirname(reads),
                        os.path.join(work, "region_1mb"), region_bp)
    region_truth = truth_prefix(truth, read_fasta(region[2]),
                                len(read_fasta(draft)) / len(truth))
    region_draft = chunked_distance(read_fasta(region[2]), region_truth,
                                    cpu)
    # run 3 attributes the default path's wall: the pipeline and the POA
    # split as in run 2 (its stored rates, which pipeline_bytes pins), the
    # align stage all on the card, on the first Mb
    for run in (1, 2, 3):
        out_path = os.path.join(work, f"default{run}.fasta")
        flags, tpath, mpath = trace_args(work, "default") if run == 2 \
            else ([], None, None)
        inputs, run_truth, run_draft = (
            (list(region), region_truth, region_draft) if run > 1
            else ([reads, paf, draft], truth, d_draft))
        with env_set(RACON_TPU_TORCH_CACHE_DIR=store, **{
                **knobs, "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY":
                    "1" if run == 3 else None}):
            pol, wall, launches = counted_polish(
                cli, argv + flags + inputs, out_path)
        if run < 3:
            with open(os.path.join(store, "calibration.json")) as fh:
                doc = json.load(fh)
        d_pol = chunked_distance(read_fasta(out_path), run_truth, cpu)
        a, p = pol.align_split_detail, pol.poa_split_detail
        emit("polish_default", run=run,
             align_device_only=run == 3,
             region_bp=region_bp if run > 1 else None, argv=argv,
             wall_s=round(wall, 3),
             stage_walls_s={k: round(v, 3)
                            for k, v in pol.stage_walls.items()},
             launches=launches,
             align_cut={"device": a.get("cut", 0),
                        "cpu": a.get("n_pending", 0) - a.get("cut", 0),
                        "probed": pol.align_probed,
                        "over_length": pol.align_over_length,
                        "fallthrough": pol.align_cpu_fallthrough},
             align_split=a, align_rungs=pol.align_rungs,
             align_chunks=chunk_rates(pol.align_chunks),
             align_kernel_ms={k: round(v, 3)
                              for k, v in pol.align_kernel_ms.items()},
             poa_cut={"device": p.get("cut", 0),
                      "cpu": p.get("n_eligible", 0) - p.get("cut", 0),
                      "on_kernel": pol.poa_engine.windows_on_kernel,
                      "rejected": sum(pol.poa_reject_counts.values())},
             poa_split=p, poa_batch=pol.poa_batch_size,
             poa_kernel_ms=round(pol.poa_engine.kernel_ms, 3),
             poa_spec_used=pol.poa_spec_used,
             poa_spec_wasted=pol.poa_spec_wasted,
             poa_spec_megabatches=pol.poa_spec_megabatches,
             spec_walls_s={k: round(v, 3)
                           for k, v in pol.spec_walls.items()},
             ready_high_water=pol.ready_high_water,
             pipeline_overlap_s=round(pol.pipeline_overlap_s, 3),
             stored_rates=doc, card_states=pol.card_states,
             draft_distance=run_draft, polished_distance=d_pol)
        if d_pol > run_draft / 10:
            raise RuntimeError(f"polish_default run {run}: distance "
                               f"{d_pol} > draft {run_draft} / 10")
        for name, n in launches.items():
            if n <= 0:
                raise RuntimeError(f"polish_default run {run} launched no "
                                   f"{name} kernel")
        if run == 2:
            stats = lane_stats(pol, launches, tpath, mpath)
            keep_files(keep, tpath, mpath)
            emit("traced", path="default", run=run, launches=launches,
                 wall_s=round(wall, 3), **stats)

    # pipeline_bytes: the second run's stored rates, pinned
    (ent,) = doc.values()

    def rate(stage, key, default):
        return str(ent.get(stage, {}).get(key, default))

    pins = {
        "RACON_TPU_TORCH_RATE_POA_DEV": rate(
            "poa", "dev", CudaPolisher.POA_DEV_US_PER_UNIT),
        "RACON_TPU_TORCH_RATE_POA_CPU": rate(
            "poa", "cpu", CudaPolisher.POA_CPU_US_PER_UNIT),
        "RACON_TPU_TORCH_RATE_ALIGN_DEV": rate(
            "align", "dev", CudaPolisher.DEV_NS_PER_ROW),
        "RACON_TPU_TORCH_RATE_ALIGN_CPU": rate(
            "align_cpu", "dev", CudaPolisher.CPU_NS_PER_CELL),
        "RACON_TPU_TORCH_RATE_ALIGN_WFA_DEV": rate(
            "align_wfa", "dev", CudaPolisher.WFA_DEV_NS_PER_STEP)}
    outs, runs = {}, {}
    # the pipeline off, on, and on with tracing: the same bytes
    for mode in ("off", "on", "on_traced"):
        out_path = os.path.join(work, f"pipeline_{mode}.fasta")
        flags = trace_args(work, "pipeline")[0] if mode == "on_traced" \
            else []
        with env_set(**{**knobs, **pins, "RACON_TPU_TORCH_PIPELINE":
                        "0" if mode == "off" else "1"}):
            pol, wall, launches = counted_polish(
                cli, argv + flags + list(region), out_path)
        outs[mode] = read_bytes(out_path)
        runs[mode] = {
            "wall_s": round(wall, 3), "launches": launches,
            "align_cut": pol.align_split_detail.get("cut"),
            "poa_cut": pol.poa_split_detail.get("cut"),
            "poa_spec_used": pol.poa_spec_used,
            "poa_spec_wasted": pol.poa_spec_wasted,
            "pipeline_overlap_s": round(pol.pipeline_overlap_s, 3),
            "bytes": len(outs[mode])}
    same = outs["off"] == outs["on"] == outs["on_traced"]
    emit("pipeline_bytes", region_bp=region_bp, pins=pins, runs=runs,
         identical=same)
    if not same:
        raise RuntimeError("pipeline off, on and on traced gave different "
                           "FASTA at pinned rates")


def load_sequences(path: str) -> list:
    from racon_tpu_torch.io.parsers import create_sequence_parser

    parser = create_sequence_parser(path)
    seqs: list = []
    try:
        parser.reset()
        parser.parse(seqs, -1)
    finally:
        parser.close()
    return seqs


def seed_buffers(reads: str, draft: str) -> list:
    """The code buffers the mapper's seeding launches on per round: the
    reads in its batches of up to ``chain.SEED_BATCH`` bases, then the
    draft."""
    from racon_tpu_torch.overlap import chain, minimizers

    datas = [s.data for s in load_sequences(reads)]
    bufs = [b"".join(b) for b in chain._batches(datas, chain.SEED_BATCH)]
    bufs += [s.data for s in load_sequences(draft)]
    return [minimizers.encode(b) for b in bufs]


def seed_bound(reads: str, draft: str, k: int = 13) -> dict:
    """The seed words' main-path bound of one round on these inputs: the
    buffers the round seeds, each code read once and its forward and
    reverse words (4 + 4 bytes a k-mer) written once, or its operations,
    whichever takes longer."""
    nbytes = ops = 0
    for codes in seed_buffers(reads, draft):
        nk = max(0, int(codes.size) - k + 1)
        nbytes += int(codes.size) + 8 * nk
        ops += OPS_PER_SEED_WORD * nk
    ms, by = bound(nbytes, 0, ops)
    return {"bound_ms": round(ms, 4), "bound_by": by, "bytes": nbytes}


def conv_words(codes, k: int):
    """The yardstick: one float64 conv1d (two groups) computes fw and rv
    exactly (every word < 2^30); returns (the call, its input)."""
    import torch
    x = (codes & 3).to(torch.float64)
    inp = torch.stack([x, 3 - x])[None]
    w = torch.tensor([[4.0 ** (k - 1 - j) for j in range(k)],
                      [4.0 ** j for j in range(k)]], dtype=torch.float64,
                     device=codes.device)[:, None, :]
    return lambda: torch.nn.functional.conv1d(inp, w, groups=2)


def seed_check(reads: str, draft: str, dev) -> dict:
    """map_rounds part 1: the seed-word kernel, its plain version on the
    card and numpy on every buffer the main path seeds (k 13), and on a
    1 Mb cut at k 5 and 15: 0 mismatches; per buffer the kernel's
    CUDA-event ms (median of 5), the plain version's ms (one call), the
    conv1d yardstick's ms (median of 5), the copies' ms and numpy's."""
    import numpy as np
    import torch
    from racon_tpu_torch.cuda import seed_words as sw
    from racon_tpu_torch.overlap import minimizers

    bufs = seed_buffers(reads, draft)
    rows, mismatches, err = [], 0, 0
    tot = dict(kernel_ms=0.0, plain_ms=0.0, library_ms=0.0, h2d_ms=0.0,
               d2h_ms=0.0, numpy_ms=0.0, bound_ms=0.0, bytes=0, ops=0)
    library_mismatches = 0

    def check(codes, k, timed):
        nonlocal mismatches, err, library_mismatches
        n = int(codes.size)
        host = torch.from_numpy(codes)
        h2d = statistics.median(cuda_ms(lambda: host.to(dev), 3))
        cd = host.to(dev)
        bufs = sw.seed_words_buffers(n, k, dev)
        out, ref, ms, plain_ms = timed_pair(
            lambda: sw.seed_words(cd, k, bufs),
            lambda: sw.seed_words_reference(cd, k), reps=5 if timed else 1)
        d2h = statistics.median(cuda_ms(
            lambda: (out[0].cpu(), out[1].cpu()), 3))
        t0 = time.perf_counter()
        want = minimizers.kmer_words(codes, k, minimizers.NUMPY)
        numpy_ms = 1e3 * (time.perf_counter() - t0)
        got = [t.cpu().numpy().view(np.uint32) for t in out]
        plain = [t.cpu().numpy().view(np.uint32) for t in ref]
        bad = sum(int((g != w).sum()) + int((p != w).sum())
                  for g, p, w in zip(got, plain, want))
        mismatches += bad
        err = max([err] + [int(np.abs(g.astype(np.int64)
                                      - p.astype(np.int64)).max())
                           for g, p in zip(got, plain)])
        lib_ms = None
        if timed:
            call = conv_words(cd, k)
            lib = call()
            lib_ms = statistics.median(cuda_ms(call, 5))
            lib_words = lib[0].round().to(torch.int64).cpu().numpy()
            library_mismatches += sum(
                int((lib_words[c] != w.astype(np.int64)).sum())
                for c, w in enumerate(want))
            del lib, call
        nk = n - k + 1
        bms, by = bound(n, 8 * nk, OPS_PER_SEED_WORD * nk)
        row = {"k": k, "bases": n, "mismatches": bad,
               "kernel_ms": round(ms, 4), "plain_ms": round(plain_ms, 3),
               "library_ms": None if lib_ms is None else round(lib_ms, 4),
               "h2d_ms": round(h2d, 3), "d2h_ms": round(d2h, 3),
               "numpy_ms": round(numpy_ms, 1), "bound_ms": round(bms, 4),
               "bound_by": by}
        if timed:
            tot["kernel_ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["library_ms"] += lib_ms
            tot["h2d_ms"] += h2d
            tot["d2h_ms"] += d2h
            tot["numpy_ms"] += numpy_ms
            tot["bytes"] += n + 8 * nk
            tot["ops"] += OPS_PER_SEED_WORD * nk
        del cd, out, ref, bufs
        torch.cuda.empty_cache()
        return row

    for codes in bufs:
        rows.append(check(codes, 13, True))
    cut = bufs[0][:1_000_000]
    for k in (5, 15):
        rows.append(check(cut, k, False))
    bms, by = bound(tot["bytes"], 0, tot["ops"])
    res = {"buffers": rows, "k": 13, "launches_per_round": len(bufs),
           "bases": sum(int(b.size) for b in bufs), "mismatches": mismatches,
           "max_abs_err": err, "library_mismatches": library_mismatches,
           **{key: round(v, 4) for key, v in tot.items()
              if key.endswith("_ms")},
           "bound_ms": round(bms, 4), "bound_by": by}
    emit("seed_words", **res)
    if mismatches:
        raise RuntimeError(f"seed words: {mismatches} word(s) differ among "
                           "the kernel, its plain version and numpy")
    return res


def recall_precision(overlaps, truth_reads) -> tuple:
    """The JAX package's mapper bar (tests/test_overlap_discovery.py): a
    read is found when one of its overlaps has the true strand and
    covers at least half its true span."""
    by_name = {}
    for name, strand, t_begin, t_end in overlaps:
        by_name.setdefault(name, []).append((strand, t_begin, t_end))
    hit = 0
    for rec in truth_reads:
        span = rec["t_end"] - rec["t_begin"]
        for strand, t_begin, t_end in by_name.get(rec["name"], []):
            inter = min(t_end, rec["t_end"]) - max(t_begin, rec["t_begin"])
            if strand == (rec["strand"] == "-") and inter >= 0.5 * span:
                hit += 1
                break
    return hit / max(1, len(truth_reads)), hit / max(1, len(overlaps))


@contextlib.contextmanager
def mapping_spy():
    """Record, for every mapping of the run, its overlaps as (read,
    strand, t_begin, t_end), its targets (from round 2 on, the previous
    round's polished draft) and every kernel's launch count just before
    it: a round maps first, so these counts cut the run's launches by
    round."""
    from racon_tpu_torch.overlap import chain

    orig = chain.map_sequences
    calls = []

    def spy(queries, targets, **kw):
        launches = launch_counts(mapped=True)
        out, stats = orig(queries, targets, **kw)
        calls.append({"launches_before": launches, "overlaps": [
            (o.q_name, o.strand, o.t_begin, o.t_end) for o in out],
            "targets": [t.data for t in targets]})
        return out, stats

    chain.map_sequences = spy
    try:
        yield calls
    finally:
        chain.map_sequences = orig


def truth_prefix(truth: bytes, draft_cut: bytes, scale: float) -> bytes:
    """The truth's prefix that a draft prefix covers: ends where the
    cut's last unmutated, unique 32-mer sits in the truth (the draft
    scales the truth's coordinates by ``scale``, with local drift)."""
    n = len(draft_cut)
    guess = int(n / scale)
    for back in range(32, n, 7):
        kmer = draft_cut[n - back:n - back + 32]
        hit = truth.find(kmer, max(0, guess - 5000), guess + 5000)
        if hit >= 0 and truth.find(kmer, hit + 1, guess + 5000) < 0:
            return truth[:hit + back]
    raise RuntimeError("no anchor for the draft cut's end in the truth")


def kept_misplaced(overlaps, truth_reads) -> dict:
    """Reads whose overlap the contig polisher keeps (the longest; a
    later one wins a tie, ``Polisher._load_overlaps``) lies off their
    true placement (other strand, or a start more than 2 kb away), and
    those of them longer than the align ladder's 16,384 bases; plus
    the reads with more than one overlap."""
    kept, multi = {}, set()
    for o in overlaps:
        if o.q_name in kept:
            multi.add(o.q_name)
            if o.length < kept[o.q_name].length:
                continue
        kept[o.q_name] = o
    off = long_off = 0
    for rec in truth_reads:
        o = kept.get(rec["name"])
        if o is None:
            continue
        if o.strand != (rec["strand"] == "-") or \
                abs(o.t_begin - rec["t_begin"]) > 2000:
            off += 1
            long_off += o.length > 16_384
    return {"multi_overlap_reads": len(multi), "kept_misplaced": off,
            "kept_misplaced_over_16384": long_off}


def map_quality(reads: str, draft: str, data: str) -> dict:
    """``--only map``: the mapper alone on the whole set with every
    admitted chain emitted, as the JAX package's does
    (``overlap.map_files`` at its defaults: words on the card): overlaps
    against the
    PAF's, recall and precision against truth.json (>= 0.95 / 0.90,
    the JAX package's bar), the reads whose kept overlap would be
    misplaced, map_s and the seed kernel's launches."""
    from racon_tpu_torch.cuda import build
    from racon_tpu_torch.overlap import map_files

    with open(os.path.join(data, "truth.json")) as fh:
        truth_reads = json.load(fh)["reads"]
    with open(os.path.join(data, "reads2draft.paf"), "rb") as fh:
        paf_overlaps = sum(1 for _ in fh)
    build.zero_launch_counts()
    t0 = time.perf_counter()
    overlaps, stats = map_files(reads, draft)
    map_s = time.perf_counter() - t0
    seed_launches = build.launch_counts()["seed_words"]
    rec, prec = recall_precision(
        [(o.q_name, o.strand, o.t_begin, o.t_end) for o in overlaps],
        truth_reads)
    res = {"reads": stats["queries"], "overlaps": stats["overlaps"],
           "paf_overlaps": paf_overlaps, "recall": round(rec, 4),
           "precision": round(prec, 4), "map_s": round(map_s, 3),
           "seed_launches": seed_launches, "stats": stats,
           **kept_misplaced(overlaps, truth_reads)}
    emit("map_quality", **res)
    if rec < 0.95 or prec < 0.90 or seed_launches <= 0:
        raise RuntimeError(f"map_quality: recall {rec:.4f}, precision "
                           f"{prec:.4f}, seed launches {seed_launches}")
    return res


#: draft bases of the cut that map_rounds' --rounds 1 runs polish (with
#: the reads inside them)
MAP_CUT_BP = 500_000


def map_rounds(cli, cpu, work, data, reads, draft, truth, threads, dev,
               keep=None, quality: bool = False) -> dict:
    """map_rounds: seed-word parity on the whole set; with ``quality``
    (``--only map``) the mapper's every chain on it and the CLI with no
    PAF at the port's defaults, --rounds 2 with --metrics-json, on the
    whole set; then on the first MAP_CUT_BP bases --rounds 1 with the
    words built on the card and --rounds 2 with the words built by
    numpy, whose round 1 must give the same overlaps and bytes.  The
    launches returned are the whole set's run's, or without it the
    --rounds 1 run's."""
    seed = seed_check(reads, draft, dev)
    if quality:
        map_quality(reads, draft, data)
    scale = len(read_fasta(draft)) / len(truth)
    with open(os.path.join(data, "truth.json")) as fh:
        all_truth = json.load(fh)["reads"]

    def region_of(bp):
        if bp == 0:
            r, d, t = reads, draft, truth
        else:
            r, _, d = cut_region(data, os.path.join(work, f"map_{bp}"), bp)
            t = truth_prefix(truth, read_fasta(d), scale)
        with open(os.path.join(os.path.dirname(r), "reads2draft.paf"),
                  "rb") as fh:
            names = {line.split(b"\t")[0].decode() for line in fh}
        return {"bp": bp, "reads": r, "draft": d, "truth": t,
                "truth_reads": [x for x in all_truth if x["name"] in names],
                "d_draft": chunked_distance(read_fasta(d), t, cpu)}

    from racon_tpu_torch.obs.devutil import DEVICE_UTIL

    argv = ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8", "-c",
            "1", "--cudaaligner-batches", "1"]

    def run(tag, region, rounds, seed_flag=None, flags=()):
        """One counted CLI run; emits its map_rounds line and holds every
        round's recall (>= 0.95) and precision (>= 0.90) against the
        truth, its distance to draft / 10 and every kernel launched."""
        out_path = os.path.join(work, f"mapped_{tag}.fasta")
        # the seed words' device lanes land in the process DEVICE_UTIL
        DEVICE_UTIL.reset()
        with env_set(**dict.fromkeys(DEFAULT_PATH_KNOBS),
                     RACON_TPU_TORCH_MAP_DEVICE_SEED=seed_flag), \
                mapping_spy() as calls:
            pol, wall, launches = counted_polish(
                cli, argv + ["--rounds", str(rounds), *flags,
                             region["reads"], region["draft"]], out_path,
                mapped=True)
        out = read_bytes(out_path)
        # what each round wrote: the next round's targets, then the output
        drafts = [c["targets"][0] for c in calls[1:]] + \
            [out.split(b"\n")[1]]
        cuts = [c["launches_before"] for c in calls] + [launches]
        per_round = []
        for i, rep in enumerate(pol.rounds_report):
            rec, prec = recall_precision(calls[i]["overlaps"],
                                         region["truth_reads"])
            per_round.append({
                **rep, "recall": round(rec, 4), "precision": round(prec, 4),
                "distance": chunked_distance(drafts[i], region["truth"],
                                             cpu),
                "launches": {k: cuts[i + 1][k] - cuts[i][k]
                             for k in launches}})
        seed_lane = DEVICE_UTIL.snapshot().get("seed_words", {})
        emit("map_rounds", run=tag, rounds=rounds,
             draft_bp=region["bp"] or "all",
             reads=len(region["truth_reads"]), argv=argv,
             seed=seed_flag or "device", wall_s=round(wall, 3),
             per_round=per_round, launches=launches,
             cache_hit_by_round=[r["cache_hit"] for r in per_round],
             seed_lane_ms=round(seed_lane.get("busy_s", 0.0) * 1e3, 3),
             seed_lane_dispatches=seed_lane.get("n_dispatches", 0),
             seed_round1_bound=seed_bound(region["reads"],
                                          region["draft"]),
             secondary_dropped=int(pol.metrics.value(
                 "map_secondary_dropped")),
             card_states=pol.card_states, draft_distance=region["d_draft"])
        for r in per_round:
            if r["distance"] > region["d_draft"] / 10 or \
                    r["recall"] < 0.95 or r["precision"] < 0.90:
                raise RuntimeError(f"map_rounds {tag} round {r['round']}: "
                                   f"distance {r['distance']} (draft "
                                   f"{region['d_draft']}), recall "
                                   f"{r['recall']}, precision "
                                   f"{r['precision']}")
        for name, n in launches.items():
            # numpy builds the words when DEVICE_SEED=0: no seed launch
            if (n == 0) != (name == "seed_words" and seed_flag == "0"):
                raise RuntimeError(f"map_rounds {tag}: {n} {name} "
                                   "launches")
        if seed_lane.get("n_dispatches", 0) != launches["seed_words"]:
            raise RuntimeError(f"map_rounds {tag}: {seed_lane} seed-word "
                               f"lanes, {launches['seed_words']} launches")
        return {"launches": launches, "calls": calls, "drafts": drafts}

    if quality:
        # the whole set's --rounds 2 run (``--only map``)
        mpath = os.path.join(work, "mapped.metrics.json")
        main = run("main", region_of(0), 2,
                   flags=["--metrics-json", mpath])
        keep_files(keep, mpath)
    cut = region_of(MAP_CUT_BP)
    card = run("cut_rounds1", cut, 1)
    if not quality:
        main = card
    numpy_seed = run("cut_rounds2_numpy", cut, 2, seed_flag="0")
    same = {"overlaps": card["calls"][0]["overlaps"]
            == numpy_seed["calls"][0]["overlaps"],
            "bytes": card["drafts"][0] == numpy_seed["drafts"][0]}
    emit("map_seed_bytes", draft_bp=MAP_CUT_BP, round1_identical=same)
    if not all(same.values()):
        raise RuntimeError(f"map_seed_bytes: --rounds 1 (card words) and "
                           f"round 1 of --rounds 2 (numpy words) differ: "
                           f"{same}")
    return {"seed": seed, "launches": main["launches"]}


# ---------------------------------------------------------------------------
# lockstep: windows past the whole-window POA kernel's caps (-w 1000)
# ---------------------------------------------------------------------------

#: the lockstep phase's window length: its caps (V 4096, LP 2048) are past
#: the whole-window kernel's, so every megabatch takes the lockstep engine
LOCKSTEP_W = 1000
#: the -w 1000 runs' cut of the draft (at 250 kb the cut's ends weigh
#: too much: -b wrote 598 against a 4,641 draft)
W1000_BP = 500_000
#: lockstep_check's wider rows: the middle auto round's layers widened to
#: these (layer bucket, band) shapes: -w above 1,024, 2,048, 4,096, 8,192
#: and 16,384
LOCKSTEP_WIDE = ((4096, 1024), (8192, 2048), (16384, 4096), (32768, 8192),
                 (65536, 16384))
#: lanes of lockstep_check's tiled launches: a -w 1000 megabatch of the
#: first 500 kb (polish_w1000's batch)
LOCKSTEP_TILED_LANES = 500
#: polish_wlong: -w 20000 (caps V 131,072, LP 65,536: rounds of layers
#: past 16,384 bases take bands of 8,192 columns) without the TGS end
#: trim (-T: most layers of a 20 kb window are partial, so coverage
#: falls under (layers - 1) / 2 over much of it and the trim cut 5-13 kb
#: of consensus on these sets) on a small long-read set: two 20 kb
#: windows and a 2.9 kb one
WLONG_W = 20_000
WLONG_SET = dict(genome_len=41_500, coverage=7, read_len=25_000, seed=11,
                 ont=True)
#: the native polish's threads: one a window, beside lockstep_check
WLONG_NATIVE_THREADS = 3
#: polish_wlong's accuracy bar: the native CPU engine's distance at the
#: same -w, times this.  The card and the engine read 7,290 / 7,291,
#: 9,999 / 9,999 and 7,970 / 7,971 on earlier sets (at most 0.014%
#: apart); racon's POA does not reach draft / 10 at -w 20000 on these
#: sets (the native engine wrote 542 against a 770 draft on this one)
WLONG_NATIVE_SLACK = 1.01


def lockstep_split(kin, kw, ranks) -> dict:
    """The kernel's phase split on one timed launch (the build that reads
    clock64() per phase): each phase's cycles summed over the lanes and
    its share, the DP's cycles a rank (pred fetch to sink fold, over
    every lane's ranks), the deepest lane's cycles (a launch lasts as long
    as it), pred rows read from the device ring, slow-path columns, and
    the kernel's plan (columns a thread, shared ring rows)."""
    from racon_tpu_torch.cuda import poa_lockstep as pl

    b = len(ranks)
    bufs = pl.lockstep_buffers(b, kw["v"], kw["l"], kw["k"], kw["wb"],
                               kin[0].device, timed=True)
    pl.poa_round(*kin, **kw, bufs=bufs)
    meta = bufs["meta"].cpu().numpy().astype("int64")
    n = len(pl.PHASES)
    tot = max(1, int(meta[:, :n].sum()))
    dp = meta[:, :n - 1].sum()
    plan = pl.plan(kw["v"], kw["l"], kw["p"], kw["wb"], kin[0].device)
    return {"phases": {name: {"cycles": int(meta[:, i].sum()),
                              "share": round(float(meta[:, i].sum()) / tot,
                                             4)}
                       for i, name in enumerate(pl.PHASES)},
            "cycles_per_rank": round(float(dp) / max(1, int(ranks.sum())),
                                     1),
            "deepest_lane_cycles": int(meta[:, :n].sum(1).max()),
            **{name: int(meta[:, n + i].sum())
               for i, name in enumerate(pl.COUNTS)},
            "plan": plan}


def lockstep_work(arrs, kin, out, kw) -> dict:
    """A round's shape and the work its bound counts: the DP cells (each
    lane's ranks x columns), the real pred rows of its live ranks, and
    the bound of reading ``kin`` once, writing ``out`` once and those
    operations."""
    import numpy as np
    from racon_tpu_torch.cuda import poa_lockstep as pl

    v, l, wb = kw["v"], kw["l"], kw["wb"]
    ranks = np.minimum(arrs[2], v)
    cols = pl.columns(l, wb)
    cells = int(ranks.sum()) * cols
    live = np.arange(v)[None, :] < ranks[:, None]
    pred_rows = int(((arrs[1] >= 0) & live[:, :, None]).sum())
    bms, by = bound(nbytes(*kin), nbytes(*out),
                    *lockstep_ops(cells, pred_rows, cols))
    return {"v": v, "l": l, "wb": wb, "cols": cols, "lanes": len(ranks),
            "cells": cells, "pred_rows": pred_rows, "bound_ms": bms,
            "bound_by": by}


def round_check(arrs, v: int, l: int, wb: int, dev, p: int = 16,
                k: int = 128, keep=None) -> dict:
    """One round through the lockstep kernel (median of 5 CUDA-event
    runs after a warm call, into buffers made before) and its plain
    version on the card: lanes whose node or seq tape differ, max
    |difference|, both times, the DP cells the round needs (each lane's
    ranks x columns), its real pred rows, the bound, and the kernel's
    phase split (``lockstep_split``).  ``keep`` (a dict) gets the inputs
    and the plain version's tapes."""
    import numpy as np
    import torch
    from racon_tpu_torch.cuda import poa_lockstep as pl

    kin = [torch.from_numpy(a).to(dev) for a in arrs]
    kw = dict(v=v, l=l, p=p, k=k, wb=wb, match=5, mismatch=-4, gap=-8)
    bufs = pl.lockstep_buffers(len(arrs[2]), v, l, k, wb, dev)
    out, ref, ms, plain_ms = timed_pair(
        lambda: pl.poa_round(*kin, **kw, bufs=bufs),
        lambda: pl.poa_round_reference(*kin, **kw))
    diff = torch.stack([(o.long() - r.long()).abs().amax(1)
                        for o, r in zip(out, ref)]).amax(0)
    if keep is not None:
        keep.update(arrs=arrs, ref=[r.cpu() for r in ref], v=v, l=l, wb=wb)
    return {**lockstep_work(arrs, kin, out, kw), "mismatches":
            int((diff > 0).sum()), "max_abs_err": int(diff.max()),
            "kernel_ms": round(ms, 4), "plain_ms": round(plain_ms, 1),
            "split": lockstep_split(kin, kw, np.minimum(arrs[2], v))}


def tiled_check(kept: dict, dev, n_lanes: int) -> dict:
    """Kernel only: a checked round's lanes tiled to ``n_lanes`` lanes in
    one launch (a -w 1000 megabatch's width).  Every lane's tapes must
    equal its lane's plain tapes already computed; the ms is the median
    of 5 CUDA-event runs after a warm call, the bound that of the tiled
    lanes' cells."""
    import numpy as np
    import torch
    from racon_tpu_torch.cuda import poa_lockstep as pl

    arrs, v, l, wb = kept["arrs"], kept["v"], kept["l"], kept["wb"]
    idx = np.arange(n_lanes) % len(arrs[2])
    tiled = [np.ascontiguousarray(a[idx]) for a in arrs]
    kin = [torch.from_numpy(a).to(dev) for a in tiled]
    kw = dict(v=v, l=l, p=16, k=128, wb=wb, match=5, mismatch=-4, gap=-8)
    bufs = pl.lockstep_buffers(n_lanes, v, l, 128, wb, dev)
    out = pl.poa_round(*kin, **kw, bufs=bufs)
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(
        lambda: pl.poa_round(*kin, **kw, bufs=bufs), 5))
    ti = torch.from_numpy(idx)
    diff = torch.stack([(o.cpu().long() - r[ti].long()).abs().amax(1)
                        for o, r in zip(out, kept["ref"])]).amax(0)
    return {**lockstep_work(tiled, kin, out, kw), "mismatches":
            int((diff > 0).sum()), "max_abs_err": int(diff.max()),
            "kernel_ms": round(ms, 4),
            "split": lockstep_split(kin, kw, np.minimum(tiled[2], v))}


def lockstep_check(region, dev, threads) -> dict:
    """The lockstep kernel against its plain version on the card: three
    rounds (first, middle, last) of 8 real -w 1000 windows of the region
    (spread over depth), at the auto band (wb 512 for layers past 1,024)
    and with -b (wb 256); the middle auto round widened to bands of
    1,024-16,384 columns (LOCKSTEP_WIDE: past 512 columns the kernel
    walks a row tile by tile), and its lanes of layers up to 1,024 bases
    at 1,025 columns unbanded; both middle rounds' lanes tiled to 500 in
    one launch (each lane held to its plain tapes); every round of the
    tiny windows at caps that take the unbanded kernel (l_b 128); a
    constructed round whose preds lag past the band's reach (wb 32).
    Node and seq tapes must agree exactly; every row carries the
    kernel's phase split."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher
    from racon_tpu_torch.core.window import WindowType
    from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine
    import numpy as np
    from racon_tpu_torch.tools.lockstep_rounds import (capture_rounds,
                                                       lag_round,
                                                       max_band_lag, widen)

    pol = create_polisher(*region, PolisherType.kC, LOCKSTEP_W, 10.0, 0.3,
                          True, 5, -4, -8, threads)
    pol.initialize()
    wins = [w for w in pol.windows if len(w.sequences) >= 3]
    pol.close()
    wins = [wins[i] for i in plain_subset(wins, 8)]
    res = {"windows": len(wins),
           "depths": [len(w.sequences) - 1 for w in wins]}
    rows, captured, kept = [], {}, {}
    for name, banded in (("auto", False), ("b", True)):
        eng = CudaPoaBatchEngine(5, -4, -8, device=dev, vcap=4096,
                                 lcap=2048, banded=banded)
        n = max(len(eng._order_layers(w)) for w in wins)
        captured[name] = capture_rounds(eng, wins, {0, n // 2, n - 1})
        # the middle round's inputs and plain tapes: the tiled launch's
        res[name] = [dict(round=d, **round_check(
            a, v, l, wb, dev, keep=kept.setdefault(name, {}) if i == 1
            else None))
            for i, (d, a, v, l, wb) in enumerate(captured[name])]
        rows += res[name]
    # the middle auto round widened to the layer buckets of longer
    # windows, and its lanes of layers up to 1,024 bases unbanded
    d, a, v, _, _ = captured["auto"][1]
    res["wide"] = [dict(round=d, **round_check(widen(a, lw), v, lw, ww,
                                               dev))
                   for lw, ww in LOCKSTEP_WIDE]
    short = a[5] <= 1024
    if not short.any():
        raise RuntimeError("the middle round has no layer of 1,024 bases")
    a = [np.ascontiguousarray(x[short]) for x in a]
    a[4] = np.ascontiguousarray(a[4][:, :1024])
    res["wide"].append(dict(round=d, **round_check(a, v, 1024, 0, dev)))
    rows += res["wide"]
    res["tiled"] = [dict(round=captured[name][1][0], part=name,
                         **tiled_check(kept[name], dev,
                                       LOCKSTEP_TILED_LANES))
                    for name in ("auto", "b")]
    rows += res["tiled"]
    eng = CudaPoaBatchEngine(5, -4, -8, device=dev, vcap=512, lcap=256)
    tiny = capture_rounds(eng, tiny_windows(random.Random(3),
                                            WindowType.TGS), None)
    res["tiny_unbanded"] = [dict(round=d, **round_check(a, v, l, wb, dev))
                            for d, a, v, l, wb in tiny]
    if any((r["l"], r["wb"]) != (128, 0) for r in res["tiny_unbanded"]):
        raise RuntimeError("a tiny round missed the unbanded kernel")
    arrs, v, l, p, k = lag_round()
    lag = max_band_lag(arrs, 32)
    res["lag_drop"] = {"max_lag_quanta": lag,
                       **round_check(arrs, v, l, 32, dev, p, k)}
    if lag < 5:
        raise RuntimeError("the lag round has no pred past the band")
    rows += res["tiny_unbanded"] + [res["lag_drop"]]
    res["mismatches"] = sum(r["mismatches"] for r in rows)
    res["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    auto = res["auto"]
    res["auto_kernel_ms"] = round(sum(r["kernel_ms"] for r in auto), 4)
    res["auto_plain_ms"] = round(sum(r["plain_ms"] for r in auto), 1)
    res["auto_bound_ms"] = sum(r["bound_ms"] for r in auto)
    res["auto_bound_by"] = max(auto, key=lambda r: r["bound_ms"])[
        "bound_by"]
    return res


def polish_w1000(cli, cpu, work, data, inputs, truth, threads) -> dict:
    """The port's CLI at -w 1000, staged, all on the card, cache off, on
    the first 500 kb of the set (the whole set took 210.6 s, the first
    Mb 35-41 s, 33-51 s with -b) at the auto band, then with -b.  Each
    run's wall,
    stage walls, launches (the lockstep kernel's > 0, the whole-window
    kernel's 0), lockstep rounds and phase walls, rejects by code, the
    kernel's CUDA-event ms against its DP cells' bound, and the distance
    to the cut's truth (<= draft / 10).  Returns the first run's
    line."""
    base = ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8", "-c",
            "1", "--cudaaligner-batches", "1", "-w", str(LOCKSTEP_W)]
    draft = read_fasta(inputs[2])
    first = None
    bp = min(W1000_BP, len(draft))
    paths = list(cut_region(data, os.path.join(work, f"region_{bp}"), bp))
    run_truth = truth_prefix(truth, read_fasta(paths[2]),
                             len(draft) / len(truth))
    run_draft = chunked_distance(read_fasta(paths[2]), run_truth, cpu)
    for name, flags in (("first_500kb", []), ("first_500kb_b", ["-b"])):
        out_path = os.path.join(work, f"w1000_{name}.fasta")
        with env_set(**STAGED_ENV, RACON_TPU_TORCH_CACHE="0"):
            pol, wall, launches = counted_polish(
                cli, base + flags + paths, out_path, lockstep=True)
        eng = pol.poa_engine
        d_pol = chunked_distance(read_fasta(out_path), run_truth, cpu)
        line = {"run": name, "bp": bp,
                "argv": base + flags, "wall_s": round(wall, 3),
                "stage_walls_s": {k: round(v, 3)
                                  for k, v in pol.stage_walls.items()},
                "launches": launches, "lockstep_rounds": eng.n_rounds,
                "lockstep_phase_s": {k: round(v, 3) for k, v in
                                     eng.phase_walls.items()},
                "batch": pol.poa_batch_size,
                "eligible_windows": pol.poa_eligible_windows,
                "windows_on_kernel": eng.windows_on_kernel,
                "rejected": {k: v for k, v in pol.poa_reject_counts.items()
                             if v},
                "skipped_layers": eng.n_skipped_layers,
                "kernel_ms": round(eng.kernel_ms, 3), "dp_cells": eng.cells,
                "main_path_bound_ms": bound(
                    0, 0, *lockstep_ops(eng.cells))[0],
                "draft_distance": run_draft, "polished_distance": d_pol}
        emit("polish_w1000", **line)
        if launches["poa_lockstep"] <= 0 or eng.n_rounds <= 0:
            raise RuntimeError(f"polish_w1000 {name}: no lockstep launch")
        if launches["poa_full"]:
            raise RuntimeError(f"polish_w1000 {name}: the whole-window "
                               "kernel ran past its caps")
        if d_pol > run_draft / 10:
            raise RuntimeError(f"polish_w1000 {name}: distance {d_pol} > "
                               f"draft {run_draft} / 10")
        first = first or line
    return first


def wlong_native(cpu, work, threads) -> dict:
    """polish_wlong's set (WLONG_SET, tools/simulate.py) and the native
    CPU engine's polish of it at -w 20000 -T (the CLI without -c, a
    thread a window), started as a process on the host at nice 10: it
    runs while lockstep_check and polish_w1000 do (none of it on the
    card)."""
    from racon_tpu_torch.tools import simulate

    data = os.path.join(work, "wlong")
    paths = simulate.simulate(data, **WLONG_SET)
    truth = read_fasta(os.path.join(data, "genome.fasta"))
    scores = ["-m", "5", "-x", "-4", "-g", "-8", "-w", str(WLONG_W), "-T"]
    out_path = os.path.join(work, "wlong_native.fasta")
    with open(out_path, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch.cli", "-t",
             str(min(threads, WLONG_NATIVE_THREADS)), *scores, *paths],
            stdout=out, stderr=subprocess.DEVNULL, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT,
                     RACON_TPU_TORCH_CACHE="0"))
    # below the card's phases on the host's cores: it has until
    # polish_wlong to finish
    os.setpriority(os.PRIO_PROCESS, proc.pid, 10)
    return {"paths": paths, "truth": truth, "argv": scores, "proc": proc,
            "out": out_path, "draft_distance": chunked_distance(read_fasta(paths[2]), truth,
                                               cpu)}


def polish_wlong(cli, cpu, work, dev, threads, native) -> dict:
    """The port's CLI at -w 20000 -T (refused before the kernel walked a
    row tile by tile), staged, all on the card, cache off, on
    ``native``'s set (``wlong_native``): wall, launches (the lockstep
    kernel's > 0), lockstep rounds, rejects by code, every round's
    columns (one past 4,096 at least), the kernel's ms, and, of every
    round past 4,096 columns (copied as it was dispatched,
    ``round_spy``), the lane of fewest rows held against the plain
    version (``round_check``; the plain version's time follows the
    rows: lockstep_check holds 8 lanes at 8,192 and 16,384 columns);
    distance to the truth below the draft's and <= the native CPU
    engine's at the same flags x WLONG_NATIVE_SLACK."""
    import numpy as np
    from racon_tpu_torch.cuda import poa_lockstep as pl
    from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine
    from racon_tpu_torch.tools.lockstep_rounds import round_spy

    paths, truth, proc = native["paths"], native["truth"], native["proc"]
    d_draft = native["draft_distance"]
    argv = ["-t", str(threads), *native["argv"], "-c", "1",
            "--cudaaligner-batches", "1"]
    out_path = os.path.join(work, "wlong.fasta")
    cols = []

    def wide(_, v_b, l_b, wb):
        cols.append(pl.columns(l_b, wb))
        return cols[-1] > 4096

    try:
        with env_set(**STAGED_ENV, RACON_TPU_TORCH_CACHE="0"), \
                round_spy(CudaPoaBatchEngine, wide) as rounds:
            pol, wall, launches = counted_polish(cli, argv + list(paths),
                                                 out_path, lockstep=True)
        eng = pol.poa_engine
        d_pol = chunked_distance(read_fasta(out_path), truth, cpu)
        check = None
        if rounds:
            # the lane of fewest rows against the plain version, while
            # the native polish runs on
            rows = [np.where(a[2] > 0, a[2], np.iinfo(np.int32).max)
                    for _, a, _, _, _ in rounds]
            i = min(range(len(rows)), key=lambda i: rows[i].min())
            d, arrs, v, l, wb = rounds[i]
            lane = int(rows[i].argmin())
            arrs = [np.ascontiguousarray(a[lane:lane + 1]) for a in arrs]
            check = dict(round=d, lane=lane, rows=int(arrs[2][0]),
                         slen=int(arrs[5][0]),
                         **round_check(arrs, v, l, wb, dev))
        native_rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if native_rc != 0:
        raise RuntimeError("polish_wlong: the native polish failed")
    d_native = chunked_distance(read_fasta(native["out"]), truth, cpu)
    line = {"set": WLONG_SET, "argv": argv, "wall_s": round(wall, 3),
            "stage_walls_s": {k: round(v, 3)
                              for k, v in pol.stage_walls.items()},
            "launches": launches, "lockstep_rounds": eng.n_rounds,
            "round_cols": cols, "widest_cols": max(cols, default=0),
            "eligible_windows": pol.poa_eligible_windows,
            "windows_on_kernel": eng.windows_on_kernel,
            "rejected": {k: v for k, v in pol.poa_reject_counts.items()
                         if v},
            "kernel_ms": round(eng.kernel_ms, 3), "dp_cells": eng.cells,
            "main_path_bound_ms": bound(0, 0, *lockstep_ops(eng.cells))[0],
            "draft_distance": d_draft, "polished_distance": d_pol,
            "native_distance": d_native}
    if launches["poa_lockstep"] <= 0 or check is None:
        emit("polish_wlong", **line)
        raise RuntimeError("polish_wlong: no lockstep round past 4,096 "
                           "columns reached the kernel")
    line["wide_check"] = check
    emit("polish_wlong", **line)
    if check["mismatches"]:
        raise RuntimeError("polish_wlong: the kernel disagrees with its "
                           f"plain version on round {check['round']}")
    if d_pol >= d_draft:
        raise RuntimeError(f"polish_wlong: distance {d_pol} >= the "
                           f"draft's {d_draft}")
    if d_pol > d_native * WLONG_NATIVE_SLACK:
        raise RuntimeError(f"polish_wlong: distance {d_pol} > the native "
                           f"engine's {d_native} x {WLONG_NATIVE_SLACK}")
    return line


def lockstep_phase(cli, cpu, work, data, region, dev, inputs, truth,
                   threads) -> tuple:
    """lockstep_check, polish_w1000, then polish_wlong (its native
    polish on the host from the start); returns the first two lines."""
    native = wlong_native(cpu, work, threads)
    try:
        lcheck = lockstep_check(region, dev, threads)
        emit("lockstep_check", **lcheck)
        if lcheck["mismatches"]:
            raise RuntimeError(f"the lockstep kernel disagrees with its "
                               f"plain version on {lcheck['mismatches']} "
                               "lane(s)")
        w1000 = polish_w1000(cli, cpu, work, data, inputs, truth, threads)
        polish_wlong(cli, cpu, work, dev, threads, native)
    finally:
        if native["proc"].poll() is None:
            native["proc"].kill()
            native["proc"].wait()
    return lcheck, w1000


# ---------------------------------------------------------------------------
# the scan ladder (RACON_TPU_TORCH_SCAN_ALIGN / RACON_TPU_TORCH_PORTABLE)
# ---------------------------------------------------------------------------

# scan full, bit-parallel (one Myers step of a 64-row word of the query
# at one target column, as the full kernel computes it):
# 17 64-bit operations (the Peq word's or with Mv, the carry-in,
# and-add-xor-or of Xh, Ph and Mh, the two top bits of hout, the two
# shifts with their carry-ins, Pv and Mv), each two int32 ones
OPS_PER_SCAN_FULL_WORD = 34
# scan banded (one slot of a diagonal, as OPS_PER_BAND_CELL counts a
# cell): substitution compare 1, the diagonal, up and left candidates 3
# (adds), their mins 2, the 2-bit direction 4 (two compares, two
# selects), its packing 2 (shift, or), and the function's own clip of
# every value to BIG 1
OPS_PER_SCAN_BAND_CELL = 13
SCAN_PORTABLE_BP = 250_000


def scan_bound(in_bytes: int, out_bytes: int, ql, tl, hw: int) -> tuple:
    """(bound ms, what binds) of a scan launch on lanes of lengths ql,
    tl: the banded kernel's cells (OPS_PER_SCAN_BAND_CELL), the full
    kernel's Myers word steps (OPS_PER_SCAN_FULL_WORD), against the
    inputs' and the op tape's bytes."""
    from racon_tpu_torch.cuda import aligner as al
    ops = al.kernel_cells(ql, tl, hw) * OPS_PER_SCAN_BAND_CELL if hw \
        else al.full_words(ql, tl) * OPS_PER_SCAN_FULL_WORD
    return bound(in_bytes, out_bytes, ops)


def scan_row(qs, ts, lq: int, lt: int, hw: int, dev, keep=None) -> dict:
    """One scan kernel launch (hw 0: the full kernel) against its plain
    version on the card, the lanes padded to a power of two as the
    ladder pads them: mismatching lanes, max |op difference|, the
    kernel's ms (median of 5 CUDA-event runs after a warm call), the
    plain ms, the DP cells it computes (``aligner.kernel_cells``), the
    bound (the inputs and the op tape against the cells' int32
    operations), the direction tape's bytes, and the lanes the rung
    certifies (tape cost <= hw) and those past it."""
    import numpy as np
    import torch
    from racon_tpu_torch.cuda import aligner as al

    bb = al._pow2_batch(len(qs))
    pad = [b""] * (bb - len(qs))
    ql = np.array([len(x) for x in qs + pad], np.int32)
    tl = np.array([len(x) for x in ts + pad], np.int32)
    kin = [torch.from_numpy(a).to(dev) for a in (
        al.encode_batch(qs + pad, lq, al.QPAD),
        al.encode_batch(ts + pad, lt, al.TPAD), ql, tl)]
    bufs = al.scan_buffers(bb, lq, lt, hw, dev)
    if hw:
        out, ref, ms, plain_ms = timed_pair(
            lambda: al.align_banded(*kin, hw, bufs),
            lambda: al.align_banded_plain(*kin, hw))
    else:
        out, ref, ms, plain_ms = timed_pair(
            lambda: al.align_full(*kin, bufs),
            lambda: al.align_full_plain(*kin))
    diff = (out.long() - ref.long()).abs().amax(1)
    cells = al.kernel_cells(ql, tl, hw)
    bms, by = scan_bound(nbytes(*kin), nbytes(out), ql, tl, hw)
    tape = ref.cpu().numpy()[:len(qs)]
    cost = ((tape != al.OP_STOP) & (tape != al.OP_EQ)).sum(1)
    if keep is not None:
        keep.update(qs=qs, ts=ts, tapes=tape, lq=lq, lt=lt, hw=hw)
    extra = {} if hw else {"words": al.full_words(ql, tl)}
    return {"hw": hw, "lq": lq, "lt": lt, "lanes": len(qs), "padded": bb,
            "longest": int(max(ql.max(), tl.max())),
            "mismatches": int((diff > 0).sum()),
            "max_abs_err": int(diff.max()), "kernel_ms": round(ms, 4),
            "plain_ms": round(plain_ms, 1), "cells": cells, **extra,
            "bound_ms": bms, "bound_by": by,
            "dir_tape_bytes": bufs["dirs"].numel(),
            "cycles": cycle_split(bufs["meta"].sum(0).tolist(),
                                  ("sweep", "traceback")),
            "certified": int((cost <= hw).sum()) if hw else len(qs),
            "past_band": int((cost > hw).sum()) if hw else 0}


def scan_check(region, dev) -> dict:
    """The scan kernels against their plain versions on the card: the
    banded kernel at the ladder's three rungs and the full kernel, on
    the region's overlap pairs at their real lengths (6 spread over the
    pairs of at most 4,096 bases, at bucket 8,192 for hw 512 and the
    full kernel and at 16,384 for hw 8,192; 2 of the 6 at bucket 16,384
    for hw 2,048: the plain version's time follows the longest pair's
    diagonals, and the region's longest pairs, up to 15,511 bases, cost
    it ~20 s), and the constructed edge pairs of
    tools/scan_pairs.py at bucket 1,024 (hw 0, 7 and 512).  Op tapes
    must agree exactly."""
    from racon_tpu_torch.cuda.aligner import BAND_LADDER
    from racon_tpu_torch.tools.scan_pairs import scan_pairs

    pairs = region_pairs(region, 64, 16384)
    order = sorted(range(len(pairs)), key=lambda k: max(map(len,
                                                             pairs[k])))
    short = [k for k in order if max(map(len, pairs[k])) <= 4096]
    six = spread(short, 6)
    two = spread(short, 2)
    rows, checked, checked_full = [], {}, {}
    narrow, main_rung, wide = BAND_LADDER
    for hw, idx, bd in ((narrow, six, 8192), (main_rung, two, 16384),
                        (wide, six, 16384), (0, six, 8192)):
        qs = [pairs[k][0] for k in idx]
        ts = [pairs[k][1] for k in idx]
        keep = {main_rung: checked, 0: checked_full}.get(hw)
        rows.append(dict(part="region", **scan_row(
            qs, ts, bd, bd, hw, dev, keep=keep)))
    eq, et = scan_pairs(random.Random(11), 600)
    for hw in (0, 7, 512):
        rows.append(dict(part="edge", **scan_row(eq, et, 1024, 1024, hw,
                                                 dev)))
    band = [r for r in rows if r["hw"]]
    full = [r for r in rows if not r["hw"]]
    main = next(r for r in rows if r["hw"] == main_rung)
    return {"rows": rows, "mismatches": sum(r["mismatches"] for r in rows),
            "band_max_abs_err": max(r["max_abs_err"] for r in band),
            "full_max_abs_err": max(r["max_abs_err"] for r in full),
            "past_band": sum(r["past_band"] for r in band),
            "band": main, "full": full[0]}, checked, checked_full


def scan_card(checked: dict, dev, n_lanes: int) -> dict:
    """Kernel only: the pairs of a scan_check row (its hw 2,048 region
    pairs; scan_full_card: its full-kernel row) tiled to ``n_lanes``
    lanes in one launch.  Every lane's tape must equal its pair's tape
    already checked against the plain version; the ms is the median of
    3 CUDA-event runs after the checked one, the bound that of the tiled
    lanes (``scan_bound``)."""
    import numpy as np
    import torch
    from racon_tpu_torch.cuda import aligner as al

    qs, ts, tapes = checked["qs"], checked["ts"], checked["tapes"]
    lq, lt, hw = checked["lq"], checked["lt"], checked["hw"]
    idx = [k % len(qs) for k in range(n_lanes)]
    tq = [qs[k] for k in idx]
    tt = [ts[k] for k in idx]
    ql = np.array([len(x) for x in tq], np.int32)
    tl = np.array([len(x) for x in tt], np.int32)
    kin = [torch.from_numpy(a).to(dev) for a in (
        al.encode_batch(tq, lq, al.QPAD), al.encode_batch(tt, lt, al.TPAD),
        ql, tl)]
    torch.cuda.empty_cache()
    bufs = al.scan_buffers(n_lanes, lq, lt, hw, dev)

    def run():
        return al.align_banded(*kin, hw, bufs) if hw \
            else al.align_full(*kin, bufs)

    out = run().cpu().numpy()
    mism = int((out != tapes[idx]).any(1).sum())
    ms = statistics.median(cuda_ms(run, 3))
    cycles = bufs["meta"].sum(0).tolist()
    dir_bytes = bufs["dirs"].numel()
    del bufs
    torch.cuda.empty_cache()
    cells = al.kernel_cells(ql, tl, hw)
    bms, by = scan_bound(nbytes(*kin), n_lanes * (lq + lt), ql, tl, hw)
    return {"hw": hw, "lq": lq, "lt": lt, "lanes": n_lanes,
            "originals": len(qs), "longest": int(max(ql.max(), tl.max())),
            "mismatches": mism, "kernel_ms": round(ms, 4),
            "cells": cells, "bound_ms": bms, "bound_by": by,
            "x_bound": round(ms / bms, 2), "dir_tape_bytes": dir_bytes,
            "cycles": cycle_split(cycles, ("sweep", "traceback"))}


def scan_forced_full(region, dev, cpu) -> dict:
    """A short-pair bucket through ``CudaBatchAligner`` (the batched
    aligner API): 8 region pairs cut to 1,500 bases and 8 unrelated
    pairs of 1,500, whose cost passes the 512 rung in a bucket under the
    next one, so the ladder hands them to the full kernel; every CIGAR's
    distance must be the native edit distance."""
    from racon_tpu_torch.cuda import aligner as al

    pairs = region_pairs(region, 16, 16384)
    qs = [q[:1500] for q, _ in pairs]
    ts = [t[:1500] for _, t in pairs[:8]] + [t[:1500] for _, t in
                                             pairs[8:][::-1]]
    aligner = al.CudaBatchAligner(1536, 1536, len(qs), device=dev)
    for q, t in zip(qs, ts):
        if not aligner.add(q, t):
            raise RuntimeError("scan_forced_full: a pair past 1,536")
    aligner.align_all()
    native = [cpu.edit_distance(q, t) for q, t in zip(qs, ts)]
    bad = int(sum(int(d) != n for d, n in zip(aligner.distances, native)))
    return {"pairs": len(qs), "native_mismatches": bad,
            "stats": {k: {"launches": v["launches"],
                          "kernel_ms": round(v["kernel_ms"], 4),
                          "cells": v["cells"],
                          **({"words": v["words"]} if "words" in v
                             else {})}
                      for k, v in aligner.stats.items()}}


def scan_paths(cli, cpu, work, data, inputs, truth, region, dev,
               threads) -> tuple:
    """polish_scan, then polish_portable; returns both lines."""
    from racon_tpu_torch.cuda import build

    base = ["-t", str(threads), "-m", "5", "-x", "-4", "-g", "-8", "-c",
            "1", "--cudaaligner-batches", "1"]
    draft = read_fasta(inputs[2])
    lines = {}
    for name, bp, env in (
            ("polish_scan", 1_000_000,
             {"RACON_TPU_TORCH_SCAN_ALIGN": "1",
              "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "1"}),
            ("polish_portable", SCAN_PORTABLE_BP,
             {"RACON_TPU_TORCH_PORTABLE": "1",
              "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "1",
              "RACON_TPU_TORCH_POA_DEVICE_ONLY": "1"})):
        cut = cut_region(data, os.path.join(work, f"region_{bp}"),
                         min(bp, len(draft)))
        cut_truth = truth_prefix(truth, read_fasta(cut[2]),
                                 len(draft) / len(truth))
        cut_draft = chunked_distance(read_fasta(cut[2]), cut_truth, cpu)
        out_path = os.path.join(work, f"{name}.fasta")
        portable = name == "polish_portable"
        with env_set(**env):
            pol, wall, launches = counted_polish(
                cli, base + list(cut), out_path, scan=True,
                lockstep=portable)
        forced = None
        if not portable and launches["align_scan_full"] == 0:
            # the set sent no pair to the full kernel: the batched
            # aligner's short-pair bucket does, a path of its own, its
            # counts set to 0 just before it and read just after
            build.zero_launch_counts()
            forced = scan_forced_full(region, dev, cpu)
            forced["launches"] = launch_counts(scan=True)
            forced["main_path_bound_ms"] = bound(
                0, 0, forced["stats"].get("align_scan_full", {}).get(
                    "words", 0) * OPS_PER_SCAN_FULL_WORD)[0]
        d_pol = chunked_distance(read_fasta(out_path), cut_truth, cpu)
        kcells = {k: pol.align_kernel_cells[k]
                  for k in ("align_scan_band", "align_scan_full")}
        line = {"bp": min(bp, len(draft)), "argv": base,
                "env": env, "wall_s": round(wall, 3),
                "stage_walls_s": {k: round(v, 3)
                                  for k, v in pol.stage_walls.items()},
                "launches": launches,
                "align_dispatches": pol.align_dispatches,
                "align_kernel_ms": {k: round(v, 3) for k, v in
                                    pol.align_kernel_ms.items()},
                "align_cells": kcells,
                "scan_cycles": {k: cycle_split(pol.align_cycles[k],
                                               ("sweep", "traceback"))
                                for k in kcells},
                "scan_rungs": {str(hw): {k: round(v, 3) for k, v in
                                         r.items()}
                               for hw, r in sorted(
                                   pol.align_scan_rungs.items())},
                "main_path_bound_ms": {
                    "align_scan_band": bound(
                        0, 0, kcells["align_scan_band"]
                        * OPS_PER_SCAN_BAND_CELL)[0],
                    "align_scan_full": bound(
                        0, 0, pol.align_scan_full_words
                        * OPS_PER_SCAN_FULL_WORD)[0]},
                "align_eligible": pol.align_eligible,
                "align_over_length": pol.align_over_length,
                "align_cpu_fallthrough": pol.align_cpu_fallthrough,
                "align_rungs": pol.align_rungs,
                "poa_rounds": pol.poa_engine.n_rounds,
                "poa_rejected": {k: v for k, v in
                                 pol.poa_reject_counts.items() if v},
                "forced_full": forced, "card_states": pol.card_states,
                "draft_distance": cut_draft, "polished_distance": d_pol}
        emit(name, **line)
        lines[name] = line
        if d_pol > cut_draft / 10:
            raise RuntimeError(f"{name}: distance {d_pol} > draft "
                               f"{cut_draft} / 10")
        if pol.align_rungs or launches["align_wfa"] \
                or launches["align_band"]:
            raise RuntimeError(f"{name}: the default ladder ran: "
                               f"{pol.align_rungs} {launches}")
        if launches["align_scan_band"] <= 0:
            raise RuntimeError(f"{name}: scan launches {launches}")
        if forced is not None and (
                forced["launches"]["align_scan_full"] <= 0
                or any(forced["launches"][k] for k in (
                    "align_wfa", "align_band", "poa_full"))):
            raise RuntimeError(f"{name}: the batched aligner's launches "
                               f"{forced['launches']}")
        if forced is not None and forced["native_mismatches"]:
            raise RuntimeError(f"{name}: {forced['native_mismatches']} "
                               "batched-aligner distance(s) differ from "
                               "the native engine")
        if portable and (launches["poa_lockstep"] <= 0
                         or launches["poa_full"]):
            raise RuntimeError(f"{name}: POA launches {launches}")
        if not portable and (launches["poa_full"] <= 0
                             or pol.poa_engine.n_rounds):
            raise RuntimeError(f"{name}: POA launches {launches}, "
                               f"{pol.poa_engine.n_rounds} rounds")
    return lines["polish_scan"], lines["polish_portable"]


def scan_phase(cli, cpu, work, data, region, dev, inputs, truth,
               threads) -> tuple:
    """scan_check, scan_card, scan_full_card, then polish_scan and
    polish_portable;
    returns the lines of scan_check, polish_scan and polish_portable."""
    scheck, checked, checked_full = scan_check(region, dev)
    emit("scan_check", **scheck)
    if scheck["mismatches"]:
        raise RuntimeError(f"a scan kernel disagrees with its plain version "
                           f"on {scheck['mismatches']} lane(s)")
    if scheck["past_band"] < 1:
        raise RuntimeError("scan_check ran no lane past its band")
    for name, kept, n_lanes in (("scan_card", checked, 64),
                                ("scan_card", checked, 1024),
                                ("scan_full_card", checked_full, 1024)):
        card = scan_card(kept, dev, n_lanes)
        emit(name, **card)
        if card["mismatches"]:
            raise RuntimeError(f"{name}: {card['mismatches']} of "
                               f"{n_lanes} tiled lanes differ from their "
                               "checked tapes")
    return (scheck, *scan_paths(cli, cpu, work, data, inputs, truth, region,
                                dev, threads))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-len", type=int, default=4_641_652)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--only", choices=["band", "wfa", "default", "traced",
                                       "map", "cache", "fusion", "serve",
                                       "fleet", "lockstep", "scan"],
                    default=None,
                    help="band / wfa: env, build, dataset, align_check and "
                    "band_card / wfa_card only; default: env, build, "
                    "dataset, polish_default and pipeline_bytes only; "
                    "traced: env, build, dataset, the staged polish, "
                    "traced and long_cap only; map: env, build, dataset "
                    "and map_rounds with the whole set's --rounds 2 run; "
                    "cache / fusion: env, build, dataset and that phase "
                    "only; serve: env, build, dataset, the staged polish "
                    "and serve; fleet: env, build, dataset and fleet (the "
                    "router, shards, failover, ranks, scrape, the wrapper "
                    "split and served, inspect --fleet, top --fleet and "
                    "explain); lockstep: env, build, dataset, "
                    "lockstep_check, polish_w1000 and polish_wlong; scan: "
                    "env, build, "
                    "dataset, scan_check, scan_card, scan_full_card, "
                    "polish_scan and polish_portable; "
                    "then exit 0 without the result line")
    ap.add_argument("--keep", default=None,
                    help="directory to copy the traced runs' traces and "
                    "reports to (default: none kept)")
    ap.add_argument("--work", default=None,
                    help="dataset directory (default: tmp/chip_smoke in "
                    "the checkout, removed at the end)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    # the calibration store stays off unless a phase names its own; the
    # result cache is on, in process only, unless the cache phase says
    # otherwise
    os.environ["RACON_TPU_TORCH_CACHE_DIR"] = ""
    for knob in ("RACON_TPU_TORCH_CACHE", "RACON_TPU_TORCH_CACHE_PERSIST",
                 "RACON_TPU_TORCH_FUSE", "RACON_TPU_TORCH_FUSE_FORCE"):
        os.environ.pop(knob, None)
    from racon_tpu_torch import cli, convert
    from racon_tpu_torch.core.polisher import (PolisherType,
                                               create_polisher)
    from racon_tpu_torch.core.window import WindowType
    from racon_tpu_torch.cuda import align_band as ab
    from racon_tpu_torch.cuda import align_wfa as aw
    from racon_tpu_torch.cuda import build, poa_full as pf
    from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine
    from racon_tpu_torch.ops import cpu
    from racon_tpu_torch.tools import simulate

    t_run = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    emit("env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- build, beside the dataset's simulation ------------------------
    # the nvcc processes and the native library's compiler run while
    # this thread simulates the set (numpy); the build thread only waits
    # on its children
    built = {}

    def build_job():
        t = time.perf_counter()
        try:
            built["log"] = build.build_all()
            built["seconds"] = time.perf_counter() - t
            cpu.get_library()
        except BaseException as e:      # raised again below
            built["error"] = e

    builder = threading.Thread(target=build_job)
    builder.start()
    work = args.work or os.path.join(ROOT, "tmp", "chip_smoke")
    data = os.path.join(work, "full")
    t0 = time.perf_counter()
    try:
        reads, paf, draft = simulate.simulate(
            data, genome_len=args.genome_len, coverage=30, read_len=8000,
            seed=7, ont=True)
    finally:
        builder.join()
    t_sim = time.perf_counter() - t0
    if "error" in built:
        raise built["error"]
    log = built["log"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit("build", seconds=round(built["seconds"], 3),
         kernels={n: {"seconds": round(r["seconds"], 3),
                      "ptxas": [l for l in r["ptxas"].splitlines()
                                if "registers" in l or "spill" in l]}
                  for n, r in log.items()},
         poa_full_stock=poa_resources(dev, sms),
         align_band_resources=band_resources(dev, sms,
                                             log["align_band"]["ptxas"]),
         align_wfa_resources=wfa_resources(dev, sms,
                                           log["align_wfa"]["ptxas"]))
    for name, rec in log.items():
        if "registers" not in rec["ptxas"]:
            raise RuntimeError(f"no ptxas report for {name}")
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                             rec["ptxas"])]
        if any(spills):
            raise RuntimeError(f"{name} spills registers: {spills} bytes")

    # ---- dataset ------------------------------------------------------
    region = cut_region(data, os.path.join(work, "region"), 120_000)
    pol = create_polisher(*region, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, args.threads)
    pol.initialize()
    region_windows = [w for w in pol.windows if len(w.sequences) >= 3]
    pol.close()
    emit("dataset", genome_len=args.genome_len, simulate_s=round(t_sim, 3),
         region_windows=len(region_windows))

    argv_polish = ["-t", str(args.threads), "-m", "5", "-x", "-4", "-g",
                   "-8", "-c", "1", "--cudaaligner-batches", "1", reads,
                   paf, draft]
    out_path = os.path.join(work, "polished.fasta")
    if args.only in (None, "default", "map", "cache", "fleet", "lockstep",
                     "scan"):
        truth = read_fasta(os.path.join(data, "genome.fasta"))
        d_draft = chunked_distance(read_fasta(draft), truth, cpu)
    if args.only is not None:
        if args.only == "default":
            default_path(cli, cpu, work, reads, paf, draft, truth, d_draft,
                         args.threads, args.keep)
        elif args.only == "map":
            map_rounds(cli, cpu, work, data, reads, draft, truth,
                       args.threads, dev, args.keep, quality=True)
        elif args.only == "cache":
            cache_phase(cli, cpu, work, argv_polish, truth, off=True)
            cache_persist(cli, work, fuse_cuts(work, data)["a"],
                          args.threads)
            cache_default(cli, work, argv_polish)
        elif args.only == "fusion":
            fusion_phase(work, data, args.threads)
        elif args.only == "fleet":
            fleet_phase(cpu, work, data, truth, args.threads)
        elif args.only == "lockstep":
            lockstep_phase(cli, cpu, work, data, region, dev,
                           [reads, paf, draft], truth, args.threads)
        elif args.only == "scan":
            scan_phase(cli, cpu, work, data, region, dev,
                       [reads, paf, draft], truth, args.threads)
        elif args.only == "serve":
            with env_set(**STAGED_ENV):
                pol, wall, launches = counted_polish(cli, argv_polish,
                                                     out_path)
            emit("polish", wall_s=round(wall, 3), launches=launches,
                 batch=pol.poa_batch_size)
            serve_phase(cli, work, data, pol.poa_batch_size, args.threads)
        elif args.only == "traced":
            with env_set(**STAGED_ENV):
                pol, wall, launches = counted_polish(cli, argv_polish,
                                                     out_path)
            emit("polish", wall_s=round(wall, 3), launches=launches,
                 align_kernel_ms={k: round(v, 3) for k, v in
                                  pol.align_kernel_ms.items()})
            traced_phase(cli, work, argv_polish, out_path, wall, args.keep)
            long_cap_phase(cli, work, args.threads)
        else:
            align_phases(region, dev, cpu, args.only)
        emit("partial", only=args.only,
             run_s=round(time.perf_counter() - t_run, 3))
        if args.work is None:
            shutil.rmtree(work)
        return 0

    # ---- kernel_check ---------------------------------------------------
    stock = dict(v=2048, lp=1024, wb=pf.band_width(1024), match=5,
                 mismatch=-4, gap=-8, wtype=1, trim=1)
    engine = CudaPoaBatchEngine(5, -4, -8, device=dev)
    fitting = [w for w in region_windows if engine.fits([w])]
    check, ms, plain_ms = poa_check(fitting, dev, stock)
    mismatches, max_err = check["mismatches"], check["max_abs_err"]
    emit("kernel_check", **check)
    if mismatches:
        raise RuntimeError(f"kernel disagrees with its plain version on "
                           f"{mismatches} window(s)")
    card_batch = full_card(fitting, dev, stock)
    emit("full_card", **card_batch)
    if card_batch["mismatches"]:
        raise RuntimeError(f"{card_batch['mismatches']} replica(s) of the "
                           "full-card batch differ from their originals")
    deep = full_card(deep_windows(work, args.threads, engine), dev, stock,
                     plain_second_pass=1)
    emit("deep_card", coverage=60, **deep)
    if deep["mismatches"]:
        raise RuntimeError(f"{deep['mismatches']} window(s) of the deep "
                           "batch differ from their originals or from the "
                           "plain version")

    # ---- align_check, band_card, wfa_card --------------------------------
    acheck = align_phases(region, dev, cpu)

    # ---- cache, and polish (the main path, counted): the cache phase's
    # cold run is the staged polish
    polisher, wall, launches, out_path, d_pol = cache_phase(
        cli, cpu, work, argv_polish, truth)
    eng = polisher.poa_engine
    rejects = sum(polisher.poa_reject_counts.values())
    eligible = polisher.poa_eligible_windows
    fallthrough = polisher.align_cpu_fallthrough
    emit("polish", argv=argv_polish[:-3], wall_s=round(wall, 3),
         stage_walls_s={k: round(v, 3)
                        for k, v in polisher.stage_walls.items()},
         launches=launches, batch=polisher.poa_batch_size,
         eligible_windows=eligible, windows_on_kernel=eng.windows_on_kernel,
         rejected=polisher.poa_reject_counts,
         skipped_layers=eng.n_skipped_layers,
         kernel_ms=round(eng.kernel_ms, 3), dp_cells=eng.cells,
         pred_rows=eng.pred_rows, phase_cycles=eng.phase_cycles,
         main_path_bound_ms={
             "poa_full": bound(0, 0, poa_ops(eng.cells, eng.pred_rows,
                                             eng.wb))[0],
             "align_wfa": bound(0, 0,
                                polisher.align_kernel_cells["align_wfa"]
                                * OPS_PER_WFA_CELL)[0],
             "align_band": bound(0, 0,
                                 polisher.align_kernel_cells["align_band"]
                                 * OPS_PER_BAND_CELL)[0]},
         align_cells=polisher.align_kernel_cells,
         align_chunks=chunk_rates(polisher.align_chunks),
         align_eligible=polisher.align_eligible,
         align_probed=polisher.align_probed,
         align_over_length=polisher.align_over_length,
         align_cpu_fallthrough=fallthrough,
         align_rungs=polisher.align_rungs,
         align_dispatches=polisher.align_dispatches,
         align_kernel_ms={k: round(v, 3) for k, v in
                          polisher.align_kernel_ms.items()},
         align_band_phases=cycle_split(polisher.align_cycles["align_band"]),
         align_wfa_phases=wfa_split(polisher.align_cycles["align_wfa"]),
         card_states=polisher.card_states, lockstep_rounds=eng.n_rounds,
         draft_distance=d_draft, polished_distance=d_pol)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the main path launched no {name} kernel")
    if eng.n_rounds:
        raise RuntimeError(f"the -w 500 polish ran {eng.n_rounds} lockstep "
                           "rounds")
    if fallthrough > 0.10 * max(1, polisher.align_eligible):
        raise RuntimeError(f"{fallthrough} of {polisher.align_eligible} "
                           "device-eligible overlaps fell through to the "
                           "CPU")
    if rejects > 0.10 * max(1, eligible):
        raise RuntimeError(f"{rejects} of {eligible} windows rejected")
    if d_pol > d_draft / 10:
        raise RuntimeError(f"polished distance {d_pol} > draft "
                           f"{d_draft} / 10")

    # ---- traced (the staged path again, traced) -------------------------
    traced_phase(cli, work, argv_polish, out_path, wall, args.keep)
    long_cap_phase(cli, work, args.threads)

    # ---- lockstep_check, polish_w1000 (windows past the whole-window
    # kernel's caps: the lockstep engine, counted) ----------------------
    lcheck, lock = lockstep_phase(cli, cpu, work, data, region, dev,
                                  [reads, paf, draft], truth, args.threads)

    # ---- scan_check, polish_scan, polish_portable (the scan ladder under
    # its switches: both scan kernels and, portable, the lockstep engine,
    # counted) ----------------------------------------------------------
    scheck, pscan, _ = scan_phase(cli, cpu, work, data, region, dev,
                                  [reads, paf, draft], truth, args.threads)

    # ---- fusion (the device executor across two tenants), then the
    # cache's persistent tier on fusion's first cut ---------------------
    cut_a, cut_a_bytes, cut_a_wall = fusion_phase(work, data, args.threads)
    cache_persist(cli, work, cut_a, args.threads, off_bytes=cut_a_bytes)

    # ---- serve (the daemon: served jobs on the card) --------------------
    serve_phase(cli, work, data, polisher.poa_batch_size, args.threads,
                cut=cut_a, cut_bytes=cut_a_bytes, cut_wall=cut_a_wall)

    # ---- fleet (a router, two backends, shards, a failover, two ranks) ---
    fleet_phase(cpu, work, data, truth, args.threads)

    # ---- polish_default, pipeline_bytes (the default path, counted) ------
    default_path(cli, cpu, work, reads, paf, draft, truth, d_draft,
                 args.threads, args.keep)

    # ---- map_rounds, map_seed_bytes (no PAF: the mapper, counted) --------
    mapped = map_rounds(cli, cpu, work, data, reads, draft, truth,
                        args.threads, dev, args.keep)

    # ---- native_compare (outside the counted run) -----------------------
    sample = [w for w in region_windows if engine.fits([w])][:200]
    dev_res = engine.consensus_batch(sample, True)
    native = cpu.PoaEngine(5, -4, -8)
    total, n_cmp = 0, 0
    for w, (cons, ok) in zip(sample, dev_res):
        if cons is None:
            continue
        total += cpu.edit_distance(cons, native.consensus(w, True))
        n_cmp += 1
    emit("native_compare", windows=n_cmp,
         kernel_vs_native_edit_distance=total,
         bases=sum(len(w.sequences[0]) for w in sample))

    # ---- kernels ---------------------------------------------------------
    emit("kernels", run_s=round(time.perf_counter() - t_run, 3),
         status={name: "ok" for name in [*mapped["launches"],
                                          "poa_lockstep", "align_scan_full",
                                          "align_scan_band"]})
    if args.work is None:
        shutil.rmtree(work)
    wfa, band, seed = acheck["wfa"], acheck["band"], mapped["seed"]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "poa_full", "route": "cuda",
        "source": "racon_tpu_torch/cuda/csrc/poa_full.cu",
        "replaces": "racon_tpu/tpu/poa_pallas.py:308",
        "launches": launches["poa_full"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": check["bound_ms"],
        "bound_by": check["bound_by"], "library_ms": None}, {
        "name": "align_wfa", "route": "cuda",
        "source": "racon_tpu_torch/cuda/csrc/align_wfa.cu",
        "replaces": "racon_tpu/tpu/align_pallas.py:858",
        "launches": launches["align_wfa"],
        "max_abs_err": max(wfa["max_abs_err"],
                           acheck["tiny"]["wfa_max_abs_err"]),
        "ms": wfa["kernel_ms"], "plain_ms": wfa["plain_ms"],
        "bound_ms": wfa["bound_ms"], "bound_by": wfa["bound_by"],
        "library_ms": None}, {
        "name": "align_band", "route": "cuda",
        "source": "racon_tpu_torch/cuda/csrc/align_band.cu",
        "replaces": "racon_tpu/tpu/align_pallas.py:214",
        "launches": launches["align_band"],
        "max_abs_err": max(band["max_abs_err"],
                           acheck["band_measured"]["max_abs_err"],
                           acheck["tiny"]["band_max_abs_err"]),
        "ms": band["kernel_ms"], "plain_ms": band["plain_ms"],
        "bound_ms": band["bound_ms"], "bound_by": band["bound_by"],
        "library_ms": None}, {
        "name": "seed_words", "route": "cuda",
        "source": "racon_tpu_torch/cuda/csrc/seed_words.cu",
        "replaces": "racon_tpu/tpu/seedmatch.py:30",
        "launches": mapped["launches"]["seed_words"],
        "max_abs_err": seed["max_abs_err"], "ms": seed["kernel_ms"],
        "plain_ms": seed["plain_ms"], "bound_ms": seed["bound_ms"],
        "bound_by": seed["bound_by"], "library_ms": seed["library_ms"]}, {
        "name": "poa_lockstep", "route": "cuda",
        "source": "racon_tpu_torch/cuda/csrc/poa_lockstep.cu",
        "replaces": "racon_tpu/tpu/poa.py:178",
        "launches": lock["launches"]["poa_lockstep"],
        "max_abs_err": lcheck["max_abs_err"],
        "ms": lcheck["auto_kernel_ms"], "plain_ms": lcheck["auto_plain_ms"],
        "bound_ms": lcheck["auto_bound_ms"],
        "bound_by": lcheck["auto_bound_by"], "library_ms": None}, {
        "name": "align_scan_full", "route": "cuda",
        "source": "racon_tpu_torch/cuda/csrc/align_scan.cu",
        "replaces": "racon_tpu/tpu/aligner.py:75",
        # the polish's own launches, or, when it sent no pair to the
        # full kernel, those of the batched aligner's run
        "launches": (pscan["forced_full"] or pscan)["launches"][
            "align_scan_full"],
        "max_abs_err": scheck["full_max_abs_err"],
        "ms": scheck["full"]["kernel_ms"],
        "plain_ms": scheck["full"]["plain_ms"],
        "bound_ms": scheck["full"]["bound_ms"],
        "bound_by": scheck["full"]["bound_by"], "library_ms": None}, {
        "name": "align_scan_band", "route": "cuda",
        "source": "racon_tpu_torch/cuda/csrc/align_scan.cu",
        "replaces": "racon_tpu/tpu/aligner.py:166",
        "launches": pscan["launches"]["align_scan_band"],
        "max_abs_err": scheck["band_max_abs_err"],
        "ms": scheck["band"]["kernel_ms"],
        "plain_ms": scheck["band"]["plain_ms"],
        "bound_ms": scheck["band"]["bound_ms"],
        "bound_by": scheck["band"]["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
