#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (racon_tpu_torch).

    python3 chip_smoke.py [--genome-len N] [--threads T] [--work DIR]

Needs one CUDA card.  Phases, one JSON line each:

1. env          card name and power limit, torch and CUDA versions;
2. build        nvcc builds every kernel from the checkout's sources;
3. dataset      simulates an E. coli-sized ONT set (4,641,652 bp,
                30x, 8 kb reads, seed 7) and cuts a 120 kb region of
                it whose windows feed the checks below;
4. kernel_check 32 real windows at stock caps (V 2048, LP 1024,
                WB 256) plus tiny windows (and a forced reject): the
                CUDA kernel and its plain PyTorch version on the card
                must agree exactly on cons[:len] and mout[:, :5];
5. polish       the port's CLI (-m 5 -x -4 -g -8 -c 1) on the whole
                set; launches > 0, rejects <= 10% of eligible windows,
                polished distance to truth <= draft distance / 10;
6. native_compare  200 region windows on the kernel and on the native
                CPU engine: summed edit distance between the two;
7. kernels      every ported kernel with its launches in phase 5.

Then the card's line as nvidia-smi prints it and the result line.  Any
failure raises and the script exits non-zero without a result line.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the
# non-tensor-core float32 rate, used as the ceiling of the kernel's
# int32 ALU operations
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# int32 operations per DP cell (per-slot load/shift/compare/select,
# substitution, the diag/vert candidates, the max-plus scan, the
# direction code and the packed store), counted from csrc/poa_full.cu
OPS_PER_CELL = 32


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def cut_region(src: str, dst: str, length: int) -> tuple:
    """The draft's first ``length`` bases with the reads whose PAF
    records fall inside them, as (reads, paf, draft) paths."""
    os.makedirs(dst, exist_ok=True)
    draft = read_fasta(os.path.join(src, "draft.fasta"))[:length]
    names, paf_lines = set(), []
    with open(os.path.join(src, "reads2draft.paf"), "rb") as fh:
        for line in fh:
            f = line.split(b"\t")
            if int(f[8]) <= length:
                f[6] = b"%d" % length
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


def cuda_ms(fn, reps: int) -> list:
    import torch
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-len", type=int, default=4_641_652)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--work", default=None,
                    help="dataset directory (default: tmp/chip_smoke in "
                    "the checkout, removed at the end)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from racon_tpu_torch import cli, convert
    from racon_tpu_torch.core.polisher import (PolisherType,
                                               create_polisher)
    from racon_tpu_torch.core.window import WindowType
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

    # ---- build ----------------------------------------------------------
    t0 = time.perf_counter()
    log = build.build_all()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         kernels={n: {"seconds": round(r["seconds"], 3),
                      "ptxas": [l for l in r["ptxas"].splitlines()
                                if "registers" in l or "spill" in l]}
                  for n, r in log.items()})
    cpu.get_library()

    # ---- dataset ------------------------------------------------------
    work = args.work or os.path.join(ROOT, "tmp", "chip_smoke")
    data = os.path.join(work, "full")
    t0 = time.perf_counter()
    reads, paf, draft = simulate.simulate(
        data, genome_len=args.genome_len, coverage=30, read_len=8000,
        seed=7, ont=True)
    t_sim = time.perf_counter() - t0
    region = cut_region(data, os.path.join(work, "region"), 120_000)
    pol = create_polisher(*region, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, args.threads)
    pol.initialize()
    region_windows = [w for w in pol.windows if len(w.sequences) >= 3]
    pol.close()
    emit("dataset", genome_len=args.genome_len, simulate_s=round(t_sim, 3),
         region_windows=len(region_windows))

    # ---- kernel_check ---------------------------------------------------
    stock = dict(v=2048, lp=1024, wb=pf.band_width(1024), match=5,
                 mismatch=-4, gap=-8, wtype=1, trim=1)
    engine = CudaPoaBatchEngine(5, -4, -8, device=dev)
    windows32 = [w for w in region_windows if engine.fits([w])][:32]
    if len(windows32) < 32:
        raise RuntimeError(f"only {len(windows32)} region windows fit")
    pk = convert.pack_windows(windows32, 1024, 2048)
    inputs = convert.to_device(pk.seqs, pk.wts, pk.meta, pk.nlay,
                               pk.bblen, dev)
    kern = pf.poa_full(*inputs, **stock)
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(lambda: pf.poa_full(*inputs, **stock),
                                   5))
    t0 = time.perf_counter()
    plain = pf.poa_full_reference(*inputs, **stock)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    mismatches, max_err = compare(kern, plain)
    rank_steps = int(kern[1][:, 4].sum())
    in_bytes = sum(t.numel() * t.element_size() for t in inputs)
    out_bytes = sum(t.numel() * t.element_size() for t in kern)
    bytes_ms = 1e3 * (in_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_ms = 1e3 * rank_steps * stock["wb"] * OPS_PER_CELL / ALU_OPS_PER_S
    check = {"windows": len(windows32),
             "batch": int(inputs[0].shape[0]), "mismatches": mismatches,
             "max_abs_err": max_err, "kernel_ms": round(ms, 4),
             "plain_ms": round(plain_ms, 1), "rank_steps": rank_steps,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    rng = random.Random(3)
    for wtype, trim in ((WindowType.TGS, 1), (WindowType.NGS, 0)):
        tiny = tiny_windows(rng, wtype)
        tp = convert.pack_windows(tiny, 256, 256)
        targs = convert.to_device(tp.seqs, tp.wts, tp.meta, tp.nlay,
                                  tp.bblen, dev)
        kw = dict(v=256, lp=256, wb=256, match=5, mismatch=-4, gap=-8,
                  wtype=wtype.value, trim=trim)
        bad, err = compare(pf.poa_full(*targs, **kw),
                           pf.poa_full_reference(*targs, **kw))
        rejected = int((pf.poa_full(*targs, **kw)[1][:, 0] < 0).sum())
        check[f"tiny_{wtype.name}_trim{trim}"] = {
            "windows": len(tiny), "mismatches": bad, "rejected": rejected}
        mismatches += bad
        max_err = max(max_err, err)
        if rejected < 1:
            raise RuntimeError("the forced reject window was not rejected")
    emit("kernel_check", **check)
    if mismatches:
        raise RuntimeError(f"kernel disagrees with its plain version on "
                           f"{mismatches} window(s)")

    # ---- polish (the main path, counted) --------------------------------
    argv_polish = ["-t", str(args.threads), "-m", "5", "-x", "-4", "-g",
                   "-8", "-c", "1", reads, paf, draft]
    out_path = os.path.join(work, "polished.fasta")
    pf.LAUNCHES = 0
    t0 = time.perf_counter()
    with open(out_path, "wb") as out:
        polisher = cli.main(argv_polish, out=out)
    wall = time.perf_counter() - t0
    launches = pf.LAUNCHES
    eng = polisher.poa_engine
    truth = read_fasta(os.path.join(data, "genome.fasta"))
    d_draft = chunked_distance(read_fasta(draft), truth, cpu)
    d_pol = chunked_distance(read_fasta(out_path), truth, cpu)
    rejects = sum(polisher.poa_reject_counts.values())
    eligible = polisher.poa_eligible_windows
    emit("polish", argv=argv_polish[:-3], wall_s=round(wall, 3),
         stage_walls_s={k: round(v, 3)
                        for k, v in polisher.stage_walls.items()},
         launches=launches, batch=polisher.poa_batch_size,
         eligible_windows=eligible, windows_on_kernel=eng.windows_on_kernel,
         rejected=polisher.poa_reject_counts,
         skipped_layers=eng.n_skipped_layers,
         kernel_ms=round(eng.kernel_ms, 3), dp_cells=eng.cells,
         draft_distance=d_draft, polished_distance=d_pol)
    if launches <= 0:
        raise RuntimeError("the main path launched no POA kernel")
    if rejects > 0.10 * max(1, eligible):
        raise RuntimeError(f"{rejects} of {eligible} windows rejected")
    if d_pol > d_draft / 10:
        raise RuntimeError(f"polished distance {d_pol} > draft "
                           f"{d_draft} / 10")

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
         status={"poa_full": "ok"})
    if args.work is None:
        shutil.rmtree(work)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "poa_full", "route": "cuda",
        "source": "racon_tpu_torch/cuda/csrc/poa_full.cu",
        "replaces": "racon_tpu/tpu/poa_pallas.py:308",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": check["bound_ms"],
        "bound_by": check["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
