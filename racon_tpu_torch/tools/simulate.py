"""Synthetic polishing-workload generator (genome + reads + PAF).

A copy of the JAX package's racon_tpu/tools/simulate.py: the same seed
gives the same files.

The reference validates at scale on an E. coli ONT dataset fetched from
S3 (reference: ci/gpu/build.sh:25-33); that network path is unavailable
here, so this module synthesizes an equivalent workload: a random
genome, a mutated draft (the polishing target), and error-laden reads
whose true coordinates are known by construction — overlaps are emitted
directly as PAF from the simulation truth, no mapper needed.

Everything is seeded and deterministic, so scale benchmarks are
reproducible run-to-run.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutate(seq: np.ndarray, rate: float,
            rng: np.random.Generator) -> np.ndarray:
    """Apply substitutions/insertions/deletions at ``rate`` (split
    evenly), the ONT-style error mix used by the window tests."""
    r = rng.random(seq.size)
    keep = r >= rate / 3                       # deletions
    out = seq[keep]
    r2 = rng.random(out.size)
    subs = r2 < rate / 3
    out = out.copy()
    out[subs] = _ACGT[rng.integers(0, 4, int(subs.sum()))]
    ins = r2 >= 1 - rate / 3
    if ins.any():
        pieces = []
        last = 0
        for idx in np.flatnonzero(ins):
            pieces.append(out[last:idx + 1])
            pieces.append(_ACGT[rng.integers(0, 4, 1)])
            last = idx + 1
        pieces.append(out[last:])
        out = np.concatenate(pieces)
    return out


def _mutate_ont(seq: np.ndarray, rate: float,
                rng: np.random.Generator):
    """ONT-structured errors: half the budget goes to
    homopolymer-run indels (the dominant nanopore error class, with
    probability growing in run length), the rest to random
    subs/ins/dels.  Returns (read, err_mask) where err_mask marks
    read positions introduced or adjacent to an error -- callers
    derive CORRELATED base qualities from it (real ONT quality
    predicts local error; uniform-random quality overstates how much
    signal the POA's quality weights can extract)."""
    # --- homopolymer indels, one per selected run ------------------
    bound = np.flatnonzero(np.diff(seq) != 0) + 1
    starts = np.concatenate(([0], bound))
    lens = np.diff(np.concatenate((starts, [seq.size])))
    # P(indel | run) saturates at 8+ bases; calibrated so ~half the
    # error budget lands in runs for a random-composition genome
    p_run = np.minimum(rate * 2.0 * np.minimum(lens, 8) / 4.0, 0.9)
    hit = rng.random(lens.size) < p_run
    del_run = hit & (rng.random(lens.size) < 0.5) & (lens > 1)
    ins_run = hit & ~del_run
    keep = np.ones(seq.size, bool)
    keep[starts[del_run]] = False
    out = seq[keep]
    err = np.zeros(out.size, bool)
    # positions shift after deletion: map old starts to new indices
    old2new = np.cumsum(keep) - 1
    err[np.clip(old2new[starts[del_run]], 0, out.size - 1)] = True
    ins_at = np.clip(old2new[starts[ins_run]], 0, out.size - 1)
    out = np.insert(out, ins_at, out[ins_at])
    err = np.insert(err, ins_at, True)

    # --- residual random subs/ins/dels -----------------------------
    rr = rate * 0.5
    r = rng.random(out.size)
    keep2 = r >= rr / 3
    out2 = out[keep2]
    err2 = err[keep2]
    old2new2 = np.cumsum(keep2) - 1
    err2[np.clip(old2new2[~keep2], 0, max(out2.size - 1, 0))] = True
    r2 = rng.random(out2.size)
    subs = r2 < rr / 3
    out2 = out2.copy()
    out2[subs] = _ACGT[rng.integers(0, 4, int(subs.sum()))]
    err2 |= subs
    ins = np.flatnonzero(r2 >= 1 - rr / 3)
    out2 = np.insert(out2, ins, _ACGT[rng.integers(0, 4, ins.size)])
    err2 = np.insert(err2, ins, True)
    # quality degrades around errors, not only on them
    dil = err2.copy()
    dil[1:] |= err2[:-1]
    dil[:-1] |= err2[1:]
    return out2, dil


def _enrich_homopolymers(genome: np.ndarray,
                         rng: np.random.Generator) -> np.ndarray:
    """Real genomes carry far more long homopolymer runs than uniform
    random sequence; stretch ~1.5% of positions by geometric extra
    copies so the ONT error model has realistic runs to act on."""
    reps = np.ones(genome.size, np.int64)
    sel = rng.random(genome.size) < 0.015
    reps[sel] += rng.geometric(0.45, int(sel.sum()))
    return np.repeat(genome, reps)


def simulate(out_dir: str, genome_len: int = 1_000_000,
             coverage: int = 30, read_len: int = 10_000,
             read_error: float = 0.10, draft_error: float = 0.02,
             seed: int = 7, ont: bool = False,
             draft_region=None) -> Tuple[str, str, str]:
    """Write genome.fasta (truth), draft.fasta (mutated target),
    reads.fastq, reads2draft.paf and truth.json into ``out_dir``.

    ``ont=True`` selects the ONT-realistic model (the reference
    validates on real E. coli ONT data, ci/gpu/cuda_test.sh:25-33,
    unreachable here): homopolymer-enriched genome, homopolymer-biased
    indels, lognormal read lengths and error-correlated qualities.
    The default stays the legacy uniform mix so recorded baselines
    remain comparable.

    ``draft_region=(begin, end)`` confines draft mutations to that
    genome-coordinate slice; the rest of the draft is a verbatim copy
    of the truth.

    ``truth.json`` records every read's true placement on the DRAFT
    ({name, length, strand, t_begin, t_end} plus draft_len).

    Returns (reads_path, paf_path, draft_path) ready for the polisher;
    genome.fasta is the accuracy oracle.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    genome = _ACGT[rng.integers(0, 4, genome_len)]
    if ont:
        genome = _enrich_homopolymers(genome, rng)
        genome_len = genome.size
    if draft_region is None:
        draft = _mutate(genome, draft_error, rng)
    else:
        rb, re_ = (max(0, int(draft_region[0])),
                   min(genome_len, int(draft_region[1])))
        draft = np.concatenate((genome[:rb],
                                _mutate(genome[rb:re_], draft_error,
                                        rng),
                                genome[re_:]))

    genome_path = os.path.join(out_dir, "genome.fasta")
    with open(genome_path, "wb") as fh:
        fh.write(b">genome\n" + genome.tobytes() + b"\n")
    draft_path = os.path.join(out_dir, "draft.fasta")
    with open(draft_path, "wb") as fh:
        fh.write(b">draft\n" + draft.tobytes() + b"\n")

    n_reads = max(1, genome_len * coverage // read_len)
    reads_path = os.path.join(out_dir, "reads.fastq")
    paf_path = os.path.join(out_dir, "reads2draft.paf")
    # PAF targets the DRAFT (what the polisher aligns against), whose
    # coordinates drift from genome coordinates by the draft's indels;
    # a single linear rescale leaves O(sqrt(p*L)) local drift, absorbed
    # by the polisher's error threshold -- these are seed coordinates,
    # not exact truth
    dlen = draft.size
    scale = dlen / genome_len
    truth = []
    with open(reads_path, "wb") as rf, open(paf_path, "wb") as pf:
        for i in range(n_reads):
            if ont:
                # lognormal lengths (ONT-style long tail), mean at
                # read_len, floored so windows still see full spans
                sigma = 0.55
                rl = int(np.clip(
                    rng.lognormal(np.log(read_len) - sigma ** 2 / 2,
                                  sigma),
                    read_len // 4, read_len * 4))
            else:
                rl = read_len
            start = int(rng.integers(0, max(1, genome_len - rl)))
            end = min(genome_len, start + rl)
            if ont:
                fwd, errm = _mutate_ont(genome[start:end], read_error,
                                        rng)
            else:
                fwd, errm = _mutate(genome[start:end], read_error,
                                    rng), None
            strand = b"+" if rng.random() < 0.5 else b"-"
            if strand == b"-":
                from racon_tpu_torch.core.sequence import _COMPLEMENT
                data = np.frombuffer(
                    fwd.tobytes().translate(_COMPLEMENT),
                    np.uint8)[::-1]
                if errm is not None:
                    errm = errm[::-1]
            else:
                data = fwd
            name = b"read%06d" % i
            if errm is None:
                qual = rng.integers(45, 75,
                                    data.size).astype(np.uint8) + 33
            else:
                # error-correlated qualities: low Phred near real
                # errors, high elsewhere (what ONT basecallers emit)
                hi = rng.integers(45, 75, data.size)
                lo = rng.integers(10, 28, data.size)
                qual = np.where(errm, lo, hi).astype(np.uint8) + 33
            rf.write(b"@" + name + b"\n" + data.tobytes() + b"\n+\n"
                     + qual.tobytes() + b"\n")
            t_begin = int(start * scale)
            t_end = min(dlen, int(end * scale))
            pf.write(b"\t".join([
                name, b"%d" % data.size, b"0", b"%d" % data.size,
                strand, b"draft", b"%d" % dlen, b"%d" % t_begin,
                b"%d" % t_end, b"%d" % (t_end - t_begin),
                b"%d" % (t_end - t_begin), b"255"]) + b"\n")
            truth.append({"name": name.decode(),
                          "length": int(data.size),
                          "strand": strand.decode(),
                          "t_begin": t_begin, "t_end": t_end})
    with open(os.path.join(out_dir, "truth.json"), "w") as tf:
        json.dump({"draft_len": dlen, "reads": truth}, tf, indent=0)
    return reads_path, paf_path, draft_path


def concat_sets(sets, out_dir: str) -> Tuple[str, str, str]:
    """Join ``(reads, paf, draft)`` sets, each with one draft contig
    and four-line FASTQ reads (what :func:`simulate` writes), into one
    job of ``len(sets)`` contigs: set i's contig is renamed ``ctg<i>``
    and its reads get the prefix ``d<i>``, in its FASTQ and in its PAF's
    query and target columns (the naming of the JAX package's test
    helper, tests/test_scatter.py:_multi_target_dataset).  The smallest
    input whose target shards own distinct non-empty slices; returns the
    joined (reads, paf, draft) paths in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = tuple(os.path.join(out_dir, n) for n in
                  ("reads.fastq", "reads2draft.paf", "draft.fasta"))
    with open(paths[0], "wb") as rf, open(paths[1], "wb") as pf, \
            open(paths[2], "wb") as df:
        for i, (reads, paf, draft) in enumerate(sets):
            tag, ctg = b"d%d" % i, b"ctg%d" % i
            with open(reads, "rb") as fh:
                lines = fh.read().splitlines(keepends=True)
            for j in range(0, len(lines), 4):
                rf.write(b"@" + tag + lines[j][1:] + b"".join(
                    lines[j + 1:j + 4]))
            with open(paf, "rb") as fh:
                for line in fh:
                    f = line.split(b"\t")
                    f[0], f[5] = tag + f[0], ctg
                    pf.write(b"\t".join(f))
            with open(draft, "rb") as fh:
                lines = fh.read().splitlines(keepends=True)
            if sum(1 for l in lines if l.startswith(b">")) != 1:
                raise ValueError(f"{draft}: one contig expected")
            df.write(b">" + ctg + b"\n" + b"".join(lines[1:]))
    return paths


def long_pair(out_dir: str, seed: int = 5) -> Tuple[str, str, str]:
    """A set for the align length cap: a 21,000-base draft, one read of
    20,000 bases of it (past the WFA kernel's 16,384 rows) and 12 reads
    of 1,000 bases, each with a substitution every 97 bases (so every
    pair has one optimal alignment, whatever aligner finds it), and
    their PAF overlaps.  Writes reads.fasta, ovl.paf and draft.fasta
    into ``out_dir``; returns (reads_path, paf_path, draft_path)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    draft = _ACGT[rng.integers(0, 4, 21_000)]
    spans = [(500, 20_000)] + [(200 + 1_600 * k, 1_000) for k in range(12)]
    fasta, paf = [], []
    for r, (start, n) in enumerate(spans):
        seq = draft[start:start + n].copy()
        # each base to the next of A, C, G, T (_ACGT is sorted)
        seq[40::97] = _ACGT[(np.searchsorted(_ACGT, seq[40::97]) + 1) % 4]
        fasta.append(b">r%d\n%s\n" % (r, seq.tobytes()))
        paf.append(b"r%d\t%d\t0\t%d\t+\tdraft\t%d\t%d\t%d\t%d\t%d\t60\n"
                   % (r, n, n, draft.size, start, start + n, n, n))
    paths = tuple(os.path.join(out_dir, name)
                  for name in ("reads.fasta", "ovl.paf", "draft.fasta"))
    for path, data in zip(paths, (b"".join(fasta), b"".join(paf),
                                  b">draft\n" + draft.tobytes() + b"\n")):
        with open(path, "wb") as fh:
            fh.write(data)
    return paths
