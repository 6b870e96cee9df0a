"""Subsample and split tool, rampler's two subcommands (JAX package:
racon_tpu/tools/rampler.py; reference: scripts/racon_wrapper.py:60-116,
vendor/rampler).

    python -m racon_tpu_torch.tools.rampler -o <dir> subsample \\
        <sequences> <reference length> <coverage>
        -> <dir>/<base>_<coverage>x.<fasta|fastq>
    python -m racon_tpu_torch.tools.rampler -o <dir> split \\
        <sequences> <chunk size in bytes>
        -> <dir>/<base>_<i>.<fasta|fastq>   (i = 0, 1, ...)

Output is uncompressed and keeps the input's record type: a FASTQ input
stays FASTQ, its reads with dropped qualities too.  Subsampling keeps a
random subset of reads whose bases reach ``reference_length *
coverage``, in input order, from a seeded RNG so that a wrapper run is
reproducible; splitting keeps the input order and puts at most the
chunk size of bases in a chunk (a chunk always takes one sequence).
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import List

from racon_tpu_torch.core.sequence import Sequence
from racon_tpu_torch.io.parsers import (_SEQUENCE_EXTENSIONS_FASTA,
                                        create_sequence_parser)


def _base_and_ext(path: str):
    base = os.path.basename(path).split(".")[0]
    # the parsers' own classification (.fna too), so that a chunk keeps
    # the input's record type
    is_fasta = path.lower().endswith(_SEQUENCE_EXTENSIONS_FASTA)
    return base, (".fasta" if is_fasta else ".fastq")


def _load(path: str) -> List[Sequence]:
    parser = create_sequence_parser(path)
    dst: List[Sequence] = []
    parser.parse(dst, -1)
    parser.close()
    return dst


def _write(path: str, seqs: List[Sequence], as_fasta: bool) -> None:
    with open(path, "wb") as out:
        for s in seqs:
            name = s.name.encode()
            if as_fasta:
                out.write(b">" + name + b"\n" + s.data + b"\n")
            else:
                # the parser drops all-'!' qualities (core/sequence.py):
                # write them back so the record stays FASTQ and parses to
                # the same no-quality read
                qual = s.quality if s.quality else b"!" * len(s.data)
                out.write(b"@" + name + b"\n" + s.data + b"\n+\n"
                          + qual + b"\n")


def subsample(sequences: str, reference_length: int, coverage: int,
              out_dir: str, seed: int = 1337) -> str:
    """Write a random subset of ~reference_length * coverage bases;
    returns ``<out_dir>/<base>_<coverage>x.<ext>``."""
    seqs = _load(sequences)
    target = reference_length * coverage
    order = list(range(len(seqs)))
    random.Random(seed).shuffle(order)
    kept, total = [], 0
    for i in order:
        if total >= target:
            break
        kept.append(i)
        total += len(seqs[i].data)
    kept.sort()
    os.makedirs(out_dir, exist_ok=True)
    base, ext = _base_and_ext(sequences)
    out_path = os.path.join(out_dir, f"{base}_{coverage}x{ext}")
    _write(out_path, [seqs[i] for i in kept], ext == ".fasta")
    print(f"[rampler::subsample] kept {len(kept)}/{len(seqs)} sequences "
          f"({total} bp) -> {out_path}", file=sys.stderr)
    return out_path


def split(sequences: str, chunk_size: int, out_dir: str) -> List[str]:
    """Split into chunks of at most ``chunk_size`` bases each; returns
    the chunk paths ``<out_dir>/<base>_<i>.<ext>``."""
    seqs = _load(sequences)
    os.makedirs(out_dir, exist_ok=True)
    base, ext = _base_and_ext(sequences)
    paths: List[str] = []
    chunk: List[Sequence] = []
    chunk_bytes = 0

    def flush():
        nonlocal chunk, chunk_bytes
        if not chunk:
            return
        path = os.path.join(out_dir, f"{base}_{len(paths)}{ext}")
        _write(path, chunk, ext == ".fasta")
        paths.append(path)
        chunk, chunk_bytes = [], 0

    for s in seqs:
        if chunk and chunk_bytes + len(s.data) > chunk_size:
            flush()
        chunk.append(s)
        chunk_bytes += len(s.data)
    flush()
    print(f"[rampler::split] wrote {len(paths)} chunk(s)", file=sys.stderr)
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="racon-tpu-torch-rampler",
        description="Subsample or split sequence datasets "
                    "(rampler's subcommands; reference: vendor/rampler).")
    parser.add_argument("-o", "--out-directory", default=".",
                        help="output directory")
    sub = parser.add_subparsers(dest="command", required=True)

    p_sub = sub.add_parser("subsample")
    p_sub.add_argument("sequences")
    p_sub.add_argument("reference_length", type=int)
    p_sub.add_argument("coverage", type=int)

    p_split = sub.add_parser("split")
    p_split.add_argument("sequences")
    p_split.add_argument("chunk_size", type=int)

    args = parser.parse_args(argv)
    os.makedirs(args.out_directory, exist_ok=True)
    if args.command == "subsample":
        subsample(args.sequences, args.reference_length, args.coverage,
                  args.out_directory)
    else:
        split(args.sequences, args.chunk_size, args.out_directory)
    return 0


if __name__ == "__main__":
    sys.exit(main())
