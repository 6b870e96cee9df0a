"""Illumina paired-end read preprocessor (JAX package:
racon_tpu/tools/preprocess.py; reference: scripts/racon_preprocess.py).

Rewrites FASTQ headers so that both reads of a pair get unique names:
the first occurrence of a name gets the suffix "1", a repeat gets "2",
in the order the reads are seen.  Prints the rewritten FASTQ to stdout.

    python -m racon_tpu_torch.tools.preprocess <first> [<second>]
    racon-tpu-torch-preprocess <first> [<second>]
"""

from __future__ import annotations

import argparse
import sys


def eprint(*args, **kwargs):
    print(*args, file=sys.stderr, **kwargs)


def _emit(name, data, qual, read_set, out):
    if len(name) == 0 or len(data) == 0 or len(data) != len(qual):
        eprint("[racon_tpu_torch::preprocess] input is not in FASTQ format")
        sys.exit(1)
    if name in read_set:
        out.write(name + "2\n")
    else:
        read_set.add(name)
        out.write(name + "1\n")
    out.write(data + "\n+\n" + qual + "\n")


def parse_file(file_name, read_set, out=None):
    """The reference's state machine: multi-line FASTQ records, the '+'
    separator, and a record that ends once its qualities are as long as
    its bases."""
    out = sys.stdout if out is None else out
    line_id = 0
    name = data = qual = ""
    valid = False
    with open(file_name) as f:
        for line in f:
            if line_id == 0:
                if valid:
                    _emit(name, data, qual, read_set, out)
                    valid = False
                name = line.rstrip().split(" ")[0]
                data = qual = ""
                line_id = 1
            elif line_id == 1:
                if line[0] == "+":
                    line_id = 2
                else:
                    data += line.rstrip()
            elif line_id == 2:
                qual += line.rstrip()
                if len(qual) >= len(data):
                    valid = True
                    line_id = 0
    if valid:
        _emit(name, data, qual, read_set, out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="racon-tpu-torch-preprocess",
        description="Preprocess Illumina paired-end reads for racon_tpu_torch:"
        " each read gets a unique header up to the first whitespace to "
        "distinguish those forming a pair.")
    parser.add_argument("first", help="file containing the first read "
                        "of a pair or both")
    parser.add_argument("second", nargs="?",
                        help="optional file containing read pairs of "
                        "the same paired-end sequencing run")
    args = parser.parse_args(argv)

    read_set = set()
    parse_file(args.first, read_set)
    if args.second is not None:
        parse_file(args.second, read_set)
    return 0


if __name__ == "__main__":
    sys.exit(main())
