"""Host codecs of the align kernels: base encoding and op-tape run
encoding (a copy of the host half of ``racon_tpu/tpu/aligner.py``).

Sequences go to the kernels as ``[B, L]`` uint8 codes (A/C/G/T 0..3,
every other byte 4, so N matches N); query rows are padded with
``QPAD`` and target rows with ``TPAD``, values no base code equals.
Decoded alignments are op tapes in traceback (reversed) order over the
``OP_*`` alphabet; ``ops_to_runs`` turns one into the
``Overlap.cigar_runs`` arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# base encoding: A/C/G/T -> 0..3, anything else 4; pads never match
ENCODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ENCODE[_b] = _i
QPAD = 5
TPAD = 6

# op codes of a decoded tape (CIGAR alphabet)
OP_STOP, OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3, 4
_OP_CHARS = np.array([0, ord("="), ord("X"), ord("I"), ord("D")],
                     dtype=np.uint8)
# op code -> "MIDNSHP=X" index (the Overlap.cigar_runs convention)
_RUN_CODE = np.array([0, 7, 8, 1, 2], dtype=np.int64)


def encode_batch(seqs: Sequence[bytes], length: int,
                 pad: int) -> np.ndarray:
    """Encode byte strings into a padded ``[B, length]`` uint8 array."""
    out = np.full((len(seqs), length), pad, dtype=np.uint8)
    for i, s in enumerate(seqs):
        a = np.frombuffer(s, dtype=np.uint8)
        out[i, :len(a)] = ENCODE[a]
    return out


def ops_to_runs(ops_row: np.ndarray):
    """RLE a reversed op tape row into (lengths, codes) arrays in the
    Overlap.cigar_runs convention ("MIDNSHP=X" indices)."""
    fwd = ops_row[ops_row != OP_STOP][::-1]
    if fwd.size == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    change = np.flatnonzero(np.diff(fwd)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [fwd.size]))
    return ((ends - starts).astype(np.int64),
            _RUN_CODE[fwd[starts].astype(np.int64)])


def ops_to_cigar(ops_row: np.ndarray) -> str:
    """RLE a reversed op tape row into a standard =/X/I/D CIGAR."""
    ops_row = ops_row[ops_row != OP_STOP][::-1]
    if ops_row.size == 0:
        return ""
    change = np.flatnonzero(np.diff(ops_row)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [ops_row.size]))
    return "".join(f"{e - s}{chr(_OP_CHARS[ops_row[s]])}"
                   for s, e in zip(starts, ends))
