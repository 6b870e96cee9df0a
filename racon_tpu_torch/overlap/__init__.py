"""Internal overlap discovery: a minimap-lite read->draft mapper (JAX
package: racon_tpu/overlap).

Real assemblies run minimap2 to discover read->draft overlaps and
polish 2-4 rounds.  This package does both in-process:

- :mod:`minimizers` -- host-vectorized k-mer minimizer extraction
  (2-bit packed k-mer words, built by numpy or on a torch device by
  ``cuda/seed_words.py``, an invertible 32-bit mix and a windowed
  argmin),
- :mod:`index`      -- target-side minimizer hash index with
  occurrence-cap masking of repeats,
- :mod:`chain`      -- anchor collinear chaining (sorted-diagonal
  banding + LIS-style DP) emitting PAF-shaped
  :class:`~racon_tpu_torch.core.overlap.Overlap` records that feed the
  breaking-point re-align path exactly like an external PAF,
- :mod:`rounds`     -- the multi-round driver: polish -> re-map reads
  against the polished draft -> re-polish, N rounds.

Determinism contract: same inputs => byte-identical overlaps =>
byte-identical FASTA.  The mapper knobs
(RACON_TPU_TORCH_MAP_K/W/OCC/MIN_CHAIN/BAND/MAX_GAP) change bytes;
RACON_TPU_TORCH_MAP_DEVICE_SEED only moves the word build between the
polisher's device and numpy, with bit-equal words.
"""

from racon_tpu_torch.overlap.chain import (MapParams, map_sequences,
                                           params_from_env)
from racon_tpu_torch.overlap.rounds import polish_rounds

__all__ = ["MapParams", "map_sequences", "params_from_env",
           "polish_rounds", "map_files"]


def map_files(sequences_path: str, target_path: str, params=None):
    """Map reads from ``sequences_path`` against ``target_path`` and
    return (overlaps, stats): the code path the polisher uses, over
    whole files.  ``params`` default to ``params_from_env()``: the seed
    words are built on the card, and a missing card raises (pass
    ``params_from_env("cpu")`` or ``params_from_env("numpy")``)."""
    from racon_tpu_torch.io.parsers import create_sequence_parser

    def drain(path):
        parser = create_sequence_parser(path)
        records: list = []
        try:
            parser.reset()
            parser.parse(records, -1)
        finally:
            parser.close()
        return records

    return map_sequences(drain(sequences_path), drain(target_path),
                         params=params)
