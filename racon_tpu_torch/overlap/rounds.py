"""Multi-round polishing driver (JAX package:
racon_tpu/overlap/rounds.py).

polish -> write the polished draft -> re-map the reads against it ->
re-polish, N rounds.  Round 1 may consume an external overlaps file;
every later round re-discovers overlaps internally (the draft just
changed, so any client-supplied PAF is stale by definition).

Determinism: each round is the deterministic single-round pipeline and
intermediate drafts are written canonically (``>name\\ndata\\n``), so
the same inputs + knobs produce byte-identical final FASTA.

The result cache (racon_tpu_torch/cache) carries across rounds: a
window or pair whose content did not move since the round before
digests identically and is served from it.  Each round's report gives
its ``cache_hit`` count, the process registry's delta over the round.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional, Tuple

from racon_tpu_torch.obs import REGISTRY
from racon_tpu_torch.obs import trace as obs_trace


def write_fasta(path: str, sequences) -> None:
    """Canonical FASTA writer: one record per line pair, exactly the
    CLI's stdout byte contract."""
    with open(path, "wb") as fh:
        fh.write(b"".join(b">" + seq.name.encode() + b"\n" + seq.data
                          + b"\n" for seq in sequences))


def polish_rounds(sequences_path: str, overlaps_path: Optional[str],
                  target_path: str, type_, window_length: int,
                  quality_threshold: float, error_threshold: float,
                  trim: bool, match: int, mismatch: int, gap: int,
                  num_threads: int, rounds: int = 1,
                  drop_unpolished: bool = True,
                  cuda_poa_batches: int = 0,
                  cuda_banded_alignment: bool = False,
                  cuda_aligner_batches: int = 0, device=None,
                  workdir: Optional[str] = None) -> Tuple[List, object]:
    """Run ``rounds`` polishing rounds and return
    ``(polished_sequences, last_polisher)``.

    ``overlaps_path=None`` turns on internal mapping from round 1;
    with a path, round 1 parses it and rounds 2+ map internally.
    Intermediate rounds never drop unpolished targets (a target must
    survive to be re-polished); ``drop_unpolished`` applies to the
    final round only.  The last polisher is returned OPEN so callers
    can read its metrics and stage walls; they own the ``close()``.
    Its ``rounds_report`` attribute holds the per-round stats list
    (the JAX package's keys, and each round's stage walls).
    """
    from racon_tpu_torch.core.polisher import create_polisher

    rounds = max(1, int(rounds))
    target = target_path
    tmpdir: Optional[str] = None
    report: List[dict] = []
    polisher = None
    polished: List = []
    try:
        for i in range(rounds):
            final = i == rounds - 1
            hits0 = int(REGISTRY.value("cache_hit", 0))
            t0 = obs_trace.now()
            polisher = create_polisher(
                sequences_path, overlaps_path if i == 0 else None,
                target, type_, window_length, quality_threshold,
                error_threshold, trim, match, mismatch, gap, num_threads,
                cuda_poa_batches=cuda_poa_batches,
                cuda_banded_alignment=cuda_banded_alignment,
                cuda_aligner_batches=cuda_aligner_batches, device=device)
            try:
                polisher.initialize()
                polished = polisher.polish(drop_unpolished if final
                                           else False)
            except BaseException:
                polisher.close()
                raise
            report.append({
                "round": i + 1,
                "wall_s": round(obs_trace.now() - t0, 6),
                "map_s": round(float(
                    polisher.metrics.value("host.map_s", 0.0)), 6),
                "overlaps": int(
                    polisher.metrics.value("map_overlaps", 0)),
                "cache_hit": int(REGISTRY.value("cache_hit", 0)) - hits0,
                "n_sequences": len(polished),
                "stage_walls": {k: round(v, 6) for k, v in
                                polisher.stage_walls.items()},
            })
            if final:
                break
            polisher.close()
            polisher = None
            if tmpdir is None:
                tmpdir = tempfile.mkdtemp(prefix="rtrounds_",
                                          dir=workdir)
            target = os.path.join(tmpdir, f"round{i + 1}.fasta")
            write_fasta(target, polished)
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
    polisher.rounds_report = report
    return polished, polisher
