"""Target-sharded ranks (JAX package: racon_tpu/parallel/multihost.py).

The reference scales past one process by running independent racon
processes on slices of the target set (the wrapper's ``--split``); its
CUDA build adds nothing across processes.  The port keeps that shape:
polishing is data-parallel over targets, each rank owns a deterministic
contiguous slice of them (:func:`target_slice`), runs the whole polish
on its card and emits its slice, and ``cat part*.fa`` in rank order is
the single-process output byte for byte (tests/test_torch_scatter.py).
There are no collectives, so unlike the JAX package nothing is
bootstrapped: :func:`maybe_initialize` only validates the environment.

Usage (one process per rank, the same arguments everywhere)::

    RACON_TPU_TORCH_COORD=host0:9876 RACON_TPU_TORCH_NPROC=2 \\
    RACON_TPU_TORCH_RANK=$i python -m racon_tpu_torch.cli -c 1 \\
        reads.fq ovl.paf draft.fa > part$i.fa

``RACON_TPU_TORCH_COORD`` is the switch, as ``RACON_TPU_COORD`` is the
JAX package's, so a launch script written for it works with the prefix
changed; its value is not read.  A rank that names no device takes
``cuda:{rank % device_count}`` (:func:`rank_device`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def env_config() -> Optional[Tuple[str, int, int]]:
    """(coordinator, number of processes, rank) when the multi-process
    environment is set, else None."""
    coord = os.environ.get("RACON_TPU_TORCH_COORD")
    if not coord:
        return None
    nproc = int(os.environ.get("RACON_TPU_TORCH_NPROC", "1"))
    rank = int(os.environ.get("RACON_TPU_TORCH_RANK", "0"))
    if nproc <= 1:
        return None
    if not 0 <= rank < nproc:
        raise ValueError(f"RACON_TPU_TORCH_RANK {rank} out of range for "
                         f"RACON_TPU_TORCH_NPROC {nproc}")
    return coord, nproc, rank


def maybe_initialize() -> Tuple[int, int]:
    """(number of processes, rank), (1, 0) outside the multi-process
    mode.  Raises on an out-of-range rank."""
    cfg = env_config()
    if cfg is None:
        return 1, 0
    return cfg[1], cfg[2]


def rank_device(device=None):
    """The device a rank runs on: ``device`` when the caller named one,
    else ``cuda:{rank % torch.cuda.device_count()}`` in the
    multi-process mode, else None (the entry point's default)."""
    if device is not None:
        return device
    cfg = env_config()
    if cfg is None:
        return None
    import torch

    count = torch.cuda.device_count()
    if count == 0:
        # resolve_device raises for a card that is asked for and absent
        return "cuda"
    return f"cuda:{cfg[2] % count}"


def target_slice(n_targets: int, nproc: int, rank: int) -> slice:
    """The contiguous slice of the target index space one rank owns:
    sizes differ by at most one, earlier ranks take the remainder."""
    base, rem = divmod(n_targets, nproc)
    begin = rank * base + min(rank, rem)
    return slice(begin, begin + base + (1 if rank < rem else 0))
