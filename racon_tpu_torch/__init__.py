"""racon_tpu_torch: racon-tpu's polisher on PyTorch and CUDA.

The port of the JAX package ``racon_tpu`` to an NVIDIA H100: the same
host pipeline (parse, overlap filter, breaking-point alignment,
windowing, per-window POA consensus, stitching) and its internal
overlap discovery over N rounds (``racon_tpu_torch/overlap``), with the
overlap alignment, the per-window POA consensus and the mapper's seed
words computed by CUDA C++ kernels written for Hopper
(``racon_tpu_torch/cuda/csrc/``).  What the kernels leave (over-length
or uncertified pairs, rejected windows) runs on the native CPU
engines.

Entry points run on the card unless the caller passes
``device="cpu"`` (CLI: ``--device cpu``); a card that is asked for and
missing raises, it never falls back to the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``cuda`` unless ``device`` says
    otherwise.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "[racon_tpu_torch] a CUDA device was requested but "
            "torch.cuda.is_available() is false; pass device='cpu' "
            "(CLI: --device cpu) to run on the CPU")
    return dev
