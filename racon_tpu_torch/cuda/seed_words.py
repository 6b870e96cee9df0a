"""The mapper's k-mer seed words: the CUDA kernel's wrapper and its
plain PyTorch version.

One call computes what ``racon_tpu/tpu/seedmatch.py:_builder`` (an XLA
``jax.jit`` kernel) computes: for every k-mer start i of a flat uint8
code buffer (``overlap.minimizers.encode``: A C G T = 0..3, anything
else 4), ``fw[i]`` packs ``codes[i:i+k] & 3`` big-endian and ``rv[i]``
packs ``3 - (codes[i:i+k] & 3)`` little-endian (the reverse
complement's word), k <= 15.  The words are below 2^30, so they come
back as int32 tensors holding the uint32 bits; ``kmer_words`` hands
them to numpy as uint32.

``seed_words`` launches the kernel (``csrc/seed_words.cu``) for CUDA
tensors and runs ``seed_words_reference`` for CPU tensors; on a CUDA
tensor it launches or raises, it never falls back.  The plain version
computes in int64 (torch's uint32 has few kernels) and masks to 32
bits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from racon_tpu_torch.cuda.devclock import DispatchTimer

MAX_K = 15


def check_inputs(codes, k: int) -> int:
    """Raise on anything the kernel does not take; returns the k-mer
    count n - k + 1 (>= 1)."""
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError(f"codes must be a 1-d uint8 tensor, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    nk = int(codes.shape[0]) - k + 1
    if nk <= 0:
        raise ValueError(f"{codes.shape[0]} codes hold no {k}-mer")
    return nk


def seed_words(codes, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fw, rv) int32 ``[n - k + 1]`` on the codes' device."""
    nk = check_inputs(codes, k)
    if codes.device.type == "cpu":
        return seed_words_reference(codes, k)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    from racon_tpu_torch.cuda import build

    lib = build.load("seed_words")
    dev = codes.device
    fw = torch.empty(nk, dtype=torch.int32, device=dev)
    rv = torch.empty(nk, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.seed_words_launch(codes.data_ptr(), fw.data_ptr(),
                                    rv.data_ptr(), int(codes.shape[0]), k,
                                    stream)
    if err != 0:
        raise RuntimeError(f"seed_words kernel launch failed: "
                           f"{build.error_string('seed_words', err)} ({err})")
    build.count_launch("seed_words")
    return fw, rv


def seed_words_reference(codes, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on the codes' device."""
    nk = check_inputs(codes, k)
    c = codes.to(torch.int64) & 3
    cc = 3 - c
    fw = torch.zeros(nk, dtype=torch.int64, device=codes.device)
    rv = torch.zeros(nk, dtype=torch.int64, device=codes.device)
    for j in range(k):
        fw |= c[j:j + nk] << (2 * (k - 1 - j))
        rv |= cc[j:j + nk] << (2 * j)
    mask = 0xFFFFFFFF
    return (fw & mask).to(torch.int32), (rv & mask).to(torch.int32)


def kmer_words(codes: np.ndarray, k: int, device
               ) -> Tuple[np.ndarray, np.ndarray]:
    """numpy uint8 codes -> numpy uint32 (fw, rv), built on ``device``
    (a torch device): the kernel on a card, the plain version on the
    CPU.  At least k codes.  The build's interval is a
    ``device.seed_words`` span of the trace's device lane and a
    ``seed_words`` interval of ``obs.DEVICE_UTIL`` (cuda/devclock.py)."""
    t = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8))
    dev = torch.device(device)
    if dev.type != "cpu":
        t = t.to(dev, non_blocking=False)
    timer = DispatchTimer(dev)
    timer.mark()
    fw, rv = seed_words(t, k)
    timer.mark()
    out = (fw.cpu().numpy().view(np.uint32),
           rv.cpu().numpy().view(np.uint32))
    timer.record("device.seed_words", "seed_words", {"n": int(t.shape[0])})
    return out
