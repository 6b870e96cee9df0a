"""Host-vectorized k-mer minimizer extraction (JAX package:
racon_tpu/overlap/minimizers.py).

Mirrors minimap2's sketch (reference: minimap2 sketch.c) with numpy in
place of the per-base C loop: 2-bit packed forward/reverse-complement
k-mer words built by a k-pass rolling OR, an invertible 32-bit mixer so
minimizer choice is position-independent, and windowed argmin over a
zero-copy sliding view to pick one minimizer per w-window.

Everything is uint32: k is clamped to <= 15 so a canonical k-mer fits
in 30 bits, the mixer is a bijection on the full 32-bit domain, and,
because it is invertible, two distinct k-mers can never collide, which
is what lets chaining trust anchors without re-verifying base equality.
The word build runs by numpy or on a torch device
(``cuda/seed_words.py``: the CUDA kernel on the card, its plain version
on the CPU) with bit-equal results, so where the words are built moves
arithmetic, not bytes.  A failed device build raises; it never falls
back to numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: base -> 2-bit code; anything not ACGT/acgt is 4 (invalid)
_CODES = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODES[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _CODES[_b] = _i

#: sentinel hash for masked (invalid / strand-ambiguous) k-mer slots
SENTINEL = np.uint32(0xFFFFFFFF)

#: canonical k-mers must fit 2k <= 30 bits (uint32 lanes)
MAX_K = 15

#: the ``device`` of :func:`kmer_words` that builds the words by numpy
#: on the host
NUMPY = "numpy"


def mix32(h: np.ndarray) -> np.ndarray:
    """Invertible 32-bit finalizer (lowbias32).  Bijective on uint32,
    so distinct k-mers keep distinct hashes: anchors are exact."""
    h = np.asarray(h, dtype=np.uint32)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x7FEB352D)
    h = (h ^ (h >> np.uint32(15))) * np.uint32(0x846CA68B)
    return h ^ (h >> np.uint32(16))


def encode(data) -> np.ndarray:
    """bytes/buffer -> per-base 2-bit codes (4 = invalid), zero-copy in."""
    return _CODES[np.frombuffer(data, dtype=np.uint8)]


def kmer_words(codes: np.ndarray, k: int, device
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Forward and reverse-complement k-mer words over ``codes``.

    ``fw[i]`` packs codes[i:i+k] big-endian (first base most
    significant); ``rv[i]`` is the word of the reverse complement of
    the same window.  Invalid bases contribute ``code & 3`` here and
    are masked out by the validity scan in :func:`extract`.  ``device``
    is :data:`NUMPY` or a torch device, where the build then runs
    (``cuda/seed_words.py``); either way the words come back as numpy
    uint32, bit for bit the same.
    """
    nk = codes.size - k + 1
    if nk <= 0:
        z = np.empty(0, dtype=np.uint32)
        return z, z
    if str(device) != NUMPY:
        from racon_tpu_torch.cuda import seed_words

        return seed_words.kmer_words(codes, k, device)
    c = codes.astype(np.uint32) & np.uint32(3)
    cc = np.uint32(3) - c
    fw = np.zeros(nk, dtype=np.uint32)
    rv = np.zeros(nk, dtype=np.uint32)
    for j in range(k):
        fw |= c[j:j + nk] << np.uint32(2 * (k - 1 - j))
        rv |= cc[j:j + nk] << np.uint32(2 * j)
    return fw, rv


def extract(data, k: int, w: int,
            words: Optional[Tuple[np.ndarray, np.ndarray]] = None
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimizers of ``data``: (positions int64, hashes uint32,
    strands uint8).

    strand 0 means the forward k-mer is canonical, 1 means the
    reverse complement is.  One minimizer per window of w consecutive
    k-mer starts (leftmost-lowest-hash), deduplicated; k-mers touching
    non-ACGT bases and strand-ambiguous palindromes are masked before
    selection, exactly like minimap2 skips them.  ``words`` are
    ``data``'s (fw, rv) built beforehand (the mapper's batched build);
    without them numpy builds them here.
    """
    k = max(3, min(int(k), MAX_K))
    w = max(1, int(w))
    codes = encode(data)
    n = codes.size
    nk = n - k + 1
    empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint32),
             np.empty(0, dtype=np.uint8))
    if nk <= 0:
        return empty
    fw, rv = kmer_words(codes, k, NUMPY) if words is None else words
    if fw.size != nk or rv.size != nk:
        raise ValueError(f"words of {fw.size}/{rv.size} k-mers for a "
                         f"sequence of {nk}")
    strand = (rv < fw).astype(np.uint8)
    hashes = mix32(np.where(strand, rv, fw))
    # mask k-mers spanning an invalid base, and palindromes (fw == rv)
    bad_base = np.concatenate(([0], np.cumsum(codes >= 4)))
    invalid = (bad_base[k:] - bad_base[:-k]) > 0
    hashes = np.where(invalid | (fw == rv), SENTINEL, hashes)
    nw = nk - w + 1
    if nw <= 0:
        # sequence shorter than one full window: keep the global min
        best = int(np.argmin(hashes))
        if hashes[best] == SENTINEL:
            return empty
        return (np.array([best], dtype=np.int64),
                hashes[best:best + 1], strand[best:best + 1])
    win = np.lib.stride_tricks.sliding_window_view(hashes, w)
    pos = np.argmin(win, axis=1) + np.arange(nw, dtype=np.int64)
    sel = np.unique(pos)
    sel = sel[hashes[sel] != SENTINEL]
    return sel, hashes[sel], strand[sel]
