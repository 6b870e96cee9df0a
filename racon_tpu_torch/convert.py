"""What crosses from the JAX package to the port: the packed POA batch.

The system has no weights; the state the POA kernel consumes is the
packed window batch.  ``pack_windows`` produces exactly the arrays the
JAX engine (``racon_tpu/tpu/poa.py:562-607``) hands its kernel for the
same windows, and ``to_device`` turns numpy arrays of that layout,
from either package, into the port's tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from racon_tpu_torch.utils.tuning import pow2_at_least


@dataclass
class PackedBatch:
    seqs: np.ndarray        # [B, D1, LP] uint8, row 0 = backbone
    wts: np.ndarray         # [B, D1, LP] uint8 base weights
    meta: np.ndarray        # [B, D1, 8] int32 (begin, end, full, slen)
    nlay: np.ndarray        # [B] int32 layers kept per window
    bblen: np.ndarray       # [B] int32 backbone length
    host_fail: List[bool]   # backbone over the caps: CPU re-polish
    skipped: List[int]      # per window: layers dropped (too long or
                            # too deep)

    @property
    def n_skipped(self) -> int:
        """Layers dropped over the batch."""
        return sum(self.skipped)


def order_layers(w, lcap: int, max_depth: int):
    """Layer indices in start-position order (src/window.cpp:84-85),
    over-long layers dropped, at most ``max_depth`` kept; returns
    (kept, number dropped)."""
    idx = sorted(range(1, len(w.sequences)),
                 key=lambda i: w.positions[i][0])
    kept = [i for i in idx if len(w.sequences[i]) <= lcap][:max_depth]
    return kept, len(idx) - len(kept)


def _weights(q: bytes) -> np.ndarray:
    """Phred quality minus 33, floored at 0."""
    return np.frombuffer(q, np.uint8).astype(np.int32) \
        .clip(33, None).astype(np.uint8) - 33


def pack_windows(windows, lcap: int, vcap: int,
                 max_depth: int = 200) -> PackedBatch:
    """Pack windows into the kernel's layout.  The batch is padded to
    a power of two (at least 8) with inert 1-base 'A' windows; windows
    without qualities weigh every base 1."""
    n = len(windows)
    layer_lists, skipped = [], []
    for w in windows:
        kept, dropped = order_layers(w, lcap, max_depth)
        layer_lists.append(kept)
        skipped.append(dropped)
    lp = lcap
    d1 = max(8, pow2_at_least(
        max((len(ll) for ll in layer_lists), default=0) + 1, 8))
    b_pad = max(8, pow2_at_least(n, 8))
    seqs = np.zeros((b_pad, d1, lp), np.uint8)
    wts = np.ones((b_pad, d1, lp), np.uint8)
    meta = np.zeros((b_pad, d1, 8), np.int32)
    nlay = np.zeros(b_pad, np.int32)
    bblen = np.ones(b_pad, np.int32)
    seqs[:, 0, 0] = ord("A")
    host_fail = [False] * n
    for b, w in enumerate(windows):
        bb = w.sequences[0]
        if len(bb) > min(lp, vcap):
            host_fail[b] = True
            continue
        bblen[b] = len(bb)
        seqs[b, 0, :len(bb)] = np.frombuffer(bb, np.uint8)
        if w.qualities[0]:
            wts[b, 0, :len(bb)] = _weights(w.qualities[0])
        offset = int(0.01 * len(bb))
        nlay[b] = len(layer_lists[b])
        for d, li in enumerate(layer_lists[b], start=1):
            s = w.sequences[li]
            seqs[b, d, :len(s)] = np.frombuffer(s, np.uint8)
            if w.qualities[li]:
                wts[b, d, :len(s)] = _weights(w.qualities[li])
            begin, end = w.positions[li]
            full = 1 if (begin < offset and end > len(bb) - offset) else 0
            meta[b, d, :4] = (begin, end, full, len(s))
    return PackedBatch(seqs, wts, meta, nlay, bblen, host_fail, skipped)


def to_device(seqs, wts, meta, nlay, bblen, device):
    """numpy arrays of the packed layout -> contiguous tensors of the
    kernel's dtypes on ``device``."""
    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    return (t(seqs, np.uint8), t(wts, np.uint8), t(meta, np.int32),
            t(nlay, np.int32), t(bblen, np.int32))
