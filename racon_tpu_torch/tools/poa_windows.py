"""Constructed POA windows that drive the kernel's rare paths.

The POA kernel (``cuda/csrc/poa_full.cu``) keeps the first
``PRED_MIRROR`` predecessor ids of each node and the last ``RING_ROWS``
DP rows in shared memory, and reads the rest from device memory; its
first pass holds ``first_pass_nodes(v)`` graph nodes and hands a window
that outgrows them to a second pass with the whole cap.  Real windows
seldom take those paths, so these three windows force them:

* ``many_preds``: around one backbone position, three layers put each
  other base in its column and two layers delete one and two bases
  before it, so the node after it gains six predecessors (> 4); later
  layers read them all.
* ``old_pred_row``: one layer inserts 24 bases in the middle of the
  backbone, so the node after the insertion has a predecessor 25 ranks
  earlier in the topological order (older than the ring).  The
  backbone is drawn from A/C and the insertion from G/T, so no
  equal-score alignment spreads the insertion among backbone nodes.
* ``big_graph``: a 120-base A/C backbone and two layers that each
  insert 40 G/T bases, at a third and at two thirds of it, so the
  graph ends at 200 nodes: past the first pass's 160 at the tiny cap
  of 256 nodes, inside the cap, so the window completes in the second
  pass.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from racon_tpu_torch.core.window import Window, WindowType

FLANK = 30
INSERT = 24
BIG_BACKBONE = 120
BIG_INSERT = 40


def _seq(rng, n: int, alphabet: bytes = b"ACGT") -> bytes:
    return bytes(rng.choice(list(alphabet), n).astype(np.uint8))


def stress_windows(wtype: WindowType, seed: int = 0,
                   rank0: int = 0) -> Tuple[List[Window], List[bytes]]:
    """The three windows (ranks ``rank0`` .. ``rank0 + 2``) and their
    backbones; every layer spans the whole backbone and has no
    qualities (weight 1 per base)."""
    rng = np.random.default_rng(seed)
    left, right = _seq(rng, FLANK), _seq(rng, FLANK)
    x, y = b"A", b"C"
    bb = left + x + y + right
    many = Window(0, rank0, wtype, bb, b"!" * len(bb))
    layers = [left + x + bytes([o]) + right for o in b"AGT"]
    layers += [left + x + right, left + right, bb, bb, bb]
    for layer in layers:
        many.add_layer(layer, None, 0, len(bb) - 1)
    left, right = _seq(rng, FLANK, b"AC"), _seq(rng, FLANK, b"AC")
    bb2 = left + right
    old = Window(0, rank0 + 1, wtype, bb2, b"!" * len(bb2))
    for layer in (left + _seq(rng, INSERT, b"GT") + right, bb2, bb2, bb2):
        old.add_layer(layer, None, 0, len(bb2) - 1)
    bb3 = _seq(rng, BIG_BACKBONE, b"AC")
    big = Window(0, rank0 + 2, wtype, bb3, b"!" * len(bb3))
    for cut in (BIG_BACKBONE // 3, 2 * BIG_BACKBONE // 3):
        layer = bb3[:cut] + _seq(rng, BIG_INSERT, b"GT") + bb3[cut:]
        big.add_layer(layer, None, 0, len(bb3) - 1)
    for _ in range(2):
        big.add_layer(bb3, None, 0, len(bb3) - 1)
    return [many, old, big], [bb, bb2, bb3]
