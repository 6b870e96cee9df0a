"""Window domain object.

A window holds a backbone slice of the target plus read fragments
("layers") routed to it via overlap breaking points, and produces a POA
consensus (reference: src/window.cpp).  The consensus computation itself
is delegated to an engine (the native CPU engine, or the batched CUDA
engine); this object only holds the data and mirrors the reference's
window-level policies: fewer than 3 sequences -> backbone copied
verbatim and the window counts as unpolished (src/window.cpp:68-71);
layers sorted by start position (src/window.cpp:84-85); TGS consensus
end-trim at coverage < (n_layers - 1) / 2 (src/window.cpp:118-139).
"""

from __future__ import annotations

import enum
import sys
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np


class WindowType(enum.Enum):
    NGS = 0   # short accurate reads (mean length <= 1000)
    TGS = 1   # long noisy reads


class WindowLedger:
    """Per-window completion accounting for the streaming pipeline.

    A window can enter POA as soon as every overlap that could route a
    layer into it has its breaking points.  Each overlap registers the
    window-id range its target span covers (``register``); its
    completion decrements the range (``complete``), and windows whose
    pending count reaches zero come back with their stashed fragments.

    Determinism: fragments are stashed with the overlap's ordinal (its
    index in the filtered overlap list) and a window's stash drains
    sorted by ordinal, so a window's layer order is the overlap-list
    order, as in the staged ``Polisher._build_windows``, whatever the
    order in which alignments finish.  One lock guards all state;
    ``cond`` also wakes the speculative POA consumer
    (racon_tpu_torch/cuda/polisher.py).
    """

    def __init__(self, n_windows: int, metrics=None):
        self.pending = np.zeros(n_windows, np.int32)
        #: registry whose ``ledger_ready_high_water`` gauge follows
        #: ``ready_high_water`` (racon_tpu/tpu/polisher.py:709)
        self.metrics = metrics
        self.cond = threading.Condition()
        # id(overlap) -> (ordinal, lo, hi); popped on completion, so a
        # second completion of the same overlap is a no-op
        self._reg: Dict[int, Tuple[int, int, int]] = {}
        # window id -> [(ordinal, window id, *fragment), ...]
        self._stash: Dict[int, list] = {}
        self.ready: deque = deque()
        #: deepest the ready queue ever got (the consumer's backlog)
        self.ready_high_water = 0
        self._sealed = False
        self.n_completed = 0

    def register(self, key: int, ordinal: int, lo: int, hi: int) -> None:
        """Mark windows [lo, hi] as pending one more overlap."""
        with self.cond:
            if self._sealed:
                raise RuntimeError("WindowLedger sealed")
            self._reg[key] = (ordinal, lo, hi)
            self.pending[lo:hi + 1] += 1

    def seal(self) -> None:
        """End of registration."""
        with self.cond:
            self._sealed = True

    def complete(self, key: int, frags) -> List[Tuple[int, list]]:
        """Record one overlap's completion with its routed fragments
        ``(ordinal, window_id, *fragment)``.  Returns
        ``[(window_id, ordinal_sorted_fragments), ...]`` for every
        window that became fully routed; unknown or repeated keys are
        no-ops (the fall-through pass notifies every overlap)."""
        with self.cond:
            reg = self._reg.pop(key, None)
            if reg is None:
                return []
            _, lo, hi = reg
            for fr in frags:
                self._stash.setdefault(fr[1], []).append(fr)
            seg = self.pending[lo:hi + 1]
            seg -= 1
            self.n_completed += 1
            newly = (lo + np.flatnonzero(seg == 0)).tolist()
            return [(wid, sorted(self._stash.pop(wid, []),
                                 key=lambda fr: fr[0]))
                    for wid in newly]

    def remaining(self) -> List[int]:
        """Registered overlap keys not yet completed, ordinal order."""
        with self.cond:
            return [k for k, _ in sorted(self._reg.items(),
                                         key=lambda kv: kv[1][0])]

    def push_ready(self, wids: List[int]) -> None:
        """Publish fully routed windows to the consumer and wake it."""
        if not wids:
            return
        with self.cond:
            self.ready.extend(wids)
            self.ready_high_water = max(self.ready_high_water,
                                        len(self.ready))
            self.cond.notify_all()
        if self.metrics is not None:
            self.metrics.peak("ledger_ready_high_water",
                              self.ready_high_water)

    def pop_ready(self, cap: int, min_n: int = 1) -> List[int]:
        """Take up to ``cap`` ready windows, or none when fewer than
        ``min_n`` are queued."""
        with self.cond:
            if len(self.ready) < max(1, min_n):
                return []
            n = min(cap, len(self.ready))
            return [self.ready.popleft() for _ in range(n)]

    def n_ready(self) -> int:
        with self.cond:
            return len(self.ready)


class Window:
    __slots__ = ("id", "rank", "type", "consensus", "sequences",
                 "qualities", "positions")

    def __init__(self, id_: int, rank: int, type_: WindowType,
                 backbone: bytes, quality: bytes):
        if len(backbone) == 0 or len(backbone) != len(quality):
            raise RuntimeError(
                "[racon_tpu_torch::Window] empty backbone sequence/unequal "
                "quality length!")
        self.id = id_
        self.rank = rank
        self.type = type_
        self.consensus: bytes = b""
        # layer 0 is the backbone; positions are window-relative
        self.sequences: List[bytes] = [backbone]
        self.qualities: List[Optional[bytes]] = [quality]
        self.positions: List[Tuple[int, int]] = [(0, 0)]

    @property
    def backbone(self) -> bytes:
        return self.sequences[0]

    def add_layer(self, sequence: bytes, quality: Optional[bytes],
                  begin: int, end: int) -> None:
        if len(sequence) == 0 or begin == end:
            return
        if quality is not None and len(sequence) != len(quality):
            raise RuntimeError(
                "[racon_tpu_torch::Window::add_layer] unequal quality "
                "size!")
        if begin >= end or begin > len(self.backbone) or \
                end > len(self.backbone):
            raise RuntimeError(
                "[racon_tpu_torch::Window::add_layer] layer begin and end "
                "positions are invalid!")
        self.sequences.append(sequence)
        self.qualities.append(quality)
        self.positions.append((begin, end))

    def generate_consensus(self, engine, trim: bool) -> bool:
        """Run POA consensus through ``engine``; returns polished flag.
        ``engine.consensus(window, trim) -> bytes`` (see
        racon_tpu_torch.ops.cpu.PoaEngine)."""
        if len(self.sequences) < 3:
            self.consensus = self.sequences[0]
            return False
        self.consensus = engine.consensus(self, trim)
        return True

    def warn_chimeric(self) -> None:
        print(f"[racon_tpu_torch::Window::generate_consensus] warning: "
              f"contig {self.id} might be chimeric in window "
              f"{self.rank}!", file=sys.stderr)
