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
from typing import List, Optional, Tuple


class WindowType(enum.Enum):
    NGS = 0   # short accurate reads (mean length <= 1000)
    TGS = 1   # long noisy reads


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
