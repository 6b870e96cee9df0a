"""Sequence domain object.

Mirrors the behaviour of racon's Sequence (reference: src/sequence.cpp):
uppercase on parse, qualities dropped when they are all-'!' (sum zero),
lazy reverse complement with reversed quality, and ``transmute`` to free
unused storage.  Data is held as immutable ``bytes``; window layers slice
it zero-copy via memoryview.
"""

from __future__ import annotations

from typing import Optional

_COMPLEMENT = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


class Sequence:
    __slots__ = ("name", "data", "quality", "_reverse_complement",
                 "_reverse_quality")

    def __init__(self, name: str, data: bytes, quality: bytes = b""):
        self.name = name
        self.data = data
        self.quality = quality
        self._reverse_complement: Optional[bytes] = None
        self._reverse_quality: Optional[bytes] = None

    # -- constructors matching the bioparser-injected ctors ----------------

    @classmethod
    def from_fasta(cls, header: bytes, data: bytes) -> "Sequence":
        name = header.split()[0].decode() if header.split() else ""
        return cls(name, data.upper())

    @classmethod
    def from_fastq(cls, header: bytes, data: bytes,
                   quality: bytes) -> "Sequence":
        name = header.split()[0].decode() if header.split() else ""
        # qualities that are all '!' carry no information and are dropped
        # (reference: src/sequence.cpp:34-41)
        if quality.count(b"!") == len(quality):
            quality = b""
        return cls(name, data.upper(), quality)

    # -- lazy reverse complement ------------------------------------------

    @property
    def reverse_complement(self) -> bytes:
        if self._reverse_complement is None:
            self.create_reverse_complement()
        return self._reverse_complement

    @property
    def reverse_quality(self) -> bytes:
        if self._reverse_quality is None:
            self.create_reverse_complement()
        return self._reverse_quality

    def create_reverse_complement(self) -> None:
        if self._reverse_complement is not None:
            return
        self._reverse_complement = self.data.translate(_COMPLEMENT)[::-1]
        self._reverse_quality = self.quality[::-1]

    def transmute(self, has_name: bool, has_data: bool,
                  has_reverse_data: bool) -> None:
        """Free unused storage (reference: src/sequence.cpp:86-100)."""
        if not has_name:
            self.name = ""
        if has_reverse_data:
            self.create_reverse_complement()
        if not has_data:
            self.data = b""
            self.quality = b""

    def __len__(self) -> int:
        return len(self.data)

    def __repr__(self) -> str:
        return f"Sequence({self.name!r}, len={len(self.data)})"
