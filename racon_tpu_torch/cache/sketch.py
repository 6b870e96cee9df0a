"""Compact digest sketch over cached unit keys (JAX package:
racon_tpu/cache/sketch.py).

A placement question for a router in front of several processes: how
much of a job's work is already in that process's result cache?  An
approximate answer is fine, a wrong-bytes answer impossible by
construction: the sketch feeds pricing only, and the cache still
checks every real lookup by its full 32-byte key.

Structure: a counting Bloom filter over 32-byte content digests.
Cache keys are blake2b output, uniformly random, so the K slot indices
come straight from the digest bytes.  Counters are 8-bit saturating (a
counter that reaches 255 sticks: decrementing it on evict could
underflow another key's membership, and a sticky counter only
over-reports warmth).  ``discard`` on evict keeps the filter honest
under LRU churn.

The export is the one-bit projection (counter > 0) packed to ``M / 8``
bytes (8 KiB at M = 65536), base64-encoded and tagged with
:func:`racon_tpu_torch.cache.keying.engine_epoch`, so a reader never
scores digests from one knob environment against a sketch built in
another.  False positives: about ``(1 - e^(-4n/65536))^4`` of absent
keys read "maybe present", under 0.5% at 10k live entries.
"""

from __future__ import annotations

import base64

SKETCH_SCHEMA = "racon-tpu-torch-sketch-v1"

#: counter slots; the exported bitmap is M bits = M/8 bytes
M = 65536
#: slot indices drawn per digest
K = 4

_SAT = 255


def _slots(key: bytes):
    """K independent slot indices from a uniformly-random digest.
    M is a power of two, so the modulo keeps the bytes' uniformity."""
    return [int.from_bytes(key[4 * i:4 * i + 4], "little") % M
            for i in range(K)]


class DigestSketch:
    """Counting Bloom filter over 32-byte digests.  NOT thread-safe:
    the owner (ResultCache) already serializes fills/evicts under its
    own lock."""

    __slots__ = ("_counts", "adds", "drops")

    def __init__(self):
        self._counts = bytearray(M)
        self.adds = 0
        self.drops = 0

    def add(self, key: bytes) -> None:
        counts = self._counts
        for s in _slots(key):
            if counts[s] < _SAT:
                counts[s] += 1
        self.adds += 1

    def discard(self, key: bytes) -> None:
        counts = self._counts
        for s in _slots(key):
            # saturated counters stick (see module docstring)
            if 0 < counts[s] < _SAT:
                counts[s] -= 1
        self.drops += 1

    def __contains__(self, key: bytes) -> bool:
        counts = self._counts
        return all(counts[s] for s in _slots(key))

    def export(self, epoch_hex: str, n: int) -> dict:
        """The wire form: one-bit projection of the counters plus the
        engine-epoch tag and the owner's live entry count ``n`` (what
        the router divides hit counts by to sanity-check density)."""
        bits = bytearray(M // 8)
        counts = self._counts
        for i in range(M):
            if counts[i]:
                bits[i >> 3] |= 1 << (i & 7)
        return {
            "schema": SKETCH_SCHEMA,
            "m": M,
            "k": K,
            "n": int(n),
            "epoch": epoch_hex,
            "bits": base64.b64encode(bytes(bits)).decode("ascii"),
        }


def decode_bits(doc: dict):
    """Packed bitmap bytes from an exported sketch doc, or None when
    the doc is missing/foreign/corrupt (treated as an empty — cold —
    sketch by every consumer)."""
    if not isinstance(doc, dict) or doc.get("schema") != SKETCH_SCHEMA:
        return None
    if doc.get("m") != M or doc.get("k") != K:
        return None
    try:
        bits = base64.b64decode(doc.get("bits") or "", validate=True)
    except (TypeError, ValueError):
        return None
    return bits if len(bits) == M // 8 else None


def bits_contain(bits: bytes, key: bytes) -> bool:
    return all(bits[s >> 3] & (1 << (s & 7)) for s in _slots(key))


def hit_fraction(doc: dict, digests) -> float:
    """Estimated fraction of ``digests`` present in an exported
    sketch — the router's per-backend warmth estimate.  0.0 for an
    undecodable doc or an empty sample."""
    bits = decode_bits(doc)
    if bits is None or not digests:
        return 0.0
    hits = sum(1 for d in digests if bits_contain(bits, d))
    return hits / len(digests)
