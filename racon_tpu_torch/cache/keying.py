"""Canonical content keys for the result cache (JAX package:
racon_tpu/cache/keying.py).

Every cacheable unit is reduced to a 32-byte blake2b digest over (a)
the unit's canonical input bytes, (b) the engine configuration that
shapes the computation, and (c) the engine epoch: the package version,
a hash of every source on a unit's result path, and every resolved
``RACON_TPU_TORCH_*`` knob that can change output bytes.  Two
units share a key only when recomputing either gives the same output
bytes, the byte-determinism the port pins, so a hit is the same bytes
as a recomputation.

Key spaces are disjoint per engine: the native CPU POA engine and the
POA kernel resolve cost ties independently, so ``poa_key`` takes a
``space`` ("cpu" / "dev"), and the device space carries the executor's
engine key (scoring, caps, depth, banded flag, torch device type).
Align keys carry the rung geometry, the per-pair measured center when
one is given, and the device type.

The port's keys never equal the JAX package's: its epoch hashes other
knobs and its own sources, and its segments carry their own schema
(cache/store.py).  ``window_digest`` alone is shared, byte for byte.

The epoch leaves out the knobs that cannot change output bytes: the
cache's own (resizing the budget must not orphan every entry), the
observability planes (trace, metrics report, flight dump), the place
the mapper's seed words are built (equal words everywhere) and the
adaptive fusion window (it moves when a batch dispatches, never what it
computes).  Everything else is hashed, so any knob that could change
bytes changes every key.
"""

from __future__ import annotations

import hashlib
import os
import struct

from racon_tpu_torch.utils import calibrate

#: knobs that never change output bytes (each pinned by tests) and so
#: stay out of the epoch; the cache's own knobs lead the list
EPOCH_EXCLUDE = frozenset({
    "RACON_TPU_TORCH_CACHE",
    "RACON_TPU_TORCH_CACHE_MB",
    "RACON_TPU_TORCH_CACHE_PERSIST",
    "RACON_TPU_TORCH_CACHE_DIR",
    # observability planes (pinned byte-identical on and off)
    "RACON_TPU_TORCH_TRACE",
    "RACON_TPU_TORCH_METRICS_JSON",
    "RACON_TPU_TORCH_FLIGHT_DUMP",
    # where the mapper builds its seed words: equal words everywhere.
    # The mapper's k/w/occ/min-chain/band/max-gap knobs change which
    # overlaps exist and stay in the epoch.
    "RACON_TPU_TORCH_MAP_DEVICE_SEED",
    # the adaptive fusion window moves when a bucket dispatches, never
    # what the fused batch computes
    "RACON_TPU_TORCH_FUSE_ADAPT",
    # the serve tier's telemetry sampler, write-ahead journal and crash
    # harness: replay and scrape only (tests/test_torch_durable.py
    # holds journal on and off to the same bytes)
    "RACON_TPU_TORCH_SERVE_SAMPLE_S",
    "RACON_TPU_TORCH_JOURNAL",
    "RACON_TPU_TORCH_JOURNAL_DIR",
    "RACON_TPU_TORCH_JOURNAL_FSYNC",
    "RACON_TPU_TORCH_FAULT",
    # the fleet: where a job, a shard or a rank runs, and whether a
    # shard's parse is staged (pinned byte-identical to the full parse
    # by tests/test_torch_scatter.py), never what a unit computes
    "RACON_TPU_TORCH_ROUTE_PROBE_S",
    "RACON_TPU_TORCH_ROUTE_PROBE_TIMEOUT_S",
    "RACON_TPU_TORCH_ROUTE_BREAKER_FAILS",
    "RACON_TPU_TORCH_ROUTE_BREAKER_COOLDOWN_S",
    "RACON_TPU_TORCH_ROUTE_AFFINITY",
    "RACON_TPU_TORCH_ROUTE_TCP",
    "RACON_TPU_TORCH_SCATTER_MIN_WALL_S",
    "RACON_TPU_TORCH_SCATTER_MAX_SHARDS",
    "RACON_TPU_TORCH_SCATTER_REBALANCE",
    "RACON_TPU_TORCH_STAGE",
    "RACON_TPU_TORCH_FLEET_INTERVAL_S",
    "RACON_TPU_TORCH_FLEET_TIMEOUT_S",
    "RACON_TPU_TORCH_FLEET_STALE_S",
    "RACON_TPU_TORCH_NPROC",
    "RACON_TPU_TORCH_RANK",
    "RACON_TPU_TORCH_COORD",
})

#: every source on a cached unit's result path (package-relative
#: globs): the kernels and their wrappers, the native engines and their
#: build flags, the host modules that build a unit's input or read its
#: result (``ops/`` packs the native engine's qualities and positions),
#: and the codec that stores it: the rate store's salt, which was
#: chosen for pricing, and what it leaves out.
EPOCH_SALTED = calibrate._SALTED + ("ops/*.py", "cache/*.py",
                                    "native/Makefile")

DIGEST_SIZE = 32

_PREFIX = "RACON_TPU_TORCH_"
#: the process's source salt (the code it loaded), computed once
_salt = None
#: knob environment -> epoch; a knob change misses and recomputes
_epochs: dict = {}


def forget() -> None:
    """Drop the memoized salt and epochs (``cache.reset`` calls it)."""
    global _salt
    _salt = None
    _epochs.clear()


def engine_epoch() -> bytes:
    """Fingerprint of the code and knob environment results depend on:
    the package version, the hash of every source in
    :data:`EPOCH_SALTED`, and every resolved port knob outside
    :data:`EPOCH_EXCLUDE`.

    The kernels are ``.cu`` sources built at first use, so a version
    string alone would let a persistent segment written before a kernel
    fix serve the old kernel's results after it; the source salt moves
    every key instead.  The salt is read once a process (its code does
    not change under it) and the epoch memoized per knob environment,
    so a call costs one scan of ``os.environ``; batch call sites still
    fetch it once per submission and pass it to the key functions.
    """
    global _salt
    env = tuple(sorted((k, v) for k, v in os.environ.items()
                       if k.startswith(_PREFIX)
                       and k not in EPOCH_EXCLUDE))
    epoch = _epochs.get(env)
    if epoch is not None:
        return epoch
    import racon_tpu_torch
    from racon_tpu_torch.obs import provenance

    if _salt is None:
        _salt = calibrate._code_salt(EPOCH_SALTED)
    h = hashlib.blake2b(digest_size=16)
    h.update(racon_tpu_torch.__version__.encode())
    h.update(b"\0salt=" + _salt.encode())
    for name, info in sorted(provenance.resolved_knobs().items()):
        if name in EPOCH_EXCLUDE:
            continue
        h.update(b"\0%s=%s" % (name.encode(), info["value"].encode()))
    epoch = h.digest()
    if len(_epochs) >= 64:
        _epochs.clear()
    _epochs[env] = epoch
    return epoch


def _h(tag: bytes, epoch: bytes):
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    h.update(tag)
    h.update(epoch)
    return h


def _as_bytes(seq) -> bytes:
    if isinstance(seq, bytes):
        return seq
    if isinstance(seq, (bytearray, memoryview)):
        return bytes(seq)
    import numpy as np

    a = np.ascontiguousarray(seq)
    return a.dtype.str.encode() + a.tobytes()


def window_digest(window) -> bytes:
    """Canonical content digest of one Window: its type and every
    layer's (sequence, quality, begin, end) in insertion order, which
    the WindowLedger pins to overlap-ordinal order, so streamed and
    staged builds of one window digest identically.  Equal to the JAX
    package's digest of the same window.  The parts are hashed as one
    buffer (the same digest as part by part): one call, which lets go
    of the GIL while it hashes, so keying on one thread does not stall
    the CPU workers and the decode pool."""
    parts = [b"win1|%d|%d" % (int(window.type.value),
                              len(window.sequences))]
    for i, seq in enumerate(window.sequences):
        qual = window.qualities[i]
        begin, end = window.positions[i]
        parts.append(struct.pack("<IIIi", len(seq),
                                 len(qual) if qual else 0,
                                 int(begin), int(end)))
        parts.append(seq)
        if qual:
            parts.append(qual)
    return hashlib.blake2b(b"".join(parts),
                           digest_size=DIGEST_SIZE).digest()


def poa_key(space: str, cfg_key, trim: bool, window,
            epoch: bytes) -> bytes:
    """One POA window unit.  ``space`` separates the native CPU engine
    ("cpu") from the POA kernel ("dev"), which break ties
    independently; ``cfg_key`` is the full engine configuration (the
    executor's ``PoaEngineHandle.cfg_key`` for the device space,
    (match, mismatch, gap) for the CPU engine)."""
    h = _h(b"poa|", epoch)
    h.update(space.encode())
    h.update(repr(cfg_key).encode())
    h.update(b"|t%d|" % int(bool(trim)))
    h.update(window_digest(window))
    return h.digest()


def wfa_key(query, target, lq: int, emax: int, dev_key,
            epoch: bytes) -> bytes:
    """One WFA align pair: pair bytes, rung geometry (padded length,
    error cap) and the device type (``dev_key``)."""
    h = _h(b"wfa|", epoch)
    h.update(repr((int(lq), int(emax), dev_key)).encode())
    q = _as_bytes(query)
    h.update(struct.pack("<I", len(q)))
    h.update(q)
    h.update(_as_bytes(target))
    return h.digest()


def band_key(query, target, lq: int, lt: int, wb: int, center,
             dev_key, epoch: bytes) -> bytes:
    """One banded align pair: pair bytes, rung geometry (padded
    lengths, band width), the per-pair measured center knots when
    given, and the device type (``dev_key``)."""
    h = _h(b"band|", epoch)
    h.update(repr((int(lq), int(lt), int(wb), dev_key)).encode())
    if center is None:
        h.update(b"c0|")
    else:
        c = _as_bytes(center)
        h.update(b"c1|" + struct.pack("<I", len(c)))
        h.update(c)
    q = _as_bytes(query)
    h.update(struct.pack("<I", len(q)))
    h.update(q)
    h.update(_as_bytes(target))
    return h.digest()


def scan_key(query, target, blq: int, blt: int, need_ratio,
             epoch: bytes) -> bytes:
    """One CPU scan-ladder pair: the ladder's per-pair result depends
    only on the pair bytes, the bucket dims and the probe need ratio;
    chunking and the memory budget only batch.  (No call site yet: the
    scan ladder is still to be ported.)"""
    h = _h(b"scan|", epoch)
    h.update(repr((int(blq), int(blt),
                   round(float(need_ratio), 9))).encode())
    q = _as_bytes(query)
    h.update(struct.pack("<I", len(q)))
    h.update(q)
    h.update(_as_bytes(target))
    return h.digest()
