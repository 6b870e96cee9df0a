"""Content-affinity digests of a served job (JAX package:
racon_tpu/serve/affinity.py).

The result cache keys units by full content digests, so "is this daemon
warm for this job?" is set membership.  Unit keys exist only after
parsing and windowing, far too late for placement, so placement uses a
cheap sample of job-level digests over the spec's input files (size,
then head, middle and tail chunks per role), folded with the engine
epoch and the job's target shard.  The daemon notes the sample into its
cache's digest sketch (``cache/sketch.py``) after each successful job
(:func:`note_job_content`), and its ``health`` and ``metrics`` frames
export the sketch.  The router (``serve/router.py``) derives the same
sample from the same spec and asks each backend's sketch what fraction
of it is warm (:func:`backend_hit_fraction`), which prices the
placement.

Folding the epoch into every digest makes a daemon with another knob
environment, whose cached results would not be reusable, score cold.
Everything here prices placement only and never changes bytes.
"""

from __future__ import annotations

import hashlib
import os

from racon_tpu_torch.cache import keying, sketch

#: per-role chunk size of the content digests (head, middle, tail)
CHUNK = 1 << 16

_ROLES = ("sequences", "overlaps", "targets")


def _file_digests(role: str, path: str, shard_tag: bytes,
                  epoch: bytes):
    """Up to four digests of one input file: a whole-file signature
    (role and size) and head, middle and tail chunk digests.  An
    unreadable file yields nothing."""
    try:
        size = os.stat(path).st_size
    except OSError:
        return
    base = b"aff1|" + role.encode() + b"|" + shard_tag + b"|" + epoch
    h = hashlib.blake2b(digest_size=keying.DIGEST_SIZE)
    h.update(base + b"|size|%d" % size)
    yield h.digest()
    offsets = sorted({0, max(0, size // 2 - CHUNK // 2),
                      max(0, size - CHUNK)})
    try:
        with open(path, "rb") as f:
            for slot, off in enumerate(offsets):
                f.seek(off)
                chunk = f.read(CHUNK)
                h = hashlib.blake2b(digest_size=keying.DIGEST_SIZE)
                h.update(base + b"|c%d|%d|" % (slot, size))
                h.update(chunk)
                yield h.digest()
    except OSError:
        return


def job_digest_sample(spec: dict, epoch: bytes = None) -> list:
    """Up to 12 32-byte digests (4 per input role), a function of the
    input bytes, the target shard and the engine epoch alone."""
    if epoch is None:
        epoch = keying.engine_epoch()
    shard = spec.get("shard")
    if isinstance(shard, (list, tuple)) and len(shard) == 2:
        shard_tag = b"s%d/%d" % (int(shard[0]), int(shard[1]))
    else:
        shard_tag = b"s0/1"
    out = []
    for role in _ROLES:
        path = spec.get(role)
        if isinstance(path, str) and path:
            out.extend(_file_digests(role, path, shard_tag, epoch))
    return out


def note_job_content(spec: dict) -> None:
    """Mark a completed job's digest sample warm in the cache's sketch.
    Never raises: bookkeeping must not fail a finished job."""
    try:
        from racon_tpu_torch import cache as rcache

        if not rcache.enabled():
            return
        for digest in job_digest_sample(spec):
            rcache.note_content(digest)
    except Exception:
        pass


def backend_hit_fraction(sketch_doc, sample, epoch_hex: str):
    """The router's side: the estimated fraction of ``sample`` warm in
    one backend's exported sketch.  None (no usable sketch: rank without
    it) when the doc is absent or undecodable, or tagged with another
    engine epoch than ``epoch_hex``: a foreign epoch's cached results
    are not reusable here, and the JAX package's sketches never decode
    (another schema and another epoch)."""
    if not sample or not isinstance(sketch_doc, dict):
        return None
    if sketch_doc.get("epoch") != epoch_hex:
        return None
    bits = sketch.decode_bits(sketch_doc)
    if bits is None:
        return None
    hits = sum(1 for d in sample if sketch.bits_contain(bits, d))
    return hits / len(sample)
