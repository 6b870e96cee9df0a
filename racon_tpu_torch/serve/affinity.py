"""Content-affinity digests of a served job (JAX package:
racon_tpu/serve/affinity.py).

The result cache keys units by full content digests, so "is this daemon
warm for this job?" is set membership.  Unit keys exist only after
parsing and windowing, far too late for placement, so placement uses a
cheap sample of job-level digests over the spec's input files (size,
then head, middle and tail chunks per role), folded with the engine
epoch.  The daemon notes the sample into its cache's digest sketch
(``cache/sketch.py``) after each successful job
(:func:`note_job_content`), and its ``health`` and ``metrics`` frames
export the sketch.  A router in front of several daemons would score
the same sample against each one's sketch; the port has no router
yet.

Folding the epoch into every digest makes a daemon with another knob
environment, whose cached results would not be reusable, score cold.
Everything here prices placement only and never changes bytes.
"""

from __future__ import annotations

import hashlib
import os

from racon_tpu_torch.cache import keying

#: per-role chunk size of the content digests (head, middle, tail)
CHUNK = 1 << 16

_ROLES = ("sequences", "overlaps", "targets")


def _file_digests(role: str, path: str, epoch: bytes):
    """Up to four digests of one input file: a whole-file signature
    (role and size) and head, middle and tail chunk digests.  An
    unreadable file yields nothing."""
    try:
        size = os.stat(path).st_size
    except OSError:
        return
    base = b"aff1|" + role.encode() + b"|s0/1|" + epoch
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
    input bytes and the engine epoch alone."""
    if epoch is None:
        epoch = keying.engine_epoch()
    out = []
    for role in _ROLES:
        path = spec.get(role)
        if isinstance(path, str) and path:
            out.extend(_file_digests(role, path, epoch))
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
