"""Write-ahead job journal: the serve daemon's crash-safe record (JAX
package: racon_tpu/serve/journal.py).

Every job-state transition is appended to an fsync'd file before the
daemon acts on it, so a restarted daemon replays the file
(``serve/recover.py``) and requeues what was interrupted.

Format: append-only, length-prefixed JSON records, the framing of the
wire protocol (``serve/protocol.py``).  Each record is a flight-event
shaped object (``kind``, ``t``, ``job``, ``tenant`` and the kind's
fields) plus ``seq`` and ``pid``: several daemon incarnations share a
file and are told apart by pid.  Each incarnation's first record is
``journal_open`` with ``schema: "racon-tpu-torch-journal-v1"``.  Kinds:

* ``admit``      -- the job spec, ``job_key``, priority, tenant, trace
  id and the calibration snapshot the job is pinned to
  (``utils/calibrate.epoch_snapshot``)
* ``start``      -- a worker popped the job
* ``checkpoint`` -- one committed POA megabatch: window ordinals with
  their consensus bytes (base64) and polish flags
* ``done``       -- the full result frame (FASTA and report), so a
  duplicate keyed submit after a restart is answered from it
* ``error``      -- terminal failure with the structured error
* ``recovery``   -- a restarted daemon's replay summary

Every journaled job has a ``job_key``, the client's or one the daemon
mints (``auto-<pid>-<id>``), and replay merges records across
incarnations by it.

The port's journal is its own file, ``<socket>.torch-journal`` (the JAX
daemon's is ``<socket>.journal``), and :func:`own_records` keeps only
the incarnations that opened with this package's schema, so neither
package's daemon replays the other's jobs, as neither package's result
cache serves the other.

Durability: :meth:`JobJournal.append` returns after write, flush and
fsync (``RACON_TPU_TORCH_JOURNAL_FSYNC=0`` drops the fsync).  ``scan``
tolerates a torn tail: a crash mid-append loses at most the record being
written.  Timestamps are wall-clock (``obs.trace.wall_now``), since a
later process reads them.  Knobs: ``RACON_TPU_TORCH_JOURNAL`` ("0"
off), ``RACON_TPU_TORCH_JOURNAL_DIR`` (default: the socket's
directory), ``RACON_TPU_TORCH_JOURNAL_FSYNC``.
"""

from __future__ import annotations

import json
import os
import struct
import threading

from racon_tpu_torch.obs import faultinject
from racon_tpu_torch.obs.trace import wall_now

SCHEMA = "racon-tpu-torch-journal-v1"
#: the file name's suffix after the socket's base name
SUFFIX = ".torch-journal"

_LEN = struct.Struct(">I")
#: refuse records past this size on scan (a torn length prefix must not
#: make replay allocate gigabytes)
RECORD_MAX = 1 << 30


def enabled() -> bool:
    return os.environ.get("RACON_TPU_TORCH_JOURNAL", "1") != "0"


def journal_path(socket_path: str) -> str:
    """``<socket>.torch-journal`` beside the socket, or under
    ``RACON_TPU_TORCH_JOURNAL_DIR``: a restart on the same socket finds
    the previous incarnation's record with no configuration."""
    d = os.environ.get("RACON_TPU_TORCH_JOURNAL_DIR") \
        or os.path.dirname(os.path.abspath(socket_path))
    return os.path.join(d, os.path.basename(socket_path) + SUFFIX)


def scan(path: str):
    """Every intact record: ``(records, truncated)``.  A torn tail (a
    partial prefix, a short body, non-JSON bytes) ends the scan with
    ``truncated=True``."""
    records = []
    try:
        f = open(path, "rb")
    except OSError:
        return records, False
    with f:
        while True:
            head = f.read(_LEN.size)
            if not head:
                return records, False
            if len(head) < _LEN.size:
                return records, True
            (n,) = _LEN.unpack(head)
            if n > RECORD_MAX:
                return records, True
            body = f.read(n)
            if len(body) < n:
                return records, True
            try:
                rec = json.loads(body)
            except ValueError:
                return records, True
            if isinstance(rec, dict):
                records.append(rec)


def own_records(records) -> list:
    """The records of the incarnations whose ``journal_open`` carries
    :data:`SCHEMA`; another package's records (a JAX daemon's journal
    in the same place) are dropped."""
    ours, out = set(), []
    for rec in records:
        if rec.get("kind") == "journal_open":
            if rec.get("schema") == SCHEMA:
                ours.add(rec.get("pid"))
            else:
                ours.discard(rec.get("pid"))
        if rec.get("pid") in ours:
            out.append(rec)
    return out


class JobJournal:
    """One daemon incarnation's append handle; thread-safe (admission,
    workers and the polisher's checkpoint callback append
    concurrently)."""

    def __init__(self, path: str, prior_records: int = 0):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "ab")
        self._fsync = os.environ.get(
            "RACON_TPU_TORCH_JOURNAL_FSYNC", "1") != "0"
        self._seq = 0
        self._prior = prior_records
        self._last_fsync_t = None
        self.append("journal_open", schema=SCHEMA, fsync=self._fsync)

    def append(self, kind: str, job=None, **fields) -> None:
        """Durably append one record; returns after the bytes are
        flushed (and fsync'd unless turned off), so the record survives
        any crash after the call."""
        rec = {"kind": kind, "t": round(wall_now(), 6),
               "pid": os.getpid()}
        if job is not None:
            rec["job"] = int(job)
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        faultinject.hit("journal-write")
        with self._lock:
            self._seq += 1
            # under the lock, so file order and seq order agree
            rec["seq"] = self._seq
            payload = json.dumps(rec, separators=(",", ":")).encode()
            self._f.write(_LEN.pack(len(payload)) + payload)
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
                self._last_fsync_t = wall_now()

    def stats(self) -> dict:
        """The ``health`` and ``status`` journal block."""
        with self._lock:
            try:
                size = os.fstat(self._f.fileno()).st_size
            except OSError:
                size = None
            return {"enabled": True, "path": self.path,
                    "depth": self._prior + self._seq,
                    "appended": self._seq, "bytes": size,
                    "fsync": self._fsync,
                    "last_fsync_t": (round(self._last_fsync_t, 3)
                                     if self._last_fsync_t else None)}

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                if self._fsync:
                    os.fsync(self._f.fileno())
            except OSError:
                pass
            try:
                self._f.close()
            except OSError:
                pass
