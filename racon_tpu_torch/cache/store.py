"""The result cache's two storage tiers (JAX package:
racon_tpu/cache/store.py).

Tier 1, in process: an ``OrderedDict`` of encoded blobs under one lock,
byte-budgeted (``RACON_TPU_TORCH_CACHE_MB``): an insert past the budget
evicts from the cold end, a hit moves to the hot end.  The budget
bounds the encoded payload bytes exactly (codec blobs, not Python
object overhead).

Tier 2, optional and shared: append-only ``torch-seg-<pid>.rseg``
files in a directory, framed ``u32BE length | body`` with body = 32-byte
key + crc32 (u32BE) + blob.  The first frame of every segment is a JSON
magic record carrying ``schema``: :data:`SCHEMA`, the port's own tag,
so a directory shared with the JAX package never serves one package's
results to the other; the ``torch-`` prefix keeps a process that runs
both packages from appending to the JAX package's ``seg-<pid>.rseg``.
``_scan_segments`` tolerates a torn tail (a crash mid-append loses at
most the frame being written), and every blob read back is crc-checked
and codec-validated, so corruption of any shape reads as a miss, never
as wrong bytes.  Segments are per pid so concurrent processes never
interleave writes; each process indexes every segment in the directory
when it opens it, which is how a restart inherits an earlier run's
fills.

Counters (process ``REGISTRY``): ``cache_hit`` / ``cache_miss`` /
``cache_fill`` / ``cache_evict``; gauges ``cache_hit_ratio`` and
``cache_bytes``.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from collections import OrderedDict

from racon_tpu_torch.cache import codec, sketch
from racon_tpu_torch.obs import REGISTRY

#: the segments' schema tag: a directory shared with the JAX package
#: never mixes the two packages' results
SCHEMA = "racon-tpu-torch-rcache-v1"

_LEN = struct.Struct(">I")
_CRC = struct.Struct(">I")
#: refuse frames past this size on scan (a torn length prefix must
#: not make a restart try to allocate gigabytes)
FRAME_MAX = 1 << 30
_KEY_SIZE = 32

#: distinguished miss sentinel — ``None`` is a legitimate cached value
MISS = object()


class ResultCache:
    """One process's content-addressed result cache (both tiers)."""

    def __init__(self, budget_bytes: int, persist_dir=None):
        self.budget = max(0, int(budget_bytes))
        self.persist_dir = persist_dir
        self._lock = threading.Lock()
        self._lru: OrderedDict = OrderedDict()   # key -> blob
        self._bytes = 0
        self._hits = self._misses = 0
        self._fills = self._evicts = 0
        self._disk_hits = 0
        # persistent tier: key -> (path, offset, length, crc)
        self._pindex: dict = {}
        self._seg = None
        self._seg_path = None
        # segment path -> read-only descriptor, opened on first read
        self._fds: dict = {}
        # digest sketch: a counting Bloom filter over every live key
        # (LRU, persistent index, job-level content digests), kept
        # under self._lock beside the structures it mirrors; its drift
        # only mis-prices placement, never bytes.  Only a placement
        # reader (a router) reads it, so it is built from the live keys
        # on first use (:meth:`_live_sketch`) and kept up to date from
        # then on; a one-shot polish never pays for it
        self._sketch = None
        self._content_n = 0
        if persist_dir:
            try:
                os.makedirs(persist_dir, exist_ok=True)
                self._scan_segments()
            except OSError:
                self.persist_dir = None

    # -- lookups -----------------------------------------------------------

    def get(self, key: bytes):
        """Decoded value for ``key``, or :data:`MISS`."""
        with self._lock:
            blob = self._lru.get(key)
            if blob is not None:
                self._lru.move_to_end(key)
                self._hits += 1
                self._note_lookup(hit=True)
                loc = None
            else:
                loc = self._pindex.get(key)
        if blob is None:
            if loc is not None:
                blob = self._read_segment(key, loc)
            if blob is None:
                with self._lock:
                    self._misses += 1
                    self._note_lookup(hit=False)
                return MISS
            with self._lock:
                self._hits += 1
                self._disk_hits += 1
                self._note_lookup(hit=True)
                self._insert(key, blob)
        try:
            return codec.decode(blob)
        except codec.CodecError:
            # never serve wrong bytes: drop the entry, report a miss
            with self._lock:
                dropped = self._lru.pop(key, None)
                if dropped is not None:
                    self._bytes -= len(dropped)
                if (self._pindex.pop(key, None) is not None
                        or dropped is not None) and self._sketch is not None:
                    self._sketch.discard(key)
                self._hits -= 1
                self._misses += 1
                self._note_lookup(hit=False)
            return MISS

    def put(self, key: bytes, value) -> None:
        """Fill ``key``; duplicate/racing fills keep the first entry."""
        try:
            blob = codec.encode(value)
        except Exception:
            return                      # uncacheable value: skip
        with self._lock:
            if key in self._lru or key in self._pindex:
                return
            self._insert(key, blob)
            self._fills += 1
        REGISTRY.add("cache_fill")
        self._append_segment(key, blob)

    # -- LRU internals (call under self._lock) -----------------------------

    def _insert(self, key: bytes, blob: bytes) -> None:
        if key in self._lru:
            return
        if self.budget and len(blob) > self.budget:
            return                      # larger than the whole budget
        self._lru[key] = blob
        self._bytes += len(blob)
        if key not in self._pindex and self._sketch is not None:
            # pindex keys are already sketched (seed scan / append),
            # so a disk-hit promotion must not double-count its key
            self._sketch.add(key)
        while self.budget and self._bytes > self.budget and \
                len(self._lru) > 1:
            old_key, old = self._lru.popitem(last=False)
            self._bytes -= len(old)
            self._evicts += 1
            if old_key not in self._pindex and self._sketch is not None:
                # still reachable through the persistent tier = still
                # warm for placement purposes; only a full departure
                # leaves the sketch
                self._sketch.discard(old_key)
            REGISTRY.add("cache_evict")
        REGISTRY.set("cache_bytes", self._bytes)

    def _note_lookup(self, hit: bool) -> None:
        REGISTRY.add("cache_hit" if hit else "cache_miss")
        total = self._hits + self._misses
        if total:
            REGISTRY.set("cache_hit_ratio",
                         round(self._hits / total, 4))

    # -- persistent tier ---------------------------------------------------

    def _scan_segments(self) -> None:
        """Index every intact frame of every segment in the shared
        directory (this process's past runs and other processes').
        Stops at the first torn or corrupt frame of each file."""
        try:
            names = sorted(n for n in os.listdir(self.persist_dir)
                           if n.endswith(".rseg"))
        except OSError:
            return
        for name in names:
            path = os.path.join(self.persist_dir, name)
            try:
                f = open(path, "rb")
            except OSError:
                continue
            with f:
                first = True
                while True:
                    head = f.read(_LEN.size)
                    if len(head) < _LEN.size:
                        break
                    (n,) = _LEN.unpack(head)
                    if n > FRAME_MAX:
                        break
                    body = f.read(n)
                    if len(body) < n:
                        break
                    if first:
                        first = False
                        try:
                            magic = json.loads(body)
                        except ValueError:
                            break
                        if not (isinstance(magic, dict)
                                and magic.get("schema") == SCHEMA):
                            break
                        continue
                    if n < _KEY_SIZE + _CRC.size:
                        break
                    key = body[:_KEY_SIZE]
                    (crc,) = _CRC.unpack(
                        body[_KEY_SIZE:_KEY_SIZE + _CRC.size])
                    off = f.tell() - n + _KEY_SIZE + _CRC.size
                    self._pindex.setdefault(
                        key, (path, off, n - _KEY_SIZE - _CRC.size,
                              crc))

    def _read_segment(self, key: bytes, loc):
        """Blob for an indexed key, crc-verified; any failure drops
        the index entry and returns None (a miss).  Reads are
        positional on one descriptor per segment, opened once, so a
        restart's lookups cost no ``open`` each."""
        path, off, length, crc = loc
        try:
            with self._lock:
                fd = self._fds.get(path)
                if fd is None:
                    fd = self._fds[path] = os.open(path, os.O_RDONLY)
            blob = os.pread(fd, length, off)
        except OSError:
            blob = b""
        if len(blob) != length or zlib.crc32(blob) != crc:
            with self._lock:
                self._pindex.pop(key, None)
            return None
        return blob

    def _append_segment(self, key: bytes, blob: bytes) -> None:
        if not self.persist_dir:
            return
        with self._lock:
            try:
                if self._seg is None:
                    self._seg_path = os.path.join(
                        self.persist_dir,
                        f"torch-seg-{os.getpid()}.rseg")
                    self._seg = open(self._seg_path, "ab")
                    if not self._seg.tell():
                        magic = json.dumps(
                            {"schema": SCHEMA, "pid": os.getpid()},
                            separators=(",", ":")).encode()
                        self._seg.write(
                            _LEN.pack(len(magic)) + magic)
                body = key + _CRC.pack(zlib.crc32(blob)) + blob
                self._seg.write(_LEN.pack(len(body)) + body)
                self._seg.flush()
                off = self._seg.tell() - len(blob)
                self._pindex.setdefault(
                    key, (self._seg_path, off, len(blob),
                          zlib.crc32(blob)))
            except OSError:
                # persistence is an optimization; never fail the run
                try:
                    if self._seg is not None:
                        self._seg.close()
                except OSError:
                    pass
                self._seg = None
                self.persist_dir = None

    # -- digest sketch -----------------------------------------------------

    def _live_sketch(self):
        """The sketch, built from every live key on first use (call
        under self._lock)."""
        if self._sketch is None:
            self._sketch = sketch.DigestSketch()
            for key in self._lru.keys() | self._pindex.keys():
                self._sketch.add(key)
        return self._sketch

    def note_content(self, digest: bytes) -> None:
        """Record a job-level content digest as warm.  Content digests
        are never discarded (they do not map one to one to evictable
        entries), so a long-lived process's sketch over-reports old
        content: a placement mis-pricing, never a bytes risk."""
        with self._lock:
            self._live_sketch().add(digest)
            self._content_n += 1

    def sketch_doc(self) -> dict:
        """The epoch-tagged export of the digest sketch (see
        :mod:`racon_tpu_torch.cache.sketch`)."""
        from racon_tpu_torch.cache import keying

        epoch_hex = keying.engine_epoch().hex()
        with self._lock:
            n = len(self._lru) + len(self._pindex) + self._content_n
            return self._live_sketch().export(epoch_hex, n)

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            sk = self._sketch
            doc = {
                "enabled": True,
                "entries": len(self._lru),
                "bytes": self._bytes,
                "budget_bytes": self.budget,
                "hits": self._hits,
                "misses": self._misses,
                "fills": self._fills,
                "evicts": self._evicts,
                "disk_hits": self._disk_hits,
                "hit_ratio": (round(self._hits / total, 4)
                              if total else 0.0),
                "sketch_adds": sk.adds if sk is not None else 0,
                "sketch_drops": sk.drops if sk is not None else 0,
                "sketch_content": self._content_n,
            }
            if self.persist_dir:
                doc["persist"] = {"dir": self.persist_dir,
                                  "indexed": len(self._pindex)}
            return doc

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._fds.clear()
            if self._seg is not None:
                try:
                    self._seg.close()
                except OSError:
                    pass
                self._seg = None
