"""The port's result cache (racon_tpu_torch/cache) against the JAX
package's, and its byte-neutrality end to end.

* the codec encodes every value to the JAX codec's bytes, and any
  truncation or unknown tag of a blob raises ``CodecError``;
* ``window_digest`` equals the JAX package's on every window of a
  polish, and a unit's key moves with its content and configuration;
* the engine epoch moves with a byte-changing knob and with the salted
  sources, and not with an ``EPOCH_EXCLUDE`` knob;
* the store (tests/test_cache.py on the port): LRU byte budget, racing
  fills, restart reuse, a corrupt segment read as a miss, a torn tail;
  and a directory shared with the JAX package serves neither package
  the other's results;
* cache off, cold, warm and persistent-restart polishes write the same
  bytes for the plain CPU ``Polisher`` and ``CudaPolisher(device=
  "cpu")``, the warm and restart runs hit, and a hit batch stores no
  rate;
* ``--rounds 2`` from a fixed-point draft serves round 2 from the
  cache.
"""

import os
import struct
import threading

import numpy as np
import pytest
import torch

from racon_tpu import cache as jax_cache
from racon_tpu.cache import codec as jax_codec
from racon_tpu.cache import keying as jax_keying
from racon_tpu.cache.store import ResultCache as JaxResultCache
from racon_tpu.core import polisher as jax_polisher
from racon_tpu_torch import cache
from racon_tpu_torch.cache import codec, keying
from racon_tpu_torch.cache.store import MISS, ResultCache
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.cuda.polisher import CudaPolisher
from racon_tpu_torch.obs import REGISTRY
from racon_tpu_torch.obs import provenance
from racon_tpu_torch.overlap import polish_rounds
from racon_tpu_torch.overlap.rounds import write_fasta
from racon_tpu_torch.tools import simulate
from racon_tpu_torch.utils import calibrate

CACHE_KNOBS = ("RACON_TPU_TORCH_CACHE", "RACON_TPU_TORCH_CACHE_MB",
               "RACON_TPU_TORCH_CACHE_PERSIST")


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    """Every test starts with no live cache and the cache knobs unset,
    and leaves none behind."""
    for knob in CACHE_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    cache.reset()
    yield
    cache.reset()


def small_window(seed=0, n_layers=4, wtype=WindowType.TGS):
    rng = np.random.default_rng(seed)
    backbone = bytes(rng.choice(list(b"ACGT"), 60))
    w = Window(0, 0, wtype, backbone, b"!" * len(backbone))
    for i in range(n_layers):
        s = bytes(rng.choice(list(b"ACGT"), 40))
        w.add_layer(s, b"#" * len(s), i, min(i + 41, 60))
    return w


# ---------------------------------------------------------------------------
# codec: the JAX package's bytes
# ---------------------------------------------------------------------------

CODEC_VALUES = {
    "none": None, "true": True, "false": False, "int": 42, "neg": -7,
    "big": 2 ** 62, "bytes": b"ACGT", "empty_bytes": b"", "str": "name",
    "poa": (b"CONS", True),
    "poa_reject": (None, False),
    "nested": ((1, (b"x", None)), "y", ()),
    "wfa_row": (np.arange(12, dtype=np.int64), 7, 3),
    "band_row": (np.arange(32, dtype=np.uint8).reshape(2, 16), 31, 5),
    "u32": np.array([3, 1, 2], np.uint32),
    "i64_3d": np.arange(24, dtype=np.int64).reshape(2, 3, 4),
    "u8_empty": np.zeros((0,), np.uint8),
    "np_int": np.int32(-5),
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b and type(a) is type(b)


def _tag_offsets(blob: bytes) -> list:
    """Offsets of every tag byte in a blob (a walk of the format)."""
    out, pos = [], 0

    def u32(p):
        return struct.unpack("<I", blob[p:p + 4])[0]

    def walk(p):
        out.append(p)
        tag = blob[p:p + 1]
        p += 1
        if tag in (b"N", b"T", b"F"):
            return p
        if tag == b"I":
            return p + 8
        if tag in (b"Y", b"S"):
            return p + 4 + u32(p)
        if tag == b"L":
            n, p = u32(p), p + 4
            for _ in range(n):
                p = walk(p)
            return p
        assert tag == b"A"
        p += 4 + u32(p)
        ndim, p = u32(p), p + 4
        p += 4 * ndim
        return p + 4 + u32(p)

    assert walk(pos) == len(blob)
    return out


@pytest.mark.parametrize("name", sorted(CODEC_VALUES))
def test_codec_bytes_equal_jax_and_round_trip(name):
    value = CODEC_VALUES[name]
    blob = codec.encode(value)
    assert blob == jax_codec.encode(value)
    want = int(value) if isinstance(value, np.integer) else value
    assert _same(want, codec.decode(blob))


@pytest.mark.parametrize("name", sorted(CODEC_VALUES))
def test_codec_truncation_and_unknown_tags_raise(name):
    blob = codec.encode(CODEC_VALUES[name])
    for k in range(len(blob)):
        with pytest.raises(codec.CodecError):
            codec.decode(blob[:k])
    for off in _tag_offsets(blob):
        bad = blob[:off] + b"Z" + blob[off + 1:]
        with pytest.raises(codec.CodecError):
            codec.decode(bad)
    with pytest.raises(codec.CodecError):
        codec.decode(blob + b"N")


def test_decoded_arrays_are_writable():
    arr = codec.decode(codec.encode(np.arange(5)))
    arr[0] = 99
    assert arr[0] == 99


# ---------------------------------------------------------------------------
# keying
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    out = tmp_path_factory.mktemp("cache_sim")
    reads, paf, draft = simulate.simulate(
        str(out), genome_len=4_000, coverage=5, read_len=800, seed=21,
        ont=True)
    return dict(reads=reads, paf=paf, draft=draft, dir=str(out))


def test_window_digest_equals_jax_on_every_window(small_set):
    paths = (small_set["reads"], small_set["paf"], small_set["draft"])
    port = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                           5, -4, -8, 2)
    ref = jax_polisher.create_polisher(
        *paths, jax_polisher.PolisherType.kC, 500, 10.0, 0.3, True, 5, -4,
        -8, 2)
    try:
        port.initialize()
        ref.initialize()
        assert len(port.windows) == len(ref.windows) > 3
        assert sum(len(w.sequences) >= 3 for w in port.windows) > 3
        for w, jw in zip(port.windows, ref.windows):
            assert keying.window_digest(w) == jax_keying.window_digest(jw)
    finally:
        port.close()
        ref.close()


def _mutations():
    def base(w):
        s = bytearray(w.sequences[1])
        s[3] = ord("A") if s[3] != ord("A") else ord("C")
        w.sequences[1] = bytes(s)

    def quality(w):
        w.qualities[2] = b"$" + w.qualities[2][1:]

    def position(w):
        b, e = w.positions[1]
        w.positions[1] = (b, e - 1)

    def wtype(w):
        w.type = WindowType.NGS

    return {"base": base, "quality": quality, "position": position,
            "type": wtype}


@pytest.mark.parametrize("what", ["base", "quality", "position", "type",
                                  "scoring", "trim", "space"])
def test_poa_key_moves_with_content_and_config(what):
    epoch = keying.engine_epoch()
    w = small_window(seed=1)
    key = keying.poa_key("cpu", (5, -4, -8), True, w, epoch)
    assert key == keying.poa_key("cpu", (5, -4, -8), True,
                                 small_window(seed=1), epoch)
    assert len(key) == keying.DIGEST_SIZE
    space, cfg, trim = "cpu", (5, -4, -8), True
    if what == "scoring":
        cfg = (5, -4, -6)
    elif what == "trim":
        trim = False
    elif what == "space":
        space = "dev"
    else:
        _mutations()[what](w)
    assert keying.poa_key(space, cfg, trim, w, epoch) != key


def test_align_keys_move_with_pair_geometry_and_center():
    epoch = keying.engine_epoch()
    q = b"ACGTACGTAC"
    t = b"ACGAACGTAC"
    k = keying.wfa_key(q, t, 1024, 512, "cuda", epoch)
    assert k == keying.wfa_key(q, t, 1024, 512, "cuda", epoch)
    assert k != keying.wfa_key(q, t, 2048, 512, "cuda", epoch)
    assert k != keying.wfa_key(q, t, 1024, 1024, "cuda", epoch)
    assert k != keying.wfa_key(t, q, 1024, 512, "cuda", epoch)
    assert k != keying.wfa_key(q, t, 1024, 512, "cpu", epoch)
    kb = keying.band_key(q, t, 1024, 1024, 2048, None, "cuda", epoch)
    assert kb != keying.band_key(q, t, 1024, 1024, 2048,
                                 np.arange(4, dtype=np.int32), "cuda",
                                 epoch)
    assert kb != keying.band_key(q, t, 1024, 1024, 4096, None, "cuda",
                                 epoch)
    ks = keying.scan_key(q, t, 1024, 1024, 0.3, epoch)
    assert ks != keying.scan_key(q, t, 1024, 1024, 0.31, epoch)


@pytest.mark.parametrize("knob,value", [
    ("RACON_TPU_TORCH_MAX_ALIGN_DIM", "32768"),
    ("RACON_TPU_TORCH_MAP_K", "15"),
    ("RACON_TPU_TORCH_PIPELINE", "0"),
    ("RACON_TPU_TORCH_FUSE_WAIT_MS", "7"),
    ("RACON_TPU_TORCH_SERVE_TENANT_QUOTA", "3"),
    ("RACON_TPU_TORCH_RATE_POA_DEV", "2.5")])
def test_epoch_moves_with_byte_changing_knobs(monkeypatch, knob, value):
    monkeypatch.delenv(knob, raising=False)
    base = keying.engine_epoch()
    monkeypatch.setenv(knob, value)
    assert keying.engine_epoch() != base
    monkeypatch.delenv(knob)
    assert keying.engine_epoch() == base


@pytest.mark.parametrize("knob", sorted(keying.EPOCH_EXCLUDE))
def test_epoch_ignores_excluded_knobs(monkeypatch, knob):
    assert knob in provenance.KNOWN_KNOBS
    base = keying.engine_epoch()
    monkeypatch.setenv(knob, "0" if provenance.KNOWN_KNOBS[knob] == "1"
                       else "1")
    assert keying.engine_epoch() == base


def test_epoch_moves_with_the_salted_sources(monkeypatch):
    base = keying.engine_epoch()
    salt = calibrate._code_salt(keying.EPOCH_SALTED)
    monkeypatch.setattr(calibrate, "_code_salt",
                        lambda *a: salt[::-1] + "x")
    assert keying.engine_epoch() == base        # read once a process
    keying.forget()
    assert keying.engine_epoch() != base


@pytest.mark.parametrize("rel", [
    "cuda/csrc/poa_full.cu", "cuda/executor.py", "core/window.py",
    "ops/cpu.py", "cache/codec.py", "convert.py", "native/poa.cpp",
    "native/poa_graph.hpp", "native/Makefile", "tools/simulate.py"])
def test_epoch_salt_covers_the_result_path(tmp_path, monkeypatch, rel):
    """Every source on a cached unit's result path moves the epoch, the
    native engine's wrapper (``ops/``) and the codec among them, which
    the rate store's salt leaves out; a module off that path (the
    simulator) does not."""
    pkg = tmp_path / "pkg"
    paths = ["cuda/csrc/poa_full.cu", "cuda/executor.py",
             "core/window.py", "ops/cpu.py", "cache/codec.py",
             "convert.py", "native/poa.cpp", "native/poa_graph.hpp",
             "native/Makefile", "tools/simulate.py"]
    for p in paths:
        (pkg / p).parent.mkdir(parents=True, exist_ok=True)
        (pkg / p).write_text(p)
    monkeypatch.setattr(calibrate, "_PKG", str(pkg))
    keying.forget()
    base = keying.engine_epoch()
    (pkg / rel).write_text(rel + " changed")
    keying.forget()
    moved = keying.engine_epoch() != base
    assert moved == (rel != "tools/simulate.py")


# ---------------------------------------------------------------------------
# the store (tests/test_cache.py on the port)
# ---------------------------------------------------------------------------

def test_lru_respects_byte_budget():
    blob_len = len(codec.encode(b"x" * 1000))
    c = ResultCache(budget_bytes=blob_len * 3)
    keys = [bytes([i]) * 32 for i in range(6)]
    for k in keys:
        c.put(k, b"x" * 1000)
    st = c.stats()
    assert st["bytes"] <= blob_len * 3
    assert st["entries"] == 3 and st["evicts"] == 3
    assert all(c.get(k) is MISS for k in keys[:3])
    assert all(c.get(k) == b"x" * 1000 for k in keys[3:])
    # a value over the whole budget is refused outright
    c.put(b"Z" * 32, b"y" * (blob_len * 4))
    assert c.get(b"Z" * 32) is MISS


def test_racing_fills_keep_one_entry():
    c = ResultCache(budget_bytes=1 << 20)
    key = b"k" * 32
    barrier = threading.Barrier(8)

    def fill():
        barrier.wait()
        c.put(key, (b"CONSENSUS", True))

    threads = [threading.Thread(target=fill) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert c.stats()["entries"] == 1
    assert c.get(key) == (b"CONSENSUS", True)


def test_restart_reuses_segments(tmp_path):
    d = str(tmp_path / "results")
    first = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    first.put(b"a" * 32, (b"AAA", True))
    first.put(b"b" * 32, (np.arange(3), 1, 2))
    first.close()
    second = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    assert second.get(b"a" * 32) == (b"AAA", True)
    got = second.get(b"b" * 32)
    assert np.array_equal(got[0], np.arange(3)) and got[1:] == (1, 2)
    assert second.stats()["disk_hits"] == 2
    second.close()


def test_restart_reads_a_segment_through_one_handle(tmp_path,
                                                    monkeypatch):
    """A restart's disk hits open each segment once, not once a key;
    frames appended after a store opened its handle read back in the
    next restart, and closing a store closes its handles."""
    d = str(tmp_path / "results")
    first = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    keys = [bytes([i]) * 32 for i in range(20)]
    for i, k in enumerate(keys[:10]):
        first.put(k, (b"V%d" % i, True))
    first.close()
    opened = []
    real_open = os.open
    monkeypatch.setattr(os, "open", lambda p, *a, **kw: (
        opened.append(p), real_open(p, *a, **kw))[1])
    second = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    for i, k in enumerate(keys[:10]):
        assert second.get(k) == (b"V%d" % i, True)
    assert len(opened) == 1
    for i, k in enumerate(keys[10:], 10):
        second.put(k, (b"V%d" % i, True))
    third = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    assert [third.get(k) for k in keys] == [(b"V%d" % i, True)
                                            for i in range(20)]
    assert third.stats()["disk_hits"] == 20
    # one segment (one pid appends to one file): one handle a store
    assert len(opened) == 2
    fds = list(third._fds.values())
    third.close()
    second.close()
    for fd in fds:
        with pytest.raises(OSError):
            os.fstat(fd)


def test_corrupt_segment_is_a_miss_never_wrong_bytes(tmp_path):
    d = str(tmp_path / "results")
    w = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    w.put(b"a" * 32, b"PAYLOAD-A")
    w.put(b"b" * 32, b"PAYLOAD-B")
    w.close()
    (seg,) = [os.path.join(d, n) for n in os.listdir(d)]
    raw = bytearray(open(seg, "rb").read())
    # one byte inside the first data frame's blob: the frame still
    # parses, so only the crc can catch it
    length = struct.unpack(">I", raw[:4])[0]
    blob_off = 4 + length + 4 + 32 + 4
    raw[blob_off + 2] ^= 0xFF
    open(seg, "wb").write(bytes(raw))
    r = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    assert r.get(b"a" * 32) is MISS
    assert r.get(b"b" * 32) == b"PAYLOAD-B"
    r.close()


def test_torn_tail_tolerated(tmp_path):
    d = str(tmp_path / "results")
    w = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    w.put(b"a" * 32, b"PAYLOAD-A")
    w.close()
    (seg,) = [os.path.join(d, n) for n in os.listdir(d)]
    with open(seg, "ab") as f:              # a crash mid-append
        f.write(struct.pack(">I", 500) + b"torn")
    r = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    assert r.get(b"a" * 32) == b"PAYLOAD-A"
    r.close()


def test_shared_directory_never_mixes_the_packages(tmp_path):
    """The JAX package's segments and the port's sit in one directory;
    neither store indexes the other's, even for the same key."""
    d = str(tmp_path / "results")
    key = b"s" * 32
    jw = JaxResultCache(budget_bytes=1 << 20, persist_dir=d)
    jw.put(key, b"FROM-JAX")
    jw.close()
    pw = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    assert pw.get(key) is MISS
    pw.put(key, b"FROM-PORT")
    pw.close()
    pr = ResultCache(budget_bytes=1 << 20, persist_dir=d)
    jr = JaxResultCache(budget_bytes=1 << 20, persist_dir=d)
    assert pr.get(key) == b"FROM-PORT"
    assert jr.get(key) == b"FROM-JAX"
    pr.close()
    jr.close()
    jax_cache._reset_for_tests()


def test_sketch_matches_jax_and_tracks_the_live_keys(tmp_path):
    """The digest sketch (for placement by a router) holds the same
    bits as the JAX package's for the same keys, and follows fills and
    evictions; the export is tagged with the port's epoch."""
    from racon_tpu.cache import sketch as jax_sketch
    from racon_tpu_torch.cache import sketch

    rng = np.random.default_rng(5)
    keys = [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            for _ in range(50)]
    ours, theirs = sketch.DigestSketch(), jax_sketch.DigestSketch()
    for k in keys:
        ours.add(k)
        theirs.add(k)
    for k in keys[:10]:
        ours.discard(k)
        theirs.discard(k)
    doc = ours.export("e", 40)
    assert sketch.decode_bits(doc) == jax_sketch.decode_bits(
        {**theirs.export("e", 40), "schema": jax_sketch.SKETCH_SCHEMA})
    assert sketch.hit_fraction(doc, keys[10:]) == 1.0
    blob_len = len(codec.encode(b"x" * 100))
    c = ResultCache(budget_bytes=blob_len * 2)
    c.put(keys[0], b"x" * 100)
    assert c.stats()["sketch_adds"] == 0        # no reader yet: not kept
    live = c.sketch_doc()                       # built from the live keys
    assert sketch.hit_fraction(live, keys[:1]) == 1.0
    for k in keys[1:3]:
        c.put(k, b"x" * 100)
    live = c.sketch_doc()
    assert live["epoch"] == keying.engine_epoch().hex()
    assert sketch.hit_fraction(live, keys[1:3]) == 1.0
    assert c.stats()["sketch_drops"] == 1      # keys[0] evicted
    # the process cache's module entry points
    assert cache.sketch_doc() is None           # not built yet: cold
    cache.note_content(keys[0])
    assert sketch.hit_fraction(cache.sketch_doc(), keys[:1]) == 1.0
    assert cache.stats()["sketch_content"] == 1


def test_persist_knob_resolves_under_the_cache_root(monkeypatch, tmp_path):
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_PERSIST", "1")
    assert cache.persist_dir() == os.path.join(str(tmp_path), "results")
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_PERSIST", "0")
    assert cache.persist_dir() is None
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_PERSIST", str(tmp_path / "x"))
    assert cache.persist_dir() == str(tmp_path / "x")


# ---------------------------------------------------------------------------
# end to end: the tiers write the same bytes
# ---------------------------------------------------------------------------

def _fasta(polished):
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in polished)


def _polish(paths, engine):
    kw = {} if engine == "plain" else dict(
        cuda_poa_batches=1, cuda_aligner_batches=1, device="cpu")
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, 2, **kw)
    try:
        pol.initialize()
        return _fasta(pol.polish(True))
    finally:
        pol.close()


def _store_bytes(root):
    path = os.path.join(root, "calibration.json")
    return open(path, "rb").read() if os.path.exists(path) else None


@pytest.mark.parametrize("engine", ["plain", "cuda_cpu"])
def test_cache_tiers_are_byte_neutral(small_set, tmp_path, monkeypatch,
                                      engine):
    """Cache off (the golden), cold with the persistent tier on, warm
    (same process), and a restart that reads the segments: the same
    bytes; the warm and restart runs hit.  The CUDA path runs all on
    the device (its bytes then depend on no rate), in chunks of 4
    pairs so its rungs store rates; the cold run stores them, and the
    warm run, all hits, leaves the store unchanged."""
    paths = (small_set["reads"], small_set["paf"], small_set["draft"])
    root = str(tmp_path / "root")
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", root)
    monkeypatch.setenv("RACON_TPU_TORCH_ALIGN_DEVICE_ONLY", "1")
    monkeypatch.setenv("RACON_TPU_TORCH_POA_DEVICE_ONLY", "1")
    monkeypatch.setattr(CudaPolisher, "CPU_ALIGN_BATCH", 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        monkeypatch.setenv("RACON_TPU_TORCH_CACHE", "0")
        golden = _polish(paths, engine)
        assert golden.startswith(b">")
        monkeypatch.setenv("RACON_TPU_TORCH_CACHE", "1")
        monkeypatch.setenv("RACON_TPU_TORCH_CACHE_PERSIST", "1")
        os.makedirs(root, exist_ok=True)
        if os.path.exists(os.path.join(root, "calibration.json")):
            os.remove(os.path.join(root, "calibration.json"))
        cold = _polish(paths, engine)
        assert cold == golden
        assert cache.stats()["fills"] > 0
        stored = _store_bytes(root)
        if engine == "cuda_cpu":
            assert stored is not None
        h0 = REGISTRY.value("cache_hit")
        warm = _polish(paths, engine)
        assert warm == golden
        assert REGISTRY.value("cache_hit") > h0
        assert _store_bytes(root) == stored
        cache.reset()                       # a restart: empty LRU
        restarted = _polish(paths, engine)
        assert restarted == golden
        assert cache.stats()["disk_hits"] > 0
        assert os.listdir(os.path.join(root, "results"))
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# --rounds: round 2 from the cache
# ---------------------------------------------------------------------------

def test_round2_hits_on_a_converged_draft(small_set, tmp_path):
    """From a draft that polishing no longer moves, round 2's windows
    are round 1's and come back from the cache
    (tests/test_overlap_discovery.py:312 on the port)."""
    args = (PolisherType.kC, 500, 10.0, 0.3, True, 5, -4, -8, 2)
    seqs, pol = polish_rounds(small_set["reads"], None, small_set["draft"],
                              *args, rounds=2)
    pol.close()
    fixed = str(tmp_path / "fixed.fasta")
    write_fasta(fixed, seqs)
    cache.reset()
    out, pol = polish_rounds(small_set["reads"], None, fixed, *args,
                             rounds=2)
    pol.close()
    report = pol.rounds_report
    assert _fasta(out).startswith(b">")
    assert report[0]["cache_hit"] == 0
    assert report[1]["cache_hit"] > 0, report
