"""The port's device executor (racon_tpu_torch/cuda/executor.py)
against the JAX package's (racon_tpu/tpu/executor.py).

* fusion mechanics, fairness and containment on a stub engine
  (tests/test_executor.py on the port): two tenants fuse, one tenant
  is a passthrough, the off switch, a handle counts only its own
  windows, the quota holds back a saturated tenant and is
  work-conserving, DRR shares a batch, a large job cannot starve a
  small tenant, a poisoned unit fails only its own tenant;
* one scripted submission sequence forms the same fused batches, in
  the same order, through the port's and the JAX executors;
* the port's memory envelope: a fused POA batch fits every
  participant's megabatch size at its own depth, a fused align chunk
  never exceeds the largest participant's chunk size, and a window's
  or pair's plain-version result does not depend on the batch it rides
  in (so the cache key need not name the batch);
* three ``CudaPolisher(device="cpu")`` polishes in threads as three
  tenants: fused, the bytes of ``RACON_TPU_TORCH_FUSE=0``, with cross-
  tenant fused launches and each tenant's own counters.
"""

import threading
import time

import numpy as np
import pytest
import torch

from racon_tpu.tpu import executor as jax_ex_mod
from racon_tpu_torch import cache
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.cuda import align
from racon_tpu_torch.cuda import executor as ex_mod
from racon_tpu_torch.cuda.executor import (DeviceExecutor, PoaEngineHandle,
                                           _FusedBatchError, _Unit)
from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine, DispatchStats
from racon_tpu_torch.obs import REGISTRY, devutil
from racon_tpu_torch.obs.flight import FLIGHT
from racon_tpu_torch.tools import simulate
from tests.test_torch_align_wfa import mutate, seq

FUSE_KNOBS = ("RACON_TPU_TORCH_FUSE", "RACON_TPU_TORCH_FUSE_FORCE",
              "RACON_TPU_TORCH_FUSE_WAIT_MS",
              "RACON_TPU_TORCH_SERVE_TENANT_QUOTA")


@pytest.fixture(autouse=True)
def fresh_executor(monkeypatch):
    for knob in FUSE_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    ex_mod._reset_for_tests()
    cache.reset()
    yield
    ex_mod._reset_for_tests()
    cache.reset()


# ---------------------------------------------------------------------------
# stub engine: deterministic, records every dispatched batch
# ---------------------------------------------------------------------------

class StubEngine:
    device = None
    wb = 128

    def __init__(self, poison=None, poison_at="dispatch"):
        self.batches = []
        self.utils = []
        self.lock = threading.Lock()
        self.poison = poison
        self.poison_at = poison_at

    def depth_cap(self, windows):
        return 8

    def consensus_batch_async(self, windows, trim, util=None, pool=None):
        windows = list(windows)
        if self.poison in windows and self.poison_at == "dispatch":
            raise RuntimeError("poisoned window at dispatch")
        with self.lock:
            self.batches.append(windows)
            self.utils.append(util)
        out = [("res", w) for w in windows]

        def collect():
            if self.poison in windows and self.poison_at == "collect":
                raise RuntimeError("poisoned window at collect")
            st = DispatchStats(len(windows))
            st.on_kernel[:] = True
            st.cells[:] = 10
            st.kernel_ms = 2.0 * len(windows)
            collect.stats = st
            return out

        collect.kernel_ms = lambda: 2.0 * len(windows)
        collect.device_s = lambda: 0.0
        return collect


def _handle(ex, eng, tenant, cap=0):
    return PoaEngineHandle(ex, eng, tenant, cap)


# ---------------------------------------------------------------------------
# fusion mechanics
# ---------------------------------------------------------------------------

def test_two_tenants_fuse_into_one_dispatch(monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE_WAIT_MS", "200")
    ex = DeviceExecutor()
    eng = StubEngine()
    ex.register_tenant("a")
    ex.register_tenant("b")
    try:
        ha = _handle(ex, eng, "a", cap=8)
        hb = _handle(ex, eng, "b", cap=8)
        ca = ex.submit_poa(ha, ["a1", "a2"], True)
        cb = ex.submit_poa(hb, ["b1"], True)
        assert ca() == [("res", "a1"), ("res", "a2")]
        assert cb() == [("res", "b1")]
    finally:
        ex.close()
    # one shared dispatch carried both tenants' units, demuxed by slice
    assert len(eng.batches) == 1
    assert sorted(eng.batches[0]) == ["a1", "a2", "b1"]
    # each handle counts its own windows, and its share of the time
    assert ha.windows_on_kernel == 2 and hb.windows_on_kernel == 1
    assert ca.kernel_ms() == pytest.approx(4.0)
    assert cb.kernel_ms() == pytest.approx(2.0)


def test_single_tenant_is_passthrough():
    ex = DeviceExecutor()
    eng = StubEngine()
    util = devutil.DeviceUtil()
    h = PoaEngineHandle(ex, eng, None, 0, util=util)
    coll = ex.submit_poa(h, ["w1"], True)
    assert coll() == [("res", "w1")]
    assert len(eng.batches) == 1
    assert eng.utils == [util]           # the polisher's own lanes
    assert ex._dispatcher is None        # no dispatcher thread
    ex.close()


def test_fuse_off_switch(monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE", "0")
    ex = DeviceExecutor()
    eng = StubEngine()
    ex.register_tenant("a")
    ex.register_tenant("b")
    coll = ex.submit_poa(_handle(ex, eng, "a"), ["w1"], True)
    assert coll() == [("res", "w1")]
    assert ex._dispatcher is None
    ex.close()


def test_handle_counters_are_deltas():
    """A handle counts the windows its own collects brought back; other
    handles on the shared engine, made before or after, count none of
    them (the engine keeps no counters)."""
    ex = DeviceExecutor()
    eng = CudaPoaBatchEngine(5, -4, -8, device="cpu", vcap=512, lcap=256)
    h = _handle(ex, eng, None)
    other = _handle(ex, eng, None)
    assert h.consensus_batch_async([_window(1, 3)], True)()[0][1] is True
    later = _handle(ex, eng, None)
    assert h.windows_on_kernel == 1 and h.cells > 0
    assert sum(h.reject_counts.values()) == 0
    assert other.windows_on_kernel == later.windows_on_kernel == 0
    assert other.cells == later.cells == 0
    ex.close()


# ---------------------------------------------------------------------------
# fairness: DRR + in-flight quota
# ---------------------------------------------------------------------------

def _seed_bucket(ex, units, unit_cls=_Unit, key=("poa", 0, True)):
    """Place units straight in a bucket (no dispatcher thread), so
    _form_batch's pick is deterministic."""
    made = []
    for tenant, size, cap in units:
        u = unit_cls("poa", tenant, [f"{tenant}{i}" for i in range(size)],
                     size, cap, None)
        made.append(u)
        ex._buckets.setdefault(key, []).append(u)
        ex._n_pending += 1
    return key, made


def test_quota_blocks_saturated_tenant(monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_SERVE_TENANT_QUOTA", "1")
    ex = DeviceExecutor()
    ex.register_tenant("big")
    ex.register_tenant("small")
    ex._inflight["big"] = 1
    key, _ = _seed_bucket(ex, [("big", 8, 8), ("big", 8, 8),
                               ("small", 2, 8)])
    picked, _, _ = ex._form_batch(key)
    assert [u.tenant for u in picked] == ["small"]
    assert sum(1 for u in ex._buckets[key] if u.tenant == "big") == 2
    ex.close()


def test_quota_is_work_conserving(monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_SERVE_TENANT_QUOTA", "1")
    ex = DeviceExecutor()
    ex.register_tenant("big")
    ex.register_tenant("other")
    ex._inflight["big"] = 3
    key, _ = _seed_bucket(ex, [("big", 4, 8)])
    picked, _, _ = ex._form_batch(key)
    assert [u.tenant for u in picked] == ["big"]
    ex.close()


def test_drr_shares_batch_across_tenants():
    ex = DeviceExecutor()
    ex.register_tenant("a")
    ex.register_tenant("b")
    key, _ = _seed_bucket(ex, [("a", 4, 8), ("a", 4, 8), ("a", 4, 8),
                               ("b", 4, 8)])
    picked, total, target = ex._form_batch(key)
    assert total <= target == 8
    assert {u.tenant for u in picked} == {"a", "b"}
    ex.close()


def test_large_job_cannot_starve_small_tenant(monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_SERVE_TENANT_QUOTA", "1")
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE_WAIT_MS", "5")
    ex = DeviceExecutor()
    eng = StubEngine()
    ex.register_tenant("big")
    ex.register_tenant("small")
    try:
        hb = _handle(ex, eng, "big", cap=4)
        hs = _handle(ex, eng, "small", cap=4)
        big = [ex.submit_poa(hb, [f"big{i}"], True) for i in range(16)]
        small = ex.submit_poa(hs, ["small0"], True)
        t0 = time.monotonic()
        assert small() == [("res", "small0")]
        # well under the time 16 serialized big batches would take
        assert time.monotonic() - t0 < 5.0
        # the big tenant's backlog had not drained when small0 ran
        done = next(k for k, b in enumerate(eng.batches) if "small0" in b)
        assert sum(len(b) for b in eng.batches[:done]) < 16
        for i, c in enumerate(big):
            assert c() == [("res", f"big{i}")]
    finally:
        ex.close()


# ---------------------------------------------------------------------------
# crash containment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("poison_at", ["dispatch", "collect"])
def test_poisoned_unit_fails_only_its_job(monkeypatch, poison_at):
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE_WAIT_MS", "200")
    ex = DeviceExecutor()
    eng = StubEngine(poison="bad", poison_at=poison_at)
    for t in ("a", "b", "c"):
        ex.register_tenant(t)
    seen = FLIGHT.stats()["recorded"]
    try:
        ca = ex.submit_poa(_handle(ex, eng, "a", cap=16), ["a1", "a2"],
                           True)
        cb = ex.submit_poa(_handle(ex, eng, "b", cap=16), ["bad"], True)
        cc = ex.submit_poa(_handle(ex, eng, "c", cap=16), ["c1"], True)
        # healthy tenants succeed through their own retries ...
        assert ca() == [("res", "a1"), ("res", "a2")]
        assert cc() == [("res", "c1")]
        # ... only the poisoned tenant's collect raises
        with pytest.raises(RuntimeError, match="poisoned"):
            cb()
    finally:
        ex.close()
    # the three units rode one fused dispatch, and each retried alone
    new = FLIGHT.snapshot(last=FLIGHT.stats()["recorded"] - seen)
    assert sorted(e["tenant"] for e in new
                  if e["kind"] == "unit_retry") == ["a", "b", "c"]


def test_fused_error_wrapper_preserves_cause():
    err = _FusedBatchError(ValueError("boom"))
    assert isinstance(err.cause, ValueError)


# ---------------------------------------------------------------------------
# parity: the same batches as the JAX executor
# ---------------------------------------------------------------------------

def _script(seed=3, n=14):
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c"]
    return [(tenants[int(rng.integers(0, 3))], int(rng.integers(1, 9)),
             int(rng.choice([0, 8, 12]))) for _ in range(n)]


def _batches(ex, unit_cls):
    for name, weight in (("a", 1.0), ("b", 2.0), ("c", 1.0)):
        ex.register_tenant(name, weight)
    key, _ = _seed_bucket(ex, _script(), unit_cls)
    formed, inflight = [], []
    for _ in range(100):
        if not ex._buckets.get(key):
            break
        picked, total, target = ex._form_batch(key)
        formed.append(([(u.tenant, tuple(u.payload)) for u in picked],
                       total, target))
        inflight.append(picked)
        # the batch formed two steps back completes: its slots free
        if len(inflight) > 2:
            for u in inflight.pop(0):
                ex._inflight[u.tenant] -= 1
    return formed


def test_same_batches_as_the_jax_executor(monkeypatch):
    monkeypatch.setenv("RACON_TPU_TORCH_SERVE_TENANT_QUOTA", "2")
    monkeypatch.setenv("RACON_TPU_SERVE_TENANT_QUOTA", "2")
    port = _batches(DeviceExecutor(), _Unit)
    ref = _batches(jax_ex_mod.DeviceExecutor(), jax_ex_mod._Unit)
    assert port == ref
    assert len(port) > 3 and any(len({t for t, _ in b}) > 1
                                 for b, _, _ in port)


@pytest.mark.parametrize("adapt", ["0", "1"])
def test_adaptive_window_follows_the_jax_executor(monkeypatch, adapt):
    """One occupancy sequence through both executors: the same window
    after every dispatch, always within [0, the ceiling]; off, the
    static window."""
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE_WAIT_MS", "100")
    monkeypatch.setenv("RACON_TPU_FUSE_WAIT_MS", "100")
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE_ADAPT", adapt)
    monkeypatch.setenv("RACON_TPU_FUSE_ADAPT", adapt)
    port, ref = DeviceExecutor(), jax_ex_mod.DeviceExecutor()
    occ = [1.0] * 40 + [0.0] * 80 + [0.7] * 8 + [0.2, 1.0] * 12
    waits = []
    for o in occ:
        port._adapt_tick(o)
        ref._adapt_tick(o)
        w = port._current_fuse_wait_s()
        assert w == pytest.approx(ref._current_fuse_wait_s())
        assert 0.0 <= w <= 0.1
        waits.append(w)
    if adapt == "1":
        assert min(waits) < 0.05 and max(waits) == pytest.approx(0.1)
        assert REGISTRY.value("fusion_wait_ms") == pytest.approx(
            port._adapt_wait_s * 1e3)
    else:
        assert set(waits) == {0.1}
    assert port.stats()["fuse_adapt"] is (adapt == "1")


# ---------------------------------------------------------------------------
# the memory envelope (a departure from the JAX package)
# ---------------------------------------------------------------------------

def _drain(ex, key):
    out = []
    while ex._buckets.get(key):
        picked, total, _ = ex._form_batch(key)
        assert picked
        for u in picked:
            ex._inflight[u.tenant] -= 1
        out.append(picked)
    return out


def test_fused_poa_batch_fits_megabatch_size_at_its_depth():
    """Each unit carries its polisher's megabatch size; the fused batch
    must also fit ``size_at(d1)`` at the deepest member's depth."""
    def size_at(d1):
        return 96 * 8 // d1            # memory per window grows with d1

    ex = DeviceExecutor()
    ex.register_tenant("a")
    ex.register_tenant("b")
    key, units = _seed_bucket(ex, [("a", 20, 96), ("b", 20, 24),
                                   ("a", 20, 96), ("b", 4, 24),
                                   ("a", 30, 96)])
    for u, d1 in zip(units, (8, 32, 8, 32, 16)):
        u.d1, u.size_at = d1, size_at
    batches = _drain(ex, key)
    assert sum(len(b) for b in batches) == len(units)
    assert any(len(b) > 1 for b in batches)
    for b in batches:
        if len(b) > 1:
            d1 = max(u.d1 for u in b)
            assert sum(u.size for u in b) <= size_at(d1)


def test_fused_align_chunk_within_largest_participant_cap():
    ex = DeviceExecutor()
    ex.register_tenant("a")
    ex.register_tenant("b")
    key, units = _seed_bucket(ex, [("a", 5, 8), ("b", 6, 16), ("a", 3, 8),
                                   ("b", 9, 16), ("a", 8, 8)],
                              key=("wfa", 512, 512, "cpu"))
    batches = _drain(ex, key)
    assert sum(len(b) for b in batches) == len(units)
    for b in batches:
        assert sum(u.size for u in b) <= max(u.cap for u in b)


def _window(seed, n_layers, length=120):
    rng = np.random.default_rng(seed)
    bb = bytes(rng.choice(list(b"ACGT"), length).astype(np.uint8))
    w = Window(0, 0, WindowType.TGS, bb, b"+" * length)
    for _ in range(n_layers):
        s = bytearray(bb)
        for k in rng.integers(0, length, 6):
            s[k] = int(rng.choice(list(b"ACGT")))
        w.add_layer(bytes(s), b"+" * length, 0, length)
    return w


def test_window_result_independent_of_batch():
    """The plain version gives a window the same consensus in two
    megabatches of other windows and other depths (depth caps 16 and
    32): the cache key holds what the result depends on, and nothing
    that only batches it."""
    torch.set_num_threads(1)
    eng = CudaPoaBatchEngine(5, -4, -8, device="cpu", vcap=512, lcap=256)
    a, b, c = _window(1, 3), _window(2, 12), _window(3, 20)
    assert eng.depth_cap([a, b]) != eng.depth_cap([c, a])
    first = eng.consensus_batch([a, b], True)
    second = eng.consensus_batch([c, a], True)
    assert first[0] == second[1] and first[0][1] is True


@pytest.mark.parametrize("kernel", ["wfa", "band"])
def test_pair_result_independent_of_chunk(kernel):
    rng = np.random.default_rng(7)
    base = [seq(n, rng) for n in (300, 500, 420)]
    qs = [mutate(s, 0.05, rng) for s in base]
    lq = 512

    def run(idx):
        q, t = [qs[i] for i in idx], [base[i] for i in idx]
        if kernel == "wfa":
            return align.wfa_dispatch(q, t, lq, 128, "cpu")()
        return align.band_dispatch(q, t, lq, lq, 256, "cpu")()

    one = run([1])
    mixed = run([0, 1, 2])
    n = int(one[1][0])
    assert int(mixed[1][1]) == n and int(mixed[2][1]) == int(one[2][0])
    assert np.array_equal(one[0][0][:n], mixed[0][1][:n])


# ---------------------------------------------------------------------------
# three tenants end to end: fused bytes == FUSE=0 bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    out = tmp_path_factory.mktemp("exec_sim")
    return simulate.simulate(str(out), genome_len=3_000, coverage=5,
                             read_len=600, seed=21, ont=True)


def _polish(paths, tenant=None):
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          5, -4, -8, 2, cuda_poa_batches=1,
                          cuda_aligner_batches=1, device="cpu")
    pol._executor_tenant = tenant
    try:
        pol.initialize()
        out = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                       for s in pol.polish(True))
    finally:
        pol.close()
    return out, pol


def test_three_tenants_fused_bytes_equal_unfused(small_set, monkeypatch):
    """Fusion forced, three registered tenants polishing in threads: the
    bytes of the unfused run, launches shared across tenants, each
    tenant's POA counters its own windows only, and the fused launches'
    intervals in the process DEVICE_UTIL."""
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE", "0")
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", "")
    monkeypatch.setenv("RACON_TPU_TORCH_ALIGN_DEVICE_ONLY", "1")
    monkeypatch.setenv("RACON_TPU_TORCH_POA_DEVICE_ONLY", "1")
    torch.set_num_threads(1)
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE", "0")
    solo, solo_pol = _polish(small_set)
    assert solo.startswith(b">")
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE", "1")
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE_FORCE", "1")
    monkeypatch.setenv("RACON_TPU_TORCH_FUSE_WAIT_MS", "50")
    ex = ex_mod.get_executor()
    names = ("t0", "t1", "t2")
    for name in names:
        ex.register_tenant(name)
    cross0 = REGISTRY.value("fused_cross_tenant")
    devutil.DEVICE_UTIL.reset()
    out, errors = {}, []

    def job(name):
        try:
            out[name] = _polish(small_set, name)
        except BaseException as exc:     # reported below
            errors.append(exc)

    threads = [threading.Thread(target=job, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        assert not t.is_alive()
    for name in names:
        ex.release_tenant(name)
    assert not errors, errors
    assert all(out[n][0] == solo for n in names)
    assert REGISTRY.value("fused_cross_tenant") > cross0
    for n in names:
        pol = out[n][1]
        assert pol.poa_engine.size_at == pol._megabatch_size
        assert pol.poa_engine.windows_on_kernel \
            == solo_pol.poa_engine.windows_on_kernel > 0
        assert pol.poa_engine.cells == solo_pol.poa_engine.cells
        assert set(pol.device_util.snapshot()) >= {"poa", "align_wfa"}
    assert set(devutil.DEVICE_UTIL.snapshot()) >= {"poa", "align_wfa"}
