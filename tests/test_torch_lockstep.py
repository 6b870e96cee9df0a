"""The port's lockstep POA engine (racon_tpu_torch/cuda/poa.py,
cuda/poa_lockstep.py, native/poa_batch.cpp) against the JAX package's
(racon_tpu/tpu/poa.py: ``_poa_kernel``, ``_poa_kernel_banded``,
``TPUPoaBatchEngine``'s lockstep half).

Rounds: the arrays ``rt_poab_export`` writes for seeded windows (and
constructed ones for the band's lag drop) go through
``poa_round_reference`` and the JAX kernels jitted on the JAX CPU
backend; every score is an integer held exactly in float32 and the
rounding near -2**28 is IEEE's in both, so node and seq tapes must be
equal, tolerance 0.  Engine: the port's lockstep batch and the JAX
engine's (its lockstep path on the CPU) give the same consensus bytes
and reject counts.  End to end: ``-w 1000`` and ``-w 10000`` polish,
byte-identical to the JAX package's CLI (the port raised at the first
before the lockstep engine, at the second before the kernel walked a
row tile by tile).  The JAX package is imported inside the tests only, so
``pytest -m cuda`` on the card imports no JAX; the ``cuda`` test holds
the kernel against its plain version there.
"""

import io
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from racon_tpu_torch import cache, cli
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.cuda import poa_lockstep as pl
from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.tools.lockstep_rounds import (capture_rounds, lag_round,
                                                   max_band_lag, widen)
from racon_tpu_torch.utils.tuning import poa_band_cols, pow2_at_least

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = dict(match=5, mismatch=-4, gap=-8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain version's small tensor ops on one intra-op thread:
    beside other test processes a team of spinning threads per op
    slows them tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def cold_result_cache():
    cache.reset()
    yield
    cache.reset()


def _seq(n, rng):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def _mutate(s, rate, rng):
    out = bytearray()
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            out.append(rng.choice([b for b in b"ACGT" if b != ch]))
        elif r < 2 * rate / 3:
            continue
        elif r < rate:
            out += bytes([ch, rng.choice(b"ACGT")])
        else:
            out.append(ch)
    return bytes(out)


def make_window(truth, depth, rate, rng, wtype=WindowType.TGS,
                backbone=None, span=None):
    """A window over ``truth``: a mutated backbone and ``depth`` mutated
    layers with qualities, over the whole backbone or over ``span``
    (tests/test_tpu_poa.py:make_window's recipe)."""
    bb = backbone if backbone is not None else _mutate(truth, rate, rng)
    w = Window(0, 0, wtype, bb, b"!" * len(bb))
    for _ in range(depth):
        layer = _mutate(truth, rate, rng)
        qual = bytes(rng.randrange(50, 80) for _ in range(len(layer)))
        w.add_layer(layer, qual, *(span or (0, len(bb) - 1)))
    return w


def to_jax(w):
    """The same window as the JAX package's Window."""
    from racon_tpu.core.window import Window as JWindow
    from racon_tpu.core.window import WindowType as JType

    j = JWindow(w.id, w.rank, JType(w.type.value), w.sequences[0],
                w.qualities[0])
    for s, q, (b, e) in zip(w.sequences[1:], w.qualities[1:],
                            w.positions[1:]):
        j.add_layer(s, q, b, e)
    return j


def capture(windows, *, vcap, lcap, keep=None):
    """The rounds the port's lockstep engine dispatches for ``windows``
    on the CPU: (arrays at the round's shape, v_b, l_b, wb)."""
    eng = CudaPoaBatchEngine(5, -4, -8, device="cpu", vcap=vcap, lcap=lcap)
    return [r[1:] for r in capture_rounds(eng, windows, keep)]


def jax_round(arrs, v, l, p, k, wb):
    import jax.numpy as jnp

    from racon_tpu.tpu.poa import _poa_kernel, _poa_kernel_banded

    a = [jnp.asarray(x) for x in arrs]
    if wb:
        nt, st = _poa_kernel_banded(*a, v, l, p, k, wb, 5, -4, -8)
    else:
        nt, st = _poa_kernel(*a, v, l, p, k, 5, -4, -8)
    return np.asarray(nt), np.asarray(st)


def port_round(arrs, v, l, p, k, wb, device="cpu"):
    t = [torch.from_numpy(x).to(device) for x in arrs]
    nt, st = pl.poa_round(*t, v=v, l=l, p=p, k=k, wb=wb, **SCORES)
    return nt.cpu().numpy(), st.cpu().numpy()


# ---------------------------------------------------------------------------
# rounds: poa_round_reference == the JAX kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported():
    """Exported rounds at the three shapes the engine takes: l_b 128
    unbanded, l_b 1024 at wb 256, l_b 2048 at wb 512."""
    rng = random.Random(7)
    out = {}
    t = _seq(100, rng)
    wins = [make_window(t, 5, 0.1, rng) for _ in range(3)]
    # a thin window: its lane has fewer ranks than the bucket
    wins.append(make_window(_seq(40, rng), 2, 0.1, rng))
    out["l128"] = capture(wins, vcap=512, lcap=256, keep={1, 4})
    t = _seq(560, rng)
    wins = [make_window(t, 3, 0.1, rng) for _ in range(2)]
    out["l1024"] = capture(wins, vcap=2048, lcap=1024, keep={2})
    t = _seq(1100, rng)
    wins = [make_window(t, 2, 0.08, rng) for _ in range(2)]
    wins.append(make_window(_seq(1050, rng), 2, 0.08, rng))
    out["l2048"] = capture(wins, vcap=4096, lcap=2048, keep={1})
    return out


@pytest.mark.parametrize("case,l_b,wb", [("l128", 128, 0),
                                         ("l1024", 1024, 256),
                                         ("l2048", 2048, 512)])
def test_round_reference_matches_jax_kernel(exported, case, l_b, wb):
    rounds = exported[case]
    assert rounds
    short = False
    for arrs, v_b, lb, w in rounds:
        assert (lb, w) == (l_b, wb)
        short |= bool((arrs[2] < v_b).any())
        want = jax_round(arrs, v_b, lb, 16, 128, w)
        got = port_round(arrs, v_b, lb, 16, 128, w)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # a lane with fewer ranks than the round's bucket (nrows < v_b)
    assert short


@pytest.mark.parametrize("case,l,wb,lanes", [("l2048", 4096, 1024, 3),
                                             ("l1024", 1024, 0, 2),
                                             ("l1024", 32768, 8192, 1),
                                             ("l1024", 65536, 16384, 1)])
def test_round_reference_matches_jax_kernel_wide(exported, case, l, wb,
                                                 lanes):
    """Real rounds at wider shapes: widened to a 4,096-base layer bucket
    (the band of 1,024 columns that -w above 1,024 gives), a 1,024-base
    row unbanded (1,025 columns), and bands of 8,192 and 16,384 columns
    (-w above 8,192 and 16,384: layers past 16,384 and 32,768 bases),
    which the kernel walks tile by tile; at those two the first lane
    alone (both versions' time follows the lanes x columns)."""
    rounds = exported[case]
    assert rounds
    for arrs, v_b, _, _ in rounds:
        arrs = [np.ascontiguousarray(a[:lanes]) for a in widen(arrs, l)]
        want = jax_round(arrs, v_b, l, 16, 128, wb)
        got = port_round(arrs, v_b, l, 16, 128, wb)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("empty", ["one_lane", "every_lane"])
@pytest.mark.parametrize("case,wb", [("l128", 0), ("l1024", 256)])
def test_round_reference_matches_jax_kernel_empty_lanes(exported, case, wb,
                                                        empty):
    """Lanes of no ranks (no sink to end on: the walk starts at row 0
    and moves left along the layer), beside real lanes or alone, where
    the round has no rank at all."""
    arrs, v_b, l_b, _ = exported[case][0]
    arrs = [a.copy() for a in arrs]
    gone = slice(0, 1) if empty == "one_lane" else slice(None)
    arrs[0][gone] = 0
    arrs[1][gone] = -1
    arrs[2][gone] = 0
    arrs[3][gone] = 0
    want = jax_round(arrs, v_b, l_b, 16, 128, wb)
    got = port_round(arrs, v_b, l_b, 16, 128, wb)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_round_reference_matches_jax_kernel_band_lag_drop():
    """Constructed rounds: preds up to 64 ranks back at wb 32 (quantum
    8) lag 5 or more quanta, so the kernels read them as -inf; at wb 0
    the same arrays take the unbanded kernel."""
    arrs, v, l, p, k = lag_round()
    assert max_band_lag(arrs, 32) >= pl.N_SHIFT
    for wb in (32, 0):
        want = jax_round(arrs, v, l, p, k, wb)
        got = port_round(arrs, v, l, p, k, wb)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_poa_round_checks_its_inputs():
    arrs, v, l, p, k = lag_round(b=1, v=128, l=128)
    t = [torch.from_numpy(x) for x in arrs]
    with pytest.raises(ValueError, match="power of two"):
        pl.poa_round(*t, v=v, l=l, p=p, k=48, wb=0, **SCORES)
    with pytest.raises(ValueError, match="bases must be"):
        pl.poa_round(*t, v=v + 1, l=l, p=p, k=k, wb=0, **SCORES)
    with pytest.raises(ValueError, match="multiple of 4"):
        pl.poa_round(*t, v=v, l=l, p=p, k=k, wb=30, **SCORES)
    bad = list(t)
    bad[1] = bad[1].to(torch.int32)
    with pytest.raises(ValueError, match="preds must be"):
        pl.poa_round(*bad, v=v, l=l, p=p, k=k, wb=0, **SCORES)
    # only a CPU tensor takes the plain version: any other device
    # launches the kernel or raises
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="unsupported device"):
        pl.poa_round(*meta, v=v, l=l, p=p, k=k, wb=0, **SCORES)


@pytest.mark.parametrize("wb", [8192, 16384])
def test_check_inputs_takes_wide_rounds(wb):
    """A banded round the JAX kernel takes passes the input check: v_b
    32,768 at a 65,536-base layer bucket (v * (l + 1) past 2**31, which
    the check once refused; the kernel's offsets are 64-bit); only a v
    past MAX_V (the kernel's shared bitset of ranks) is refused."""
    v, l, p = 32768, 65536, 16

    def arrays(v):
        return (torch.zeros((1, v), dtype=torch.uint8),
                torch.zeros((1, v, p), dtype=torch.int16),
                torch.ones(1, dtype=torch.int32),
                torch.zeros((1, v), dtype=torch.uint8),
                torch.zeros((1, l), dtype=torch.uint8),
                torch.ones(1, dtype=torch.int32))

    assert pl.check_inputs(*arrays(v), v=v, l=l, p=p, k=128, wb=wb) == 1
    big = pl.MAX_V + 1
    with pytest.raises(ValueError, match="does not fit"):
        pl.check_inputs(*arrays(big), v=big, l=l, p=p, k=128, wb=wb)


# ---------------------------------------------------------------------------
# engine: the port's lockstep batch == TPUPoaBatchEngine's lockstep path
# ---------------------------------------------------------------------------

REJECT_CODES = {"vcap": -1, "pcap": -2, "kcap": -3}


def _engine_cases():
    """The windows of tests/test_tpu_poa.py's non-slow cases (with their
    caps and trim), and one window whose deletion layers reach past a
    16-row ring: a kcap reject."""
    cases = []
    rng = random.Random(11)
    for depth, rate in ((6, 0.05), (12, 0.15)):
        t = _seq(180, rng)
        cases.append(("recovers_truth", [make_window(t, depth, rate, rng)
                                         for _ in range(3)],
                      dict(vcap=512, pcap=8, lcap=256), True))
    rng = random.Random(21)
    t = _seq(550, rng)
    cases.append(("banded", [make_window(t, 10, 0.1, rng)
                             for _ in range(2)],
                  dict(vcap=2048, pcap=16, lcap=1024), True))
    rng = random.Random(5)
    t = _seq(300, rng)
    bb = _mutate(t, 0.08, rng)
    w = Window(0, 0, WindowType.TGS, bb, b"!" * len(bb))
    for lo, hi in [(0, 149), (100, 249), (150, 299), (0, 299), (50, 199),
                   (200, 299)]:
        w.add_layer(_mutate(t[lo:hi + 1], 0.08, rng), None,
                    min(lo, len(bb) - 1), min(hi, len(bb) - 1))
    cases.append(("partial_span", [w], dict(vcap=1024, pcap=8, lcap=512),
                  False))
    rng = random.Random(3)
    cases.append(("thin", [make_window(_seq(100, rng), 1, 0.1, rng)],
                  dict(vcap=256, pcap=8, lcap=128), True))
    rng = random.Random(9)
    cases.append(("vcap", [make_window(_seq(200, rng), 8, 0.3, rng)],
                  dict(vcap=128, pcap=8, lcap=256), True))
    rng = random.Random(13)
    t = _seq(150, rng)
    w = make_window(t, 5, 0.05, rng)
    w.add_layer(_seq(400, rng), None, 0, 149)       # longer than lcap
    cases.append(("overlong", [w], dict(vcap=512, pcap=8, lcap=200), True))
    rng = random.Random(17)
    t = _seq(160, rng)
    w = make_window(t, 3, 0.03, rng)
    for _ in range(2):
        w.add_layer(t[:40] + t[80:], None, 0, len(w.sequences[0]) - 1)
    cases.append(("kcap", [w, make_window(t, 3, 0.03, rng)],
                  dict(vcap=512, pcap=16, lcap=256), True))
    return cases


@pytest.mark.parametrize("case", _engine_cases(), ids=lambda c: c[0])
def test_lockstep_engine_matches_jax_engine(case):
    from racon_tpu.tpu.poa import TPUPoaBatchEngine

    name, windows, caps, trim = case
    # the kcap case: a 16-row ring in both engines
    kcap = 16 if name == "kcap" else CudaPoaBatchEngine.KCAP
    jeng = TPUPoaBatchEngine(5, -4, -8, kcap=kcap, **caps)
    want = jeng.consensus_batch([to_jax(w) for w in windows], trim=trim)
    eng = CudaPoaBatchEngine(5, -4, -8, device="cpu", **caps)
    eng.KCAP = kcap
    got, st = eng.lockstep_batch(windows, trim)
    assert got == want
    rejects = {REJECT_CODES[f]: st.fails.count(f) for f in REJECT_CODES}
    assert rejects == jeng.reject_counts
    assert int(st.skipped.sum()) == jeng.n_skipped_layers
    assert st.rounds == jeng.n_rounds
    # the JAX engine counts every lane at the round's bucket, the port
    # each lane's own ranks
    assert 0 < int(st.cells.sum()) <= jeng.cells or st.rounds == 0
    if name in ("vcap", "kcap"):
        assert rejects[REJECT_CODES[name]] >= 1


def test_engine_sends_oversized_caps_to_lockstep():
    """At -w 1000's caps (V 4096, LP 2048) the whole-window kernel does
    not fit, so the engine runs the lockstep rounds; its counters reach
    the executor's handle."""
    from racon_tpu_torch.cuda import executor

    rng = random.Random(2)
    t = _seq(120, rng)
    wins = [make_window(t, 3, 0.05, rng) for _ in range(2)]
    eng = CudaPoaBatchEngine(5, -4, -8, device="cpu", vcap=4096,
                             lcap=2048)
    assert not eng.fits(wins)
    ref, _ = eng.lockstep_batch(wins, True)
    ex = executor.DeviceExecutor()
    handle = executor.PoaEngineHandle(ex, eng, None, 0)
    try:
        coll = ex.submit_poa(handle, wins, True)
        assert coll() == ref
    finally:
        ex.close()
    assert handle.n_rounds == 3 and handle.windows_on_kernel == 2
    assert set(handle.phase_walls) == {"export", "dispatch", "apply",
                                       "extract"}


# ---------------------------------------------------------------------------
# end to end: -w 1000 polishes like the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def w1000_set(tmp_path_factory):
    from racon_tpu.tools import simulate

    out = tmp_path_factory.mktemp("w1000")
    return simulate.simulate(str(out), genome_len=4000, coverage=7,
                             read_len=1500, seed=3, ont=True)


@pytest.mark.parametrize("banded", [False, True], ids=["auto", "b"])
def test_w1000_polishes_like_jax(w1000_set, banded, monkeypatch):
    """The port's CLI at -w 1000 (all windows on the device path: the
    lockstep engine's plain version here) writes the JAX package's
    bytes; before the lockstep engine it raised."""
    flags = ["-c", "1", "-w", "1000"] + (["-b"] if banded else [])
    monkeypatch.setenv("RACON_TPU_TORCH_POA_DEVICE_ONLY", "1")
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", "")
    buf = io.BytesIO()
    pol = cli.main(["--device", "cpu", "-t", "1", *flags, *w1000_set],
                   out=buf)
    env = dict(os.environ, RACON_TPU_POA_DEVICE_ONLY="1",
               RACON_TPU_PIPELINE="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT)
    jax_out = subprocess.run(
        [sys.executable, "-m", "racon_tpu.cli", "-t", "1", *flags,
         *w1000_set], env=env, cwd=ROOT, capture_output=True, check=True)
    assert buf.getvalue() == jax_out.stdout
    assert buf.getvalue().startswith(b">")
    rounds = pol.metrics.value("poa_rounds")
    assert rounds > 0
    assert pol.poa_engine.n_rounds == rounds
    assert pol.poa_device_windows + sum(pol.poa_reject_counts.values()) \
        == pol.poa_eligible_windows


@pytest.mark.parametrize("banded", [False, True], ids=["auto", "b"])
@pytest.mark.parametrize("w", [8193, 16385, 20000, 40000])
def test_window_length_past_the_kernel_is_refused(w1000_set, w, banded):
    """No -w is refused any more: a -w whose lockstep rounds pass 4,096
    columns (above 8,192, 16,384 with -b) once raised InvalidInputError
    when the polisher was made; the kernel now walks a row of any width
    tile by tile, so the polisher is made, with the caps the JAX
    package takes."""
    pol = create_polisher(*w1000_set, PolisherType.kC, w, 10.0, 0.3, True,
                          5, -4, -8, 1, cuda_poa_batches=1,
                          cuda_banded_alignment=banded, device="cpu")
    try:
        vcap, lcap = pol._poa_caps()
        assert (vcap, lcap) == (pow2_at_least(4 * w, 512),
                                pow2_at_least(2 * w, 512))
        # the widest round's columns: past the old 4,096 (with -b past
        # -w 16,384)
        cols = pl.columns(lcap, poa_band_cols(lcap, banded))
        assert cols > 4096 or (banded and w <= 16384)
    finally:
        pol.close()


@pytest.fixture(scope="module")
def w10000_set(tmp_path_factory):
    from racon_tpu.tools import simulate

    out = tmp_path_factory.mktemp("wlong")
    return simulate.simulate(str(out), genome_len=4000, coverage=3,
                             read_len=2000, seed=5, ont=True)


def test_w10000_polishes_like_jax(w10000_set, monkeypatch):
    """The port's CLI at -w 10000 (caps V 65,536, LP 32,768; the set's
    one window on the lockstep engine's plain version here, 6 rounds)
    writes the JAX package's bytes; before the kernel walked its rows
    tile by tile the polisher refused this -w."""
    flags = ["-c", "1", "-w", "10000"]
    monkeypatch.setenv("RACON_TPU_TORCH_POA_DEVICE_ONLY", "1")
    monkeypatch.setenv("RACON_TPU_TORCH_CACHE_DIR", "")
    buf = io.BytesIO()
    pol = cli.main(["--device", "cpu", "-t", "1", *flags, *w10000_set],
                   out=buf)
    env = dict(os.environ, RACON_TPU_POA_DEVICE_ONLY="1",
               RACON_TPU_PIPELINE="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT)
    jax_out = subprocess.run(
        [sys.executable, "-m", "racon_tpu.cli", "-t", "1", *flags,
         *w10000_set], env=env, cwd=ROOT, capture_output=True, check=True)
    assert buf.getvalue() == jax_out.stdout
    assert buf.getvalue().startswith(b">")
    assert pol.poa_engine.n_rounds > 0
    assert pol.poa_device_windows > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, on
    exported rounds at the engine's three shapes, on rounds widened to
    wider rows (bands of 1,024 to 16,384 columns, walked tile by tile;
    a 1,024-base row unbanded), on the constructed lag-drop rounds, a
    500-lane launch of a real round's lanes tiled (a -w 1000
    megabatch's width) held lane for lane to its plain version, and one
    lane at 32,768 columns, a plan with no shared-memory ring (needs a
    GPU and nvcc; run with ``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = random.Random(7)
    rounds = []
    for n, vcap, lcap, depth in ((100, 512, 256, 5), (560, 2048, 1024, 3),
                                 (1100, 4096, 2048, 2)):
        t = _seq(n, rng)
        wins = [make_window(t, depth, 0.1, rng) for _ in range(3)]
        rounds += [(a, v, l, 16, 128, w) for a, v, l, w
                   in capture(wins, vcap=vcap, lcap=lcap)]
    a, v = rounds[-1][:2]
    rounds += [(widen(a, l), v, l, 16, 128, wb)
               for l, wb in ((4096, 1024), (8192, 2048), (16384, 4096),
                             (32768, 8192), (65536, 16384))]
    a, v, l = next(r[:3] for r in rounds if r[2] == 1024)
    rounds.append((a, v, l, 16, 128, 0))
    arrs, v, l, p, k = lag_round()
    rounds += [(arrs, v, l, p, k, 32), (arrs, v, l, p, k, 0)]
    for arrs, v, l, p, k, wb in rounds:
        want = port_round(arrs, v, l, p, k, wb, "cuda")
        t = [torch.from_numpy(x) for x in arrs]
        ref = pl.poa_round_reference(*t, v=v, l=l, p=p, k=k, wb=wb,
                                     **SCORES)
        np.testing.assert_array_equal(want[0], ref[0].numpy())
        np.testing.assert_array_equal(want[1], ref[1].numpy())
    # 500 lanes in one launch: the 2,048-base round's lanes tiled
    a, v, l, p, k, wb = next(r for r in rounds if r[2] == 2048)
    n = a[0].shape[0]
    idx = np.arange(500) % n
    tiled = [np.ascontiguousarray(x[idx]) for x in a]
    got = port_round(tiled, v, l, p, k, wb, "cuda")
    t = [torch.from_numpy(x) for x in a]
    ref = pl.poa_round_reference(*t, v=v, l=l, p=p, k=k, wb=wb, **SCORES)
    np.testing.assert_array_equal(got[0], ref[0].numpy()[idx])
    np.testing.assert_array_equal(got[1], ref[1].numpy()[idx])
    # the widest plan: a row of 32,768 columns (l_b 131,072) does not fit
    # twice in shared memory, so every pred row comes from the device
    # ring; one lane, the plain version on the card
    a, v, l, p, k, wb = next(r for r in rounds if r[2] == 65536)
    one = [np.ascontiguousarray(x[:1]) for x in widen(a, 131072)]
    assert pl.plan(v, 131072, p, 32768, "cuda")["shared_rows"] == 0
    got = port_round(one, v, 131072, p, k, 32768, "cuda")
    t = [torch.from_numpy(x).cuda() for x in one]
    ref = pl.poa_round_reference(*t, v=v, l=131072, p=p, k=k, wb=32768,
                                 **SCORES)
    np.testing.assert_array_equal(got[0], ref[0].cpu().numpy())
    np.testing.assert_array_equal(got[1], ref[1].cpu().numpy())
