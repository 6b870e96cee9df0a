"""The port's packing (racon_tpu_torch/convert.py) against the JAX
engine's: the arrays ``TPUPoaBatchEngine._run_full_device_async`` hands
to ``poa_pallas.poa_full_dispatch`` are captured (the dispatch is
monkeypatched in the test; nothing in racon_tpu changes) and must be
byte-equal to ``convert.pack_windows`` on the same windows."""

import numpy as np
import pytest
import torch

from racon_tpu.core.window import Window as JaxWindow
from racon_tpu.core.window import WindowType as JaxWindowType
from racon_tpu.tpu import poa_pallas
from racon_tpu.tpu.poa import TPUPoaBatchEngine
from racon_tpu_torch import convert
from racon_tpu_torch.core.window import Window, WindowType

VCAP, LCAP = 512, 256


def _seq(n, rng):
    return bytes(rng.choice(list(b"ACGT"), n).astype(np.uint8))


def _qual(n, rng):
    return bytes((rng.integers(0, 60, n) + 33).astype(np.uint8))


def _window_specs(case: str, rng):
    """(backbone, backbone quality, [(layer, quality, begin, end)])
    per window for one packing case."""
    specs = []
    for k in range(5):
        n = {"long_backbone": 300 if k == 1 else 150}.get(case, 150)
        bb = _seq(n, rng)
        bq = _qual(n, rng) if case == "backbone_quality" else b"!" * n
        layers = []
        depth = 12 if case == "depth_cap" else 4 + k
        for d in range(depth):
            ln = int(rng.integers(80, 170))
            if case == "long_layers" and d % 3 == 0:
                ln = LCAP + 10           # over the layer cap: skipped
            begin = int(rng.integers(0, 20)) if d % 2 else 0
            end = n - 1 - (int(rng.integers(0, 20)) if d % 2 else 0)
            q = None if case == "no_quality" or d == 1 else _qual(ln, rng)
            layers.append((_seq(ln, rng), q, begin, end))
        specs.append((bb, bq, layers))
    return specs


def _build(cls, wtype, specs):
    out = []
    for i, (bb, bq, layers) in enumerate(specs):
        w = cls(0, i, wtype, bb, bq)
        for layer in layers:
            w.add_layer(*layer)
        out.append(w)
    return out


CASES = ["plain", "no_quality", "backbone_quality", "long_layers",
         "long_backbone", "depth_cap"]


@pytest.mark.parametrize("case", CASES)
def test_pack_matches_jax_engine(case, monkeypatch):
    rng = np.random.default_rng(CASES.index(case) + 1)
    specs = _window_specs(case, rng)
    max_depth = 6 if case == "depth_cap" else 200
    captured = {}

    def capture(seqs, wts, meta, nlay, bblen, **kw):
        captured.update(seqs=seqs.copy(), wts=wts.copy(), meta=meta.copy(),
                        nlay=nlay.copy(), bblen=bblen.copy(), kw=kw)
        b = seqs.shape[0]
        return lambda: (np.zeros((b, kw["v"]), np.int32),
                        np.zeros((b, 8), np.int32))

    monkeypatch.setattr(poa_pallas, "poa_full_dispatch", capture)
    eng = TPUPoaBatchEngine(5, -4, -8, vcap=VCAP, pcap=16, lcap=LCAP,
                            max_depth=max_depth)
    eng._run_full_device_async(_build(JaxWindow, JaxWindowType.TGS, specs),
                               True)
    pk = convert.pack_windows(_build(Window, WindowType.TGS, specs), LCAP,
                              VCAP, max_depth)
    for name in ("seqs", "wts", "meta", "nlay", "bblen"):
        want = captured[name]
        got = getattr(pk, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    assert pk.n_skipped == eng.n_skipped_layers
    assert pk.host_fail == [len(bb) > min(LCAP, VCAP)
                            for bb, _, _ in specs]


def test_to_device_keeps_layout():
    rng = np.random.default_rng(0)
    specs = _window_specs("plain", rng)
    pk = convert.pack_windows(_build(Window, WindowType.TGS, specs), LCAP,
                              VCAP)
    tens = convert.to_device(pk.seqs, pk.wts, pk.meta.astype(np.int64),
                             pk.nlay, pk.bblen, "cpu")
    assert [t.dtype for t in tens] == [torch.uint8, torch.uint8,
                                       torch.int32, torch.int32,
                                       torch.int32]
    assert all(t.is_contiguous() for t in tens)
    assert np.array_equal(tens[2].numpy(), pk.meta)
    assert np.array_equal(tens[0].numpy(), pk.seqs)
