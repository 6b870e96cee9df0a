"""The dispatches' event windows hold the kernel wrapper alone.

A dispatch's timer (``cuda/devclock.py:DispatchTimer``) records a CUDA
event at each mark, so whatever the host does between the two marks
counts as kernel time while the stream waits.  These tests replace the
marks, the kernel wrappers and the input and buffer builders with
recorders and hold, for ``cuda/align.py``'s ``wfa_dispatch`` and
``band_dispatch`` and for the scan ladder's launches
(``cuda/aligner.py:band_align_batch``, at every rung and the unbanded
kernel), that every input and buffer is built before the first mark
and handed to the wrapper, and that only the wrapper runs between the
two marks; and the same for the POA dispatch
(``cuda/poa.py:CudaPoaBatchEngine._launch``, its buffers from
``cuda/poa_full.py:poa_full_buffers``) and the mapper's seed words
(``cuda/seed_words.py:kmer_words``, its buffers from
``seed_words_buffers``).  They run the plain versions on the CPU.
"""

import random

import numpy as np
import pytest

from racon_tpu_torch import convert
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.cuda import align
from racon_tpu_torch.cuda import align_band as ab
from racon_tpu_torch.cuda import align_wfa as aw
from racon_tpu_torch.cuda import aligner as al
from racon_tpu_torch.cuda import poa_full as pf
from racon_tpu_torch.cuda import seed_words as sw
from racon_tpu_torch.cuda.devclock import DispatchTimer
from racon_tpu_torch.cuda.poa import CudaPoaBatchEngine
from racon_tpu_torch.tools.scan_pairs import mutate


def _pairs(n: int, length: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    r = random.Random(seed)
    qs = [bytes(rng.choice(list(b"ACGT"), length - 7 * k).tolist())
          for k in range(n)]
    return qs, [mutate(s, 0.08, r) for s in qs]


@pytest.fixture
def log(monkeypatch):
    """Recorders: ``mark``, ``kernel`` (a wrapper, which also asserts
    that it was handed device tensors and its buffers) and
    ``build:<name>`` (an input or buffer builder)."""
    events = []
    real_mark = DispatchTimer.mark

    def mark(self):
        events.append("mark")
        real_mark(self)

    monkeypatch.setattr(DispatchTimer, "mark", mark)

    def builder(mod, name):
        real = getattr(mod, name)

        def rec(*a, **kw):
            events.append(f"build:{name}")
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, rec)

    for mod, name in ((al, "encode_batch"), (al, "scan_buffers"),
                      (align, "_lengths"), (align, "_upload"),
                      (ab, "proportional_knots"), (aw, "wfa_buffers"),
                      (ab, "band_buffers"), (convert, "pack_windows"),
                      (convert, "to_device"), (pf, "poa_full_buffers"),
                      (sw, "seed_words_buffers")):
        builder(mod, name)

    def wrapper(mod, name, inputs=4):
        real = getattr(mod, name)

        def rec(*a, **kw):
            events.append("kernel")
            assert all(hasattr(x, "device") for x in a[:inputs]), name
            bufs = kw["bufs"] if "bufs" in kw else a[-1]
            assert isinstance(bufs, dict), f"{name} made its buffers"
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, rec)

    wrapper(aw, "wfa_align")
    wrapper(ab, "band_align")
    wrapper(al, "align_banded")
    wrapper(al, "align_full")
    wrapper(pf, "poa_full", inputs=5)
    wrapper(sw, "seed_words", inputs=1)
    return events


def _windows(events):
    """The events between each pair of marks, and those before each
    window's first mark since the last window."""
    inside, before, cur, out = [], [], [], None
    for ev in events:
        if ev == "mark":
            if out is None:
                before.append(cur)
                out = []
            else:
                inside.append(out)
                out = None
                cur = []
        elif out is not None:
            out.append(ev)
        else:
            cur.append(ev)
    assert out is None, "a dispatch left its window open"
    return inside, before


def test_wfa_dispatch_builds_before_its_window(log):
    qs, ts = _pairs(3, 200)
    collect = align.wfa_dispatch(qs, ts, 256, 64, "cpu")
    collect()
    inside, before = _windows(log)
    assert inside == [["kernel"]]
    assert {"build:encode_batch", "build:_lengths",
            "build:wfa_buffers"} <= set(before[0])


def test_band_dispatch_builds_before_its_window(log):
    qs, ts = _pairs(3, 200)
    centers = [None, ab.proportional_knots(len(qs[1]), len(ts[1]), 256),
               None]
    log.clear()
    collect = align.band_dispatch(qs, ts, 256, 256, 256, "cpu",
                                  centers=centers)
    collect()
    inside, before = _windows(log)
    assert inside == [["kernel"]]
    assert {"build:encode_batch", "build:_lengths", "build:_upload",
            "build:proportional_knots", "build:band_buffers"} <= set(before[0])


@pytest.mark.parametrize("allow_full", [False, True])
def test_scan_launches_build_before_their_windows(log, monkeypatch,
                                                  allow_full):
    """Every launch of the ladder: rungs 16 and 48 under a 128 bucket,
    retries at the wider rung and (allow_full) the unbanded kernel past
    it, chunked by a small budget."""
    monkeypatch.setattr(al, "BAND_LADDER", (16, 48))
    qs, ts = _pairs(6, 110)
    qs.append(b"ACGT" * 30)
    ts.append(b"TTGCA" * 20)                  # past both rungs
    al.band_align_batch(qs, ts, 128, 128, allow_full=allow_full,
                        mem_budget=4096, need_ratio=0.05)
    inside, before = _windows(log)
    assert len(inside) > 3
    assert all(w == ["kernel"] for w in inside), inside
    for b in before:
        assert {"build:encode_batch", "build:scan_buffers"} <= set(b), b


def _poa_window(seed: int, n_layers: int, length: int = 90):
    rng = np.random.default_rng(seed)
    bb = bytes(rng.choice(list(b"ACGT"), length).astype(np.uint8))
    w = Window(0, 0, WindowType.TGS, bb, b"+" * length)
    for _ in range(n_layers):
        s = bytearray(bb)
        for k in rng.integers(0, length, 5):
            s[k] = int(rng.choice(list(b"ACGT")))
        w.add_layer(bytes(s), b"+" * length, 0, length)
    return w


def test_poa_dispatch_builds_before_its_window(log):
    """One whole-window POA launch: the packed inputs, their upload and
    every buffer (``poa_full_buffers``) come before the first mark."""
    eng = CudaPoaBatchEngine(5, -4, -8, device="cpu", vcap=256, lcap=256)
    results = eng.consensus_batch([_poa_window(1, 3), _poa_window(2, 4)],
                                  True)
    assert all(ok for _, ok in results)
    inside, before = _windows(log)
    assert inside == [["kernel"]]
    assert {"build:pack_windows", "build:to_device",
            "build:poa_full_buffers"} <= set(before[0])


def test_seed_words_dispatch_builds_before_its_window(log):
    """The mapper's seed words: the word buffers (``seed_words_buffers``)
    come before the first mark, the copy back after the second."""
    codes = np.random.default_rng(4).integers(0, 5, 300).astype(np.uint8)
    fw, rv = sw.kmer_words(codes, 13, "cpu")
    assert fw.dtype == np.uint32 and fw.shape == (288,)
    inside, before = _windows(log)
    assert inside == [["kernel"]]
    assert "build:seed_words_buffers" in before[0]
