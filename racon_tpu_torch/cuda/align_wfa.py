"""Unit-cost global alignment by wavefronts (WFA): the CUDA kernel's
wrapper and its plain PyTorch version.

One call computes, for every pair of a batch, what
``racon_tpu/tpu/align_pallas.py:_wfa_kernel`` computes together with its
match-word pre-pass ``_wfa_match_words``: wavefront e over diagonals
d = j - i in [-emax, emax]; each step takes the candidates of the native
engine (``native/align.cpp``): deletion keeps i from d - 1, substitution
advances i on d, insertion advances i from d + 1, each with its boundary
test against ql/tl; the furthest-reaching point then slides along exact
matches.  A pair stops at the first e whose final diagonal reaches ql,
or is rejected past emax.  The traceback walks back with the engine's
preference (insertion > substitution > deletion on ties), so the tape
decodes to the native engine's CIGAR.

Inputs: ``q``/``t`` ``[B, lq]`` uint8 codes (``aligner.encode_batch``:
bases 0..4, q pad 5, t pad 6), ``ql``/``tl`` ``[B]`` int32.  Outputs:
``tape [B, wfa_tape_rows(emax), 128]`` int32 entries ``slide * 4 + op``
(op 0 the final e = 0 slide, 1 substitution, 2 insertion, 3 deletion) in
traceback order, zero past the count, and ``meta [B, 8]`` int32: 0 the
distance (``BIG`` when rejected: empty, ``|tl - ql| > emax`` or a
distance past emax; ``TOO_LONG`` from the kernel for a pair longer than
the launch's ``lmax``, which it does not align), 1 the tape entry count
(0 when rejected), 2 and 3 the kernel's clock64() cycles of the pair's
wavefront steps and traceback (0 from the plain version).

``wfa_align`` launches the kernel (``csrc/align_wfa.cu``) for CUDA
tensors and runs ``wfa_align_reference`` for CPU tensors.  The plain
version is batched over pairs x diagonals per wavefront step and slides
along the JAX package's 32-row match words (``wfa_match_words``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from racon_tpu_torch.cuda import aligner as al

BIG = 1 << 20
TOO_LONG = -1                # kernel's meta[:, 0] of a pair past lmax
NEG = -(1 << 20)             # inactive-diagonal sentinel
NEG_H = -(1 << 19)           # activity threshold
W_SUB, W_INS, W_DEL = 1, 2, 3
MAX_DIM = 1 << 14            # longest row: the history is int16
SMEM_MAX = 232_448           # shared memory a block may opt into
WIN = 32                     # kernel's traceback window: steps (kWin)
SYNC_WORDS = 4               # kernel's per-block exchange words (kSync)


def wfa_wd(emax: int) -> int:
    """Diagonal lanes of the plain version: d in [-emax, emax],
    128-padded (the JAX kernel's extent)."""
    return ((2 * emax + 2) + 127) // 128 * 128


def wfa_nwords(lq: int) -> int:
    """Match words per diagonal (32 query rows each)."""
    return ((lq // 32 + 2) + 7) // 8 * 8


def wfa_tape_rows(emax: int) -> int:
    return (emax + 2 + 127) // 128


def hist_words(emax: int) -> int:
    """int16 history entries per pair in the kernel: wavefront e keeps
    its live diagonals [-e, e] with padding, 2 e + 6 entries a row."""
    return (emax + 1) * (emax + 6)


def smem_bytes(lmax: int, emax: int) -> int:
    """Shared memory of one block for pairs of at most ``lmax`` bases:
    the exchange words, then q and t as 4-bit codes (8 per word, with
    pad words) and two int16 wavefront buffers over d in [-h, h + 1], h
    = min(emax, lmax) + 3 rounded down to even, which the traceback
    window (WIN steps x 2 WIN + 2 int16) reuses; mirrors ``layout`` in
    ``csrc/align_wfa.cu``."""
    nib = (lmax + 16) // 8 + 2
    wf = 2 * ((min(emax, lmax) + 3) & ~1) + 2
    win = WIN * (2 * WIN + 2) // 2
    return 4 * (SYNC_WORDS + max(2 * nib + wf, win))


def wfa_per_pair_bytes(lq: int, emax: int) -> int:
    """Device bytes one pair costs at rung ``emax``: the int16 wavefront
    history dominates, plus q/t, lengths, tape and meta."""
    return 2 * hist_words(emax) + 2 * lq + 8 \
        + 4 * (128 * wfa_tape_rows(emax) + 8)


def fits(lq: int, emax: int) -> bool:
    return 1 <= emax and 0 < lq <= MAX_DIM \
        and smem_bytes(lq, emax) <= SMEM_MAX


def resident_slots(device, lmax: int, emax: int, b: int) -> int:
    """Pairs the kernel holds at once on ``device`` at (lmax, emax) in a
    launch of ``b`` pairs (which sets the warps per pair)."""
    from racon_tpu_torch.cuda import build

    with torch.cuda.device(device):
        return int(build.load("align_wfa").align_wfa_slots(lmax, emax, b))


def check_inputs(q, t, ql, tl, emax: int) -> Tuple[int, int]:
    """Raise on anything the kernel does not take; returns (B, lq)."""
    if q.dim() != 2:
        raise ValueError(f"q must be [B, lq], got {tuple(q.shape)}")
    b, lq = int(q.shape[0]), int(q.shape[1])
    want = {"q": (q, torch.uint8, (b, lq)), "t": (t, torch.uint8, (b, lq)),
            "ql": (ql, torch.int32, (b,)), "tl": (tl, torch.int32, (b,))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not fits(lq, emax):
        raise ValueError(f"lq={lq} emax={emax} does not fit the kernel")
    return b, lq


def wfa_buffers(q, t, ql, tl, *, emax: int) -> dict:
    """Every buffer one WFA launch writes, and its pair queue, made on
    the inputs' device before the launch (so a dispatch's event window
    holds the launch alone): the zeroed tape and meta, the int16
    history, the longest-first pair order and the queue counter, and
    the bound library with its kernel loaded.  Nothing on the CPU."""
    if q.device.type != "cuda":
        return {}
    from racon_tpu_torch.cuda import build

    b, dev = int(q.shape[0]), q.device
    rows = wfa_tape_rows(emax)
    return {
        "lib": build.prepare("align_wfa", dev),
        "tape": torch.zeros((b, rows, 128), dtype=torch.int32, device=dev),
        "meta": torch.zeros((b, 8), dtype=torch.int32, device=dev),
        "hist": torch.empty((b, hist_words(emax)), dtype=torch.int16,
                            device=dev),
        "order": torch.argsort(torch.maximum(ql, tl), descending=True,
                               stable=True).to(torch.int32),
        "queue": torch.zeros(1, dtype=torch.int32, device=dev)}


def wfa_align(q, t, ql, tl, *, emax: int, lmax: int, bufs=None):
    """(tape, meta) of every pair, on the inputs' device.  ``lmax`` in
    [1, lq] bounds every ql / tl of the batch (the caller knows the
    lengths): CUDA tensors launch the kernel with shared memory sized
    for it, into ``bufs`` (``wfa_buffers``, or buffers made here), and
    the kernel marks a pair past it with meta[:, 0] = ``TOO_LONG``; CPU
    tensors run the plain version, after raising on a pair past it."""
    b, lq = check_inputs(q, t, ql, tl, emax)
    if not 1 <= lmax <= lq:
        raise ValueError(f"lmax={lmax} outside [1, lq={lq}]")
    if q.device.type == "cpu":
        if b and int(torch.maximum(ql, tl).max()) > lmax:
            raise ValueError(f"a pair is longer than lmax={lmax}")
        return wfa_align_reference(q, t, ql, tl, emax=emax)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from racon_tpu_torch.cuda import build

    if bufs is None:
        bufs = wfa_buffers(q, t, ql, tl, emax=emax)
    tape, meta = bufs["tape"], bufs["meta"]
    if b == 0:
        return tape, meta
    rows = wfa_tape_rows(emax)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = bufs["lib"].align_wfa_launch(
            q.data_ptr(), t.data_ptr(), ql.data_ptr(), tl.data_ptr(),
            tape.data_ptr(), meta.data_ptr(), bufs["hist"].data_ptr(),
            bufs["order"].data_ptr(), bufs["queue"].data_ptr(), b, lq, lmax,
            emax, rows * 128, stream)
    if err != 0:
        raise RuntimeError(f"align_wfa kernel launch failed: "
                           f"{build.error_string('align_wfa', err)} ({err})")
    build.count_launch("align_wfa")
    return tape, meta


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def wfa_match_words(q, t, emax: int, nwords: int = None):
    """Per-diagonal match bits, 32 query rows per int32: word r of lane
    c holds bit k = (q[32r + k] == t[32r + k + c - emax]) over the
    padded arrays (q pad 5, t pad 6, shift sentinel 7, so positions
    outside the sequences never match).  ``[B, nwords, wd]`` int32,
    bit-equal to ``_wfa_match_words`` reshaped to ``[B * nwords, wd]``;
    ``nwords`` may cut the rows short of ``wfa_nwords(lq)``."""
    b, lq = q.shape
    wd = wfa_wd(emax)
    nwords = wfa_nwords(lq) if nwords is None else nwords
    li = nwords * 32
    dev = q.device
    qq = torch.full((b, li), al.QPAD, dtype=torch.uint8, device=dev)
    qq[:, :min(lq, li)] = q[:, :li]
    tp = torch.full((b, li + wd), 7, dtype=torch.uint8, device=dev)
    n_t = min(lq, li + wd - emax)
    tp[:, emax:emax + n_t] = t[:, :n_t]
    base = (torch.arange(wd, device=dev)[:, None]
            + 32 * torch.arange(nwords, device=dev)[None, :])
    word = torch.zeros((b, wd, nwords), dtype=torch.int64, device=dev)
    for k in range(32):
        eq = tp[:, base + k] == qq[:, None, k::32]
        word |= eq.to(torch.int64) << k
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    return word.to(torch.int32).transpose(1, 2).contiguous()


def _trailing_ones(x):
    """Trailing one bits of each 32-bit value held in an int64."""
    y = ~x & 0xFFFFFFFF
    lsb = y & -y                       # lowest zero bit of x, or 0
    ctz = sum(((lsb & m) != 0).to(torch.int64) * k
              for m, k in ((0xFFFF0000, 16), (0xFF00FF00, 8),
                           (0xF0F0F0F0, 4), (0xCCCCCCCC, 2),
                           (0xAAAAAAAA, 1)))
    return torch.where(y == 0, 32, ctz)


def wfa_align_reference(q, t, ql, tl, *, emax: int):
    """The kernel's function in plain PyTorch, on the inputs' device."""
    b, lq = q.shape
    dev = q.device
    wd = wfa_wd(emax)
    rows = wfa_tape_rows(emax)
    tape = torch.zeros((b, rows * 128), dtype=torch.int32, device=dev)
    meta = torch.zeros((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return tape.view(b, rows, 128), meta
    qlc = ql.to(torch.int64)[:, None]
    tlc = tl.to(torch.int64)[:, None]
    valid = (ql > 0) & (tl > 0) & ((tl - ql).abs() <= emax)
    # words past the longest query are never read
    nwords = min(wfa_nwords(lq), max(int(ql.max()), 0) // 32 + 2)
    words = wfa_match_words(q, t, emax, nwords).view(b, -1) \
        .to(torch.int64) & 0xFFFFFFFF
    cols = torch.arange(wd, device=dev)[None, :]
    dcol = cols - emax
    fin = (tl - ql).to(torch.int64)[:, None] + emax
    dist = torch.where(valid, -1, BIG).to(torch.int64)
    negc = torch.full((b, 1), NEG, dtype=torch.int64, device=dev)

    def extend(f, done):
        """Slide every active lane to its furthest-reaching point."""
        while True:
            active = (f > NEG_H) & ~done[:, None] & (f < qlc)
            fc = f.clamp(min=0)
            w = words.gather(1, (fc >> 5) * wd + cols)
            tr = torch.where(active, _trailing_ones(w >> (fc & 31)), 0)
            f = f + tr
            if not (active & (tr > 0) & ((f & 31) == 0) & (f < qlc)).any():
                return f

    def check_done(f, e):
        sel = f.gather(1, fin.clamp(0, wd - 1))[:, 0]
        newly = (sel >= qlc[:, 0]) & valid & (dist == -1)
        dist[newly] = e

    f = torch.where((cols == emax) & valid[:, None], 0, NEG)
    f = extend(f.to(torch.int64), dist != -1)
    # history as int16 (F is NEG or in [0, ql], ql <= MAX_DIM)
    hist = [f.clamp(min=-1).to(torch.int16)]
    check_done(f, 0)
    e = 1
    while e <= emax and bool((dist == -1).any()):
        done = dist != -1
        nl = torch.cat([negc, f[:, :-1]], 1)
        nr = torch.cat([f[:, 1:], negc], 1)
        vdel = torch.where((nl > NEG_H) & (nl + dcol <= tlc), nl, NEG)
        vsub = torch.where((f > NEG_H) & (f + 1 <= qlc)
                           & (f + 1 + dcol <= tlc), f + 1, NEG)
        vins = torch.where((nr > NEG_H) & (nr + 1 <= qlc), nr + 1, NEG)
        cand = torch.maximum(torch.maximum(vdel, vsub), vins)
        f = extend(torch.where(done[:, None], f, cand), done)
        hist.append(f.clamp(min=-1).to(torch.int16))
        check_done(f, e)
        e += 1
    dist = torch.where(dist == -1, BIG, dist)

    # traceback, all pairs in lockstep from their distance down to 0
    ok = dist < BIG
    bidx = torch.arange(b, device=dev)
    i = ql.to(torch.int64).clone()
    dcur = (tl - ql).to(torch.int64)
    n = torch.zeros(b, dtype=torch.int64, device=dev)
    e_top = int(dist[ok].max()) if bool(ok.any()) else 0
    for e in range(e_top, 0, -1):
        act = ok & (e <= dist)
        prev = hist[e - 1].to(torch.int64)
        prev = torch.where(prev < 0, NEG, prev)
        c = dcur + emax

        def pick(delta):
            idx = c + delta
            v = prev.gather(1, idx.clamp(0, wd - 1)[:, None])[:, 0]
            return torch.where((idx >= 0) & (idx < wd), v, NEG)

        vm1, v0, vp1 = pick(-1), pick(0), pick(1)
        qlv, tlv = qlc[:, 0], tlc[:, 0]
        del_c = torch.where((vm1 > NEG_H) & (vm1 + dcur <= tlv), vm1, NEG)
        sub_c = torch.where((v0 > NEG_H) & (v0 + 1 <= qlv)
                            & (v0 + 1 + dcur <= tlv), v0 + 1, NEG)
        ins_c = torch.where((vp1 > NEG_H) & (vp1 + 1 <= qlv), vp1 + 1, NEG)
        i0 = torch.maximum(torch.maximum(del_c, sub_c), ins_c)
        is_ins = (ins_c > NEG_H) & (ins_c == i0)
        is_sub = ~is_ins & (sub_c > NEG_H) & (sub_c == i0)
        op = torch.where(is_ins, W_INS, torch.where(is_sub, W_SUB, W_DEL))
        entry = (i - i0) * 4 + op
        tape[bidx[act], n[act]] = entry[act].to(torch.int32)
        n = n + act
        i = torch.where(act, torch.where(is_ins | is_sub, i0 - 1, i0), i)
        dcur = torch.where(act, torch.where(
            is_ins, dcur + 1, torch.where(is_sub, dcur, dcur - 1)), dcur)
    tape[bidx[ok], n[ok]] = (i[ok] * 4).to(torch.int32)
    n = n + ok
    meta[:, 0] = dist.to(torch.int32)
    meta[:, 1] = n.to(torch.int32)
    return tape.view(b, rows, 128), meta


def wfa_tape_to_ops(tape_row: np.ndarray, n_entries: int) -> np.ndarray:
    """Decode one tape row into the op alphabet, reversed (traceback)
    order.  Each entry expands to ``slide`` exact matches followed by
    its op; substitutions are true mismatches (the slide is maximal)."""
    ent = np.asarray(tape_row).reshape(-1)[:n_entries].astype(np.int64)
    slides = ent >> 2
    opc = ent & 3
    counts = slides + (opc != 0)
    out = np.full(int(counts.sum()), al.OP_EQ, np.uint8)
    ends = np.cumsum(counts)
    has = opc != 0
    opmap = np.array([al.OP_EQ, al.OP_X, al.OP_I, al.OP_D], np.uint8)
    out[(ends - 1)[has]] = opmap[opc[has]]
    return out
