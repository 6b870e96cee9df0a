"""Banded unit-cost global alignment along a center table: the CUDA
kernel's wrapper, its plain PyTorch version and the host helpers that
place the band.

One call computes, for every pair of a batch, what
``racon_tpu/tpu/align_pallas.py:_kernel`` computes: the edit-distance
DP over a band of ``wb`` target columns per query row.  The band of row
i starts at ``128 * clip((ctr_i - wb/2) >> 7, 0, smax)``, where ctr_i
interpolates the pair's knots (one every 1024 rows) and
``smax = ceil(max(tl + 1 - wb, 0) / 128)``; the previous row is
realigned by the start's advance when it is 1 or 2 quanta and read
unshifted otherwise.  A row is the vertical and diagonal candidates
closed by an in-row prefix minimum (the horizontal chain), with
``D[i][0] = i`` and columns past tl out of reach.  Direction codes:
diagonal when the cell equals its diagonal candidate, else up when it
equals the vertical one, else left; up in column 0.  The distance is
read at ``tl - start(ql)`` (``BIG`` outside the band), and the
traceback from (ql, tl) reads the direction at the band column of j
(clipped to the band), left on row 0 and up at j <= 0.

Inputs: ``q [B, lq]`` and ``t [B, lt]`` uint8 codes
(``aligner.encode_batch``), ``ql``/``tl`` ``[B]`` int32, ``ctr
[B, n_ctr(lq)]`` int32 knots.  Outputs: ``tape [B, tape_rows, 128]``
int32 holding 2-bit moves (diagonal 0 / up 1 / left 2), 16 per word,
in traceback order, and ``meta [B, 8]`` int32: 0 the distance (``BIG``
out of band), 1 the move count, 2 and 3 the kernel's clock64() cycles
of the pair's DP rows and traceback (0 from the plain version).

``band_align`` launches the kernel (``csrc/align_band.cu``) for CUDA
tensors and runs ``band_align_reference`` for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from racon_tpu_torch.cuda import aligner as al

BIG = 1 << 20
MV_DIAG, MV_UP, MV_LEFT = 0, 1, 2
Q = 128                      # band-start quantum
SYNC_WORDS = 34              # kernel's per-block exchange words (kSync)

# center-table knot spacing (rows)
CTR_BLK = 1024
CTR_LOG = 10
# per-row center advance cap: the previous row is realigned by at most
# 2 quanta (256 columns), so a knot segment advances <= 255 per row
CTR_SLOPE_MAX = 255


def n_ctr(lq: int) -> int:
    """Knots per pair (row i reads knots i >> 10 and (i >> 10) + 1)."""
    return lq // CTR_BLK + 2


def tape_rows(lq: int, lt: int) -> int:
    return ((lq + lt) // 16 + 1 + 127) // 128


def band_per_pair_bytes(lq: int, lt: int, wb: int) -> int:
    """Device bytes one pair costs at band ``wb``: the 2-bit direction
    scratch (lq rows x wb columns) dominates, plus q/t, knots, lengths,
    tape and meta."""
    return lq * wb // 4 + lq + lt + 4 * n_ctr(lq) + 8 \
        + 4 * (128 * tape_rows(lq, lt) + 8)


def fits(lq: int, lt: int, wb: int) -> bool:
    """One warp per pair: wb / 32 columns per lane in whole units of 8,
    at most 8192 columns."""
    return wb % 256 == 0 and 256 <= wb <= 8192 and lq > 0 and lt > 0


def smem_bytes(lt: int, wb: int) -> int:
    """Dynamic shared memory of one pair in the one-warp kernel: the row
    ring (wb + 256 int32 cells and a 16-byte pad per run of the largest
    power of two dividing wb / 32), the target's match-bit table (4 rows
    of (max(lt, wb) + 128) / 32 + 2 words), the exchange words and one
    row of match bits (wb / 32 + 2 words); mirrors ``layout`` in
    ``csrc/align_band.cu``."""
    cols = wb // 32
    run = cols & -cols
    ring = wb + 2 * Q
    return 4 * (ring + 4 * (ring // run)
                + 4 * ((max(lt, wb) + Q) // 32 + 2) + SYNC_WORDS
                + wb // 32 + 2)


def resident_slots(device, lt: int, wb: int) -> int:
    """Pairs the kernel holds at once on ``device`` (one warp each)."""
    from racon_tpu_torch.cuda import build

    with torch.cuda.device(device):
        return int(build.load("align_band").align_band_slots(lt, wb))


def proportional_knots(ql: int, tl: int, lq: int) -> np.ndarray:
    """Default center table: the proportional diagonal ``i*tl/ql`` at
    the knot rows.  Knots past the query length keep the slope (rows
    stop at ql and the band start is clipped)."""
    ks = np.arange(n_ctr(lq), dtype=np.int64) * CTR_BLK
    vals = (ks * tl) // max(ql, 1)
    return np.minimum(vals, ks * CTR_SLOPE_MAX + tl).astype(np.int32)


def smooth_knots(knots: np.ndarray, tl: int) -> np.ndarray:
    """Clamp a measured center path into legal knots: monotone
    non-decreasing, each segment advancing at most ``CTR_SLOPE_MAX``
    columns per row, bounded but not clipped to tl."""
    k = np.maximum.accumulate(np.clip(
        knots, 0, tl + CTR_SLOPE_MAX * CTR_BLK).astype(np.int64))
    d = np.clip(np.diff(k), 0, CTR_SLOPE_MAX * CTR_BLK)
    return np.concatenate(([k[0]], k[0] + np.cumsum(d))).astype(np.int32)


def estimate_center_knots(query: bytes, target: bytes,
                          lq: int) -> np.ndarray:
    """The pair's measured diagonal path: at every knot row an exact
    query 16-mer is looked up in a rolling-hash index of the target and
    the hit nearest the previous knot's extrapolation wins; missing
    knots interpolate along the proportional slope."""
    k = 16
    ql, tl = len(query), len(target)
    prop = proportional_knots(ql, tl, lq)
    if ql < 4 * k or tl < 4 * k:
        return prop
    qa = np.frombuffer(query, np.uint8).astype(np.uint64)
    ta = np.frombuffer(target, np.uint8).astype(np.uint64)
    mul = np.uint64(1099511628211)

    def hashes(a):
        h = np.zeros(len(a) - k + 1, np.uint64)
        for p in range(k):
            h = h * mul + a[p:p + len(h)]
        return h
    hq, ht = hashes(qa), hashes(ta)
    nk = n_ctr(lq)
    knots = np.full(nk, -1, np.int64)
    knots[0] = 0
    slope = tl / max(ql, 1)
    prev_row, prev_col = 0, 0
    for ki in range(1, nk):
        row = ki * CTR_BLK
        if row >= ql - k:
            break
        cand = np.flatnonzero(ht == hq[row])
        if cand.size:
            expect = prev_col + (row - prev_row) * slope
            j = int(cand[np.argmin(np.abs(cand - expect))])
            knots[ki] = j
            prev_row, prev_col = row, j
    last = -1
    for ki in range(nk):
        if knots[ki] >= 0:
            last = ki
    for ki in range(nk):
        if knots[ki] < 0:
            knots[ki] = (knots[last] + (ki - last) * CTR_BLK * slope
                         if last >= 0 and ki > last else prop[ki])
    return smooth_knots(knots, tl)


def path_center_margin(moves_row: np.ndarray, length: int,
                       knots: np.ndarray, wb: int) -> int:
    """Smallest distance (columns) from the decoded path to either edge
    of the knot-centered band: the acceptance rule of measured-center
    retries."""
    mv = moves_row[:length][::-1]
    di = np.cumsum((mv != MV_LEFT).astype(np.int64))      # i after op
    dj = np.cumsum((mv != MV_UP).astype(np.int64))        # j after op
    kk = di >> CTR_LOG
    kn = knots.astype(np.int64)
    c0 = kn[np.minimum(kk, len(kn) - 1)]
    c1 = kn[np.minimum(kk + 1, len(kn) - 1)]
    ctr = c0 + (((c1 - c0) * (di & (CTR_BLK - 1))) >> CTR_LOG)
    dev = int(np.max(np.abs(dj - ctr))) if len(mv) else 0
    return wb // 2 - dev


def moves_to_ops(moves_row, length: int, query: bytes,
                 target: bytes) -> np.ndarray:
    """Decode one reversed move row into the op alphabet (=/X/I/D),
    reversed like the tape."""
    mv = moves_row[:length][::-1]
    di = (mv != MV_LEFT).astype(np.int64)
    dj = (mv != MV_UP).astype(np.int64)
    i_idx = np.cumsum(di) - 1
    j_idx = np.cumsum(dj) - 1
    qa = np.frombuffer(query, np.uint8)
    ta = np.frombuffer(target, np.uint8)
    eq = np.zeros(len(mv), bool)
    m = mv == MV_DIAG
    eq[m] = qa[i_idx[m]] == ta[j_idx[m]]
    ops = np.where(m, np.where(eq, al.OP_EQ, al.OP_X),
                   np.where(mv == MV_UP, al.OP_I, al.OP_D))
    return ops.astype(np.uint8)[::-1]


def unpack_moves(tape: np.ndarray) -> np.ndarray:
    """``[B, words]`` packed tape -> ``[B, 16 * words]`` uint8 moves."""
    tp = np.asarray(tape).reshape(tape.shape[0], -1).astype(np.uint32)
    moves = np.zeros((tp.shape[0], tp.shape[1] * 16), np.uint8)
    for sh in range(16):
        moves[:, sh::16] = (tp >> (2 * sh)) & 3
    return moves


def check_inputs(q, t, ql, tl, ctr, wb: int) -> Tuple[int, int, int]:
    """Raise on anything the kernel does not take; returns (B, lq, lt)."""
    if q.dim() != 2 or t.dim() != 2:
        raise ValueError("q and t must be [B, L]")
    b, lq, lt = int(q.shape[0]), int(q.shape[1]), int(t.shape[1])
    want = {"q": (q, torch.uint8, (b, lq)), "t": (t, torch.uint8, (b, lt)),
            "ql": (ql, torch.int32, (b,)), "tl": (tl, torch.int32, (b,)),
            "ctr": (ctr, torch.int32, (b, n_ctr(lq)))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not fits(lq, lt, wb):
        raise ValueError(f"lq={lq} lt={lt} wb={wb} does not fit the kernel")
    return b, lq, lt


def band_buffers(q, t, *, wb: int) -> dict:
    """Every buffer one band launch writes, made on the inputs' device
    before the launch (so a dispatch's event window holds the launch
    alone): the zeroed tape and meta, the direction scratch, the pair
    queue's counter and the bound library with its kernels loaded.
    Nothing on the CPU."""
    if q.device.type != "cuda":
        return {}
    from racon_tpu_torch.cuda import build

    b, lq, lt, dev = int(q.shape[0]), int(q.shape[1]), int(t.shape[1]), \
        q.device
    return {
        "lib": build.prepare("align_band", dev),
        "tape": torch.zeros((b, tape_rows(lq, lt), 128), dtype=torch.int32,
                            device=dev),
        "meta": torch.zeros((b, 8), dtype=torch.int32, device=dev),
        # 2-bit directions of every band cell, 8 columns per uint16
        "dirs": torch.empty((b, lq * wb // 8), dtype=torch.int16,
                            device=dev),
        "queue": torch.zeros(1, dtype=torch.int32, device=dev)}


def band_align(q, t, ql, tl, ctr, *, wb: int, warps: int = 0, bufs=None):
    """(tape, meta) of every pair, on the inputs' device.  CUDA tensors
    launch the kernel, into ``bufs`` (``band_buffers``, or buffers made
    here), with ``warps`` warps per pair (0: the kernel's choice from
    the batch size; each thread takes wb / (32 x warps) columns, a
    multiple of 8); CPU tensors run the plain version."""
    b, lq, lt = check_inputs(q, t, ql, tl, ctr, wb)
    if warps not in (0, 1, 2, 4, 8) or (warps and wb % (256 * warps)):
        raise ValueError(f"warps={warps} per pair does not fit wb={wb}")
    if q.device.type == "cpu":
        return band_align_reference(q, t, ql, tl, ctr, wb=wb)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from racon_tpu_torch.cuda import build

    if bufs is None:
        bufs = band_buffers(q, t, wb=wb)
    tape, meta = bufs["tape"], bufs["meta"]
    if b == 0:
        return tape, meta
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = bufs["lib"].align_band_launch(
            q.data_ptr(), t.data_ptr(), ql.data_ptr(), tl.data_ptr(),
            ctr.data_ptr(), bufs["dirs"].data_ptr(), tape.data_ptr(),
            meta.data_ptr(), bufs["queue"].data_ptr(), b, lq, lt, wb,
            n_ctr(lq), tape_rows(lq, lt) * 128, warps, stream)
    if err != 0:
        raise RuntimeError(f"align_band kernel launch failed: "
                           f"{build.error_string('align_band', err)} "
                           f"({err})")
    build.count_launch("align_band")
    return tape, meta


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _band_start(ctr, i, wb: int, smax):
    """Quantized band start of row ``i`` ([B] int32) per pair, in the
    kernel's int32 arithmetic."""
    k = i >> CTR_LOG
    c0 = ctr.gather(1, k[:, None].long())[:, 0]
    c1 = ctr.gather(1, k[:, None].long() + 1)[:, 0]
    ci = c0 + (((c1 - c0) * (i - (k << CTR_LOG))) >> CTR_LOG)
    return torch.minimum(((ci - wb // 2) >> 7).clamp(min=0), smax)


def band_align_reference(q, t, ql, tl, ctr, *, wb: int):
    """The kernel's function in plain PyTorch, on the inputs' device:
    one DP row of every pair per step (the prefix minimum as cummin),
    directions kept for the whole band, then a lockstep traceback."""
    b, lq = q.shape
    lt = t.shape[1]
    dev = q.device
    rows = tape_rows(lq, lt)
    tape = torch.zeros((b, rows * 128), dtype=torch.int32, device=dev)
    meta = torch.zeros((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return tape.view(b, rows, 128), meta
    i32 = torch.int32
    qli = ql.clamp(max=lq)
    tli = tl.clamp(max=lt)
    smax = ((tli + 1 - wb).clamp(min=0) + Q - 1) // Q
    cols = torch.arange(wb, dtype=i32, device=dev)[None, :]
    # target codes as int16, padded so a band read past lt matches nothing
    tpad = torch.cat([t.to(torch.int16),
                      torch.full((b, wb + Q), -1, dtype=torch.int16,
                                 device=dev)], 1)
    big_col = torch.full((b, 1), BIG, dtype=i32, device=dev)
    pad = torch.full((b, 3 * Q), BIG, dtype=i32, device=dev)
    prev = torch.where(cols > tli[:, None], BIG, cols).to(i32)
    sq_prev = _band_start(ctr, torch.zeros(b, dtype=i32, device=dev), wb,
                          smax)
    max_ql = int(qli.max())
    dirs = torch.empty((b, max(max_ql, 1), wb), dtype=torch.uint8,
                       device=dev)
    for i in range(1, max_ql + 1):
        iv = torch.full((b,), i, dtype=i32, device=dev)
        sq = _band_start(ctr, iv, wb, smax)
        dq = sq - sq_prev
        sq_prev = sq
        shift = torch.where((dq == 1) | (dq == 2), dq * Q, 0)
        pu = torch.cat([prev, pad], 1).gather(1, (shift[:, None] + cols)
                                              .long())
        j = sq[:, None] * Q + cols
        tb = tpad.gather(1, j.long())
        qc = q[:, i - 1:i].to(torch.int16)
        du = pu + (tb != qc).to(i32)
        vu = pu + 1
        dsh = torch.cat([big_col, du[:, :-1]], 1)
        tu = torch.minimum(dsh, vu)
        tu = torch.where(j == 0, i, tu)
        tu = torch.where(j > tli[:, None], BIG, tu)
        x = torch.cummin(tu - j, dim=1).values
        row = torch.minimum(x + j, torch.tensor(BIG, dtype=i32, device=dev))
        dr = torch.where(row == dsh, MV_DIAG,
                         torch.where(row == vu, MV_UP, MV_LEFT))
        dirs[:, i - 1] = torch.where(j == 0, MV_UP, dr).to(torch.uint8)
        # a pair whose query ended keeps its final row
        prev = torch.where((qli < i)[:, None], prev, row)
    c_end = tli - _band_start(ctr, qli, wb, smax) * Q
    inb = (c_end >= 0) & (c_end < wb)
    dist = torch.where(inb, prev.gather(1, c_end.clamp(0, wb - 1)
                                        .long()[:, None])[:, 0], BIG)

    # lockstep traceback: one move of every unfinished pair per step
    bidx = torch.arange(b, device=dev)
    i = qli.clone()
    j = tli.clone()
    moves = torch.zeros((b, rows * 128 * 16), dtype=torch.int64,
                        device=dev)
    n = torch.zeros(b, dtype=torch.int64, device=dev)
    step = 0
    active = (i > 0) | (j > 0)
    while bool(active.any()):
        s_i = _band_start(ctr, i, wb, smax) * Q
        cc = (j - s_i).clamp(0, wb - 1)
        mv = dirs[bidx, (i - 1).clamp(min=0).long(), cc.long()].to(i32)
        mv = torch.where(j <= 0, MV_UP, mv)
        mv = torch.where(i == 0, MV_LEFT, mv)
        moves[:, step] = torch.where(active, mv, 0)
        ni = torch.where(mv != MV_LEFT, i - 1, i)
        nj = torch.where(mv != MV_UP, j - 1, j)
        i = torch.where(active, torch.where(i == 0, i, ni), i)
        j = torch.where(active, nj, j)
        n = n + active
        step += 1
        active = (i > 0) | (j > 0)
    shifts = 2 * torch.arange(16, device=dev)
    words = (moves.view(b, -1, 16) << shifts).sum(2)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    tape[:] = words.to(i32)
    meta[:, 0] = dist.to(i32)
    meta[:, 1] = n.to(i32)
    return tape.view(b, rows, 128), meta
