"""Whole-window POA consensus: the CUDA kernel's wrapper and its plain
PyTorch version.

One call computes, for every window of a packed batch, what
``racon_tpu/tpu/poa_pallas.py:_kernel`` computes: the graph seeded from
the backbone, then per layer a banded graph-vs-sequence DP (band
quantum 128, band ``wb``, first-slot-on-tie direction codes),
traceback and merge, then the heaviest-bundle consensus and the TGS
trim.

Inputs (the JAX package's packed layout, ``convert.pack_windows``):
``seqs``/``wts`` ``[B, D1, LP]`` uint8 (row 0 = backbone), ``meta``
``[B, D1, 8]`` int32 (begin, end, full_span, slen), ``nlay``/``bblen``
``[B]`` int32.  Outputs: ``cons [B, V]`` int32 consensus characters
(zero past the length) and ``mout [B, 8]`` int32: 0 length (-1 =
failed, the window goes to the CPU engine), 1 status (2 = chimeric
warning), 2 fail code, 3 graph nodes used, 4 DP rank steps, and from
the kernel 5-7 the window's clock cycles in the DP walk, in traceback
+ merge and in the rest (the plain version writes 0 there).  An
optional ``stats [B, 3]`` int32 output receives, per window, the pred
rows the DP read from the kernel's shared-memory ring, those it read
from device memory, and the pred slots past the shared-memory mirror it
read.

``poa_full`` launches the kernel (``csrc/poa_full.cu``) for CUDA
tensors and runs ``poa_full_reference`` for CPU tensors.  The plain
version keeps the graph in Python lists and computes each DP row as a
vector over the band on the inputs' device; it is the kernel's
arithmetic written out, not a fast path.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from racon_tpu_torch.utils.tuning import poa_band_cols

# fail codes (mout[2]); the same numbers as the JAX package's kernel
FAIL_VCAP = 1
FAIL_EDGE = 2         # pred/succ slot overflow
FAIL_KCAP = 3         # band reach: pred band lagged out of shift
                      # range, or no subset sink within band reach
FAIL_ALIGNED = 4
FAIL_PATH = 5

Q = 128               # band-start quantum
N_SHIFT = 4           # a pred band may lag <= 3 quanta
NEG = -(1 << 28)      # -inf of the DP rows
CLIP = 1 << 24        # stored scores are clipped to [-CLIP, CLIP]
SINK_FLOOR = -(1 << 22)
INF16 = 0xFFFF        # "no successor" anchor sentinel
FULL_SPAN_END = 0xFFFE
# the kernel's shared-memory graph (csrc/poa_full.cu kR, kPM, kMaxP)
RING_ROWS = 8         # DP rows in the ring; a row is read from it
                      # while fewer than RING_ROWS ranks old
PRED_MIRROR = 4       # pred ids per node in shared memory
MAX_PREDS = 16        # pred slots (the consensus masks are 16 bits)
SMEM_MAX = 232_448    # dynamic shared memory one block may opt in to


def band_width(lp: int, banded: bool = False) -> int:
    """DP band width for layer cap ``lp``: the shared band policy
    rounded up to the 128-column quantum and clamped to the padded
    row."""
    wb = poa_band_cols(lp, banded) or (lp + 1)
    return min((wb + 127) & ~127, ((lp + 127) & ~127))


def path_radix(lp: int) -> int:
    """Radix of the packed path entries (node+2)*pkr + (spos+2)."""
    pkr = 1
    while pkr < lp + 8:
        pkr <<= 1
    return pkr


def scratch_words(v: int, lp: int, wb: int, p: int, s: int,
                  a: int) -> int:
    """int32 words of device scratch one resident block of the kernel
    needs (the wrapper allocates one slice per block, not per window):
    the DP rows by rank [V, WB], pred slots past the mirror [V, P - 4],
    pred weights [V, P] and aligned-sibling rows [V, A]."""
    return v * (wb + max(p - PRED_MIRROR, 0) + p + a)


def _a16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(v: int, lp: int, wb: int) -> int:
    """Dynamic shared memory of one block (one window's graph of ``v``
    nodes): the ring region (RING_ROWS rows or the path tape, whichever
    is larger; later the consensus scores), the pred-id mirror, six
    u16 and five u8 per-node arrays and the staged layer's characters
    (LP + 256) and weights, each 16-byte aligned."""
    ring = max(RING_ROWS * wb * 4, (v + lp) * 4)
    return (_a16(ring) + _a16(v * PRED_MIRROR * 2) + 6 * _a16(2 * v)
            + 5 * _a16(v) + _a16(lp + 256) + _a16(lp))


def fits(v: int, lp: int, d1: int, p: int, s: int, a: int,
         wb: int) -> bool:
    """True when the kernel takes this shape: a band of 8 columns per
    lane of one warp (wb 256, the band of every cap the polisher
    fits), direction codes below 64 and at most MAX_PREDS pred slots,
    counts that fit the u8 node fields, the packed path inside int32,
    node ids and anchors inside the u16 fields, the band-slope product
    inside int32, 16-byte staged rows, and the window's graph inside
    the shared memory one block may opt in to."""
    return (wb == 256 and 1 <= p <= MAX_PREDS
            and 1 <= s <= 255 and 1 <= a <= 32
            and v * lp * 256 < 2 ** 31
            and (v + 2) * path_radix(lp) < 2 ** 31
            and v <= 0x8000 and lp <= 16384 and 1 <= d1 <= 256
            and v % 16 == 0 and lp % 16 == 0
            and smem_bytes(v, lp, wb) <= SMEM_MAX)


def first_pass_nodes(v: int) -> int:
    """Nodes of the shared-memory graph in the kernel's first pass:
    21/32 of the cap, so more windows are resident (five per H100 SM at
    the stock caps instead of three).  The fraction is tuned for 30x
    ONT windows of 500 bases, whose graphs fit in the 1,344 nodes.  A
    window that outgrows it runs again, from the start, in a second
    pass with the whole cap at fewer blocks per SM; deeper traffic
    sends a large share of its windows there (chip_smoke.py's
    ``deep_card`` phase measures the share at 60x)."""
    return min(v, max(64, (v * 21 // 32) & ~15))


_SLOTS = {}


def resident_slots(device, v: int, lp: int, wb: int) -> int:
    """Blocks of the kernel the card holds at once for this shape (SMs
    x blocks per SM, from the CUDA occupancy calculator); raises when
    the card takes none."""
    from racon_tpu_torch.cuda import build

    dev = torch.device(device)
    key = (dev.index, v, lp, wb)
    if key not in _SLOTS:
        lib = build.load("poa_full")
        with torch.cuda.device(dev):
            n = lib.poa_full_slots(v, lp, wb)
        if n <= 0:
            why = build.error_string("poa_full", -n) if n else "no slot"
            raise RuntimeError(f"poa_full kernel cannot be resident at "
                               f"v={v} lp={lp} wb={wb}: {why}")
        _SLOTS[key] = n
    return _SLOTS[key]


def pass_grids(device, b: int, v: int, lp: int,
               wb: int) -> List[Tuple[int, int, int]]:
    """(graph nodes, second-pass flag, grid blocks) of each pass of a
    launch of ``b`` windows: the first pass with ``first_pass_nodes(v)``
    nodes, then, when that is smaller than ``v``, the second with all
    ``v``; each grid is the pass's resident blocks, at most ``b``.  The
    launch allocates one scratch slice per block of its largest grid."""
    vs = first_pass_nodes(v)
    passes = [(vs, 0)] + ([(v, 1)] if vs < v else [])
    return [(n, second, min(b, resident_slots(device, n, lp, wb)))
            for n, second in passes]


def check_inputs(seqs, wts, meta, nlay, bblen, *, v, lp, wb, p, s,
                 a) -> Tuple[int, int]:
    """Raise on anything the kernel does not take; returns (B, D1)."""
    if seqs.dim() != 3 or seqs.shape[2] != lp:
        raise ValueError(f"seqs must be [B, D1, {lp}], got "
                         f"{tuple(seqs.shape)}")
    b, d1 = int(seqs.shape[0]), int(seqs.shape[1])
    want = {"seqs": (seqs, torch.uint8, (b, d1, lp)),
            "wts": (wts, torch.uint8, (b, d1, lp)),
            "meta": (meta, torch.int32, (b, d1, 8)),
            "nlay": (nlay, torch.int32, (b,)),
            "bblen": (bblen, torch.int32, (b,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != seqs.device:
            raise ValueError(f"{name} is on {t.device}, seqs on "
                             f"{seqs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not fits(v, lp, d1, p, s, a, wb):
        raise ValueError(f"shape v={v} lp={lp} d1={d1} wb={wb} p={p} "
                         f"s={s} a={a} does not fit the kernel")
    return b, d1


def poa_full(seqs, wts, meta, nlay, bblen, *, v: int, lp: int, wb: int,
             match: int, mismatch: int, gap: int, wtype: int, trim: int,
             p: int = 16, s: int = 16, a: int = 8, stats=None,
             timer=None):
    """Consensus of every window of the batch: (cons [B, V] int32,
    mout [B, 8] int32) on the inputs' device; ``stats``, when given,
    is a [B, 3] int32 tensor on that device filled in place, and
    ``timer``, a ``devclock.DispatchTimer``, gets a mark after each
    pass's launch on the card.  CUDA
    tensors launch the kernel, in two passes of resident blocks that
    take the windows in batch order: the first with a shared-memory
    graph of ``first_pass_nodes(v)`` nodes, the second with all ``v``
    for the windows that outgrew it (device-side hand-over, no host
    synchronisation); CPU tensors run the plain version."""
    b, d1 = check_inputs(seqs, wts, meta, nlay, bblen, v=v, lp=lp,
                         wb=wb, p=p, s=s, a=a)
    if stats is not None and (stats.dtype != torch.int32
                              or tuple(stats.shape) != (b, 3)
                              or stats.device != seqs.device
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous int32 ({b}, 3) on "
                         f"{seqs.device}")
    if seqs.device.type == "cpu":
        return poa_full_reference(
            seqs, wts, meta, nlay, bblen, v=v, lp=lp, wb=wb,
            match=match, mismatch=mismatch, gap=gap, wtype=wtype,
            trim=trim, p=p, s=s, a=a, stats=stats)
    if seqs.device.type != "cuda":
        raise ValueError(f"unsupported device {seqs.device}")
    from racon_tpu_torch.cuda import build

    lib = build.load("poa_full")
    dev = seqs.device
    cons = torch.zeros((b, v), dtype=torch.int32, device=dev)
    mout = torch.zeros((b, 8), dtype=torch.int32, device=dev)
    if b == 0:
        return cons, mout
    if any(t.data_ptr() % 16 for t in (seqs, wts)):
        raise ValueError("seqs and wts must be 16-byte aligned")
    passes = pass_grids(dev, b, v, lp, wb)
    words = scratch_words(v, lp, wb, p, s, a)
    scratch = torch.empty((max(g for *_, g in passes), words),
                          dtype=torch.int32, device=dev)
    queue = torch.zeros(3 + b, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n, second, grid in passes:
        with torch.cuda.device(dev):
            err = lib.poa_full_launch(
                seqs.data_ptr(), wts.data_ptr(), meta.data_ptr(),
                nlay.data_ptr(), bblen.data_ptr(), cons.data_ptr(),
                mout.data_ptr(),
                None if stats is None else stats.data_ptr(),
                scratch.data_ptr(), queue.data_ptr(), words, b, grid, v, n,
                second, lp, d1, wb, p, s, a, match, mismatch, gap, wtype,
                trim, stream)
        if err != 0:
            raise RuntimeError(
                f"poa_full kernel launch failed: "
                f"{build.error_string('poa_full', err)} ({err})")
        build.count_launch("poa_full")
        if timer is not None:
            timer.mark()
    return cons, mout


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def poa_full_reference(seqs, wts, meta, nlay, bblen, *, v: int, lp: int,
                       wb: int, match: int, mismatch: int, gap: int,
                       wtype: int, trim: int, p: int = 16, s: int = 16,
                       a: int = 8, stats=None):
    """The kernel's function in plain PyTorch, same inputs and outputs
    as ``poa_full`` (mout[5:8] stay 0).  The graph bookkeeping runs in
    Python; every DP row is a vector over the band on the inputs'
    device.  ``stats`` [B, 3], when given, receives the counts the
    kernel reports for its shared-memory paths."""
    dev = seqs.device
    b = int(seqs.shape[0])
    seqs_h = seqs.cpu().numpy()
    wts_h = wts.cpu().numpy()
    meta_h = meta.cpu().numpy()
    nlay_h = nlay.cpu().numpy()
    bblen_h = bblen.cpu().numpy()
    # staged layer rows on the device, zero-padded by 256 columns so
    # every band slice stays in range
    rows = torch.zeros((b, seqs.shape[1], lp + 256), dtype=torch.int32,
                       device=dev)
    rows[:, :, :lp] = seqs.to(torch.int32)
    cons = torch.zeros((b, v), dtype=torch.int32, device=dev)
    mout = np.zeros((b, 8), np.int32)
    params = dict(v=v, lp=lp, wb=wb, match=match, mismatch=mismatch,
                  gap=gap, wtype=wtype, trim=trim, p=p, s=s, a=a)
    for i in range(b):
        st = {} if stats is not None else None
        out, mo = _window_reference(
            seqs_h[i], wts_h[i], meta_h[i], int(nlay_h[i]),
            int(bblen_h[i]), rows[i], **params, stats=st)
        mout[i] = mo
        if st is not None:
            stats[i] = torch.tensor(
                [st["ring_hits"], st["ring_misses"], st["pred_overflow"]],
                dtype=torch.int32)
        if out:
            cons[i, :len(out)] = torch.tensor(out, dtype=torch.int32,
                                              device=dev)
    return cons, torch.from_numpy(mout).to(dev)


def _window_reference(seq_rows, wt_rows, meta, nlay: int, bblen: int,
                      rows_dev, *, v, lp, wb, match, mismatch, gap,
                      wtype, trim, p, s, a,
                      stats=None) -> Tuple[List[int], list]:
    """One window.  ``stats``, a dict when given, receives the
    kernel's shared-memory path counts: ``ring_hits`` / ``ring_misses``
    (pred rows fewer / at least RING_ROWS ranks older than the row
    being computed) and ``pred_overflow`` (pred slots >= PRED_MIRROR
    the DP walk read)."""
    dev = rows_dev.device
    ring_hits = ring_misses = pred_overflow = 0
    pkr = path_radix(lp)
    tape = v + lp
    cols = torch.arange(wb, dtype=torch.int32, device=dev)
    colsg = cols * gap
    neg_pad = {k: torch.full((k * Q,), NEG, dtype=torch.int32, device=dev)
               for k in range(1, N_SHIFT)}
    neg1 = torch.full((1,), NEG, dtype=torch.int32, device=dev)
    zero1 = torch.zeros((1,), dtype=torch.int32, device=dev)

    # ---- graph state (node slots 0..v-1) ----
    bblm = min(bblen, v)
    fail = FAIL_VCAP if bblen > v else 0
    head = 0
    nodes = bblm
    n_incl = 1
    rank_steps = 0
    base = [0] * v
    nseq = [0] * v
    anch = [0] * v
    minsucc = [INF16] * v
    nxt = [-1] * v
    glast = list(range(v))
    pcnt = [0] * v
    scnt = [0] * v
    gcnt = [0] * v
    epoch = [0] * v
    bq = [0] * v
    cpred = [-1] * v
    preds = [[-1] * p for _ in range(v)]
    predw = [[0] * p for _ in range(v)]
    succs = [[-1] * s for _ in range(v)]
    alig = [[0] * a for _ in range(v)]
    # the path tape; the consensus scores alias it (dead until the
    # consensus backtrack), as in the kernel
    path = [0] * tape
    ring = torch.zeros((v, wb), dtype=torch.int32, device=dev)

    # ---- seed the backbone chain ----
    bb = [int(x) for x in seq_rows[0]]
    bw = [int(x) for x in wt_rows[0]]
    for j in range(bblm):
        has_nxt = j + 1 < bblen
        base[j], nseq[j], anch[j] = bb[j], 1, j
        minsucc[j] = j + 1 if has_nxt else INF16
        nxt[j] = j + 1 if has_nxt else -1
        pcnt[j] = 1 if j > 0 else 0
        scnt[j] = 1 if has_nxt else 0
        if j > 0:
            preds[j][0] = j - 1
            predw[j][0] = bw[j - 1] + bw[j]
        if j < bblm - 1:
            succs[j][0] = j + 1

    def new_node(c, anchor, pos):
        nonlocal nodes, head, fail
        nid = nodes
        if nid >= v:
            if fail == 0:
                fail = FAIL_VCAP
            return 0
        base[nid], nseq[nid], anch[nid] = c, 0, anchor
        minsucc[nid] = INF16
        nxt[nid] = -1
        glast[nid] = nid
        gcnt[nid] = epoch[nid] = bq[nid] = 0
        pcnt[nid] = scnt[nid] = 0
        preds[nid][0] = -1
        nodes = nid + 1
        if pos >= 0:
            nxt[nid] = nxt[pos]
            nxt[pos] = nid
        else:
            nxt[nid] = head
            head = nid
        return nid

    def add_edge(nu, t, w):
        nonlocal fail
        row = preds[t]
        hit = p
        for k in range(p):
            if row[k] == nu:
                hit = k
                break
        if hit < p:
            predw[t][hit] += w
            return
        free, pfree = scnt[nu], pcnt[t]
        if free < s and pfree < p:
            succs[nu][free] = t
            minsucc[nu] = min(minsucc[nu], anch[t])
            row[pfree] = nu
            scnt[nu] = free + 1
            pcnt[t] = pfree + 1
            predw[t][pfree] = w
        elif fail == 0:
            fail = FAIL_EDGE

    for d in range(1, nlay + 1):
        if fail != 0:
            break
        begin, end, fsp, m = (int(x) for x in meta[d, :4])
        if m > 0:
            n_incl += 1
        chars = [int(x) for x in seq_rows[d]]
        wts = [int(x) for x in wt_rows[d]]
        row_dev = rows_dev[d]
        end_eff = FULL_SPAN_END if fsp > 0 else end
        smax = (max(m + 1 - wb, 0) + Q - 1) // Q
        span = max(end - begin, 1)
        nr_est = nodes if fsp > 0 else max(1, (span * nodes) // max(bblm, 1))
        slope = (m * 256) // max(nr_est, 1)

        # 1+2) walk the topological list; banded DP row per subset node
        sinks = []          # (node, score tensor) in walk order
        visit = {}          # node -> rank in this layer's walk
        nvis = 0
        node = head
        while node >= 0:
            anc = anch[node]
            in_sub = fsp > 0 or begin <= anc <= end
            if in_sub:
                if minsucc[node] > end_eff:
                    sq_r = smax
                else:
                    sq_r = min(max(
                        (((nvis * slope) >> 8) - Q // 2) >> 7, 0), smax)
                s_r = sq_r * Q
                acc = arg = None
                nreal = 0
                for t in range(pcnt[node]):
                    pred_overflow += t >= PRED_MIRROR
                    pid = preds[node][t]
                    if pid < 0 or epoch[pid] != d:
                        continue
                    nreal += 1
                    dq = sq_r - bq[pid]
                    if not 0 <= dq < N_SHIFT:
                        fail = FAIL_KCAP
                        continue
                    if nvis - visit[pid] < RING_ROWS:
                        ring_hits += 1
                    else:
                        ring_misses += 1
                    h = ring[pid] >> 6
                    if dq:
                        h = torch.cat((h[dq * Q:], neg_pad[dq]))[:wb]
                    if acc is None:
                        # the first real slot wins every column over
                        # the -inf start (NEG never beats NEG)
                        acc = h
                        arg = torch.where(h > NEG, t, 0)
                    else:
                        up = h > acc
                        acc = torch.where(up, h, acc)
                        arg = torch.where(up, t, arg)
                if nreal == 0:
                    acc = colsg + s_r * gap
                    arg = torch.zeros_like(cols)
                elif acc is None:
                    acc = torch.full_like(cols, NEG)
                    arg = torch.zeros_like(cols)
                sub = torch.where(row_dev[s_r:s_r + wb] == base[node],
                                  match, mismatch)
                dmax = torch.cat((neg1, (acc + sub)[:-1]))
                vmax = acc + gap
                argd = torch.cat((zero1, arg[:-1]))
                x = torch.maximum(dmax, vmax) - colsg
                hr = torch.cummax(x, 0).values + colsg
                code = torch.where(dmax == hr, argd,
                                   torch.where(vmax == hr, arg + p, 2 * p))
                ring[node] = hr.clamp(-CLIP, CLIP) * 64 + code
                epoch[node], bq[node] = d, sq_r
                visit[node] = nvis
                if minsucc[node] > end_eff:
                    c_end = m - s_r
                    if c_end < wb:
                        sinks.append((node, hr[c_end]))
                nvis += 1
            node = nxt[node]
        rank_steps += nvis
        best_node, best = -1, SINK_FLOOR
        if sinks:
            scores = torch.stack([sc for _, sc in sinks]).tolist()
            for (nd, _), sc in zip(sinks, scores):
                if sc > best:
                    best, best_node = sc, nd
        if best_node < 0 and nvis > 0:
            fail = FAIL_KCAP
        if fail != 0:
            break

        # 3) traceback -> reversed packed path
        codes = ring.cpu().numpy()
        node, jj, step = best_node, m, 0
        while (node >= 0 or jj > 0) and step < tape:
            nodec = max(node, 0)
            s0 = bq[nodec] * Q if node >= 0 else 0
            code = int(codes[nodec, min(max(jj - s0, 0), wb - 1)]) & 63
            is_diag = code < p and node >= 0
            is_vert = p <= code < 2 * p and node >= 0
            take = is_diag or is_vert
            slot = min(max(code if is_diag else code - p, 0), p - 1)
            pid = preds[nodec][slot]
            pnode = pid if pid >= 0 and epoch[pid] == d else -1
            en = node if take else -1
            es = -1 if is_vert else jj - 1
            path[step] = (en + 2) * pkr + (es + 2)
            node = pnode if take else node
            jj = jj if is_vert else max(jj - 1, 0)
            step += 1
        if step >= tape:
            fail = FAIL_PATH
            break

        # 4) merge the path into the graph, forward order
        prev, prev_w = -1, 0
        for t in range(step):
            packed = path[step - 1 - t]
            nid = packed // pkr - 2
            jj = packed % pkr - 2
            if jj < 0:
                continue
            c = chars[jj]
            w = wts[jj]
            if nid >= 0 and base[nid] == c:
                target = nid
            elif nid < 0:
                anchor = begin if prev < 0 else anch[prev]
                pos = -1 if prev < 0 else glast[prev]
                target = new_node(c, anchor, pos)
            else:
                gc = gcnt[nid]
                arow = list(alig[nid])
                found = -1
                for k in range(gc):
                    if arow[k] % 256 == c and (found < 0
                                               or arow[k] // 256 < found):
                        found = arow[k] // 256
                if found >= 0:
                    target = found
                else:
                    tgt = new_node(c, anch[nid], glast[nid])
                    if gc >= a:
                        fail = FAIL_ALIGNED
                    else:
                        alig[tgt] = arow[:gc] + [nid * 256 + base[nid]] \
                            + arow[gc + 1:]
                        gcnt[tgt] = gc + 1
                        for k in range(gc):
                            sib = arow[k] // 256
                            gs = gcnt[sib]
                            if gs < a:
                                alig[sib][gs] = tgt * 256 + c
                                gcnt[sib] = gs + 1
                            glast[sib] = tgt
                        alig[nid][gc] = tgt * 256 + c
                        gcnt[nid] = gc + 1
                        glast[nid] = tgt
                    target = tgt
            nseq[target] += 1
            if prev >= 0:
                add_edge(prev, target, prev_w + w)
            prev, prev_w = target, w

    if stats is not None:
        stats.update(ring_hits=ring_hits, ring_misses=ring_misses,
                     pred_overflow=pred_overflow)
    mo = [0] * 8
    mo[2], mo[3], mo[4] = fail, nodes, rank_steps
    if fail != 0:
        mo[0] = -1
        return [], mo

    # ---- consensus: heaviest bundle over the full graph ----
    order = []
    node = head
    while node >= 0:
        order.append(node)
        node = nxt[node]
    score = path
    best_sink = -1
    for node in order:
        bu, bwt = -1, -1
        for t in range(pcnt[node]):
            pid = preds[node][t]
            w = predw[node][t]
            if pid >= 0 and (w > bwt or (w == bwt and bu >= 0
                                         and score[pid] > score[bu])):
                bu, bwt = pid, w
        score[node] = score[bu] + bwt if bu >= 0 else 0
        cpred[node] = bu
        if minsucc[node] >= INF16 and (
                best_sink < 0 or score[node] > score[best_sink]):
            best_sink = node
    clen = 0
    node = best_sink
    while node >= 0:
        path[clen] = (node + 2) * pkr + 2
        node = cpred[node]
        clen += 1
    walk = [path[clen - 1 - t] // pkr - 2 for t in range(clen)]
    status = 0
    cbegin, cend = 0, clen - 1
    if wtype == 1 and trim:
        avg = (n_incl - 1) // 2
        hits = [t for t, nd in enumerate(walk) if nseq[nd] >= avg]
        if not hits or hits[0] >= hits[-1]:
            status = 2
        else:
            cbegin, cend = hits[0], hits[-1]
    length = max(cend - cbegin + 1, 0)
    mo[0], mo[1] = length, status
    return [base[nd] for nd in walk[cbegin:cbegin + length]], mo
