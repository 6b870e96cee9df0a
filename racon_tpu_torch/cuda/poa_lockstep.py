"""One round of the lockstep POA engine: the CUDA kernel's wrapper, its
plain PyTorch version and the host graphs' ctypes binding.

The lockstep engine (``cuda/poa.py``, for windows past the whole-window
kernel's caps) advances a batch of windows one layer per round: the
graphs live on the host in C++ (``native/poa_batch.cpp``), each round
exports every window's current (sub)graph as fixed-shape arrays, one
launch aligns every window's next layer against its graph, and the host
applies the returned paths.  One round computes what the JAX package's
``racon_tpu/tpu/poa.py:_poa_kernel`` (``wb == 0``) and
``_poa_kernel_banded`` (``wb > 0``) compute: a global NW of ``seq``
against the DAG in topological rank order, keeping only a ring of the
last ``k`` score rows, then the traceback from the best sink.

Inputs: ``bases`` ``[B, V]`` uint8 node bases in rank order, ``preds``
``[B, V, P]`` int16 predecessor DP-row indices (0 = the virtual start
row, -1 = pad; a pred row lies at most ``k`` rows back, as
``rt_poab_export`` guarantees), ``nrows`` ``[B]`` int32 valid ranks,
``sinks`` ``[B, V]`` uint8 sink flags, ``seq`` ``[B, L]`` uint8 layer
bases, ``slen`` ``[B]`` int32.  Outputs ``(node_tape, seq_tape)``
``[B, V + L]`` int32: the reversed alignment path per lane, node entries
0-based ranks or PATH_NONE, seq entries positions or PATH_NONE, and
PATH_DONE once the walk reached the origin.

Banded rounds (``wb > 0``) restrict each rank's row to a ``wb``-column
band whose start, quantised to ``wb // 4``, follows the expected
sequence position ``r * slen / nrows``; a pred row whose band lags 5
quanta or more reads as -inf.  Scores are float32 with -inf = -2**28,
as in the JAX kernels: every value a traceback can reach is an integer
held exactly, and the rounding near -2**28 is the same IEEE rounding
in both.

``poa_round`` launches the kernel (``csrc/poa_lockstep.cu``) for CUDA
tensors, counting each launch, and runs ``poa_round_reference`` for CPU
tensors; on a CUDA tensor it launches or raises.  The kernel takes any
width: a row wider than one block's tile is walked tile by tile, so a
round's only bounds are device memory (``lockstep_buffers``) and the
block's shared memory (``plan``).  ``lockstep_buffers(..., timed=True)``
adds ``meta`` ``[B, 9]`` int64: each lane's clock64() cycles of the
kernel's phases (``PHASES``), its pred rows read from the device ring
and its columns that took the rounding slow path (``COUNTS``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from racon_tpu_torch.ops import cpu as cpu_ops

# traceback tape sentinels
PATH_NONE = -1      # no node / no seq position in this step
PATH_DONE = -3      # walk finished

NEG = -(1 << 28)    # -inf of the DP rows (float32-exact)
N_SHIFT = 5         # a banded pred row may lag at most 4 quanta
MAX_P = 32
#: ranks a round may hold: the kernel keeps a bitset of the rows it
#: reads from its device ring (v bits) in shared memory
MAX_V = 1 << 20
#: ``meta``'s columns: the phases' clock64() cycles (warp 0's), then
#: two counts
PHASES = ("pred_fetch", "candidates", "scan", "codes", "sink", "barrier",
          "traceback")
COUNTS = ("far_pred_rows", "slow_columns")


class _NativeBatch:
    """ctypes wrapper over the native lockstep API (poa_batch.cpp)."""

    _bound = False

    @classmethod
    def _bind(cls):
        lib = cpu_ops.get_library()
        if not cls._bound:
            lib.rt_poab_create.restype = ctypes.c_void_p
            lib.rt_poab_create.argtypes = [ctypes.c_int32]
            lib.rt_poab_destroy.argtypes = [ctypes.c_void_p]
            lib.rt_poab_seed.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
                ctypes.c_int32, ctypes.c_char_p, ctypes.c_uint8]
            lib.rt_poab_export.restype = ctypes.c_int32
            lib.rt_poab_export.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                np.ctypeslib.ndpointer(np.uint8),
                np.ctypeslib.ndpointer(np.int16),
                np.ctypeslib.ndpointer(np.uint8),
                np.ctypeslib.ndpointer(np.int32)]
            lib.rt_poab_apply.argtypes = [
                ctypes.c_void_p, ctypes.c_int32,
                np.ctypeslib.ndpointer(np.int32),
                np.ctypeslib.ndpointer(np.int32),
                ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
                ctypes.c_char_p, ctypes.c_uint8, ctypes.c_int32]
            lib.rt_poab_num_nodes.restype = ctypes.c_int32
            lib.rt_poab_num_nodes.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int32]
            lib.rt_poab_consensus.restype = ctypes.c_int64
            lib.rt_poab_consensus.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32)]
            cls._bound = True
        return lib

    def __init__(self, n_windows: int):
        self.lib = self._bind()
        self.handle = ctypes.c_void_p(self.lib.rt_poab_create(n_windows))

    def close(self):
        if self.handle:
            self.lib.rt_poab_destroy(self.handle)
            self.handle = None

    def __del__(self):
        self.close()


def columns(l: int, wb: int) -> int:
    """DP columns of a round: the band, or the whole row."""
    return wb if wb else l + 1


def check_inputs(bases, preds, nrows, sinks, seq, slen, *, v, l, p, k,
                 wb) -> int:
    """Raise on anything the kernel does not take; returns B."""
    if bases.dim() != 2 or bases.shape[1] != v:
        raise ValueError(f"bases must be [B, {v}], got "
                         f"{tuple(bases.shape)}")
    b = int(bases.shape[0])
    want = {"bases": (bases, torch.uint8, (b, v)),
            "preds": (preds, torch.int16, (b, v, p)),
            "nrows": (nrows, torch.int32, (b,)),
            "sinks": (sinks, torch.uint8, (b, v)),
            "seq": (seq, torch.uint8, (b, l)),
            "slen": (slen, torch.int32, (b,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != bases.device:
            raise ValueError(f"{name} is on {t.device}, bases on "
                             f"{bases.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k < 1 or k & (k - 1):
        raise ValueError(f"k={k} must be a power of two")
    if wb and (wb % 4 or wb < 4):
        raise ValueError(f"wb={wb} must be a positive multiple of 4")
    # every offset of the kernel's v x cols tape and its v + l tapes is
    # 64-bit, and it walks a row of any width tile by tile
    if not (1 <= v <= MAX_V and 1 <= l and 1 <= p <= MAX_P):
        raise ValueError(f"shape v={v} l={l} p={p} wb={wb} does not fit "
                         "the kernel")
    return b


def plan(v: int, l: int, p: int, wb: int, device) -> dict:
    """The kernel's plan for a round on the CUDA ``device``: columns a
    thread, warps a lane, rows of its shared-memory ring, whether the
    layer sits in shared memory, the block's shared bytes (0: it does
    not fit)."""
    from racon_tpu_torch.cuda import build

    lib = build.load("poa_lockstep")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        lib.poa_lockstep_plan(v, l, p, wb, out)
    return dict(zip(("cols_per_thread", "warps", "shared_rows",
                     "seq_in_shared", "shared_bytes"), out))


def lockstep_buffers(b: int, v: int, l: int, k: int, wb: int, device,
                     timed: bool = False) -> dict:
    """Every buffer one round's launch writes, made on the CUDA
    ``device`` before the launch (so a dispatch's event window holds the
    launch alone), and the bound library with its kernels loaded: the
    ring of 2k score rows (a pred row k back is never the slot its rank
    writes), the direction tape, both output tapes and, ``timed``, the
    phase counters.  Nothing on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    from racon_tpu_torch.cuda import build

    cols = columns(l, wb)
    out = {"key": (b, v, l, k, wb),
           "lib": build.prepare("poa_lockstep", device),
           "ring": torch.empty((b, 2 * k, cols), dtype=torch.float32,
                               device=device),
           "dirs": torch.empty((b, v, cols), dtype=torch.uint8,
                               device=device),
           "node_tape": torch.empty((b, v + l), dtype=torch.int32,
                                    device=device),
           "seq_tape": torch.empty((b, v + l), dtype=torch.int32,
                                   device=device)}
    if timed:
        out["meta"] = torch.zeros((b, len(PHASES) + len(COUNTS)),
                                  dtype=torch.int64, device=device)
    return out


def poa_round(bases, preds, nrows, sinks, seq, slen, *, v: int, l: int,
              p: int, k: int, wb: int, match: int, mismatch: int,
              gap: int, timer=None, bufs=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(node_tape, seq_tape) ``[B, V + L]`` int32 on the inputs' device.
    CUDA tensors launch the kernel (one block per lane) into ``bufs``
    (``lockstep_buffers`` for this round, or buffers made here; with
    ``meta`` the build that counts its phases); ``timer``, a
    ``devclock.DispatchTimer``, gets a mark after the launch.  CPU
    tensors run the plain version."""
    b = check_inputs(bases, preds, nrows, sinks, seq, slen, v=v, l=l, p=p,
                     k=k, wb=wb)
    scores = dict(match=match, mismatch=mismatch, gap=gap)
    if bases.device.type == "cpu":
        return poa_round_reference(bases, preds, nrows, sinks, seq, slen,
                                   v=v, l=l, p=p, k=k, wb=wb, **scores)
    if bases.device.type != "cuda":
        raise ValueError(f"unsupported device {bases.device}")
    from racon_tpu_torch.cuda import build

    dev = bases.device
    if bufs is None:
        bufs = lockstep_buffers(b, v, l, k, wb, dev)
    elif bufs.get("key") != (b, v, l, k, wb):
        raise ValueError(f"buffers for {bufs.get('key')}, not the round's "
                         f"{(b, v, l, k, wb)}")
    node_tape, seq_tape = bufs["node_tape"], bufs["seq_tape"]
    if b == 0:
        return node_tape, seq_tape
    meta = bufs.get("meta")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = bufs["lib"].poa_lockstep_launch(
            bases.data_ptr(), preds.data_ptr(), nrows.data_ptr(),
            sinks.data_ptr(), seq.data_ptr(), slen.data_ptr(),
            bufs["ring"].data_ptr(), bufs["dirs"].data_ptr(),
            node_tape.data_ptr(), seq_tape.data_ptr(),
            None if meta is None else meta.data_ptr(), b, v, l, p, k, wb,
            match, mismatch, gap, stream)
    if err != 0:
        raise RuntimeError(f"poa_lockstep kernel launch failed: "
                           f"{build.error_string('poa_lockstep', err)} "
                           f"({err})")
    build.count_launch("poa_lockstep")
    if timer is not None:
        timer.mark()
    return node_tape, seq_tape


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def poa_round_reference(bases, preds, nrows, sinks, seq, slen, *, v: int,
                        l: int, p: int, k: int, wb: int, match: int,
                        mismatch: int, gap: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, same inputs and outputs as
    ``poa_round``: both JAX kernels' float32 arithmetic written out, a
    Python loop over ranks vectorised over the batch on the inputs'
    device, then each lane's traceback walked on the host from the
    direction codes (one step a move, as the JAX kernels walk it).
    Ranks past the deepest lane's ``nrows`` are left out: no traceback
    reads them."""
    b = check_inputs(bases, preds, nrows, sinks, seq, slen, v=v, l=l, p=p,
                     k=k, wb=wb)
    dev = bases.device
    f32 = torch.float32
    cols = columns(l, wb)
    node_tape = torch.full((b, v + l), PATH_DONE, dtype=torch.int32,
                           device=dev)
    seq_tape = torch.full_like(node_tape, PATH_DONE)
    if b == 0:
        return node_tape, seq_tape
    lanes = torch.arange(b, device=dev)
    ci = torch.arange(cols, dtype=torch.int64, device=dev)
    cg = ci.to(f32) * gap                           # j * gap, exact
    neg = torch.tensor(float(NEG), dtype=f32, device=dev)
    s_match = torch.tensor(float(match), dtype=f32, device=dev)
    s_mismatch = torch.tensor(float(mismatch), dtype=f32, device=dev)
    nrows_l = nrows.to(torch.int64)
    slen_l = slen.to(torch.int64)
    rmax = min(v, int(nrows_l.max()))
    ring = torch.full((b, k, cols), float(NEG), dtype=f32, device=dev)
    dir_rows = torch.zeros((max(rmax, 1), b, cols), dtype=torch.uint8,
                           device=dev)
    end_score = torch.full((b, max(rmax, 1)), float(NEG), dtype=f32,
                           device=dev)
    neg_p1 = neg.expand(b, p, 1)
    neg_b1 = neg.expand(b, 1)
    # what no score depends on, for every rank at once: the base, the
    # preds' ring slots, which preds are rows and which the start row
    bases_l = bases[:, :rmax].to(torch.int64)
    preds_l = preds[:, :rmax].to(torch.int64)
    slots = (preds_l - 1) & (k - 1)
    is_start = (preds_l == 0)[..., None]
    rows = torch.arange(rmax + 1, dtype=torch.int64, device=dev)
    sink_row = (sinks[:, :rmax] > 0) & (rows[None, 1:] <= nrows_l[:, None])

    if wb:
        q = wb // 4
        nr = nrows_l.clamp(min=1)
        smax_q = _floordiv((slen_l + 1 - wb).clamp(min=0) + q - 1, q)
        # every DP row's quantised band start, [B, rmax + 1] (row 0, the
        # virtual start row, is never read through it)
        sq_all = torch.minimum(_floordiv(
            _floordiv(rows[None, :] * slen_l[:, None], nr[:, None])
            - wb // 2, q).clamp(min=0), smax_q[:, None])
        s_all = sq_all * q
        # a pred row lagging m < N_SHIFT quanta: its band shifted by m * q
        dq = sq_all[:, 1:, None] - sq_all.gather(
            1, preds_l.clamp(min=0).flatten(1)).view(b, rmax, p)
        lag_ok = ((dq >= 0) & (dq < N_SHIFT) & (preds_l > 0))[..., None]
        lag_at = (dq.clamp(0, N_SHIFT - 1) * q)[..., None]
        ext = torch.arange(wb + 1, dtype=torch.int64, device=dev)
        neg_pad = neg.expand(b, p, N_SHIFT * q)
        # the start row's value at band column c (sequence index j = s +
        # c - 1), and the layer shifted one so that index 0 is j = -1;
        # off the layer no base matches
        span = max(int(s_all.max()) + wb, l) + 1
        jv = torch.arange(span, dtype=torch.int64, device=dev) - 1
        v_row = torch.where(jv >= 0, jv.to(f32) * gap, neg)
        seq_ext = torch.full((b, span), -1, dtype=torch.int64, device=dev)
        seq_ext[:, 1:l + 1] = seq.to(torch.int64)
        seq_ext[:, 1:][jv[None, 1:] >= slen_l[:, None]] = -1
        c_end = slen_l[:, None] - s_all[:, 1:]
        end_ok = c_end < wb
        end_col = c_end.clamp(0, wb - 1)
    else:
        seq_l = seq.to(torch.int64)
        has_pred = (preds_l > 0)[..., None]

    for r in range(1, rmax + 1):
        g1 = ring[lanes[:, None], slots[:, r - 1]]           # [B, P, cols]
        base_r = bases_l[:, r - 1, None]
        if wb:
            at = s_all[:, r, None] + ext                     # [B, wb + 1]
            g1_pad = torch.cat([neg_p1, g1, neg_pad], dim=2)
            hp = torch.where(lag_ok[:, r - 1],
                             g1_pad.gather(2, lag_at[:, r - 1] + ext),
                             torch.where(is_start[:, r - 1],
                                         v_row[at][:, None, :], neg))
            sub = torch.where(seq_ext.gather(1, at[:, :wb]) == base_r,
                              s_match, s_mismatch)
            diag = hp[:, :, :wb] + sub[:, None, :]
            vert = hp[:, :, 1:] + gap
        else:
            hp = torch.where(has_pred[:, r - 1], g1,
                             torch.where(is_start[:, r - 1],
                                         cg[None, None, :], neg))
            sub = torch.where(seq_l == base_r, s_match, s_mismatch)
            diag = torch.cat([neg_p1, hp[:, :, :-1] + sub[:, None, :]],
                             dim=2)
            vert = hp + gap
        t_best = torch.maximum(diag.amax(dim=1), vert.amax(dim=1))
        # close the in-row gap chain: H[j] = max_{c<=j} T[c] + (j-c) gap
        hr = torch.cummax(t_best - cg, dim=1).values + cg
        horiz = torch.cat([neg_b1, hr[:, :-1] + gap], dim=1)
        cand = torch.cat([diag, vert, horiz[:, None, :]], dim=1)
        # first candidate equal to the row value: diag(p), vert(p), horiz
        dir_rows[r - 1] = (cand == hr[:, None, :]).to(torch.uint8) \
            .argmax(dim=1).to(torch.uint8)
        ring[:, (r - 1) & (k - 1)] = hr
        # the row's score at the layer's end, for the sink fold
        end_score[:, r - 1] = hr.gather(1, end_col[:, r - 1, None])[:, 0] \
            if wb else hr[lanes, slen_l]

    # fold sink-row end scores: the earliest rank of the best score above
    # -inf wins (row 0, the start, when none)
    if wb:
        sink_row = sink_row & end_ok
    scores = torch.where(sink_row, end_score[:, :rmax], neg)
    top = torch.cat([neg_b1, scores], dim=1).amax(dim=1, keepdim=True)
    first = torch.where(scores == top, rows[None, 1:],
                        rmax + 1).amin(dim=1) if rmax else 0
    best_row = torch.where(top[:, 0] > neg, first, 0)

    # the traceback from each lane's best sink: code < p a diagonal move
    # from pred slot code, < 2p a vertical one from slot code - p, else
    # horizontal; row 0 moves left only
    codes = dir_rows.cpu().numpy()
    preds_h = preds.cpu().numpy()
    sq_h = sq_all.cpu().numpy() if wb else None
    nt = np.full((b, v + l), PATH_DONE, dtype=np.int32)
    st = np.full((b, v + l), PATH_DONE, dtype=np.int32)
    for i, (r, j) in enumerate(zip(best_row.tolist(), slen_l.tolist())):
        for t in range(v + l):
            if r == 0 and j == 0:
                break
            code = 2 * p
            if r > 0:
                c = min(max(j - int(sq_h[i, r]) * q, 0), wb - 1) if wb \
                    else j
                code = int(codes[min(r, len(codes)) - 1, i, c])
            if code < 2 * p:
                nt[i, t] = r - 1
                st[i, t] = j - 1 if code < p else PATH_NONE
                r = int(preds_h[i, r - 1, code % p])
            else:
                nt[i, t] = PATH_NONE
                st[i, t] = j - 1
            if code >= p * 2 or code < p:
                j = max(j - 1, 0)
    node_tape.copy_(torch.from_numpy(nt))
    seq_tape.copy_(torch.from_numpy(st))
    return node_tape, seq_tape
