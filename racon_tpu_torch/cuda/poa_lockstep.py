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
tensors; on a CUDA tensor it launches or raises.
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
THREADS = 256       # the kernel's block: one lane (window) per block
MAX_COLS = 16 * THREADS     # columns a block holds (16 per thread)
MAX_P = 32


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
    if not (1 <= v and 1 <= l and 1 <= p <= MAX_P
            and columns(l, wb) <= MAX_COLS
            and v * (l + 1) < 2 ** 31 and (v + l) * max(b, 1) < 2 ** 31):
        raise ValueError(f"shape v={v} l={l} p={p} wb={wb} does not fit "
                         "the kernel")
    return b


def poa_round(bases, preds, nrows, sinks, seq, slen, *, v: int, l: int,
              p: int, k: int, wb: int, match: int, mismatch: int,
              gap: int, timer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(node_tape, seq_tape) ``[B, V + L]`` int32 on the inputs' device.
    CUDA tensors launch the kernel (one block per lane; ``timer``, a
    ``devclock.DispatchTimer``, gets a mark after the launch), CPU
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

    lib = build.load("poa_lockstep")
    dev = bases.device
    cols = columns(l, wb)
    node_tape = torch.empty((b, v + l), dtype=torch.int32, device=dev)
    seq_tape = torch.empty((b, v + l), dtype=torch.int32, device=dev)
    if b == 0:
        return node_tape, seq_tape
    # the kernel's scratch: a ring of 2k score rows (a pred row k back
    # is never the slot its rank writes) and the direction tape
    ring = torch.empty((b, 2 * k, cols), dtype=torch.float32, device=dev)
    dirs = torch.empty((b, v, cols), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.poa_lockstep_launch(
            bases.data_ptr(), preds.data_ptr(), nrows.data_ptr(),
            sinks.data_ptr(), seq.data_ptr(), slen.data_ptr(),
            ring.data_ptr(), dirs.data_ptr(), node_tape.data_ptr(),
            seq_tape.data_ptr(), b, v, l, p, k, wb, match, mismatch, gap,
            stream)
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
    device.  Ranks past the deepest lane's ``nrows`` and traceback steps
    after every lane's walk ended are left out: no traceback reads
    them."""
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
    preds_l = preds.to(torch.int64)
    seq_l = seq.to(torch.int64)
    bases_l = bases.to(torch.int64)
    nrows_l = nrows.to(torch.int64)
    slen_l = slen.to(torch.int64)
    ring = torch.full((b, k, cols), float(NEG), dtype=f32, device=dev)
    best_score = torch.full((b,), float(NEG), dtype=f32, device=dev)
    best_row = torch.zeros(b, dtype=torch.int64, device=dev)
    rmax = min(v, int(nrows_l.max()))
    dir_rows = torch.zeros((max(rmax, 1), b, cols), dtype=torch.uint8,
                           device=dev)
    neg_p1 = neg.expand(b, p, 1)
    neg_b1 = neg.expand(b, 1)

    if wb:
        q = wb // 4
        nr = nrows_l.clamp(min=1)
        smax_q = _floordiv((slen_l + 1 - wb).clamp(min=0) + q - 1, q)

        def band_start_q(r):
            """Quantised band start of DP row(s) ``r`` ([B] or [B, P])."""
            if r.dim() == 2:
                c = _floordiv(_floordiv(r * slen_l[:, None], nr[:, None])
                              - wb // 2, q)
                return torch.minimum(c.clamp(min=0), smax_q[:, None])
            c = _floordiv(_floordiv(r * slen_l, nr) - wb // 2, q)
            return torch.minimum(c.clamp(min=0), smax_q)

        ext = torch.arange(wb + 1, dtype=torch.int64, device=dev)
        neg_pad = neg.expand(b, p, N_SHIFT * q)
        neg_ext = neg.expand(b, p, wb + 1)

    for r in range(1, rmax + 1):
        pidx = preds_l[:, r - 1, :]                          # [B, P]
        slot = (pidx - 1) & (k - 1)
        g1 = ring[lanes[:, None], slot]                      # [B, P, cols]
        base_r = bases_l[:, r - 1]
        if wb:
            sq_r = band_start_q(torch.full_like(nrows_l, r))
            s_r = sq_r * q
            dq = sq_r[:, None] - band_start_q(pidx)
            g1_pad = torch.cat([neg_p1, g1, neg_pad], dim=2)
            hp = neg_ext
            for m in range(N_SHIFT):
                hp = torch.where((dq == m)[:, :, None],
                                 g1_pad[:, :, m * q: m * q + wb + 1], hp)
            j_ext = s_r[:, None] + ext[None, :] - 1
            vv = torch.where(j_ext >= 0, j_ext.to(f32) * gap, neg)
            hp = torch.where((pidx > 0)[:, :, None], hp,
                             torch.where((pidx == 0)[:, :, None],
                                         vv[:, None, :], neg))
            j_sub = s_r[:, None] + ci[None, :] - 1           # seq index
            sb = seq_l.gather(1, j_sub.clamp(0, l - 1))
            sub_ok = (j_sub >= 0) & (j_sub < slen_l[:, None]) \
                & (sb == base_r[:, None])
            sub = torch.where(sub_ok, match, mismatch).to(f32)
            diag = hp[:, :, :wb] + sub[:, None, :]
            vert = hp[:, :, 1:] + gap
        else:
            hp = torch.where((pidx > 0)[:, :, None], g1,
                             torch.where((pidx == 0)[:, :, None],
                                         cg[None, None, :], neg))
            sub = torch.where(seq_l == base_r[:, None], match,
                              mismatch).to(f32)               # [B, L]
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
        # fold sink-row end scores (the earliest rank wins ties)
        is_sink = (sinks[:, r - 1] > 0) & (r <= nrows_l)
        if wb:
            c_end = slen_l - s_r
            s_end = hr.gather(1, c_end.clamp(0, wb - 1)[:, None])[:, 0]
            better = is_sink & (c_end < wb) & (s_end > best_score)
        else:
            s_end = hr[lanes, slen_l]
            better = is_sink & (s_end > best_score)
        best_score = torch.where(better, s_end, best_score)
        best_row = torch.where(better, torch.full_like(best_row, r),
                               best_row)

    r, j = best_row, slen_l.clone()
    for t in range(v + l):
        done = (r == 0) & (j == 0)
        if bool(done.all()):
            break                   # PATH_DONE from here on, as filled
        rm1 = (r - 1).clamp(min=0)
        c = (j - band_start_q(r) * q).clamp(0, wb - 1) if wb else j
        code = dir_rows[rm1.clamp(max=dir_rows.shape[0] - 1), lanes, c] \
            .to(torch.int64)
        live = r > 0
        is_diag = (code < p) & live
        is_vert = (code >= p) & (code < 2 * p) & live
        step = is_diag | is_vert
        slot = torch.where(is_diag, code, code - p).clamp(0, p - 1)
        pred_r = preds_l[lanes, rm1, slot]
        node = torch.where(step, r - 1, PATH_NONE)
        spos = torch.where(is_vert, PATH_NONE, j - 1)
        node_tape[:, t] = torch.where(done, PATH_DONE, node).to(torch.int32)
        seq_tape[:, t] = torch.where(done, PATH_DONE, spos).to(torch.int32)
        r = torch.where(done | ~step, r, pred_r)
        j = torch.where(done | is_vert, j, (j - 1).clamp(min=0))
    return node_tape, seq_tape
