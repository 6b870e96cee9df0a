"""The scan align ladder: host codecs, the two scan kernels' wrappers and
plain PyTorch versions, the band-doubling ladder and the batched aligner
(the port's counterpart of ``racon_tpu/tpu/aligner.py``).

Sequences go to the kernels as ``[B, L]`` uint8 codes (A/C/G/T 0..3,
every other byte 4, so N matches N); query rows are padded with
``QPAD`` and target rows with ``TPAD``, values no base code equals.
Decoded alignments are op tapes in traceback (reversed) order over the
``OP_*`` alphabet; ``ops_to_runs`` turns one into the
``Overlap.cigar_runs`` arrays.

The two kernels (``csrc/align_scan.cu``) compute what
``racon_tpu/tpu/aligner.py:_align_kernel`` and ``_banded_align_kernel``
(XLA ``jax.jit`` kernels) compute (the full kernel bit-parallel, column
by column, its traceback recomputing the same directions from the
scores): unit-cost global alignment swept over
the anti-diagonals d = 1, 2, ... of the DP, cell (i, j) = (d - j, j),
with a 2-bit direction per cell (diagonal 0 when the cell equals its
diagonal candidate, else up 1 when it equals its vertical one, else left
2) and a traceback from (ql, tl) that reads them.  The full kernel holds
columns 0..lt of each diagonal; the banded one holds ``hw + 2`` slots
from ``jlo(d) = max(0, floor((d - hw + 1) / 2))`` (the Ukkonen band
|j - i| <= hw), cells off the matrix at ``BIG`` and every value clipped
to ``BIG``.  Both give the reversed op tape ``[B, lq + lt]`` uint8,
``OP_STOP`` after (0, 0); a banded lane whose tape costs more than
``hw`` (or whose lengths differ by more than ``hw``) is not exact, and
``band_align_batch`` runs it again wider.

``align_full`` / ``align_banded`` launch the kernel for CUDA tensors
(counted as ``align_scan_full`` / ``align_scan_band``) and run the plain
version for CPU tensors; on a CUDA tensor they launch or raise.  The
plain versions sweep only the diagonals the traceback can read (up to
the batch's largest ``ql + tl``); the tape is the same.

Switches: ``RACON_TPU_TORCH_SCAN_ALIGN=1`` (the JAX package's
``RACON_TPU_PALLAS_ALIGN=0``) sends the polisher's align stage to this
ladder instead of the WFA/band ladder; ``RACON_TPU_TORCH_PORTABLE=1``
(its ``RACON_TPU_NO_PALLAS=1``) does that and also sends every POA
megabatch to the lockstep engine.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from racon_tpu_torch.obs.decision import DECISIONS
from racon_tpu_torch.utils.tuning import pow2_at_least

# base encoding: A/C/G/T -> 0..3, anything else 4; pads never match
ENCODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ENCODE[_b] = _i
QPAD = 5
TPAD = 6

# op codes of a decoded tape (CIGAR alphabet)
OP_STOP, OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3, 4
_OP_CHARS = np.array([0, ord("="), ord("X"), ord("I"), ord("D")],
                     dtype=np.uint8)
# op code -> "MIDNSHP=X" index (the Overlap.cigar_runs convention)
_RUN_CODE = np.array([0, 7, 8, 1, 2], dtype=np.int64)

BIG = 1 << 20
# 2-bit direction codes of the scan kernels
DIR_DIAG, DIR_UP, DIR_LEFT = 0, 1, 2

# band-doubling ladder (half-widths); past it the unbanded kernel, or
# the caller's CPU fall-through
BAND_LADDER = (512, 2048, 8192)


def scan_selected() -> bool:
    """True when the polisher's align stage runs the scan ladder:
    RACON_TPU_TORCH_SCAN_ALIGN=1 or RACON_TPU_TORCH_PORTABLE=1."""
    return os.environ.get("RACON_TPU_TORCH_SCAN_ALIGN") == "1" \
        or portable()


def portable() -> bool:
    """RACON_TPU_TORCH_PORTABLE=1: the scan ladder, and every POA
    megabatch on the lockstep engine."""
    return os.environ.get("RACON_TPU_TORCH_PORTABLE") == "1"


def encode_batch(seqs: Sequence[bytes], length: int,
                 pad: int) -> np.ndarray:
    """Encode byte strings into a padded ``[B, length]`` uint8 array."""
    out = np.full((len(seqs), length), pad, dtype=np.uint8)
    for i, s in enumerate(seqs):
        a = np.frombuffer(s, dtype=np.uint8)
        out[i, :len(a)] = ENCODE[a]
    return out


def ops_to_runs(ops_row: np.ndarray):
    """RLE a reversed op tape row into (lengths, codes) arrays in the
    Overlap.cigar_runs convention ("MIDNSHP=X" indices)."""
    fwd = ops_row[ops_row != OP_STOP][::-1]
    if fwd.size == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    change = np.flatnonzero(np.diff(fwd)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [fwd.size]))
    return ((ends - starts).astype(np.int64),
            _RUN_CODE[fwd[starts].astype(np.int64)])


def ops_to_cigar(ops_row: np.ndarray) -> str:
    """RLE a reversed op tape row into a standard =/X/I/D CIGAR."""
    ops_row = ops_row[ops_row != OP_STOP][::-1]
    if ops_row.size == 0:
        return ""
    change = np.flatnonzero(np.diff(ops_row)) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [ops_row.size]))
    return "".join(f"{e - s}{chr(_OP_CHARS[ops_row[s]])}"
                   for s, e in zip(starts, ends))


# ---------------------------------------------------------------------------
# the scan kernels: wrappers
# ---------------------------------------------------------------------------

def jlo(d: int, hw: int) -> int:
    """First in-band column of anti-diagonal ``d`` (a floor shift, also
    for negative arguments)."""
    return max(0, (d - hw + 1) >> 1)


def packed_width(lt: int, hw: int) -> int:
    """Bytes of one diagonal's 2-bit directions: lt + 1 columns (full)
    or hw + 2 slots (banded), 4 a byte."""
    return (lt + 4) // 4 if hw == 0 else (hw + 5) // 4


def check_inputs(q, t, ql, tl, hw: int) -> Tuple[int, int, int]:
    """Raise on anything the kernels do not take; returns (B, lq, lt)."""
    if q.dim() != 2 or t.dim() != 2:
        raise ValueError("q and t must be [B, L]")
    b, lq, lt = int(q.shape[0]), int(q.shape[1]), int(t.shape[1])
    want = {"q": (q, torch.uint8, (b, lq)), "t": (t, torch.uint8, (b, lt)),
            "ql": (ql, torch.int32, (b,)), "tl": (tl, torch.int32, (b,))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hw < 0 or lq < 1 or lt < 1:
        raise ValueError(f"lq={lq} lt={lt} hw={hw} does not fit the kernel")
    return b, lq, lt


def tape_bytes(b: int, lq: int, lt: int, hw: int, device) -> int:
    """Bytes of the direction tape of a launch of ``b`` lanes: the
    kernels' own layout on the card (``align_scan_dir_bytes``; -1 when
    hw is past the banded kernel), elsewhere the JAX package's 2-bit
    one (``packed_width``), by which its ladder sizes its chunks."""
    device = torch.device(device)
    if device.type != "cuda":
        return b * (lq + lt) * packed_width(lt, hw)
    from racon_tpu_torch.cuda import build

    with torch.cuda.device(device):
        return int(build.load("align_scan").align_scan_dir_bytes(
            b, lq, lt, hw))


def scan_buffers(b: int, lq: int, lt: int, hw: int, device) -> dict:
    """Every buffer one scan launch writes, made on ``device`` before
    the launch (so a dispatch's event window holds the launch alone):
    ``ops`` [b, lq + lt] uint8 zeroed (the tapes), ``meta`` [b, 2]
    int64 zeroed (each lane's sweep and traceback clock64() cycles; the
    plain version leaves 0), the launch they were made for (``key``),
    and on the card the kernel's tape (``dirs``: the full kernel's
    column words, the banded kernel's direction words) and the bound
    library with its kernels loaded.  Raises when hw is past the banded
    kernel."""
    device = torch.device(device)
    bufs = {"ops": torch.zeros((b, lq + lt), dtype=torch.uint8,
                               device=device),
            "meta": torch.zeros((b, 2), dtype=torch.int64, device=device),
            "key": (b, lq, lt, hw)}
    if device.type != "cuda" or b == 0:
        return bufs
    from racon_tpu_torch.cuda import build

    bufs["lib"] = lib = build.prepare("align_scan", device)
    with torch.cuda.device(device):
        dir_bytes = int(lib.align_scan_dir_bytes(b, lq, lt, hw))
    if dir_bytes < 0:
        raise ValueError(f"hw={hw} is past the banded kernel")
    bufs["dirs"] = torch.empty(dir_bytes, dtype=torch.uint8, device=device)
    return bufs


def _launch(q, t, ql, tl, hw: int, name: str, bufs: dict):
    """One align_scan launch (hw 0: the full kernel) into ``bufs``
    (``scan_buffers`` for this very launch: the tape's size follows b,
    lq, lt and hw): the op tape."""
    from racon_tpu_torch.cuda import build

    b, lq, lt = int(q.shape[0]), int(q.shape[1]), int(t.shape[1])
    if bufs.get("key") != (b, lq, lt, hw):
        raise ValueError(f"scan buffers made for (b, lq, lt, hw) = "
                         f"{bufs.get('key')} do not fit the launch's "
                         f"{(b, lq, lt, hw)}")
    ops = bufs["ops"]
    if b == 0:
        return ops
    dev = q.device
    dirs, meta = bufs["dirs"], bufs["meta"]
    if any(x.device != dev for x in (ops, meta, dirs)):
        raise ValueError("scan buffers are not on the inputs' device")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = bufs["lib"].align_scan_launch(
            q.data_ptr(), t.data_ptr(), ql.data_ptr(), tl.data_ptr(),
            dirs.data_ptr(), ops.data_ptr(), meta.data_ptr(), b, lq, lt,
            hw, stream)
    if err != 0:
        msg = bufs["lib"].align_scan_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    build.count_launch(name)
    return ops


def _run(q, t, ql, tl, hw: int, plain, name: str, bufs):
    b, lq, lt = check_inputs(q, t, ql, tl, hw)
    if q.device.type == "cpu":
        return plain()
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if bufs is None:
        bufs = scan_buffers(b, lq, lt, hw, q.device)
    return _launch(q, t, ql, tl, hw, name, bufs)


def align_full(q, t, ql, tl, bufs=None):
    """Reversed op tapes ``[B, lq + lt]`` of the unbanded alignment, on
    the inputs' device: the kernel for CUDA tensors (into ``bufs``, from
    ``scan_buffers``, or buffers made here), the plain version for CPU
    tensors."""
    return _run(q, t, ql, tl, 0, lambda: align_full_plain(q, t, ql, tl),
                "align_scan_full", bufs)


def align_banded(q, t, ql, tl, hw: int, bufs=None):
    """Reversed op tapes ``[B, lq + lt]`` of the alignment banded at
    half-width ``hw`` (>= 1), on the inputs' device."""
    if hw < 1:
        raise ValueError(f"hw={hw}: the banded kernel needs hw >= 1")
    return _run(q, t, ql, tl, hw,
                lambda: align_banded_plain(q, t, ql, tl, hw),
                "align_scan_band", bufs)


# ---------------------------------------------------------------------------
# plain versions (the JAX scans' own formulation)
# ---------------------------------------------------------------------------

_PACK = (1, 4, 16, 64)


def _pack(codes: torch.Tensor, width: int) -> torch.Tensor:
    """``[B, n]`` 2-bit codes -> ``[B, width]`` bytes, 4 a byte, cell
    k at byte k >> 2, bits 2 * (k & 3)."""
    b, n = codes.shape
    x = torch.nn.functional.pad(codes, (0, width * 4 - n)).view(b, width, 4)
    w = torch.tensor(_PACK, dtype=torch.uint8, device=codes.device)
    return (x * w).sum(2, dtype=torch.uint8)


def _codes(cur, c_diag, c_up) -> torch.Tensor:
    """Diagonal 0 if cur equals its diagonal candidate, else up 1 if it
    equals its vertical one, else left 2."""
    return ((cur != c_diag).to(torch.uint8)
            * (1 + (cur != c_up).to(torch.uint8)))


def _traceback(q, t_pad, ql, tl, dirs, slot_of) -> torch.Tensor:
    """Walk every lane from (ql, tl) to (0, 0), one op a step: the code
    at ``dirs[d - 1, lane, slot >> 2]`` (``slot_of(i, j)``), forced left
    on row 0 and up on column 0, then ``OP_STOP``."""
    b, lq = q.shape
    lt = t_pad.shape[1] - 1
    dev = q.device
    ops = torch.zeros((b, lq + lt), dtype=torch.uint8, device=dev)
    q_pad1 = torch.cat([torch.full((b, 1), QPAD, dtype=torch.uint8,
                                   device=dev), q], 1)
    lanes = torch.arange(b, device=dev)
    i = ql.long().clamp(0, lq)
    j = tl.long().clamp(0, lt)
    for k in range(dirs.shape[0]):
        done = (i == 0) & (j == 0)
        # a finished lane writes STOP and stays, so the host checks
        # for the end only now and then
        if k % 64 == 0 and bool(done.all()):
            break
        s = slot_of(i, j)
        byte = dirs[(i + j - 1).clamp(min=0), lanes, s >> 2].long()
        code = (byte >> ((s & 3) * 2)) & 3
        code = torch.where(i == 0, DIR_LEFT, code)
        code = torch.where(j == 0, DIR_UP, code)
        op = torch.where(code == DIR_DIAG,
                         torch.where(q_pad1[lanes, i] == t_pad[lanes, j],
                                     OP_EQ, OP_X),
                         torch.where(code == DIR_UP, OP_I, OP_D))
        ops[:, k] = torch.where(done, OP_STOP, op)
        live = ~done
        i = i - ((code != DIR_LEFT) & live).long()
        j = j - ((code != DIR_UP) & live).long()
    return ops


def _sweep_len(ql, tl, lq: int, lt: int) -> int:
    """Diagonals the traceback can read: the batch's largest ql + tl."""
    if ql.numel() == 0:
        return 0
    return int((ql.long().clamp(0, lq) + tl.long().clamp(0, lt)).max())


def align_full_plain(q, t, ql, tl):
    """``_align_kernel`` in plain PyTorch on the inputs' device: one
    anti-diagonal of every pair per step over columns 0..lt (the column
    j reads up = prev[j], left = prev[j - 1], diag = prev2[j - 1]), the
    diagonal's directions packed 4 a byte, then a lockstep traceback."""
    b, lq = q.shape
    lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    steps = _sweep_len(ql, tl, lq, lt)
    # rq_pad[lt + m] = q[lq - 1 - m]: the slice from lt + lq - d puts
    # q[d - 1 - j] at column j
    rq_pad = torch.full((b, lq + 2 * lt + 1), QPAD, dtype=torch.uint8,
                        device=dev)
    rq_pad[:, lt:lt + lq] = q.flip(1)
    t_pad = torch.cat([torch.full((b, 1), TPAD, dtype=torch.uint8,
                                  device=dev), t], 1)
    big_col = torch.full((b, 1), BIG, dtype=i32, device=dev)
    prev = torch.arange(lt + 1, dtype=i32, device=dev)[None, :].expand(
        b, -1).contiguous()
    prev2 = torch.zeros((b, lt + 1), dtype=i32, device=dev)
    width = packed_width(lt, 0)
    dirs = torch.empty((max(steps, 1), b, width), dtype=torch.uint8,
                       device=dev)
    for d in range(1, steps + 1):
        left = torch.cat([big_col, prev[:, :-1]], 1)
        diag = torch.cat([big_col, prev2[:, :-1]], 1)
        qd = rq_pad[:, lt + lq - d:lt + lq - d + lt + 1]
        sub = (qd != t_pad).to(i32)
        c_diag = diag + sub
        c_up = prev + 1
        cur = torch.minimum(torch.minimum(c_diag, c_up), left + 1)
        # boundary cells of this diagonal: j == 0 and j == d (i == 0)
        cur[:, 0] = d
        if d <= lt:
            cur[:, d] = d
        dirs[d - 1] = _pack(_codes(cur, c_diag, c_up), width)
        prev2, prev = prev, cur
    return _traceback(q, t_pad, ql, tl, dirs[:steps], lambda i, j: j)


def align_banded_plain(q, t, ql, tl, hw: int):
    """``_banded_align_kernel`` in plain PyTorch on the inputs' device:
    the ``hw + 2`` slots of each anti-diagonal from ``jlo(d)`` (slot s
    reads up / left at s + d1 + 1 / s + d1 of the padded diagonal d - 1
    and diag at s + d2 of d - 2, d1 and d2 the 0/1 shifts of jlo),
    cells off the matrix at BIG, then a lockstep traceback that clips
    each slot to the band."""
    b, lq = q.shape
    lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    steps = _sweep_len(ql, tl, lq, lt)
    wb = hw + 2
    slots = torch.arange(wb, dtype=i32, device=dev)
    pad_rq = lt + wb + 2
    rq_pad = torch.full((b, lq + 2 * pad_rq), QPAD, dtype=torch.uint8,
                        device=dev)
    rq_pad[:, pad_rq:pad_rq + lq] = q.flip(1)
    t_pad = torch.full((b, lt + wb + 2), TPAD, dtype=torch.uint8,
                       device=dev)
    t_pad[:, 1:lt + 1] = t
    edge = torch.full((b, 1), BIG, dtype=i32, device=dev)

    def padded(x):
        return torch.cat([edge, x, edge], 1)

    # diagonal 0 holds only cell (0, 0), at slot 0
    prev = padded(torch.where(slots == 0, 0, BIG).to(i32)[None, :]
                  .expand(b, -1))
    prev2 = padded(torch.full((b, wb), BIG, dtype=i32, device=dev))
    width = packed_width(lt, hw)
    dirs = torch.empty((max(steps, 1), b, width), dtype=torch.uint8,
                       device=dev)
    for d in range(1, steps + 1):
        lo = jlo(d, hw)
        d1 = lo - jlo(d - 1, hw)
        d2 = lo - jlo(d - 2, hw)
        up = prev[:, 1 + d1:1 + d1 + wb]
        left = prev[:, d1:d1 + wb]
        diag = prev2[:, d2:d2 + wb]
        qs = pad_rq + lq - d + lo
        qd = rq_pad[:, qs:qs + wb]
        # the JAX slice clamps its start into the row; the cells it
        # moves are past lt and read TPAD either way
        ts = min(lo, t_pad.shape[1] - wb)
        td = t_pad[:, ts:ts + wb]
        sub = (qd != td).to(i32)
        c_diag = diag + sub
        c_up = up + 1
        cur = torch.minimum(torch.minimum(c_diag, c_up), left + 1)
        # slot s holds (i, j) = (d - lo - s, lo + s): the boundary cells
        # j == 0 and i == 0 take d, then the cells off the matrix
        # (j > lt, i > lq, i < 0: two runs of slots) BIG, the rest at
        # most BIG
        for sb in (-lo, d - lo):
            if 0 <= sb < wb:
                cur[:, sb] = d
        cur.clamp_(max=BIG)
        cur[:, :max(0, min(wb, d - lo - lq))] = BIG
        cur[:, max(0, min(wb, lt - lo + 1, d - lo + 1)):] = BIG
        dirs[d - 1] = _pack(_codes(cur, c_diag, c_up), width)
        prev2, prev = prev, padded(cur)

    def slot_of(i, j):
        lo = torch.clamp((i + j - hw + 1) >> 1, min=0)
        return (j - lo).clamp(0, wb - 1)

    return _traceback(q, t_pad[:, :lt + 1], ql, tl, dirs[:steps], slot_of)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

def _pow2_batch(n: int, lo: int = 8) -> int:
    return pow2_at_least(n, lo)


def kernel_cells(ql, tl, hw: int) -> int:
    """DP cells a kernel launch computes for lanes of lengths ql, tl:
    every slot of ql + tl diagonals (banded), or the (ql + 1)(tl + 1)
    cells of the matrix (full)."""
    ql = np.asarray(ql, np.int64)
    tl = np.asarray(tl, np.int64)
    if hw:
        return int(((ql + tl) * (hw + 2)).sum())
    return int(((ql + 1) * (tl + 1) * ((ql + tl) > 0)).sum())


def full_words(ql, tl) -> int:
    """The full kernel's sweep for lanes of lengths ql, tl: one Myers
    step per 64-row word of the query per target column, summed."""
    ql = np.asarray(ql, np.int64).clip(min=0)
    tl = np.asarray(tl, np.int64).clip(min=0)
    return int(((ql + 63) // 64 * tl).sum())


def band_align_batch(queries: Sequence[bytes], targets: Sequence[bytes],
                     blq: int, blt: int, allow_full: bool = True,
                     mem_budget: int = 2 << 30, need_ratio: float = 0.2,
                     device="cpu", util=None, stats=None):
    """Align a bucket of pairs via the banded ladder (the JAX package's
    ``band_align_batch``).

    Each pair starts at the narrowest rung that could hold its
    alignment (>= |length difference| and >= ``need_ratio``, clamped to
    0.02-0.67, of its longer side); lanes whose tape costs at most the
    half-width are exact (Ukkonen) and accepted, the rest run again
    wider.  Each rung's lanes go in pow2 chunks sized by its direction
    tape against ``mem_budget``.  Lanes still unresolved past the ladder
    run the unbanded kernel when ``allow_full`` (or when the bucket is
    no wider than the last rung), else come back for the caller's CPU
    fall-through.  Retries and fall-throughs are decision records.

    ``device`` runs the kernels (a CUDA device) or their plain versions
    (the CPU); each launch's interval goes to ``util`` (default
    ``obs.DEVICE_UTIL``) and the trace's device lane.  ``stats``, when
    given, accumulates per kernel its ``launches``, ``kernel_ms``,
    ``device_s``, ``cells`` (``kernel_cells``; the full kernel's
    ``words`` too, ``full_words``), ``cycles`` (the
    lanes' summed sweep and traceback cycles, 0 on the CPU) and
    ``rungs`` (per half-width: launches, lanes, kernel_ms).  Each
    launch's inputs and buffers (``scan_buffers``) are made before its
    timer's first mark, so the marks hold the kernel wrapper alone.

    Returns (ops, cells, unresolved): the reversed op tapes
    [n, blq + blt] uint8, the ladder's cell count (the JAX package's:
    padded lanes x (blq + blt) x the rung's width), and the indices whose
    rows in ``ops`` are not valid."""
    from racon_tpu_torch.cuda.devclock import DispatchTimer

    device = torch.device(device)
    n = len(queries)
    ql_all = np.array([len(s) for s in queries], dtype=np.int64)
    tl_all = np.array([len(s) for s in targets], dtype=np.int64)
    ops_out = np.zeros((n, blq + blt), dtype=np.uint8)
    cells = 0
    # smallest plausible rung per lane: the band must hold the length
    # difference and the divergence-scaled cost estimate
    need = np.maximum(
        np.abs(ql_all - tl_all),
        (np.maximum(ql_all, tl_all)
         * min(max(need_ratio, 0.02), 0.67)).astype(np.int64))

    def run_one(idx, hw):
        nonlocal cells
        bb = _pow2_batch(len(idx))
        qs = [queries[i] for i in idx]
        ts = [targets[i] for i in idx]
        q = encode_batch(qs + [b""] * (bb - len(idx)), blq, QPAD)
        t = encode_batch(ts + [b""] * (bb - len(idx)), blt, TPAD)
        ql = np.zeros(bb, np.int32)
        ql[:len(idx)] = ql_all[idx]
        tl = np.zeros(bb, np.int32)
        tl[:len(idx)] = tl_all[idx]
        args = [torch.from_numpy(a).to(device) for a in (q, t, ql, tl)]
        bufs = scan_buffers(bb, blq, blt, hw, device)
        name = "align_scan_band" if hw else "align_scan_full"
        timer = DispatchTimer(device, util)
        timer.mark()
        ops = align_banded(*args, hw, bufs) if hw \
            else align_full(*args, bufs)
        timer.mark()
        ops = ops.cpu().numpy()
        cycles = bufs["meta"].sum(0).tolist()
        timer.record(f"device.{name}{hw if hw else ''}", name,
                     {"n": len(idx)})
        cells += bb * (blq + blt) * ((hw + 2) if hw else (blt + 1))
        if stats is not None:
            st = stats.setdefault(name, {"launches": 0, "kernel_ms": 0.0,
                                         "device_s": 0.0, "cells": 0,
                                         "cycles": [0, 0]})
            st["launches"] += 1
            st["kernel_ms"] += timer.kernel_ms()
            st["device_s"] += timer.device_s()
            st["cells"] += kernel_cells(ql, tl, hw)
            if not hw:
                st["words"] = st.get("words", 0) + full_words(ql, tl)
            st["cycles"] = [a + int(c) for a, c in zip(st["cycles"], cycles)]
            rung = st.setdefault("rungs", {}).setdefault(
                hw, {"launches": 0, "lanes": 0, "kernel_ms": 0.0})
            rung["launches"] += 1
            rung["lanes"] += len(idx)
            rung["kernel_ms"] += timer.kernel_ms()
        return ops[:len(idx)]

    def run(idx, hw):
        # chunk by this rung's direction-tape bytes (a wide rung costs
        # ~16x the narrow one per lane): the largest pow2 chunk within
        # mem_budget (padding respects it), at least one lane
        cap = 1 << (len(idx) - 1).bit_length()
        while cap > 1 and tape_bytes(cap, blq, blt, hw,
                                     device) > mem_budget:
            cap //= 2
        outs = [run_one(idx[k:k + cap], hw)
                for k in range(0, len(idx), cap)]
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    pending = np.arange(n)
    for hw in BAND_LADDER:
        if len(pending) == 0 or hw >= max(blq, blt):
            break
        idx = pending[need[pending] <= hw]
        if len(idx) == 0:
            continue
        ops = run(idx, hw)
        cost = ((ops != OP_STOP) & (ops != OP_EQ)).sum(axis=1)
        ok = cost <= hw
        ops_out[idx[ok]] = ops[ok]
        pending = np.setdiff1d(pending, idx[ok], assume_unique=True)
        n_retry = int(len(idx) - int(ok.sum()))
        if n_retry:
            DECISIONS.record("align_retry", engine="band", rung=int(hw),
                             pairs=n_retry)
    # past the ladder the unbanded kernel is exact for everything; on
    # the largest buckets a caller with allow_full=False sends the rare
    # pairs left to the CPU instead
    if len(pending) and (allow_full
                         or max(blq, blt) <= max(BAND_LADDER)):
        ops_out[pending] = run(pending, 0)
        pending = pending[:0]
    if len(pending):
        DECISIONS.record("align_cpu_fallthrough", pairs=int(len(pending)))
    return ops_out, cells, pending


class CudaBatchAligner:
    """Batched aligner with bucketed dispatch (the JAX package's
    ``TPUBatchAligner``; racon-gpu's CUDABatchAligner add/align/get
    contract): ``add`` rejects pairs past the configured maximum (the
    caller aligns those on the CPU), ``align_all`` runs the ladder on
    ``device`` (the card unless the caller asks for the CPU), ``cigars``
    gives the host CIGAR strings."""

    def __init__(self, max_query_length: int, max_target_length: int,
                 max_alignments: int, device=None):
        from racon_tpu_torch import resolve_device

        self.max_q = int(max_query_length)
        self.max_t = int(max_target_length)
        self.max_alignments = int(max_alignments)
        self.device = resolve_device(device)
        self.queries: List[bytes] = []
        self.targets: List[bytes] = []
        self._ops = None
        self.distances = None
        #: per kernel: launches, kernel ms, device s and cells
        self.stats: dict = {}

    def add(self, query: bytes, target: bytes) -> bool:
        """Queue one pair; False if it must go to the CPU path."""
        if len(self.queries) >= self.max_alignments:
            return False
        if len(query) > self.max_q or len(target) > self.max_t:
            return False
        self.queries.append(query)
        self.targets.append(target)
        return True

    def __len__(self) -> int:
        return len(self.queries)

    def align_all(self) -> None:
        if not self.queries:
            return
        lq = max(len(s) for s in self.queries)
        lt = max(len(s) for s in self.targets)
        # bucket dims rounded up to multiples of 128, as the JAX package
        # bounds its compiled variants
        lq = min((lq + 127) // 128 * 128, self.max_q)
        lt = min((lt + 127) // 128 * 128, self.max_t)
        self._ops, _, _ = band_align_batch(self.queries, self.targets, lq,
                                           lt, device=self.device,
                                           stats=self.stats)
        # edit distance = every non-'=' op on the tape
        self.distances = np.sum(
            (self._ops != OP_STOP) & (self._ops != OP_EQ),
            axis=1).astype(np.int32)

    def cigars(self) -> List[str]:
        assert self._ops is not None, "align_all() not called"
        return [ops_to_cigar(self._ops[i])
                for i in range(len(self.queries))]

    def reset(self) -> None:
        self.queries = []
        self.targets = []
        self._ops = None
        self.distances = None


def align_pairs(pairs: Sequence[Tuple[bytes, bytes]],
                max_len: int = 1 << 14, device=None) -> List[str]:
    """One-shot batched alignment of (query, target) pairs: their
    CIGARs."""
    aligner = CudaBatchAligner(max_len, max_len, len(pairs), device=device)
    for q, t in pairs:
        ok = aligner.add(q, t)
        assert ok, "pair exceeds max_len"
    aligner.align_all()
    return aligner.cigars()
