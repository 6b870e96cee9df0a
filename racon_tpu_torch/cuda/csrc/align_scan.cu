// The scan align ladder's two kernels on Hopper (sm_90a).
//
// Replace racon_tpu/tpu/aligner.py:_align_kernel (:75) and
// _banded_align_kernel (:166), XLA jax.jit kernels (not Pallas ones):
// unit-cost global alignment of a batch of pairs, swept over the
// anti-diagonals d = 1 .. ql + tl of the DP, cell (i, j) = (d - j, j):
//
//   cur = min(diag + (q[i-1] != t[j-1]), up + 1, left + 1),
//   boundary cells (i == 0 or j == 0) = d,
//   direction 0 (diagonal) if cur == diag candidate, else 1 (up) if
//   cur == up candidate, else 2 (left),
//
// then a traceback from (ql, tl) that writes the reversed op tape
// (= 1, X 2, I 3, D 4; 0 after (0, 0)).  Query codes past lq read QPAD
// (5), target codes past lt TPAD (6); neither matches anything, while N
// (4) matches N.
//
// Full kernel: only cells with i <= ql and j <= tl matter (the
// traceback reads no other cell, and none of those reads another), and
// they hold the edit distance D[i][j] of the prefixes, which the kernel
// computes column by column (below) and the traceback turns into the
// same directions.
//
// Banded kernel (half-width hw): the wb = hw + 2 slots of diagonal d
// start at column jlo(d) = max(0, floor((d - hw + 1) / 2)).  Slot s
// reads up and left at slots s + d1 and s + d1 - 1 of diagonal d - 1
// and diag at slot s + d2 - 1 of d - 2, where d1, d2 (0 or 1) are jlo's
// advances; slots past the band read BIG.  Cells off the padded matrix
// (j > lt, i > lq or i < 0) are BIG, every other value is clipped to
// BIG, and the direction is taken from the clipped value.  The
// traceback reads slot clip(j - jlo(d), 0, wb - 1), so a lane whose path
// leaves the band reads edge slots: every slot of every diagonal it
// reaches is computed exactly as the JAX kernel computes it, and a lane
// past its band gives the JAX kernel's tape too.
//
// What bounds them: the banded kernel's 13 int32 operations a cell at
// 16.7 T/s; the full kernel's ~34 operations a 64-row word of a column
// (bit-parallel: see below).  What holds them back is latency: one
// pair's diagonals (or columns) are a chain, and a main-path launch
// holds fewer pairs than the card has SMs.
//
// Full kernel design (bit-parallel columns, Myers / Hyyro; racon-gpu's
// cudaaligner and edlib answer the chain the same way):
//
// * One warp a pair, G pairs a block (G = ceil(b / SMs), at most 4), so
//   a launch of 16 pairs spreads over 16 SMs.  Lane l holds the 64 query
//   rows of word s0 + l (a stripe of 32 words, 2,048 rows; a longer
//   query runs stripe after stripe, each handing the next its last
//   word's horizontal deltas through the tape) and its column's
//   vertical deltas Pv / Mv; the stripe's Peq words (one a code 0..6;
//   codes of 7 and up match nothing, the encoding gives 0..6) sit in
//   shared memory.
// * Each target column is one Myers step a word; lane l runs column j
//   at step j + l - 1, one step behind lane l - 1, whose horizontal
//   delta out of its last row arrives by one shuffle a step.  Target
//   codes come through a ring in shared memory filled 32 steps ahead and
//   the next column's Peq word is read a step ahead, so the chain a step
//   carries is the shuffle and the word's add-and-carry.
// * The directions come out of the step bit-parallel: up where the new
//   vertical delta is +1; diagonal where hd(i, j) + vd(i, j - 1) (the
//   step's horizontal deltas and the last column's vertical ones), which
//   is D[i][j] - D[i-1][j-1] (0 or 1), equals the substitution cost:
//   always on a Peq match, on a mismatch where it is 1.  That is the JAX
//   tie rule (diagonal, then up, then left), so no score is stored: two
//   64-bit planes a word-column (not diagonal; then left, or on the
//   diagonal a mismatch), 16 bytes, diagonal-major (row j - 1 + l of
//   the tape holds lane l's word of column j), so a step's 32 stores
//   are one contiguous run.
// * Traceback: the warp walks from (ql, tl) over windows of 32 columns
//   x 8 words of the tape staged in shared memory with cp.async, the
//   next window to the left in flight while it walks.  The move at the
//   walk's cell repeats along its own direction while the cells agree:
//   lane m reads the m-th cell of that run (diagonal, up or left), a
//   ballot gives the run's length and its lanes store their ops side by
//   side, so one round covers a run (a diagonal run of matches and
//   mismatches, an insertion or a deletion).  Each pair's sweep and
//   traceback clock64() cycles go to meta.
//
// Banded kernel design:
//
// * Diagonals in registers.  Thread k of a pair owns C contiguous slots
//   [Ck, Ck + C) and keeps them of diagonals d - 1 and d - 2 in
//   registers; diagonal d overwrites d - 2 in place (slots descending,
//   so a slot's diagonal read comes first).  C = 9 (hw 512: 2 warps,
//   2,048: 8, two a scheduler).
//   A diagonal's cells are the interior (the thread's own slots) and
//   the two edge cells, which need one slot of each neighbour: slot
//   Ck - 1 of d - 1 and d - 2 from the left, slot Ck + C of d - 1 from
//   the right.  A thread sends its edge slots at the end of a diagonal
//   (a shuffle each way in the warp, a word each way between warps
//   through shared memory, double-buffered by the diagonal's parity)
//   and collects them after the next diagonal's interior, which hides
//   the exchange.
// * No block barrier.  A pair of W > 1 warps synchronises its own
//   warps with a named barrier (bar.sync 1 + pair, 32 W) once a
//   diagonal; a one-warp pair needs none.  G pairs share a block
//   (G x W <= 16 warps), G = ceil(b / SMs) so a launch spreads over the
//   card; there is no one-block-per-SM launch bound.
// * Split pairs.  A launch of few pairs (the hw 8,192 rung's 16-lane
//   launches) leaves most SMs idle, so a pair that needs more than 8
//   warps splits over a thread-block cluster of K <= 8 SMs, b K <= the
//   SM count, about 4 warps each; a pair past 16 warps always splits,
//   over as few blocks of at most 16 warps as hold it.  Neighbouring
//   blocks pass their edge
//   slots through distributed shared memory: one 64-bit word (diagonal
//   + 1 << 32 | value) into a ring of 4 in the neighbour, which polls
//   it after its interior; a poll past 2^26 tries traps rather than
//   hangs.  Cluster barriers open (rings cleared) and close (every
//   block's rows written) the sweep.
// * The sequences: each thread keeps its C query and C target codes in
//   registers; a diagonal shifts one of the two windows by one code
//   (the target when jlo advances, else the query), each loaded ahead
//   through L1.  jlo advances on a fixed schedule (not for d <= hw,
//   then every other diagonal), so the loop's two diagonals an
//   iteration are compiled for their advances.
// * Masks only at the edges: cells with i < 0 are BIG by the
//   recurrence itself (their neighbours are all BIG), and the boundary
//   cells equal d by it too, so only j > lt and i > lq need a mask, and
//   a warp takes the masked path only when one of its cells does.  Of
//   the slots past the band (the last thread's tail) only slot wb is
//   read by the band (as up of slot wb - 1): its warp sets it to BIG.
// * No predicates in a cell: v is at most each candidate, so the sign
//   of v - c says v != c; Hopper's three-way min (DPX) takes the min.
// * One store a thread a diagonal: the C cells' 2 bits (not diagonal;
//   then left, or on the diagonal a mismatch) as one 32-bit word; this
//   kernel's tape layout is a row of K x 32 W words a
//   diagonal (align_scan_dir_bytes).  The traceback needs the sequences
//   only where it reads a clipped slot.
// * Traceback: warp 0 of the pair (of block 0 of a split one) walks, one
//   lane, over windows of 128 rows x 16 words staged in shared memory
//   with cp.async; the window below is in flight while the lane walks
//   the current one.  A path that leaves a window's slots stages one
//   where it stands.  Each pair's sweep and traceback clock64() cycles
//   go to meta.
//
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr uint8_t kQPad = 5, kTPad = 6;
constexpr uint8_t kOpEq = 1, kOpX = 2, kOpI = 3, kOpD = 4;

// full kernel: pairs (warps) a block at most, the rings' entries, the
// codes with a Peq word (0..6), and the traceback window's columns and
// 64-row words
constexpr int kFullWarps = 4;
constexpr int kRing = 128;
constexpr int kCodes = 7;
constexpr int kTbCols = 32;
constexpr int kTbBlocks = 8;

// banded kernel: slots a thread, warps a block's pair at most, blocks
// a split pair at most (a portable cluster: hw <= 8 x 16 x 32 x 9 - 2)
constexpr int kSlots = 9;
constexpr int kMaxPairWarps = 16;
constexpr int kMaxCluster = 8;
constexpr int kBandThreads = 32 * kMaxPairWarps;
constexpr int kTbRows = 128;           // traceback window: rows
constexpr int kTbWords = 16;           // and words (threads) a row

// floor(x / 2) for any sign (C's / truncates)
__device__ __forceinline__ int floor_half(int x) {
    return (x - (x < 0 && (x & 1))) / 2;
}

__device__ __forceinline__ int jlo_of(int d, int hw) {
    return max(0, floor_half(d - hw + 1));
}

// ---------------------------------------------------------------------------
// the full kernel (hw = 0)
// ---------------------------------------------------------------------------

// a warp's shared memory: the target-code and carry-in rings, the
// stripe's Peq words (code x lane; code 7 matches nothing) and the
// traceback's two windows
struct FullShared {
    uint8_t tcode[kRing];
    signed char hin[kRing];
    uint64_t peq[kCodes + 1][32];
    uint4 win[2][kTbCols * kTbBlocks];
};

// the tape record of column c (0-based: target position c), word b:
// diagonal-major, so a step's 32 lanes store one contiguous run
__device__ __forceinline__ long long rec_of(int c, int b, int nbp) {
    return (long long)(c + (b & 31)) * nbp + b;
}

// A lane's ring entry of target position p: its code (7 for codes past
// 6 and positions past TL) and, for a stripe past the first, the
// horizontal delta out of the previous stripe's last word at that
// column; loaded a chunk of 32 positions before it enters the rings.
struct RingLoad {
    int code, hin;
};

__device__ __forceinline__ RingLoad load_ring(const uint8_t* ts,
                                              const signed char* ho, int p,
                                              int TL, int s0) {
    RingLoad r{kCodes, 0};
    if (p < TL) {
        r.code = min((int)__ldg(ts + p), kCodes);
        if (s0 > 0) r.hin = ho[p];
    }
    return r;
}

__device__ __forceinline__ void store_ring(FullShared* sh, int p,
                                           RingLoad r) {
    sh->tcode[p & (kRing - 1)] = (uint8_t)r.code;
    sh->hin[p & (kRing - 1)] = (signed char)r.hin;
}

// a predicated 16-byte store of two planes (no divergent block around
// it: the sweep's lanes stay converged from step to step)
__device__ __forceinline__ void store_if(uint4* p, uint64_t p0, uint64_t p1,
                                         bool on) {
    asm volatile("{\n\t.reg .pred q;\n\t"
                 "setp.ne.u32 q, %5, 0;\n\t"
                 "@q st.global.v4.u32 [%0], {%1, %2, %3, %4};\n\t}"
                 ::"l"(p), "r"((unsigned)p0), "r"((unsigned)(p0 >> 32)),
                   "r"((unsigned)p1), "r"((unsigned)(p1 >> 32)),
                   "r"((unsigned)on) : "memory");
}

// One stripe of the sweep: words s0 .. s0 + 31 over columns 1 .. TL.
// Lane l's word b holds rows 64 b + 1 .. 64 b + 64; at column j it
// takes the horizontal delta hin at its first row (lane l - 1's hout,
// by shuffle; +1 on row 0), and stores two bit-planes of the column's
// directions: not diagonal, then (diagonal) mismatch or (not) left.
__device__ __forceinline__ void full_stripe(FullShared* sh, const uint8_t* qs,
                                            const uint8_t* ts, uint4* tape,
                                            signed char* ho, int QL, int TL,
                                            int nb, int nbp, int s0,
                                            int lane) {
    const int bk = s0 + lane;
    const bool live = bk < nb;
    uint64_t peq[kCodes];
#pragma unroll
    for (int c = 0; c < kCodes; ++c) peq[c] = 0;
    if (live) {
        for (int r = 0; r < 64; ++r) {
            const int i = 64 * bk + r;
            const int c = i < QL ? (int)__ldg(qs + i) : kCodes;
#pragma unroll
            for (int k = 0; k < kCodes; ++k)
                peq[k] |= (uint64_t)(c == k) << r;
        }
    }
#pragma unroll
    for (int c = 0; c < kCodes; ++c) sh->peq[c][lane] = peq[c];
    sh->peq[kCodes][lane] = 0;
    uint64_t pv = ~0ull, mv = 0;          // column 0: D[i][0] = i
    unsigned state = 1;                   // hout + 1
    uint4* out = tape + s0 + lane;        // record (k - lane, bk) at step k
    // the rings: every slot a valid code first, then positions [0, 32)
    // now and [32, 64) in flight
#pragma unroll
    for (int m = 0; m < kRing / 32; ++m) sh->tcode[lane + 32 * m] = kCodes;
    __syncwarp();
    store_ring(sh, lane, load_ring(ts, ho, lane, TL, s0));
    RingLoad ahead = load_ring(ts, ho, 32 + lane, TL, s0);
    // steps in whole chunks of 32 (those past the last column do nothing)
    const int steps = TL + min(32, nb - s0) - 1;
    // the Peq word of this step's column and the target code of the one
    // after next: each step's shared loads serve later steps, none its own
    __syncwarp();
    uint64_t eq = sh->peq[sh->tcode[(-lane) & (kRing - 1)]][lane];
    int code = sh->tcode[(1 - lane) & (kRing - 1)];
    int hin0 = s0 ? (int)sh->hin[0] : 1;  // lane 0's carry-in, a step ahead
    for (int k0 = 0; k0 < steps; k0 += 32) {
        // the rings hold positions [k0 - 31, k0 + 63] from here on; the
        // chunk after those is loaded now, stored 32 steps on
        __syncwarp();
        store_ring(sh, k0 + 32 + lane, ahead);
        ahead = load_ring(ts, ho, k0 + 64 + lane, TL, s0);
        __syncwarp();
#pragma unroll 8
        for (int kk = 0; kk < 32; ++kk, out += nbp) {
            const int k = k0 + kk;
            const uint64_t eq_next = sh->peq[code][lane];
            code = sh->tcode[(k + 2 - lane) & (kRing - 1)];
            const int hin_next = s0 ? (int)sh->hin[(k + 1) & (kRing - 1)]
                                    : 1;
            const unsigned in = __shfl_up_sync(0xffffffffu, state, 1);
            const int j = k - lane + 1;   // this lane's column
            const int hin = lane ? (int)in - 1 : hin0;
            // edlib's block step, the Peq word eq kept for the planes;
            // computed on every lane, kept where the lane has a column
            // (no divergent block: the stores are predicated)
            const bool act = live && (unsigned)(j - 1) < (unsigned)TL;
            const uint64_t xv = eq | mv;
            const uint64_t neg = hin < 0 ? 1ull : 0ull;
            const uint64_t e = eq | neg;
            const uint64_t xh = (((e & pv) + pv) ^ pv) | e;
            const uint64_t ph = mv | ~(xh | pv);
            const uint64_t mh = pv & xh;
            const int hout = (int)(ph >> 63) - (int)(mh >> 63);
            // diagonal iff D[i][j] - D[i-1][j-1] = hd(i, j) + vd(i, j-1)
            // (0 or 1) equals the substitution cost: always on a match,
            // on a mismatch where hd + vd = 1 (+1 and 0, or 0 and +1)
            const uint64_t diag = eq | ((ph | pv) & ~(mh | mv));
            const uint64_t ph2 = (ph << 1) | (hin > 0 ? 1ull : 0ull);
            const uint64_t mh2 = (mh << 1) | neg;
            const uint64_t npv = mh2 | ~(xv | ph2);  // up iff vd(i, j) = +1
            const uint64_t p0 = ~diag;
            const uint64_t p1 = (diag & ~eq) | (p0 & ~npv);
            store_if(out, p0, p1, act);
            // the next stripe's first word takes its carry-in here
            if (act && lane == 31 && bk + 1 < nb)
                ho[j - 1] = (signed char)hout;
            pv = act ? npv : pv;
            mv = act ? (ph2 & xv) : mv;
            state = act ? (unsigned)(hout + 1) : state;
            eq = eq_next;
            hin0 = hin_next;
        }
    }
    // the last lane's carries reach the next stripe's first lane
    __syncwarp();
}

// Stage the tape window of columns [c0, c0 + kTbCols) x words [b0, b0 +
// kTbBlocks) (columns < lt) into window ``w``: one 16-byte cp.async a
// record, the warp's lanes over the window, committed as one group.
__device__ __forceinline__ void stage_full(FullShared* sh, int w,
                                           const uint4* tape, int c0, int b0,
                                           int lt, int nbp, int lane) {
#pragma unroll
    for (int m = 0; m < kTbCols * kTbBlocks / 32; ++m) {
        const int e = lane + 32 * m;
        const int cc = e / kTbBlocks, bw = e % kTbBlocks;
        if (c0 + cc < lt) {
            const unsigned dst = (unsigned)__cvta_generic_to_shared(
                &sh->win[w][e]);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                         ::"r"(dst), "l"(tape + rec_of(c0 + cc, b0 + bw, nbp))
                         : "memory");
        }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// the window placed for a walk at (i, j): column j - 1 and word
// (i - 1) / 64 at its right and lower edges
__device__ __forceinline__ void place_full(int i, int j, int nbp, int& c0,
                                           int& b0) {
    c0 = max(0, j - kTbCols);
    b0 = max(0, min(nbp - kTbBlocks,
                    ((max(i, 1) - 1) >> 6) - (kTbBlocks - 1)));
}

// whether window (c0, b0) holds the record the step at (i, j) reads:
// column j - 1 at row i's word
__device__ __forceinline__ bool holds_full(int i, int j, int c0, int b0) {
    return i == 0 || j == 0
           || ((unsigned)(j - 1 - c0) < (unsigned)kTbCols
               && (unsigned)(((i - 1) >> 6) - b0) < (unsigned)kTbBlocks);
}

// The direction bits of cell (i, j) from the window at shared address
// ``win`` (bit 0: not diagonal; bit 1: then left, or on the diagonal a
// mismatch), or -1 when the window does not hold it (or i, j < 1).
__device__ __forceinline__ int cell_bits(unsigned win, int i, int j, int c0,
                                         int b0) {
    const int c = j - 1 - c0, w = ((i - 1) >> 6) - b0;
    if (i < 1 || j < 1 || (unsigned)c >= (unsigned)kTbCols
        || (unsigned)w >= (unsigned)kTbBlocks)
        return -1;
    const int r = (i - 1) & 63;
    const unsigned addr = win + 16u * (c * kTbBlocks + w) + 4u * (r >> 5);
    unsigned p0, p1;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(p0) : "r"(addr));
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(p1) : "r"(addr + 8u));
    return (int)((p0 >> (r & 31)) & 1u) | (int)((p1 >> (r & 31)) & 1u) << 1;
}

// the run of lanes 0 .. n - 1 whose ballot bit is set, from lane 0
__device__ __forceinline__ int run_of(unsigned mask) {
    return mask == 0xffffffffu ? 32 : __ffs(~mask) - 1;
}

// The warp's walk over the window at shared address ``win`` (columns
// [c0, c0 + kTbCols), words [b0, b0 + kTbBlocks)) from (i, j), until the
// window no longer holds (i, j) or the walk reaches row or column 0.
// The move at (i, j) repeats along its own direction while the cells
// agree: lane m reads the m-th cell of that run (diagonal, up or left),
// a ballot gives the run's length, and the lanes of the run store their
// ops side by side.  A run stops at the window's edge.
__device__ __forceinline__ void walk_full(unsigned win, int& i, int& j,
                                          int& pos, uint8_t* out, int c0,
                                          int b0, int lane) {
    while (i > 0 && j > 0) {
        const int bd = cell_bits(win, i - lane, j - lane, c0, b0);
        const int first = __shfl_sync(0xffffffffu, bd, 0);
        if (first < 0) return;            // (i, j) is in the next window
        int run, di, dj;
        if ((first & 1) == 0) {           // diagonal: = or X
            run = run_of(__ballot_sync(0xffffffffu, bd >= 0 && !(bd & 1)));
            if (lane < run) out[pos + lane] = bd & 2 ? kOpX : kOpEq;
            di = dj = run;
        } else if (first == 1) {          // up: I
            const int bu = cell_bits(win, i - lane, j, c0, b0);
            run = run_of(__ballot_sync(0xffffffffu, bu == 1));
            if (lane < run) out[pos + lane] = kOpI;
            di = run;
            dj = 0;
        } else {                          // left: D
            const int bl = cell_bits(win, i, j - lane, c0, b0);
            run = run_of(__ballot_sync(0xffffffffu, bl == 3));
            if (lane < run) out[pos + lane] = kOpD;
            di = 0;
            dj = run;
        }
        i -= di;
        j -= dj;
        pos += run;
    }
    // row 0: left; column 0: up
    for (int m = lane; m < j; m += 32) out[pos + m] = kOpD;
    pos += j;
    j = 0;
    for (int m = lane; m < i; m += 32) out[pos + m] = kOpI;
    pos += i;
    i = 0;
}

__device__ __forceinline__ void wait_full() {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
}

__global__ void __launch_bounds__(32 * kFullWarps)
align_full_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ t, const int* __restrict__ ql,
                  const int* __restrict__ tl, uint4* __restrict__ tape_g,
                  signed char* __restrict__ ho_g, uint8_t* __restrict__ ops,
                  long long* __restrict__ meta, int b, int lq, int lt,
                  int nbp) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int pair = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (pair >= b) return;
    const int QL = min(max(ql[pair], 0), lq);
    const int TL = min(max(tl[pair], 0), lt);
    if (QL + TL == 0) return;
    const long long c0k = clock64();
    FullShared* sh = reinterpret_cast<FullShared*>(smem) + (threadIdx.x >> 5);
    const uint8_t* qs = q + (size_t)pair * lq;
    const uint8_t* ts = t + (size_t)pair * lt;
    uint4* tape = tape_g + (size_t)pair * (lt + 31) * nbp;
    signed char* ho = ho_g + (size_t)pair * lt;
    const int nb = (QL + 63) >> 6;
    if (TL > 0)
        for (int s0 = 0; s0 < nb; s0 += 32)
            full_stripe(sh, qs, ts, tape, ho, QL, TL, nb, nbp, s0, lane);
    const long long c1 = clock64();

    // traceback: lane 0 walks, the warp stages windows
    uint8_t* out = ops + (size_t)pair * (lq + lt);
    int i = QL, j = TL, pos = 0;
    int cur = 0, c0, b0, c2 = 0, b2 = 0;
    place_full(i, j, nbp, c0, b0);
    stage_full(sh, 0, tape, c0, b0, lt, nbp, lane);
    wait_full();
    while (true) {
        // the window to the left, in flight while the warp walks this one
        const bool next = c0 > 0;
        if (next) {
            place_full(i, c0, nbp, c2, b2);
            stage_full(sh, cur ^ 1, tape, c2, b2, lt, nbp, lane);
        }
        walk_full((unsigned)__cvta_generic_to_shared(sh->win[cur]), i, j,
                  pos, out, c0, b0, lane);
        wait_full();
        if (i == 0 && j == 0) break;
        if (next && holds_full(i, j, c2, b2)) {
            cur ^= 1;
            c0 = c2;
            b0 = b2;
        } else {
            place_full(i, j, nbp, c0, b0);
            stage_full(sh, cur, tape, c0, b0, lt, nbp, lane);
            wait_full();
        }
    }
    if (lane == 0) {
        meta[2 * pair] = c1 - c0k;
        meta[2 * pair + 1] = clock64() - c1;
    }
}

// ---------------------------------------------------------------------------
// the banded kernel (hw > 0)
// ---------------------------------------------------------------------------

// a thread's codes of one diagonal: 2 bits a slot
using BandWord = unsigned;
static_assert(2 * kSlots <= 32, "a thread's codes fill one word");

// shared memory of one pair
struct BandShared {
    // a split pair: the edge slots of the blocks left and right of this
    // one, (diagonal << 32 | value), a ring of 4 diagonals
    unsigned long long from_left[4], from_right[4];
    int edge[2][2][kMaxPairWarps];   // [parity][first, last slot][warp]
    alignas(16) BandWord win[2][kTbRows * kTbWords];  // traceback
};

// distributed shared memory of a cluster: the address of ``local`` in
// block ``rank``'s shared memory, a store there, a volatile load here
__device__ __forceinline__ unsigned cluster_addr(const void* local,
                                                 unsigned rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out)
                 : "r"((unsigned)__cvta_generic_to_shared(local)),
                   "r"(rank));
    return out;
}

__device__ __forceinline__ void cluster_store(unsigned addr,
                                              unsigned long long v) {
    asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;"
                 ::"r"(addr), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long shared_load(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.volatile.shared.u64 %0, [%1];"
                 : "=l"(v)
                 : "r"((unsigned)__cvta_generic_to_shared(p)) : "memory");
    return v;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the value a neighbour block sent for diagonal d (its tag); a wait past
// 2^26 polls traps rather than hangs
__device__ __forceinline__ int await_edge(const unsigned long long* slot,
                                          int d) {
    unsigned long long v = shared_load(slot);
    for (int n = 0; (int)(v >> 32) != d; ++n) {
        if (n > (1 << 26)) __trap();
        v = shared_load(slot);
    }
    return (int)(unsigned)v;
}

__device__ __forceinline__ void pair_sync(int id, int nthreads) {
    if (nthreads == 32)
        __syncwarp();
    else
        asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ int qchar(const uint8_t* qs, int idx, int lq) {
    return (unsigned)idx < (unsigned)lq ? (int)__ldg(qs + idx) : kQPad;
}

__device__ __forceinline__ int tchar(const uint8_t* ts, int idx, int lt) {
    return (unsigned)idx < (unsigned)lt ? (int)__ldg(ts + idx) : kTPad;
}

// Cell k of a thread from its three neighbours: its value to out, its
// codes to bits 2k and 2k + 1 of word: not the diagonal candidate, then
// (not diagonal) not up, (diagonal) the codes differ.  No compare makes
// a predicate: v is at most each candidate, so v - c is negative
// exactly when v != c, and the sign bits carry the tests.  With kMask,
// cells k < kmin or k > kmax are off the matrix (BIG).
template <int C, bool kMask>
__device__ __forceinline__ void band_cell(int k, int up, int left, int dg,
                                          int codes, int kmin, int kmax,
                                          int& out, BandWord& word) {
    const int diff = -codes;                         // < 0: codes differ
    const int cd = dg - (diff >> 31);
    const int cu = up + 1;
    int v = __vimin3_s32(cd, cu, __viaddmin_s32(left, 1, kBig));
    unsigned nd = (unsigned)(v - cd), nu = (unsigned)(v - cu);
    if (kMask && (k < kmin || k > kmax)) {
        v = kBig;
        nd = v == cd ? 0u : 1u << 31;
        nu = v == cu ? 0u : 1u << 31;
    }
    const unsigned second = (nd & nu) | (~nd & (unsigned)diff);
    out = v;
    word |= (BandWord)(nd >> 31) << (2 * k)
          | (BandWord)(second >> 31) << (2 * k + 1);
}

// A thread's cells of one diagonal: x holds diagonal d - 2 and becomes
// diagonal d; p1 holds d - 1.  First the interior cells 1 .. C - 2,
// which read only the thread's own slots (slots descending, so a slot's
// diagonal read comes before its overwrite) ...
template <int C, int D1, int D2, bool kMask>
__device__ __forceinline__ void band_interior(int (&x)[C], const int (&p1)[C],
                                              const int (&qc)[C],
                                              const int (&tc)[C], int kmin,
                                              int kmax, BandWord& word) {
#pragma unroll
    for (int k = C - 2; k >= 1; --k)
        band_cell<C, kMask>(k, D1 ? p1[k + 1] : p1[k],
                            D1 ? p1[k] : p1[k - 1], D2 ? x[k] : x[k - 1],
                            qc[k] ^ tc[k], kmin, kmax, x[k], word);
}

// ... then the edge cells C - 1 and 0, with the neighbours' slots: lp1 /
// lp2 the left neighbour's last slot of d - 1 / d - 2, rp1 the right
// neighbour's first slot of d - 1, xo slot C - 2 of d - 2.
template <int C, int D1, int D2, bool kMask>
__device__ __forceinline__ void band_edges(int (&x)[C], const int (&p1)[C],
                                           const int (&qc)[C],
                                           const int (&tc)[C], int lp1,
                                           int lp2, int rp1, int xo,
                                           int kmin, int kmax,
                                           BandWord& word) {
    band_cell<C, kMask>(C - 1, D1 ? rp1 : p1[C - 1],
                        D1 ? p1[C - 1] : p1[C - 2], D2 ? x[C - 1] : xo,
                        qc[C - 1] ^ tc[C - 1], kmin, kmax, x[C - 1], word);
    band_cell<C, kMask>(0, D1 ? p1[1] : p1[0], D1 ? p1[0] : lp1,
                        D2 ? x[0] : lp2, qc[0] ^ tc[0], kmin, kmax, x[0],
                        word);
}

// one thread's sweep: where it stands, and its registers besides the
// two diagonals
template <int C>
struct BandThread {
    const uint8_t* qs;
    const uint8_t* ts;
    BandWord* out;                     // this thread's word of the next row
    int* edge;                         // the block's edge[2][2][16] words
    unsigned long long* ring;          // from_left (from_right at + 4)
    unsigned to_left, to_right;        // the neighbours' rings (cluster)
    bool left_end, right_end;          // the block's first / last thread
    int lq, lt, wb, s0, nt, pitch, w, lane, W, bar;
    int s0f, s0l;                      // the warp's first and last s0
    unsigned padm;                     // bit k: cell k is slot wb
    bool padw;                         // slot wb is in this warp
    bool top;                          // no slot of the band above this one
    int lo;                            // jlo of the last diagonal
    int qi, ti;                        // next query / target code index
    int nq, ntc;                       // and those codes, loaded ahead
    int qc[C], tc[C];                  // codes of the thread's cells
    int lp1, lp2, rp1;                 // neighbours' edge slots
    int lsh, rsh;                      // and the shuffled ones, in flight
};

// Diagonal d of a thread, whose jlo advances by D1 over d - 1 and by D2
// over d - 2 (d <= hw: 0, 0; past it 1, 1 and 0, 1 in turn): xx holds
// d - 2 and becomes d, yy holds d - 1.
// Diagonal d's edge slots to the thread's neighbours, at its end: to
// the blocks beside this one (a split pair; tagged d + 1), to the warps
// beside this one (shared memory, by the diagonal's parity) and in the
// warp (shuffles).  The next diagonal collects them after its interior.
template <int C, bool kSplit>
__device__ __forceinline__ void band_send(BandThread<C>& st, int d,
                                          int first, int last) {
    if constexpr (kSplit) {
        const unsigned long long tag = (unsigned long long)(unsigned)(d + 1)
                                       << 32;
        if (st.right_end)
            cluster_store(st.to_right + (d & 3) * 8, tag | (unsigned)last);
        if (st.left_end)
            cluster_store(st.to_left + (d & 3) * 8, tag | (unsigned)first);
    }
    if (st.W > 1) {
        int* e = st.edge + (d & 1) * 2 * kMaxPairWarps + st.w;
        if (st.lane == 31) e[kMaxPairWarps] = last;
        if (st.lane == 0) e[0] = first;
    }
    st.lsh = __shfl_up_sync(0xffffffffu, last, 1);
    st.rsh = __shfl_down_sync(0xffffffffu, first, 1);
}

// Diagonal d of a thread, whose jlo advances by D1 over d - 1 and by D2
// over d - 2 (d <= hw: 0, 0; past it 1, 1 and 0, 1 in turn): xx holds
// d - 2 and becomes d, yy holds d - 1.
template <int C, bool kSplit, int D1, int D2>
__device__ __forceinline__ void band_step(BandThread<C>& st, int d,
                                          int (&xx)[C],
                                          const int (&yy)[C]) {
    // the cells' codes: jlo advanced, the target's window moves by one
    // code, else the query's
    st.lo += D1;
    if (D1) {
#pragma unroll
        for (int k = 0; k < C - 1; ++k) st.tc[k] = st.tc[k + 1];
        st.tc[C - 1] = st.ntc;
        st.ntc = tchar(st.ts, ++st.ti, st.lt);
    } else {
#pragma unroll
        for (int k = C - 1; k > 0; --k) st.qc[k] = st.qc[k - 1];
        st.qc[0] = st.nq;
        st.nq = qchar(st.qs, ++st.qi, st.lq);
    }
    // cells off the matrix: i > lq (s < d - lo - lq), j > lt (s > lt -
    // lo); those with i < 0 are BIG by the recurrence.  The test is the
    // warp's: its first thread's lowest slot and last thread's highest
    const int lo = st.lo;
    const bool mask = d - lo - st.lq > st.s0f || st.lt - lo - st.s0l < C - 1;
    const int kmin = d - lo - st.lq - st.s0, kmax = st.lt - lo - st.s0;
    const int xo = xx[C - 2];
    BandWord word = 0;
    if (mask)
        band_interior<C, D1, D2, true>(xx, yy, st.qc, st.tc, kmin, kmax,
                                       word);
    else
        band_interior<C, D1, D2, false>(xx, yy, st.qc, st.tc, 0, 0, word);
    // the neighbours' edge slots of d - 1 (sent at its end)
    int l = st.lsh, r = st.rsh;
    if (st.W > 1) {
        pair_sync(st.bar, st.nt);
        const int* e = st.edge + ((d - 1) & 1) * 2 * kMaxPairWarps + st.w;
        if (st.lane == 0) l = st.w > 0 ? e[kMaxPairWarps - 1] : kBig;
        if (st.lane == 31) r = st.w + 1 < st.W ? e[1] : kBig;
    } else {
        if (st.lane == 0) l = kBig;
        if (st.lane == 31) r = kBig;
    }
    if constexpr (kSplit) {
        if (st.left_end) l = await_edge(st.ring + ((d - 1) & 3), d);
        if (st.right_end) r = await_edge(st.ring + 4 + ((d - 1) & 3), d);
    }
    st.lp2 = st.lp1;
    st.lp1 = l;
    st.rp1 = st.top ? kBig : r;
    if (mask)
        band_edges<C, D1, D2, true>(xx, yy, st.qc, st.tc, st.lp1, st.lp2,
                                    st.rp1, xo, kmin, kmax, word);
    else
        band_edges<C, D1, D2, false>(xx, yy, st.qc, st.tc, st.lp1, st.lp2,
                                     st.rp1, xo, 0, 0, word);
    // slot wb, the first past the band, is read (as up) by slot wb - 1:
    // it holds BIG (the warp that has it sets it); the slots above it
    // hold what they compute, which reaches no slot of the band
    if (st.padw) {
#pragma unroll
        for (int k = 0; k < C; ++k)
            xx[k] = max(xx[k], (int)((st.padm >> k) & 1u) * kBig);
    }
    *st.out = word;
    st.out += st.pitch;
    band_send<C, kSplit>(st, d, xx[0], xx[C - 1]);
}

template <int C>
__device__ __forceinline__ void swap_rows(int (&x)[C], int (&y)[C]) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const int t = x[k];
        x[k] = y[k];
        y[k] = t;
    }
}

// Stage rows [rb, rb + kTbRows) x words [tb, tb + kTbWords) of a pair's
// tape (pitch words a row, rows < nrows) into buf: 16-byte cp.async by
// the warp's lanes, committed as one group.
__device__ __forceinline__ void stage_window(BandWord* buf,
                                             const BandWord* tape,
                                             int pitch, int rb, int tb,
                                             int nrows, int lane) {
    constexpr int kPer = 16 / sizeof(BandWord);  // words a chunk
    constexpr int kRow = kTbWords / kPer;        // chunks a row
#pragma unroll 8
    for (int m = 0; m < kTbRows * kRow / 32; ++m) {
        const int c = lane + 32 * m;             // 16-byte chunk
        const int row = c / kRow;
        const int col = (c % kRow) * kPer;
        if (rb + row < nrows) {
            const unsigned dst = (unsigned)__cvta_generic_to_shared(
                buf + row * kTbWords + col);
            const BandWord* src =
                tape + (size_t)(rb + row) * pitch + tb + col;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                         ::"r"(dst), "l"(src) : "memory");
        }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_windows() {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
}

// the window's first word: kTbWords threads' words around slot s's
// thread, 16-byte aligned, inside the row
template <int C>
__device__ __forceinline__ int window_word(int s, int pitch) {
    constexpr int kAlign = 16 / sizeof(BandWord);
    return min(max(0, (s / C - kTbWords / 2 + 1) & -kAlign),
               pitch - kTbWords);
}

template <int C, bool kSplit>
__global__ void __launch_bounds__(kBandThreads)
align_band_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ t, const int* __restrict__ ql,
                  const int* __restrict__ tl, void* __restrict__ dirs,
                  uint8_t* __restrict__ ops, long long* __restrict__ meta,
                  int b, int lq, int lt, int hw, int W, int G, int K) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int nt = 32 * W;                       // threads of a block's pair
    const int g = threadIdx.x / nt;
    const int kb = blockIdx.x % K;               // block in the pair's cluster
    const int pair = blockIdx.x / K * G + g;
    if (pair >= b) return;
    const int D = min(max(ql[pair], 0), lq) + min(max(tl[pair], 0), lt);
    if (D == 0) return;
    // the sweep's start clock waits in meta (no register holds it)
    if (threadIdx.x == g * nt && kb == 0) meta[2 * pair] = clock64();
    BandShared* sh = reinterpret_cast<BandShared*>(smem) + g;
    const int wt = threadIdx.x - g * nt;         // thread in the block's pair
    const int wb = hw + 2;
    const int pitch = K * nt;                    // words a tape row
    BandWord* const tape =
        static_cast<BandWord*>(dirs) + (size_t)pair * (lq + lt) * pitch;
    BandThread<C> st;
    st.edge = &sh->edge[0][0][0];
    st.ring = sh->from_left;
    st.w = wt >> 5;
    st.lane = wt & 31;
    st.s0 = (kb * nt + wt) * C;
    st.s0f = (kb * W + st.w) * 32 * C;
    st.s0l = st.s0f + 31 * C;
    st.padm = (unsigned)(wb - st.s0) < (unsigned)C ? 1u << (wb - st.s0) : 0u;
    st.padw = st.s0f <= wb && wb < st.s0l + C;
    st.top = st.s0 + C >= wb;
    st.wb = wb;
    st.nt = nt;
    st.pitch = pitch;
    st.W = W;
    st.lq = lq;
    st.lt = lt;
    st.bar = 1 + g;
    st.qs = q + (size_t)pair * lq;
    st.ts = t + (size_t)pair * lt;
    st.out = tape + kb * nt + wt;
    st.left_end = kb > 0 && wt == 0;
    st.right_end = kb + 1 < K && wt == nt - 1;
    st.to_left = st.to_right = 0;
    if (kSplit) {
        // a pair split over a cluster: empty rings, then every block
        // started before any sends to it
        if (wt < 4) sh->from_left[wt] = sh->from_right[wt] = 0;
        cluster_sync();
        if (st.left_end) st.to_left = cluster_addr(sh->from_right, kb - 1);
        if (st.right_end) st.to_right = cluster_addr(sh->from_left, kb + 1);
    }
    // diagonals -1 (x) and 0 (y): only cell (0, 0) = 0, at slot 0; the
    // codes of diagonal 0's cells (-s0 - k, s0 + k), and the next ones
    // each window shifts in
    int x[C], y[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        x[k] = kBig;
        y[k] = (st.s0 == 0 && k == 0) ? 0 : kBig;
        st.qc[k] = qchar(st.qs, -st.s0 - k - 1, lq);
        st.tc[k] = tchar(st.ts, st.s0 + k - 1, lt);
    }
    st.qi = -st.s0;
    st.ti = st.s0 + C - 1;
    st.nq = qchar(st.qs, st.qi, lq);
    st.ntc = tchar(st.ts, st.ti, lt);
    st.lo = 0;
    st.lp1 = st.lp2 = st.rp1 = kBig;
    band_send<C, kSplit>(st, 0, y[0], y[C - 1]);
    // d = 1 .. hw: jlo stays 0; past it jlo advances every other
    // diagonal.  Two diagonals an iteration, so x and y swap roles in
    // place; after an odd count the rows swap once.
    int d = 1;
    const int end1 = min(D, hw);
    for (; d + 1 <= end1; d += 2) {
        band_step<C, kSplit, 0, 0>(st, d, x, y);
        band_step<C, kSplit, 0, 0>(st, d + 1, y, x);
    }
    if (d <= end1) {
        band_step<C, kSplit, 0, 0>(st, d, x, y);
        ++d;
        swap_rows(x, y);
    }
    for (; d + 1 <= D; d += 2) {
        band_step<C, kSplit, 1, 1>(st, d, x, y);
        band_step<C, kSplit, 0, 1>(st, d + 1, y, x);
    }
    if (d <= D) band_step<C, kSplit, 1, 1>(st, d, x, y);
    const int w = st.w, lane = st.lane, bar = st.bar;
    const uint8_t* qs = st.qs;
    const uint8_t* ts = st.ts;
    __threadfence_block();
    pair_sync(bar, nt);
    if (kSplit) {
        // every block's rows written, and no block sends any more
        __threadfence();
        cluster_sync();
        if (kb != 0) return;
    }
    if (w != 0) return;
    // the sweep's cycles, and the traceback's start clock, in meta
    if (lane == 0) {
        const long long c1 = clock64();
        meta[2 * pair] = c1 - meta[2 * pair];
        meta[2 * pair + 1] = c1;
    }

    // traceback: lane 0 walks, the warp stages windows
    uint8_t* out = ops + (size_t)pair * (lq + lt);
    int i = min(max(ql[pair], 0), lq), j = min(max(tl[pair], 0), lt);
    int pos = 0;
    auto slot_of = [&](int ii, int jj) {
        return min(max(jj - jlo_of(ii + jj, hw), 0), wb - 1);
    };
    // the window being walked (rows from rb, words from tw) and the one
    // below it, in flight
    int cur = 0, rb = (D - 1) / kTbRows * kTbRows;
    int tw = window_word<C>(slot_of(i, j), pitch), rb2 = 0, tw2 = 0;
    stage_window(sh->win[0], tape, pitch, rb, tw, D, lane);
    wait_windows();
    while (i > 0 || j > 0) {
        // the window below, around where the walk stands now
        rb2 = rb - kTbRows;
        if (rb2 >= 0) {
            tw2 = window_word<C>(slot_of(i, j), pitch);
            stage_window(sh->win[cur ^ 1], tape, pitch, rb2, tw2, D, lane);
        }
        if (lane == 0) {
            const BandWord* wn = sh->win[0] + cur * (kTbRows * kTbWords);
            for (int dd = i + j; dd > 0; dd = i + j) {
                const int r = dd - 1 - rb;
                const int sj = j - max(0, (dd - hw + 1) >> 1);
                const int sl = min(max(sj, 0), wb - 1);
                const int th = sl / C;
                const int tt = th - tw;
                if (r < 0 || (unsigned)tt >= (unsigned)kTbWords) break;
                // bit 0: not diagonal; bit 1: then left (not up), or
                // (diagonal) the codes differ
                int bits = (int)(wn[r * kTbWords + tt] >> (2 * (sl - th * C)))
                           & 3;
                bits = i == 0 ? 3 : (j == 0 ? 1 : bits);
                uint8_t op = bits & 1 ? (bits & 2 ? kOpD : kOpI)
                                      : (bits & 2 ? kOpX : kOpEq);
                // a clipped slot is another cell's: compare the codes
                if (!(bits & 1) && sl != sj)
                    op = __ldg(qs + i - 1) == __ldg(ts + j - 1) ? kOpEq
                                                                 : kOpX;
                i -= bits != 3;
                j -= bits != 1;
                out[pos++] = op;
            }
        }
        i = __shfl_sync(0xffffffffu, i, 0);
        j = __shfl_sync(0xffffffffu, j, 0);
        pos = __shfl_sync(0xffffffffu, pos, 0);
        wait_windows();
        if (i == 0 && j == 0) break;
        // go on in the window below if it holds the walk, else stage one
        // where it stands
        const int dd = i + j;
        const int tt = slot_of(i, j) / C;
        if (rb2 >= 0 && dd - 1 >= rb2 && dd - 1 < rb2 + kTbRows
            && tt >= tw2 && tt < tw2 + kTbWords) {
            cur ^= 1;
            rb = rb2;
            tw = tw2;
        } else {
            rb = (dd - 1) / kTbRows * kTbRows;
            tw = window_word<C>(slot_of(i, j), pitch);
            stage_window(sh->win[cur], tape, pitch, rb, tw, D, lane);
            wait_windows();
        }
    }
    if (lane == 0) meta[2 * pair + 1] = clock64() - meta[2 * pair + 1];
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// per device, read once: the shared memory a block may opt into, the
// SM count, and the dynamic shared memory each kernel was opted into
struct DevInfo {
    int optin, sms, band_set, split_set;
    bool prepared;
};

DevInfo& dev_info() {
    static DevInfo cached[64];
    int dev = 0;
    cudaGetDevice(&dev);
    DevInfo& v = cached[dev & 63];
    if (v.optin == 0) {
        int optin = 48 << 10, sms = 1;
        cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        v.sms = sms;
        v.optin = optin;
    }
    return v;
}

// opt a kernel into smem bytes of dynamic shared memory (once per size)
template <typename K>
cudaError_t opt_in(K kernel, int smem, int& done) {
    if (smem <= (48 << 10) || smem <= done) return cudaSuccess;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) done = smem;
    return e;
}

// The full kernel's launch: G pairs (warps) a block, enough blocks for
// the SMs; and its tape's 64-row words a column, padded to the window's
// kTbBlocks (nbp), with lt + 31 diagonal-major rows a pair.
struct FullShape {
    int G, nbp;
    long long recs;           // tape records of one pair
};

FullShape full_shape(int b, int lq, int lt, const DevInfo& info) {
    FullShape f;
    f.G = min(kFullWarps, max(1, (b + info.sms - 1) / info.sms));
    f.nbp = ((lq + 63) / 64 + kTbBlocks - 1) / kTbBlocks * kTbBlocks;
    f.recs = (long long)(lt + 31) * f.nbp;
    return f;
}

// How a banded launch of b pairs runs: W warps a block, K blocks a
// pair and G pairs a block.  A pair's warps on one SM up to 8 (two a
// scheduler: hw 2,048); a pair that needs more, in a launch that leaves
// SMs idle, splits over a cluster of K SMs of about 4 warps each (at
// most 8 SMs, b K of them in all: hw 8,192 in the main path's 16-lane
// launches); else up to 16 warps on one SM, and past 16 over the
// fewest blocks of at most 16 warps.  G (K = 1): enough blocks for the
// SMs, at most 16 warps and the shared memory a block may hold.  False
// when hw is past the kernel (more than kMaxCluster blocks).
struct BandShape {
    int W, K, G, per;
};

bool band_shape(int b, int hw, const DevInfo& info, BandShape& sh) {
    const int wb = hw + 2;
    const int warps = (wb + 32 * kSlots - 1) / (32 * kSlots);
    const int spread =
        warps > 8 ? min(min(8, info.sms / max(b, 1)), (warps + 3) / 4) : 1;
    sh.K = max(max(1, spread),
               (warps + kMaxPairWarps - 1) / kMaxPairWarps);
    if (sh.K > kMaxCluster) return false;
    sh.W = (wb + 32 * kSlots * sh.K - 1) / (32 * kSlots * sh.K);
    sh.per = (int)sizeof(BandShared);
    sh.G = sh.K > 1 ? 1
                    : min(min(max(1, (b + info.sms - 1) / info.sms),
                              kMaxPairWarps / sh.W),
                          max(1, info.optin / sh.per));
    return true;
}

template <int C, bool kSplit>
int band_launch(const void* q, const void* t, const void* ql,
                const void* tl, void* dirs, void* ops, void* meta, int b,
                int lq, int lt, int hw, const BandShape& sh, int& opted,
                void* stream) {
    cudaError_t e =
        opt_in(align_band_kernel<C, kSplit>, sh.G * sh.per, opted);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((b + sh.G - 1) / sh.G * sh.K);
    cfg.blockDim = dim3(32 * sh.W * sh.G);
    cfg.dynamicSmemBytes = sh.G * sh.per;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = sh.K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = kSplit ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, align_band_kernel<C, kSplit>,
                           (const uint8_t*)q, (const uint8_t*)t,
                           (const int*)ql, (const int*)tl, dirs,
                           (uint8_t*)ops, (long long*)meta, b, lq, lt, hw,
                           sh.W, sh.G, sh.K);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the direction tape of a launch of b pairs: the full kernel's
// lt + 31 rows a pair of one 16-byte record (two 64-bit direction
// planes) a 64-row word of the query, padded to 8 words, then lt carry
// bytes a pair (a stripe's hand-off to the next); the banded kernel's
// lq + lt rows a pair of one 4-byte word a thread of the pair's K
// blocks; -1 when hw is past the banded kernel.
long long align_scan_dir_bytes(int b, int lq, int lt, int hw) {
    if (hw == 0)
        return (long long)b * (full_shape(b, lq, lt, dev_info()).recs
                               * (long long)sizeof(uint4) + lt);
    BandShape sh;
    if (!band_shape(b, hw, dev_info(), sh)) return -1;
    return (long long)b * (lq + lt) * sh.K * 32 * sh.W * sizeof(BandWord);
}

// Loads the library's kernels on the current device and opts each into
// the most dynamic shared memory a block may take, once a device.  CUDA
// loads a module at its first use, so a launch that came first would
// pay for the load (and the opt-in) inside its dispatch's event window;
// the wrapper calls this with the buffers, before the window.  Returns a
// CUDA error code (0 = ready).
int align_scan_prepare() {
    DevInfo& info = dev_info();
    if (info.prepared) return 0;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, align_full_kernel);
    if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&a, align_band_kernel<kSlots, false>);
    if (e == cudaSuccess)
        e = opt_in(align_band_kernel<kSlots, false>,
                   info.optin - (int)a.sharedSizeBytes, info.band_set);
    if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&a, align_band_kernel<kSlots, true>);
    if (e == cudaSuccess)
        e = opt_in(align_band_kernel<kSlots, true>,
                   info.optin - (int)a.sharedSizeBytes, info.split_set);
    info.prepared = e == cudaSuccess;
    return (int)e;
}

// Aligns b pairs on ``stream``: q [b, lq], t [b, lt] uint8 codes, ql, tl
// [b] int32, hw 0 for the full kernel, else the band's half-width (at
// most 8 x 16 x 32 x 9 - 2 = 36,862).  dirs holds align_scan_dir_bytes()
// bytes of tape; ops [b, lq + lt] uint8 zeroed, meta [b, 2] int64 (each
// pair's sweep and traceback clock64() cycles).  Returns
// cudaGetLastError() after the launch (0 = launched).
int align_scan_launch(const void* q, const void* t, const void* ql,
                      const void* tl, void* dirs, void* ops, void* meta,
                      int b, int lq, int lt, int hw, void* stream) {
    if (b < 0 || lq < 1 || lt < 1 || hw < 0)
        return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    DevInfo& info = dev_info();
    if (hw == 0) {
        const FullShape f = full_shape(b, lq, lt, info);
        if (f.recs >= (1LL << 31)) return (int)cudaErrorInvalidValue;
        uint4* tape = static_cast<uint4*>(dirs);
        signed char* ho = reinterpret_cast<signed char*>(
            tape + (size_t)b * f.recs);
        align_full_kernel<<<(b + f.G - 1) / f.G, 32 * f.G,
                            f.G * sizeof(FullShared),
                            (cudaStream_t)stream>>>(
            (const uint8_t*)q, (const uint8_t*)t, (const int*)ql,
            (const int*)tl, tape, ho, (uint8_t*)ops, (long long*)meta, b,
            lq, lt, f.nbp);
        return (int)cudaGetLastError();
    }
    BandShape sh;
    if (!band_shape(b, hw, info, sh)) return (int)cudaErrorInvalidValue;
    if (sh.K > 1)
        return band_launch<kSlots, true>(q, t, ql, tl, dirs, ops, meta, b,
                                         lq, lt, hw, sh, info.split_set,
                                         stream);
    return band_launch<kSlots, false>(q, t, ql, tl, dirs, ops, meta, b, lq,
                                      lt, hw, sh, info.band_set, stream);
}

const char* align_scan_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
