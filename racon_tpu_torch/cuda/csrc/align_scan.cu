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
// Full kernel: columns 0..lt of each diagonal.  Only cells with i <= ql
// and j <= tl are computed: the traceback reads no other cell, and none
// of those reads another.
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
// What bounds them: 12 (full) and 13 (banded) int32 operations a cell
// at 16.7 T/s; the direction tape's bytes are a few percent of that.
// What holds them back is latency: one pair's diagonals are a chain,
// and a main-path launch holds fewer pairs than the card has SMs.
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
// The full kernel keeps one block a pair: the three rolling diagonals
// of lt + 1 columns in shared memory (device scratch past it), one
// barrier a diagonal, thread 0's traceback over 32-row windows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr uint8_t kQPad = 5, kTPad = 6;
constexpr int kDirDiag = 0, kDirUp = 1, kDirLeft = 2;
constexpr uint8_t kOpEq = 1, kOpX = 2, kOpI = 3, kOpD = 4;
constexpr int kMaxThreads = 1024;
constexpr int kWindowRows = 32;

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

// one byte of four lanes' 2-bit codes, written by the group's first
// lane (every lane of the warp calls this)
__device__ __forceinline__ void pack_store(uint8_t* row, int cell, int code,
                                           int pw) {
    unsigned x = (unsigned)code << (2 * (threadIdx.x & 3));
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 2);
    if ((threadIdx.x & 3) == 0 && (cell >> 2) < pw)
        row[cell >> 2] = (uint8_t)x;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
align_full_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ t, const int* __restrict__ ql,
                  const int* __restrict__ tl, uint8_t* __restrict__ dirs,
                  uint8_t* __restrict__ ops, long long* __restrict__ meta,
                  int* __restrict__ roll_g, int lq, int lt, int roll_smem,
                  int seq_smem) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_state[3];            // traceback i, j, tape position
    const int lane = blockIdx.x;
    const int QL = min(max(ql[lane], 0), lq);
    const int TL = min(max(tl[lane], 0), lt);
    const int D = QL + TL;
    if (D == 0) return;
    const long long c0 = clock64();
    const int tid = threadIdx.x, T = blockDim.x;
    const int W = lt + 1;
    const int RW = W + 2;
    const int PW = (W + 3) / 4;
    int* roll = roll_smem ? reinterpret_cast<int*>(smem)
                          : roll_g + (size_t)lane * 3 * RW;
    const uint8_t* qs = q + (size_t)lane * lq;
    const uint8_t* ts = t + (size_t)lane * lt;
    if (seq_smem) {
        uint8_t* sq = smem + (size_t)12 * RW;
        uint8_t* st = sq + lq;
        for (int k = tid; k < lq; k += T) sq[k] = qs[k];
        for (int k = tid; k < lt; k += T) st[k] = ts[k];
        qs = sq;
        ts = st;
    }
    for (int k = tid; k < 3 * RW; k += T) roll[k] = kBig;
    __syncthreads();
    // diagonal 0 (row 0): cell (0, 0) = 0 at column 0
    if (tid == 0) roll[0] = 0;
    __syncthreads();
    uint8_t* drow = dirs + (size_t)lane * (lq + lt) * PW;

    for (int d = 1; d <= D; ++d) {
        int* cur = roll + (d % 3) * RW;
        const int* p1 = roll + ((d + 2) % 3) * RW;
        const int* p2 = roll + ((d + 1) % 3) * RW;
        uint8_t* row = drow + (size_t)(d - 1) * PW;
        const int jmin = max(0, d - QL), jmax = min(d, TL);
        for (int base = jmin & ~31; base + (tid & ~31) <= jmax; base += T) {
            const int j = base + tid;
            int code = 0;
            if (j >= jmin && j <= jmax) {
                const int i = d - j;
                int v = d;
                if (i != 0 && j != 0) {
                    const int cd = p2[j - 1] + (qs[i - 1] != ts[j - 1]);
                    const int cu = p1[j] + 1;
                    v = min(min(cd, cu), p1[j - 1] + 1);
                    code = v == cd ? kDirDiag : (v == cu ? kDirUp : kDirLeft);
                }
                cur[j] = v;
            }
            pack_store(row, j, code, PW);
        }
        __syncthreads();
    }

    const long long c1 = clock64();
    // traceback over staged windows of direction rows
    uint8_t* win = reinterpret_cast<uint8_t*>(roll);
    const int rows = min(kWindowRows, 12 * RW / PW);
    uint8_t* tape = ops + (size_t)lane * (lq + lt);
    if (tid == 0) {
        s_state[0] = QL;
        s_state[1] = TL;
        s_state[2] = 0;
    }
    __syncthreads();
    while (true) {
        int i = s_state[0], j = s_state[1];
        const int d = i + j;
        if (d == 0) break;
        const int dlo = max(1, d - rows + 1);
        const uint8_t* src = drow + (size_t)(dlo - 1) * PW;
        const int n = (d - dlo + 1) * PW;
        for (int k = tid; k < n; k += T) win[k] = src[k];
        __syncthreads();
        if (tid == 0) {
            int pos = s_state[2];
            while ((i > 0 || j > 0) && i + j >= dlo) {
                const int dd = i + j;
                int code = (win[(dd - dlo) * PW + (j >> 2)] >> (2 * (j & 3)))
                           & 3;
                if (i == 0) code = kDirLeft;
                if (j == 0) code = kDirUp;
                uint8_t op;
                if (code == kDirDiag) {
                    op = qs[i - 1] == ts[j - 1] ? kOpEq : kOpX;
                    --i;
                    --j;
                } else if (code == kDirUp) {
                    op = kOpI;
                    --i;
                } else {
                    op = kOpD;
                    --j;
                }
                tape[pos++] = op;
            }
            s_state[0] = i;
            s_state[1] = j;
            s_state[2] = pos;
        }
        __syncthreads();
    }
    if (tid == 0) {
        meta[2 * lane] = c1 - c0;
        meta[2 * lane + 1] = clock64() - c1;
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
    int optin, sms, full_set, band_set, split_set;
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

// the full kernel: shared memory of one block, and whether the rolling
// rows and the sequences fit there
struct Layout {
    int threads, smem, roll_smem, seq_smem;
    long long roll_bytes;     // one block's rolling rows
};

Layout full_layout(int lq, int lt) {
    const int optin = dev_info().optin - 64;   // the static s_state words
    const long long w = (long long)lt + 1;
    Layout l;
    l.roll_bytes = 12 * (w + 2);
    l.roll_smem = l.roll_bytes <= optin;
    l.seq_smem = l.roll_smem && l.roll_bytes + lq + lt <= optin;
    l.smem = (int)((l.roll_smem ? l.roll_bytes : 0)
                   + (l.seq_smem ? lq + lt : 0));
    l.threads = (int)(w < kMaxThreads ? (w + 31) / 32 * 32 : kMaxThreads);
    return l;
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

// Device scratch bytes one lane needs for its rolling rows: the full
// kernel's past shared memory, else 0 (the banded kernel needs none).
long long align_scan_roll_bytes(int lq, int lt, int hw) {
    if (hw) return 0;
    const Layout l = full_layout(lq, lt);
    return l.roll_smem ? 0 : l.roll_bytes;
}

// Bytes of the direction tape of a launch of b pairs: lq + lt rows a
// pair of ceil((lt + 1) / 4) bytes (full), or of one 4-byte word a
// thread of the pair's K blocks (banded); -1 when hw is past the banded
// kernel.
long long align_scan_dir_bytes(int b, int lq, int lt, int hw) {
    if (hw == 0) return (long long)b * (lq + lt) * ((lt + 4) / 4);
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
        e = opt_in(align_full_kernel, info.optin - (int)a.sharedSizeBytes,
                   info.full_set);
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
// bytes of direction tape; ops [b, lq + lt]
// uint8 zeroed, meta [b, 2] int64 (each pair's sweep and traceback
// clock64() cycles), roll b * align_scan_roll_bytes() bytes (unused
// when that is 0).  Returns cudaGetLastError() after the launch (0 =
// launched).
int align_scan_launch(const void* q, const void* t, const void* ql,
                      const void* tl, void* dirs, void* ops, void* meta,
                      void* roll, int b, int lq, int lt, int hw,
                      void* stream) {
    if (b < 0 || lq < 1 || lt < 1 || hw < 0)
        return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    DevInfo& info = dev_info();
    if (hw == 0) {
        const Layout l = full_layout(lq, lt);
        if (!l.roll_smem && roll == nullptr)
            return (int)cudaErrorInvalidValue;
        cudaError_t e = opt_in(align_full_kernel, l.smem, info.full_set);
        if (e != cudaSuccess) return (int)e;
        align_full_kernel<<<b, l.threads, l.smem, (cudaStream_t)stream>>>(
            (const uint8_t*)q, (const uint8_t*)t, (const int*)ql,
            (const int*)tl, (uint8_t*)dirs, (uint8_t*)ops, (long long*)meta,
            (int*)roll, lq, lt, l.roll_smem, l.seq_smem);
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
