// Banded unit-cost global alignment along a center table on Hopper
// (sm_90a).
//
// Replaces racon_tpu/tpu/align_pallas.py:_kernel.  A block of 1-8 warps
// aligns one pair at a time: the DP runs row by row over a band of wb
// target columns whose start follows the pair's knot-interpolated center
// (in 128-column quanta), each thread owning wb / (32 x warps) adjacent
// columns.  The rules that place the band and break ties are the Pallas
// kernel's: the band start clip((ctr_i - wb/2) >> 7, 0, smax), the
// previous row realigned by an advance of 1 or 2 quanta and read
// unshifted otherwise (a backward step included), D[i][0] = i, columns
// past tl out of reach, diagonal > up > left direction codes (up in
// column 0), the distance read at tl - start(ql), and the traceback's
// clipped band column, left on row 0 and up at j <= 0.  Results
// (distance, move count, moves) equal the Pallas kernel's.
//
// What bounds it: int32 operations (about a dozen per band cell) and
// the serial chain of up to 16,384 rows per pair; many pairs in flight
// hide the chain, and more warps per pair shorten it where a batch
// leaves warp slots free.  What the design does about it:
//
// * At most one block barrier per row (none with one warp).  A row is
//   the diagonal and vertical candidates closed by the in-row horizontal
//   chain, a prefix minimum of (candidate - j).  Pass 1 folds each
//   thread's columns into a thread-local prefix and stores each cell's
//   candidate, a 5-step shuffle scan closes the chain across a warp, the
//   warps' totals cross in shared memory behind the row's one barrier,
//   and pass 2 finishes the cells and their 2-bit directions.  Cells
//   hold 2 x D, and a candidate 2 x min + (up flag), so one min yields
//   both the candidate and its direction.
// * The row lives in shared memory as a ring of wb + 256 cells: a band
//   advance of 1 or 2 quanta moves the ring's base instead of the data,
//   so a thread reads and writes only its own cells; the cell left of a
//   thread comes by shuffle (across warps through shared memory).  One
//   16-byte pad per run of U cells (U the largest power of two dividing
//   a thread's columns) spreads the threads' 16-byte accesses over all
//   banks.
// * Matches come from a per-pair bit table of the target in shared
//   memory (one bit per target column for each of A/C/G/T): 8 columns'
//   match bits are one shared load.  For a row whose query code is
//   past T (N), the block first builds that row's bits from the target.
// * Directions go to a device-memory scratch, lq x wb / 4 bytes per
//   pair (8 columns per uint16, the row's words contiguous).  The
//   traceback walks on warp 0: every lane fetches one of the next 32
//   rows' 32 direction words around the path into shared memory at
//   once, and the walk reads shared memory until the path leaves that
//   window.
// * Persistent blocks (as many as fit on the card) take pairs from a
//   device queue, so no launch ends in a tail wave.
//
// meta[:, 2] and meta[:, 3] hold clock64() cycles per pair (DP rows
// with the bit table, traceback); the plain version writes 0 there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kBig2 = 2 * kBig;
constexpr int kInf = 1 << 29;         // above every prefix value
constexpr int kQ = 128;               // band-start quantum
constexpr int kPad = 2 * kQ;          // ring cells past the band
constexpr int kCtrLog = 10;           // knots every 1024 rows
constexpr int kCodes = 4;             // bit-table rows: A/C/G/T
constexpr int kWin = 32;              // traceback window: rows and words
constexpr int kMaxWarps = 8;
// per block: the pair index, its start clock; per warp, by row parity,
// the left-cell exchange and the warp totals
constexpr int kSync = 2 + 4 * kMaxWarps;
constexpr unsigned kFull = 0xffffffffu;
enum { kDiag = 0, kUp = 1, kLeft = 2 };

__device__ __forceinline__ int band_start(const int* ctr, int i, int wb,
                                          int smax) {
    const int k = i >> kCtrLog;
    const int c0 = ctr[k], c1 = ctr[k + 1];
    const int ci = c0 + (((c1 - c0) * (i - (k << kCtrLog))) >> kCtrLog);
    return min(max((ci - (wb >> 1)) >> 7, 0), smax);
}

struct Layout {
    int cols, ushift, ring, ring_words, peq_words, erow_words;
};

// shared memory of a block: the ring, the bit table, the sync words,
// then one row of match bits for a query code past T
__host__ __device__ inline Layout layout(int lt, int wb, int nw) {
    Layout g;
    g.cols = wb / (32 * nw);                       // columns per thread
    g.ushift = 0;                                  // log2 of the pad run
    while (!((g.cols >> g.ushift) & 1)) ++g.ushift;
    g.ring = wb + kPad;
    g.ring_words = g.ring + ((g.ring >> g.ushift) << 2);
    // the band reads target columns below max(lt, wb) + kQ
    g.peq_words = ((lt > wb ? lt : wb) + kQ) / 32 + 2;
    g.erow_words = wb / 32 + 2;
    return g;
}

inline size_t smem_bytes(int lt, int wb, int nw) {
    const Layout g = layout(lt, wb, nw);
    return sizeof(int) * (size_t)(g.ring_words + kCodes * g.peq_words +
                                  kSync + g.erow_words);
}

// shared-memory word of ring cell p (0 <= p < ring)
__device__ __forceinline__ int cell(int p, int ushift) {
    return p + ((p >> ushift) << 2);
}

// block-wide barrier of a pair's warps (a warp barrier for one warp)
__device__ __forceinline__ void pair_sync(int nwarps) {
    if (nwarps > 1)
        __syncthreads();
    else
        __syncwarp();
}

// Pass 1 over one unit of 8 columns jb .. jb + 7: from the previous
// row's cells (2 D, read in place) the candidates e = min(diagonal,
// vertical), as 2 x value + (1 if vertical), stored back in place.
// ``run`` carries the horizontal chain min(run + 2, e) along the
// thread's columns, ``dprev`` the next column's diagonal (2 D, + 2 on a
// mismatch: bit k + 1 of mm2).  kEdge: columns past tl are out of reach.
template <bool kEdge>
__device__ __forceinline__ void pass1(int* c, unsigned mm2, int jb, int i,
                                      int tl, int& run, int& dprev) {
    int4* v = reinterpret_cast<int4*>(c);
    const int4 lo = v[0], hi = v[1];
    const int pu[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        int ek = min(dprev, pu[k] + 3);
        if (k == 0 && jb == 0) ek = 2 * i + 1;   // D[i][0] = i, up
        if (kEdge && jb + k > tl) ek = kBig2;
        run = min(run + 2, ek);
        e[k] = ek;
        dprev = pu[k] + (int)((mm2 >> k) & 2u);
    }
    v[0] = make_int4(e[0], e[1], e[2], e[3]);
    v[1] = make_int4(e[4], e[5], e[6], e[7]);
}

// Pass 2 over one unit: the cells, min(y, 2 BIG) for the horizontal
// chain y = min(y + 2, candidate without its up flag) carried in from
// the left, and their 16 direction bits: the candidate minus the cell,
// capped at 2, is the up flag where the cell equals its candidate and
// 2 (left) where it is below.
__device__ __forceinline__ unsigned pass2(int* c, int& y) {
    int4* v = reinterpret_cast<int4*>(c);
    const int4 lo = v[0], hi = v[1];
    const int e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int out[8];
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        y = min(y + 2, e[k] & ~1);
        const int val = min(y, kBig2);
        bits += (unsigned)min(e[k] - val, 2) << (2 * k);
        out[k] = val;
    }
    v[0] = make_int4(out[0], out[1], out[2], out[3]);
    v[1] = make_int4(out[4], out[5], out[6], out[7]);
    return bits;
}

// The ring cells of a thread's unit u; for kGroup 4 a group's 4 units
// are one run of 32 contiguous cells.
__device__ __forceinline__ int* unit_cells(int* ring, int base, int c0,
                                           int u, int R, int us) {
    int p = base + c0 + 8 * u;
    if (p >= R) p -= R;
    return ring + cell(p, us);
}

// Pass 1 over a thread's columns, kGroup units per unrolled step;
// returns the chain at its last column.
template <int kGroup, bool kEdge>
__device__ __forceinline__ int row_pass1(int* ring, const uint32_t* prow,
                                         int units, int base, int c0,
                                         int s, int R, int us, int i,
                                         int tl, int dprev) {
    int run = kInf;
    for (int u0 = 0; u0 < units; u0 += kGroup) {
        const int jg = s + c0 + 8 * u0;
        int* cg = unit_cells(ring, base, c0, u0, R, us);
        const unsigned mm = ~(prow[jg >> 5] >> (jg & 31));
#pragma unroll
        for (int du = 0; du < kGroup; ++du) {
            int* c = kGroup > 1 ? cg + 8 * du
                                : unit_cells(ring, base, c0, u0 + du, R, us);
            pass1<kEdge>(c, (mm >> (8 * du)) << 1, jg + 8 * du, i, tl, run,
                         dprev);
        }
    }
    return run;
}

// kGroup units per unrolled step: 4 (32 contiguous cells, one bit-table
// word, one 8-byte direction store) when a thread's columns are a
// multiple of 32, else 1 (a uint16 store).  A block of nwarps warps aligns one pair at a time.
template <int kGroup>
__global__ void __launch_bounds__(32 * kMaxWarps)
align_band_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ t,
                  const int* __restrict__ qlen, const int* __restrict__ tlen,
                  const int* __restrict__ ctr, uint16_t* dirs,
                  int* __restrict__ tape, int* __restrict__ meta,
                  int* __restrict__ queue, int nb, int lq, int lt, int wb,
                  int n_ctr, int tape_w) {
    extern __shared__ __align__(16) int smem[];
    const int nthreads = blockDim.x, nwarps = nthreads >> 5;
    const Layout g = layout(lt, wb, nwarps);
    int* ring = smem;
    uint32_t* peq = reinterpret_cast<uint32_t*>(smem + g.ring_words);
    int* sync = smem + g.ring_words + kCodes * g.peq_words;
    int* xfer = sync + 2;                  // [2][kMaxWarps]
    int* wtot = xfer + 2 * kMaxWarps;      // [2][kMaxWarps]
    uint32_t* erow = reinterpret_cast<uint32_t*>(sync + kSync);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int C = g.cols, c0 = tid * C, units = C >> 3;
    const int R = g.ring, us = g.ushift;
    const int row_words = wb >> 3;        // uint16 direction words per row

    for (;;) {
        if (tid == 0) sync[0] = atomicAdd(queue, 1);
        pair_sync(nwarps);
        const int b = sync[0];
        if (b >= nb) break;
        // the start clock waits in shared memory (no register across
        // the DP)
        if (tid == 0) sync[1] = (int)clock64();
        const int ql = min(qlen[b], lq), tl = min(tlen[b], lt);
        const int smax = (max(tl + 1 - wb, 0) + kQ - 1) / kQ;
        const int* cb = ctr + (long long)b * n_ctr;
        const uint8_t* qb = q + (long long)b * lq;
        const uint8_t* tb = t + (long long)b * lt;
        uint16_t* db = dirs + (long long)b * lq * row_words;

        // bit table: bit jt of row a is t[jt] == a (0 past lt)
        for (int w = tid; w < g.peq_words; w += nthreads) {
            unsigned m[kCodes] = {0u, 0u, 0u, 0u};
            for (int k = 0; k < 32; ++k) {
                const int jt = (w << 5) + k;
                const int code = jt < lt ? (int)tb[jt] : 255;
#pragma unroll
                for (int a = 0; a < kCodes; ++a)
                    m[a] |= (unsigned)(code == a) << k;
            }
#pragma unroll
            for (int a = 0; a < kCodes; ++a) peq[a * g.peq_words + w] = m[a];
        }
        // row 0: D[0][c] = c, out of reach past tl; the pad out of reach
        for (int u = 0; u < units; ++u) {
            const int p = c0 + 8 * u;
            int e[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) e[k] = p + k > tl ? kBig2 : 2 * (p + k);
            int4* v = reinterpret_cast<int4*>(ring + cell(p, us));
            v[0] = make_int4(e[0], e[1], e[2], e[3]);
            v[1] = make_int4(e[4], e[5], e[6], e[7]);
        }
        for (int p = wb + 8 * tid; p < R; p += 8 * nthreads) {
            int4* v = reinterpret_cast<int4*>(ring + cell(p, us));
            v[0] = v[1] = make_int4(kBig2, kBig2, kBig2, kBig2);
        }
        pair_sync(nwarps);

        int base = 0;
        int sq_prev = band_start(cb, 0, wb, smax);
        int sq_next = ql > 0 ? band_start(cb, 1, wb, smax) : 0;
        int qc_next = ql > 0 ? (int)qb[0] : 0;
        for (int i = 1; i <= ql; ++i) {
            const int sq = sq_next, qc = qc_next;
            if (i < ql) {
                sq_next = band_start(cb, i + 1, wb, smax);
                qc_next = qb[i];
            }
            const int dq = sq - sq_prev;
            sq_prev = sq;
            const int s = sq * kQ;
            if (dq == 1 || dq == 2) {
                // realign: the ring's base moves by the advance and the
                // previous row's first dq quanta become pad
                const int sh = dq * kQ;
                pair_sync(nwarps);
                for (int p = 8 * tid; p < sh; p += 8 * nthreads) {
                    int pp = base + p;
                    if (pp >= R) pp -= R;
                    int4* v = reinterpret_cast<int4*>(ring + cell(pp, us));
                    v[0] = v[1] = make_int4(kBig2, kBig2, kBig2, kBig2);
                }
                base += sh;
                if (base >= R) base -= R;
            }
            const uint32_t* prow;
            if (qc < kCodes) {
                prow = peq + qc * g.peq_words;
            } else {
                // this row's match bits, from the target bytes
                pair_sync(nwarps);
                for (int w = tid; w < g.erow_words; w += nthreads) {
                    unsigned m = 0;
                    for (int k = 0; k < 32; ++k) {
                        const int jt = s + (w << 5) + k;
                        m |= (unsigned)((jt < lt ? (int)tb[jt] : -1) == qc)
                             << k;
                    }
                    erow[w] = m;
                }
                pair_sync(nwarps);
                prow = erow - (s >> 5);
            }
            const int par = (i & 1) * kMaxWarps;
            // the diagonal of this thread's first column: the left
            // thread's last cell plus its mismatch, by shuffle in a warp;
            // across warps through xfer, after the row's barrier
            int plast = base + c0 + C - 1;
            if (plast >= R) plast -= R;
            const int jl = s + c0 + C - 8;
            const unsigned eql = (prow[jl >> 5] >> (jl & 31)) & 0xffu;
            const int left =
                ring[cell(plast, us)] + (int)((~eql >> 6) & 2u);
            int dprev = __shfl_up_sync(kFull, left, 1);
            if (lane == 31) xfer[par + warp] = left;
            int pfirst = base + c0;
            if (pfirst >= R) pfirst -= R;
            const int pu_first = nwarps > 1 ? ring[cell(pfirst, us)] : 0;
            if (lane == 0) dprev = kBig2;   // exact for warp 0

            // the chain at the last column, as a prefix minimum of e - 2j
            const int run =
                (s + wb - 1 > tl
                     ? row_pass1<kGroup, true>(ring, prow, units, base, c0,
                                               s, R, us, i, tl, dprev)
                     : row_pass1<kGroup, false>(ring, prow, units, base, c0,
                                                s, R, us, i, tl, dprev)) -
                2 * (s + c0 + C - 1);
            // exclusive prefix minimum of the thread totals: a shuffle
            // scan in the warp, then the warps to the left
            int incl = run;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl = min(incl, y);
            }
            int x = __shfl_up_sync(kFull, incl, 1);
            if (lane == 0) x = kInf;
            if (nwarps > 1) {
                if (lane == 31) wtot[par + warp] = incl;
                __syncthreads();
                // warp v's first column took BIG for its diagonal in
                // pass 1; its true candidate adds the left cell's term
                int carry = kInf, dl = kInf;
#pragma unroll
                for (int v = 0; v < kMaxWarps; ++v) {
                    const int j0 = s + v * 32 * C;
                    const int dlv = v > 0 && v <= warp && j0 <= tl
                                        ? xfer[par + v - 1] - 2 * j0
                                        : kInf;
                    if (v < warp)
                        carry = min(carry, min(wtot[par + v], dlv));
                    else if (v == warp)
                        dl = dlv;
                }
                x = min(x, min(carry, dl));
                const int j0 = s + warp * 32 * C;
                if (lane == 0 && warp > 0 && j0 <= tl)
                    ring[cell(pfirst, us)] =
                        min(xfer[par + warp - 1], pu_first + 3);
            }

            // the chain entering this thread's first column (even: a
            // candidate's up flag is its low bit)
            int y = (x & ~1) + 2 * (s + c0 - 1);
            uint16_t* drow = db + (long long)(i - 1) * row_words + (c0 >> 3);
            for (int u0 = 0; u0 < units; u0 += kGroup) {
                int* cg = unit_cells(ring, base, c0, u0, R, us);
                unsigned acc[2] = {0u, 0u};
#pragma unroll
                for (int du = 0; du < kGroup; ++du) {
                    int* c = kGroup > 1
                                 ? cg + 8 * du
                                 : unit_cells(ring, base, c0, u0 + du, R, us);
                    const unsigned bits = pass2(c, y);
                    if (kGroup == 1)
                        drow[u0 + du] = (uint16_t)bits;
                    else
                        acc[(du >> 1) & 1] |= bits << (16 * (du & 1));
                }
                if (kGroup > 1)
                    *reinterpret_cast<uint2*>(drow + u0) =
                        make_uint2(acc[0], acc[1]);
            }
        }
        pair_sync(nwarps);

        const int c_end = tl - band_start(cb, ql, wb, smax) * kQ;
        int dist = kBig;
        if (c_end >= 0 && c_end < wb) {
            int p = base + c_end;
            if (p >= R) p -= R;
            dist = ring[cell(p, us)] >> 1;
        }
        pair_sync(nwarps);
        const unsigned t_dp = (unsigned)clock64();
        if (warp != 0) continue;

        // traceback from (ql, tl) on warp 0, 16 moves per tape word; the
        // window (kWin rows of kWin direction words) reuses the ring
        uint16_t* win = reinterpret_cast<uint16_t*>(smem);
        int* wstart = smem + kWin * kWin / 2;     // band start per row
        int* wword = wstart + kWin;               // first word per row
        int* out = tape + (long long)b * tape_w;
        int i = ql, j = tl, n = 0, nw = 0, nbits = 0, i0 = -1;
        unsigned word = 0;
        while (i > 0 || j > 0) {
            int mv = kLeft;
            if (i > 0) {
                int r = i0 - i, cc = 0, off = -1;
                if (r >= 0 && r < kWin) {
                    cc = min(max(j - wstart[r], 0), wb - 1);
                    off = (cc >> 3) - wword[r];
                }
                if (off < 0) {
                    // refill: lane l fetches row i - l's words around j
                    __syncwarp();
                    i0 = i;
                    if (i - lane >= 1) {
                        const int sr =
                            band_start(cb, i - lane, wb, smax) * kQ;
                        const int wr = min(max(j - sr, 0), wb - 1) >> 3;
                        const int a = min(max(wr - 24, 0) & ~7,
                                          row_words - kWin);
                        const uint4* src = reinterpret_cast<const uint4*>(
                            db + (long long)(i - 1 - lane) * row_words + a);
                        uint4* dst =
                            reinterpret_cast<uint4*>(win + lane * kWin);
                        const uint4 w0 = src[0], w1 = src[1], w2 = src[2],
                                    w3 = src[3];
                        dst[0] = w0;
                        dst[1] = w1;
                        dst[2] = w2;
                        dst[3] = w3;
                        wstart[lane] = sr;
                        wword[lane] = a;
                    }
                    __syncwarp();
                    r = 0;
                    cc = min(max(j - wstart[0], 0), wb - 1);
                    off = (cc >> 3) - wword[0];
                }
                mv = (win[r * kWin + off] >> (2 * (cc & 7))) & 3;
                if (j <= 0) mv = kUp;
            }
            word |= (unsigned)mv << (2 * nbits);
            if (++nbits == 16) {
                if (lane == 0) out[nw] = (int)word;
                ++nw;
                word = 0;
                nbits = 0;
            }
            ++n;
            if (i == 0) {
                --j;
            } else {
                if (mv != kLeft) --i;
                if (mv != kUp) --j;
            }
        }
        if (lane == 0) {
            if (nbits) out[nw] = (int)word;
            const unsigned t_end = (unsigned)clock64();
            meta[8LL * b] = dist;
            meta[8LL * b + 1] = n;
            // cycles of the low 32 clock bits (a pair takes far fewer
            // than 2^31)
            meta[8LL * b + 2] = (int)(t_dp - (unsigned)sync[1]);
            meta[8LL * b + 3] = (int)(t_end - t_dp);
        }
    }
}

// warps per pair: more when the batch leaves the card's warp slots
// (kWarpsPerSm per SM) idle, while each thread keeps whole units of 8
// columns
constexpr int kWarpsPerSm = 32;

bool warps_fit(int wb, int nw) { return wb % (256 * nw) == 0; }

int warps_per_pair(int b, int wb, int sms) {
    int nw = 1;
    while (nw < kMaxWarps && warps_fit(wb, 2 * nw) &&
           (long long)b * 2 * nw <= (long long)kWarpsPerSm * sms)
        nw *= 2;
    return nw;
}

template <int kGroup>
int launch(const void* q, const void* t, const void* ql, const void* tl,
           const void* ctr, void* dirs, void* tape, void* meta, void* queue,
           int b, int lq, int lt, int wb, int n_ctr, int tape_w, int nw,
           int sms, cudaStream_t stream) {
    auto* kern = align_band_kernel<kGroup>;
    const size_t smem = smem_bytes(lt, wb, nw);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        32 * nw, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const int grid = b < per_sm * sms ? b : per_sm * sms;
    kern<<<grid, 32 * nw, smem, stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int*)ql,
        (const int*)tl, (const int*)ctr, (uint16_t*)dirs, (int*)tape,
        (int*)meta, (int*)queue, b, lq, lt, wb, n_ctr, tape_w);
    return (int)cudaGetLastError();
}

int sm_count() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

}  // namespace

extern "C" {

// Launches persistent blocks (as many as fit on the card, at most b) of
// ``warps`` warps each (a power of two up to 8 leaving each thread a
// multiple of 8 columns; 0 = chosen from b), which take pairs from ``queue`` (one
// int32, zero at launch) on ``stream``; returns cudaGetLastError() after
// the launch (0 = launched).
int align_band_launch(const void* q, const void* t, const void* ql,
                      const void* tl, const void* ctr, void* dirs,
                      void* tape, void* meta, void* queue, int b, int lq,
                      int lt, int wb, int n_ctr, int tape_w, int warps,
                      void* stream) {
    if (b <= 0 || wb % 256 != 0 || wb < 256 || wb > 8192 || lt <= 0 ||
        warps < 0 || warps > kMaxWarps || (warps & (warps - 1)) ||
        (warps && !warps_fit(wb, warps)))
        return (int)cudaErrorInvalidValue;
    const int sms = sm_count();
    const int nw = warps ? warps : warps_per_pair(b, wb, sms);
    auto s = (cudaStream_t)stream;
    if ((wb / (32 * nw)) % 32 == 0)
        return launch<4>(q, t, ql, tl, ctr, dirs, tape, meta, queue, b, lq,
                         lt, wb, n_ctr, tape_w, nw, sms, s);
    return launch<1>(q, t, ql, tl, ctr, dirs, tape, meta, queue, b, lq, lt,
                     wb, n_ctr, tape_w, nw, sms, s);
}

// Loads both kernels on the current device.  CUDA loads a module at
// its first use, so a launch that came first would pay for the load
// inside its dispatch's event window; the wrapper calls this with the
// buffers, before the window.  Returns a CUDA error code (0 = ready).
int align_band_prepare() {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, align_band_kernel<1>);
    if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&a, align_band_kernel<4>);
    return (int)e;
}

// Warps per pair the launch takes for a batch of b pairs at band wb.
int align_band_warps(int b, int wb) {
    return warps_per_pair(b, wb, sm_count());
}

// Pairs resident at once on the current device at (lt, wb) with one warp
// per pair: blocks per SM times SMs (0 if none fits).
int align_band_slots(int lt, int wb) {
    auto* kern = (wb >> 5) % 32 == 0 ? align_band_kernel<4>
                                     : align_band_kernel<1>;
    const size_t smem = smem_bytes(lt, wb, 1);
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
        return 0;
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32,
                                                      smem) != cudaSuccess)
        return 0;
    return per_sm * sm_count();
}

// Dynamic shared memory of a one-warp pair at (lt, wb), in bytes.
int align_band_smem(int lt, int wb) { return (int)smem_bytes(lt, wb, 1); }

const char* align_band_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
