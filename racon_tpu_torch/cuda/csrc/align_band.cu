// Banded unit-cost global alignment along a center table on Hopper
// (sm_90a).
//
// Replaces racon_tpu/tpu/align_pallas.py:_kernel.  One thread block
// aligns one pair: the DP runs row by row over a band of wb target
// columns whose start follows the pair's knot-interpolated center (in
// 128-column quanta), each thread owning 8 adjacent columns.  A row is
// the diagonal and vertical candidates closed by the in-row horizontal
// chain, which is a prefix minimum of (candidate - j): each thread
// scans its 8 columns, then the block scans the thread totals (warp
// shuffles, then warp totals), as block_scan_max does in poa_full.cu
// with min in place of max.  The rules that place the band and break
// ties are the Pallas kernel's: the band start clip((ctr_i - wb/2) >> 7,
// 0, smax), the previous row realigned by an advance of 1 or 2 quanta
// and read unshifted otherwise, D[i][0] = i, columns past tl out of
// reach, diagonal > up > left direction codes (up in column 0), the
// distance read at tl - start(ql), and the traceback's clipped band
// column, left on row 0 and up at j <= 0.  Results (distance, move
// count, moves) equal the Pallas kernel's.
//
// What bounds it: the rows form a serial chain of up to 16,384 steps,
// two block barriers each, so the kernel is bound by latency, not by
// bytes or operations; many independent pairs in flight (one block
// each) hide it.  Directions: the Pallas kernel keeps score checkpoints
// and recomputes each block of rows in its traceback; here every cell's
// 2-bit direction goes to a device-memory scratch instead (8 columns
// per uint16 a thread stores each row), lq x wb / 4 bytes per pair:
// 8 MB at wb 2048 and lq 16384, 32 MB at wb 8192.  The traceback is a
// serial walk of at most ql + tl steps on thread 0.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kQ = 128;               // band-start quantum
constexpr int kCols = 8;              // band columns per thread
constexpr int kShiftPad = 3 * kQ;     // realignment reads past the band
constexpr int kCtrLog = 10;           // knots every 1024 rows
constexpr unsigned kFull = 0xffffffffu;
enum { kDiag = 0, kUp = 1, kLeft = 2 };

__device__ __forceinline__ int band_start(const int* ctr, int i, int wb,
                                          int smax) {
    const int k = i >> kCtrLog;
    const int c0 = ctr[k], c1 = ctr[k + 1];
    const int ci = c0 + (((c1 - c0) * (i - (k << kCtrLog))) >> kCtrLog);
    return min(max((ci - (wb >> 1)) >> 7, 0), smax);
}

// target code at band position jt (-1 past the stored row: no match)
__device__ __forceinline__ int tcode(const uint8_t* tb, int jt, int lt) {
    return jt < lt ? (int)tb[jt] : -1;
}

__global__ void __launch_bounds__(1024)
align_band_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ t,
                  const int* __restrict__ qlen, const int* __restrict__ tlen,
                  const int* __restrict__ ctr, uint16_t* __restrict__ dirs,
                  int* __restrict__ tape, int* __restrict__ meta, int lq,
                  int lt, int wb, int n_ctr, int tape_w) {
    extern __shared__ int row[];          // [wb + kShiftPad] then 32
    int* wtot = row + wb + kShiftPad;
    const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    // lengths past the stored rows are cut to them (the wrapper's
    // inputs never exceed them)
    const int ql = min(qlen[b], lq), tl = min(tlen[b], lt);
    const int smax = (max(tl + 1 - wb, 0) + kQ - 1) / kQ;
    const int* cb = ctr + (long long)b * n_ctr;
    const uint8_t* qb = q + (long long)b * lq;
    const uint8_t* tb = t + (long long)b * lt;
    uint16_t* db = dirs + (long long)b * lq * nthr;
    const int c0 = tid * kCols;

    // row 0: D[0][c] = c, out of reach past tl
    for (int k = 0; k < kCols; ++k)
        row[c0 + k] = (c0 + k > tl) ? kBig : c0 + k;
    for (int c = wb + tid; c < wb + kShiftPad; c += nthr) row[c] = kBig;
    int sq_prev = band_start(cb, 0, wb, smax);
    __syncthreads();

    for (int i = 1; i <= ql; ++i) {
        const int sq = band_start(cb, i, wb, smax);
        const int dq = sq - sq_prev;
        const int sh = (dq == 1 || dq == 2) ? dq * kQ : 0;
        sq_prev = sq;
        const int s = sq * kQ;
        const int qc = qb[i - 1];
        // previous row at this row's columns (c0 + sh is a multiple of 8)
        int pu[kCols];
        const int4 lo = *reinterpret_cast<const int4*>(row + c0 + sh);
        const int4 hi = *reinterpret_cast<const int4*>(row + c0 + sh + 4);
        pu[0] = lo.x; pu[1] = lo.y; pu[2] = lo.z; pu[3] = lo.w;
        pu[4] = hi.x; pu[5] = hi.y; pu[6] = hi.z; pu[7] = hi.w;
        unsigned mm = 0;                  // mismatch bit per column
        for (int k = 0; k < kCols; ++k)
            mm |= (unsigned)(tcode(tb, s + c0 + k, lt) != qc) << k;
        // diagonal candidate of column c0: column c0 - 1's, from the
        // neighbour thread or, for a warp's lane 0, recomputed
        int dleft = __shfl_up_sync(kFull, pu[kCols - 1] + (int)(mm >> 7), 1);
        if (lane == 0)
            dleft = c0 == 0 ? kBig
                            : row[c0 - 1 + sh] +
                                  (tcode(tb, s + c0 - 1, lt) != qc);
        int x[kCols];
        int run = INT_MAX;
        for (int k = 0; k < kCols; ++k) {
            const int j = s + c0 + k;
            const int dsh = k ? pu[k - 1] + (int)((mm >> (k - 1)) & 1u)
                              : dleft;
            int tu = min(dsh, pu[k] + 1);
            if (j == 0) tu = i;
            if (j > tl) tu = kBig;
            run = min(run, tu - j);
            x[k] = run;
        }
        // block-wide exclusive prefix minimum of the thread totals
        int incl = run;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl = min(incl, y);
        }
        if (lane == 31) wtot[warp] = incl;
        __syncthreads();                  // every read of the row is done
        int excl = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) excl = INT_MAX;
        for (int w = 0; w < warp; ++w) excl = min(excl, wtot[w]);
        unsigned bits = 0;
        for (int k = 0; k < kCols; ++k) {
            const int j = s + c0 + k;
            const int v = min(min(x[k], excl) + j, kBig);
            const int dsh = k ? pu[k - 1] + (int)((mm >> (k - 1)) & 1u)
                              : dleft;
            int dir = v == dsh ? kDiag : v == pu[k] + 1 ? kUp : kLeft;
            if (j == 0) dir = kUp;
            bits |= (unsigned)dir << (2 * k);
            x[k] = v;
        }
        *reinterpret_cast<int4*>(row + c0) = make_int4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<int4*>(row + c0 + 4) =
            make_int4(x[4], x[5], x[6], x[7]);
        db[(long long)(i - 1) * nthr + tid] = (uint16_t)bits;
        __syncthreads();
    }
    if (tid != 0) return;

    const int c_end = tl - band_start(cb, ql, wb, smax) * kQ;
    const int dist = (c_end >= 0 && c_end < wb) ? row[c_end] : kBig;
    // traceback from (ql, tl), 16 moves per tape word
    int* out = tape + (long long)b * tape_w;
    int i = ql, j = tl, n = 0, nw = 0, nb = 0;
    unsigned word = 0;
    while (i > 0 || j > 0) {
        int mv = kLeft;
        if (i > 0) {
            const int s = band_start(cb, i, wb, smax) * kQ;
            const int cc = min(max(j - s, 0), wb - 1);
            mv = (db[(long long)(i - 1) * nthr + (cc >> 3)] >> (2 * (cc & 7)))
                 & 3;
            if (j <= 0) mv = kUp;
        }
        word |= (unsigned)mv << (2 * nb);
        if (++nb == 16) {
            out[nw++] = (int)word;
            word = 0;
            nb = 0;
        }
        ++n;
        if (i == 0) {
            --j;
        } else {
            if (mv != kLeft) --i;
            if (mv != kUp) --j;
        }
    }
    if (nb) out[nw] = (int)word;
    meta[8LL * b] = dist;
    meta[8LL * b + 1] = n;
}

}  // namespace

extern "C" {

// Launches one block of wb / 8 threads per pair on ``stream``; returns
// cudaGetLastError() after the launch (0 = launched).
int align_band_launch(const void* q, const void* t, const void* ql,
                      const void* tl, const void* ctr, void* dirs,
                      void* tape, void* meta, int b, int lq, int lt, int wb,
                      int n_ctr, int tape_w, void* stream) {
    if (b <= 0 || wb % 256 != 0 || wb < 256 || wb > 8192)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(int) * (wb + kShiftPad + 32);
    align_band_kernel<<<b, wb / kCols, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int*)ql,
        (const int*)tl, (const int*)ctr, (uint16_t*)dirs, (int*)tape,
        (int*)meta, lq, lt, wb, n_ctr, tape_w);
    return (int)cudaGetLastError();
}

const char* align_band_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
