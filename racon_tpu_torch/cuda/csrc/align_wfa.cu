// Unit-cost global alignment by wavefronts (WFA) on Hopper (sm_90a).
//
// Replaces racon_tpu/tpu/align_pallas.py:_wfa_kernel together with its
// match-word pre-pass _wfa_match_words.  Wavefront e covers the
// diagonals d = j - i in [-e, e]; every step applies the native
// engine's candidates (deletion keeps i from d - 1, substitution and
// insertion advance i from d and d + 1, each with its boundary test)
// before sliding the furthest-reaching point along exact matches.  The
// pair stops at the first e whose final diagonal reaches ql, or is
// rejected past emax.  The traceback walks the history back with the
// engine's preference (insertion > substitution > deletion) and writes
// the (slide, op) tape, which equals the Pallas kernel's.
//
// What bounds it: a step's work is a few compares per diagonal, so the
// least time is the int32 operations of the wavefront cells, but a
// history the traceback can read costs bytes per cell as well (at
// 2 bytes a cell it takes more time on the main path than the
// operations), and the steps form a serial chain per pair.  On an H100
// the kernel is held by instruction issue (about 48 instructions a cell,
// the slide included) and by each launch's longest pair, not by the
// history's bytes.  What the design does about it:
//
// * A block of 8 or 16 warps aligns one pair at a time (16 when the
//   batch would leave half the card's warp slots idle at 8), with one
//   barrier per step.  Persistent blocks take pairs from a device
//   queue, longest first (the wrapper's order), so a launch ends in no
//   tail wave of long pairs.
// * Each thread steps two adjacent diagonals at a time: one 32-bit load
//   of the pair and two 16-bit loads of its neighbours, one 32-bit store
//   each to the wavefront and the history.  Inactive diagonals hold
//   large negative values, so the candidates need no activity tests;
//   the first eight bases of both slides are compared with no branch
//   ahead of their loads, so the two cells' latencies overlap.  The step
//   that finishes a pair is read from the wavefront after the barrier.
// * Only the diagonals a pair can reach, [-ql, tl] within [-e, e], are
//   stepped (rounded out to whole pairs); the others are provably
//   inactive.
// * q and t sit in shared memory as 4-bit codes, eight bases per word,
//   sized from the launch's longest pair (``lmax``; a pair longer than
//   that is not aligned but marked, meta[:, 0] = -1); a slide compares eight bases
//   at a time with one XOR (__funnelshift_r for unaligned starts, __ffs
//   for the first mismatch), and none is tried past tl.  Positions at or
//   past ql / tl hold the pads 5 / 6, which match nothing, so a slide
//   stops at a sequence end with no bounds test, and code 4 (any
//   non-ACGT byte) matches code 4 as in the Pallas version.  The two
//   wavefront buffers are int16 in shared memory.
// * The history is int16 (f is below 0 for an inactive diagonal or lies
//   in [0, ql], ql <= 16,384), only the live diagonals of each step with
//   a few cells of padding, in a device-memory scratch: 2 (emax + 1)
//   (emax + 6) bytes per pair, 8.4 MB at emax 2048, half of an int32
//   history's.
// * The traceback runs on warp 0 over windows of 32 steps x 65
//   diagonals around the path: the warp copies a window of history into
//   shared memory with coalesced loads (four rows' loads in flight at
//   once), then walks it there, so no step waits on device memory.  Tape
//   entries gather in the lanes' registers and leave 32 at a time.
//
// meta[:, 2] and meta[:, 3] hold clock64() cycles per pair (wavefront
// steps with the code packing, traceback); the plain version writes 0
// there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
// an inactive diagonal: every step raises it by at most 1, so it stays
// below 0 for all 2,048 steps and no activity test is needed
constexpr int kNeg = -30000;
constexpr int kQPad = 5, kTPad = 6;
constexpr int kSub = 1, kIns = 2, kDel = 3;
constexpr int kWin = 32;                  // traceback window: steps
constexpr int kWinCols = 2 * kWin + 1;    // its diagonals around the path
constexpr int kWinStride = kWinCols + 1;  // int16 per window row
constexpr int kGroup = 4;                 // window rows per batch of loads
constexpr int kMinWarps = 8, kMaxWarps = 16;
// meta[:, 0] of a pair longer than the launch's lmax
constexpr int kTooLong = -1;
// per block: the pair index, its start clock
constexpr int kSync = 4;

struct Layout {
    int nib;        // words of 4-bit codes per sequence
    int off;        // wavefront buffers hold d in [-off, off + 1]
    int wf;         // int16 per wavefront buffer
    int words;      // shared memory, 32-bit words
};

// shared memory of a block: the sync words, then q and t codes and the
// two wavefront buffers, which the traceback window reuses.  A step
// reads d - 1 .. d + 2 around pairs of diagonals (d even) within
// [-m - 1, m + 1], m = min(emax, lmax); ``off`` is even, so the pair
// (d, d + 1) is one aligned 32-bit word.
__host__ __device__ inline Layout layout(int lmax, int emax) {
    Layout g;
    g.nib = (lmax + 16) / 8 + 2;
    g.off = ((emax < lmax ? emax : lmax) + 3) & ~1;
    g.wf = 2 * g.off + 2;
    const int dp = 2 * g.nib + g.wf;
    const int tb = kWin * kWinStride / 2;
    g.words = kSync + (dp > tb ? dp : tb);
    return g;
}

inline size_t smem_bytes(int lmax, int emax) {
    return sizeof(int) * (size_t)layout(lmax, emax).words;
}

// eight 4-bit codes starting at position p (position p in bits 0..3)
__device__ __forceinline__ uint32_t nib8(const uint32_t* w, int p) {
    const int k = p >> 3;
    return __funnelshift_r(w[k], w[k + 1], (p & 7) * 4);
}

// furthest point of diagonal (i, j) along exact matches; the pads make
// every position at or past a sequence end a mismatch
__device__ __forceinline__ int slide(const uint32_t* qn, const uint32_t* tn,
                                     int i, int j) {
    while (true) {
        const uint32_t x = nib8(qn, i) ^ nib8(tn, j);
        if (x) return i + ((__ffs(x) - 1) >> 2);
        i += 8;
        j += 8;
    }
}

// history index of (step e, diagonal d), d in [-e - 1, e + 1]: row e
// spans 2 e + 6 entries from e (e + 5), and its d = 0 sits at an even
// offset, so an even d starts an aligned pair
__device__ __forceinline__ long long hist_at(int e, int d) {
    return (long long)e * (e + 5) + ((e + 3) & ~1) + d;
}

// the engine's candidates for diagonal d from the previous step's d - 1,
// d and d + 1 (inactive ones below 0), with their boundary tests
__device__ __forceinline__ int candidate(int nl, int v0, int nr, int d,
                                         int ql, int tl) {
    int f = nl + d <= tl ? nl : kNeg;
    const int s = v0 + 1;
    if (s <= ql && s + d <= tl) f = max(f, s);
    if (nr < ql) f = max(f, nr + 1);
    return f;
}

// The slide of a candidate, in two parts so that a thread's cells
// overlap: ``probe`` compares the first eight bases with no branch
// ahead of its loads (a cell that does not slide reads position 0) and
// returns the furthest point, or -1 - (f + 8) after eight matches, which
// ``finish`` carries on from.
__device__ __forceinline__ int probe(const uint32_t* __restrict__ qn,
                                     const uint32_t* __restrict__ tn, int f,
                                     int d, int ql, int tl) {
    const bool live = f >= 0 && f < ql && f + d < tl;
    const int i = live ? f : 0, j = live ? f + d : 0;
    const uint32_t x = nib8(qn, i) ^ nib8(tn, j);
    const int run = x ? (__ffs(x) - 1) >> 2 : 8;
    return !live ? f : x ? f + run : -1 - (f + 8);
}

__device__ __forceinline__ int finish(const uint32_t* __restrict__ qn,
                                      const uint32_t* __restrict__ tn, int p,
                                      int d, int f_in) {
    if (p >= 0 || f_in < 0) return p;
    const int f = -1 - p;
    return slide(qn, tn, f, f + d);
}

// the two cells (d, d + 1) of one aligned pair: their probes, before
// any long slide goes on
struct Pair {
    int f0, f1, p0, p1;
};

__device__ __forceinline__ Pair pair_probe(const int16_t* __restrict__ prev,
                                           const uint32_t* __restrict__ qn,
                                           const uint32_t* __restrict__ tn,
                                           int d, int ql, int tl) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(prev + d);
    const int a = (int16_t)(w & 0xffffu), c = (int16_t)(w >> 16);
    Pair r;
    r.f0 = candidate(prev[d - 1], a, c, d, ql, tl);
    r.f1 = candidate(a, c, prev[d + 2], d + 1, ql, tl);
    r.p0 = probe(qn, tn, r.f0, d, ql, tl);
    r.p1 = probe(qn, tn, r.f1, d + 1, ql, tl);
    return r;
}

__device__ __forceinline__ uint32_t pair_finish(
    const uint32_t* __restrict__ qn, const uint32_t* __restrict__ tn,
    const Pair& r, int d) {
    const int f0 = finish(qn, tn, r.p0, d, r.f0);
    const int f1 = finish(qn, tn, r.p1, d + 1, r.f1);
    return (uint32_t)(f0 & 0xffff) | ((uint32_t)f1 << 16);
}

// one wavefront step over the pairs (d, d + 1) from d0 in strides of
// ``step``, two pairs per iteration (the second one, past hi, repeats
// the first and stores nothing): one aligned 32-bit load of a pair and
// two 16-bit loads of its neighbours, one 32-bit store each to the
// wavefront and the history
__device__ __forceinline__ void wavefront_step(
    const int16_t* __restrict__ prev, int16_t* __restrict__ cur,
    int16_t* __restrict__ hrow, const uint32_t* __restrict__ qn,
    const uint32_t* __restrict__ tn, int d0, int hi, int step, int ql,
    int tl) {
    for (int d = d0; d <= hi; d += 2 * step) {
        const bool two = d + step <= hi;
        const int d2 = two ? d + step : d;
        const Pair r = pair_probe(prev, qn, tn, d, ql, tl);
        const Pair r2 = pair_probe(prev, qn, tn, d2, ql, tl);
        const uint32_t out = pair_finish(qn, tn, r, d);
        const uint32_t out2 = pair_finish(qn, tn, r2, d2);
        *reinterpret_cast<uint32_t*>(cur + d) = out;
        *reinterpret_cast<uint32_t*>(hrow + d) = out;
        if (two) {
            *reinterpret_cast<uint32_t*>(cur + d2) = out2;
            *reinterpret_cast<uint32_t*>(hrow + d2) = out2;
        }
    }
}

// one row of codes as 4-bit words; positions >= len hold the pad
__device__ __forceinline__ void pack_codes(uint32_t* out, int nwords,
                                           const uint8_t* src, int len,
                                           int pad, int tid, int nthreads) {
    for (int k = tid; k < nwords; k += nthreads) {
        uint32_t w = 0;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const int p = 8 * k + m;
            const uint32_t c = p < len ? src[p] : pad;
            w |= (c & 15u) << (4 * m);
        }
        out[k] = w;
    }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
align_wfa_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int* __restrict__ qlen, const int* __restrict__ tlen,
                 int* __restrict__ tape, int* __restrict__ meta,
                 int16_t* __restrict__ hist_all,
                 const int* __restrict__ order, int* __restrict__ queue,
                 int nb, int lq, int lmax, int emax, int tape_w) {
    extern __shared__ __align__(16) int smem[];
    const Layout g = layout(lmax, emax);
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int lane = tid & 31;
    int* sync = smem;
    uint32_t* qn = reinterpret_cast<uint32_t*>(smem + kSync);
    uint32_t* tn = qn + g.nib;
    int16_t* fbuf = reinterpret_cast<int16_t*>(tn + g.nib);
    int16_t* win = reinterpret_cast<int16_t*>(smem + kSync);
    const long long hist_len = (long long)(emax + 1) * (emax + 6);

    for (;;) {
        // every thread has read the previous pair's index and is done
        // with its shared memory
        __syncthreads();
        if (tid == 0) {
            const int k = atomicAdd(queue, 1);
            sync[0] = k < nb ? order[k] : nb;
        }
        __syncthreads();
        const int b = sync[0];
        if (b >= nb) break;
        const int ql = qlen[b], tl = tlen[b];
        int* mo = meta + 8LL * b;
        if (ql > lmax || tl > lmax) {
            if (tid == 0) { mo[0] = kTooLong; mo[1] = 0; }
            continue;
        }
        if (!(ql > 0 && tl > 0 && abs(tl - ql) <= emax)) {
            if (tid == 0) { mo[0] = kBig; mo[1] = 0; }
            continue;
        }
        if (tid == 0) sync[1] = (int)clock64();
        pack_codes(qn, g.nib, q + (long long)b * lq, ql, kQPad, tid,
                   nthreads);
        pack_codes(tn, g.nib, t + (long long)b * lq, tl, kTPad, tid,
                   nthreads);
        for (int k = tid; k < 2 * g.wf; k += nthreads) fbuf[k] = kNeg;
        const int fin = tl - ql;
        int16_t* hist = hist_all + (long long)b * hist_len;
        int16_t* prev = fbuf + g.off;
        int16_t* cur = fbuf + g.wf + g.off;
        __syncthreads();
        if (tid == 0) {
            const int f0 = slide(qn, tn, 0, 0);
            prev[0] = (int16_t)f0;
            hist[hist_at(0, 0)] = (int16_t)f0;
        }
        __syncthreads();
        // the step whose final diagonal reaches ql: every thread reads it
        // from the buffer just written, which the next step only reads
        int dist = prev[fin] >= ql ? 0 : kBig;
        for (int e = 1; e <= emax && dist == kBig; ++e) {
            // the reachable diagonals, by aligned pairs from an even d
            // (an extra diagonal past either end comes out inactive)
            const int lo = max(-e, -ql), hi = min(e, tl);
            wavefront_step(prev, cur, hist + hist_at(e, 0), qn, tn,
                           (lo & ~1) + 2 * tid, hi, 2 * nthreads, ql, tl);
            __syncthreads();
            if (cur[fin] >= ql) dist = e;
            int16_t* tmp = prev;
            prev = cur;
            cur = tmp;
        }
        // every thread has read the last step's final diagonal before
        // the traceback window overwrites the wavefronts
        __syncthreads();
        const unsigned t_dp = (unsigned)clock64();
        if (tid >= 32) continue;
        if (dist == kBig) {
            if (lane == 0) {
                mo[0] = kBig;
                mo[1] = 0;
                mo[2] = (int)(t_dp - (unsigned)sync[1]);
            }
            continue;
        }

        // traceback from (dist, fin) on warp 0; window slot s holds the
        // history row top - 1 - s at diagonals dc - kWin .. dc + kWin
        int* out = tape + (long long)b * tape_w;
        int i = ql, d = fin, n = 0, e = dist;
        int top = e + kWin, dc = d, held = 0;
        while (e > 0) {
            int s = top - e;
            if (s >= kWin) {
                __syncwarp();
                top = e;
                dc = d;
                s = 0;
                // kGroup rows at a time: every load of a group is issued
                // before its values are stored (a row r < 0 loads nothing)
                for (int k0 = 0; k0 < kWin; k0 += kGroup) {
                    int v[kGroup][3];
#pragma unroll
                    for (int kk = 0; kk < kGroup; ++kk) {
                        const int r = e - 1 - k0 - kk;
                        const int rlo = max(-r, -ql), rhi = min(r, tl);
                        const int16_t* hr = hist + hist_at(r, 0);
#pragma unroll
                        for (int m = 0; m < 3; ++m) {
                            const int c = lane + 32 * m;
                            const int dd = dc - kWin + c;
                            v[kk][m] = c < kWinCols && dd >= rlo && dd <= rhi
                                           ? hr[dd] : -1;
                        }
                    }
#pragma unroll
                    for (int kk = 0; kk < kGroup; ++kk)
#pragma unroll
                        for (int m = 0; m < 3; ++m)
                            if (lane + 32 * m < kWinCols)
                                win[(k0 + kk) * kWinStride + lane + 32 * m] =
                                    (int16_t)v[kk][m];
                }
                __syncwarp();
            }
            const int16_t* wr = win + s * kWinStride + (d - dc + kWin);
            const int vm1 = wr[-1], v0 = wr[0], vp1 = wr[1];
            const int del_c = (vm1 >= 0 && vm1 + d <= tl) ? vm1 : -1;
            const int sub_c =
                (v0 >= 0 && v0 < ql && v0 + 1 + d <= tl) ? v0 + 1 : -1;
            const int ins_c = (vp1 >= 0 && vp1 < ql) ? vp1 + 1 : -1;
            const int i0 = max(max(del_c, sub_c), ins_c);
            const bool is_ins = ins_c >= 0 && ins_c == i0;
            const bool is_sub = !is_ins && sub_c >= 0 && sub_c == i0;
            const int entry =
                (i - i0) * 4 + (is_ins ? kIns : is_sub ? kSub : kDel);
            if (lane == (n & 31)) held = entry;
            if ((n & 31) == 31) out[n - 31 + lane] = held;
            ++n;
            i = (is_ins || is_sub) ? i0 - 1 : i0;
            d = is_ins ? d + 1 : is_sub ? d : d - 1;
            --e;
        }
        // the e = 0 slide, then the entries still held
        if (lane == (n & 31)) held = i * 4;
        if (lane <= (n & 31)) out[(n & ~31) + lane] = held;
        ++n;
        if (lane == 0) {
            const unsigned t_end = (unsigned)clock64();
            mo[0] = dist;
            mo[1] = n;
            // cycles of the low 32 clock bits (a pair takes far fewer
            // than 2^31)
            mo[2] = (int)(t_dp - (unsigned)sync[1]);
            mo[3] = (int)(t_end - t_dp);
        }
    }
}

// warps per pair: 16 when the batch at 8 would leave at least half of
// the card's warp slots (kWarpsPerSm per SM, the most an SM holds)
// idle, else 8 (a main-path chunk of ~1,000 pairs); a pair's steps are
// a serial chain, so a launch ends with its longest pair, and more
// warps per pair shorten that chain
constexpr int kWarpsPerSm = 64;

int warps_per_pair(int b, int sms) {
    return (long long)b * 2 * kMinWarps <= (long long)kWarpsPerSm * sms
               ? kMaxWarps : kMinWarps;
}

int sm_count() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

// blocks of nw warps resident per SM at (lmax, emax) in ``per_sm``, with
// the shared-memory opt-in set; returns a CUDA error code (0 = ok)
int blocks_per_sm(int lmax, int emax, int nw, int* per_sm) {
    const size_t smem = smem_bytes(lmax, emax);
    cudaError_t err = cudaFuncSetAttribute(
        align_wfa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, align_wfa_kernel, 32 * nw, smem);
}

}  // namespace

extern "C" {

// Launches persistent blocks (as many as fit on the card, at most b) of
// align_wfa_warps(b) warps each, which take
// the pairs ``order[0], order[1], ...`` (a permutation of 0 .. b - 1)
// through ``queue`` (one int32, zero at launch) on ``stream``.
// ``lmax`` (at most lq) sizes the shared memory: a pair with ql or tl
// above it gets meta[:, 0] = -1 and no alignment.  Returns cudaGetLastError() after the launch (0 =
// launched).
int align_wfa_launch(const void* q, const void* t, const void* ql,
                     const void* tl, void* tape, void* meta, void* hist,
                     const void* order, void* queue, int b, int lq, int lmax,
                     int emax, int tape_w, void* stream) {
    if (b <= 0 || emax < 1 || lq < 1 || lmax < 1 || lmax > lq)
        return (int)cudaErrorInvalidValue;
    const int sms = sm_count();
    const int nw = warps_per_pair(b, sms);
    int per_sm = 0;
    const int err = blocks_per_sm(lmax, emax, nw, &per_sm);
    if (err != 0) return err;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const int grid = b < per_sm * sms ? b : per_sm * sms;
    align_wfa_kernel<<<grid, 32 * nw, smem_bytes(lmax, emax),
                       (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int*)ql,
        (const int*)tl, (int*)tape, (int*)meta, (int16_t*)hist,
        (const int*)order, (int*)queue, b, lq, lmax, emax, tape_w);
    return (int)cudaGetLastError();
}

// Loads the kernel on the current device.  CUDA loads a module at its
// first use, so a launch that came first would pay for the load inside
// its dispatch's event window; the wrapper calls this with the buffers,
// before the window.  Returns a CUDA error code (0 = ready).
int align_wfa_prepare() {
    cudaFuncAttributes a;
    return (int)cudaFuncGetAttributes(&a, align_wfa_kernel);
}

// Warps per pair the launch takes for a batch of b pairs.
int align_wfa_warps(int b) { return warps_per_pair(b, sm_count()); }

// Pairs resident at once on the current device at (lmax, emax) for a
// batch of b pairs: blocks per SM times SMs (0 if none fits).
int align_wfa_slots(int lmax, int emax, int b) {
    int per_sm = 0;
    if (blocks_per_sm(lmax, emax, warps_per_pair(b, sm_count()), &per_sm)
        != 0)
        return 0;
    return per_sm * sm_count();
}

// Dynamic shared memory of a block at (lmax, emax), in bytes.
int align_wfa_smem(int lmax, int emax) {
    return (int)smem_bytes(lmax, emax);
}

const char* align_wfa_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
