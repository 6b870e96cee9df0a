// Unit-cost global alignment by wavefronts (WFA) on Hopper (sm_90a).
//
// Replaces racon_tpu/tpu/align_pallas.py:_wfa_kernel together with its
// match-word pre-pass _wfa_match_words.  One thread block aligns one
// pair: wavefront e covers the diagonals d = j - i in [-e, e], each
// thread takes a stride of them, and every step applies the native
// engine's candidates (deletion keeps i from d - 1, substitution and
// insertion advance i from d and d + 1, each with its boundary test)
// before sliding the furthest-reaching point along exact matches.  The
// pair stops at the first e whose final diagonal reaches ql, or is
// rejected past emax.  Thread 0 then walks the history back with the
// engine's preference (insertion > substitution > deletion) and writes
// the (slide, op) tape, which equals the Pallas kernel's.
//
// What bounds it: the wavefront steps form a serial chain, one block
// barrier each, and a step's work is a few compares per diagonal, so
// the kernel is bound by latency, not by bytes or operations.  The
// answer is one block per pair (a chunk of hundreds of pairs keeps
// every SM busy with independent chains) and a cheap step.  The match
// words of the Pallas version (an O(wd x lq) pre-pass through device
// memory, 8.8 MB per pair at emax 2048 and lq 16384) are gone: q and t
// sit in shared memory as 4-bit codes, eight bases per word, and a
// slide compares eight bases at a time with one XOR (__funnelshift_r
// for unaligned starts, __ffs for the first mismatch).  Positions at or
// past ql / tl hold the pads 5 / 6, which match nothing, so a slide
// stops at a sequence end with no bounds test, and code 4 (any non-ACGT
// byte) matches code 4 as in the Pallas version.  The two wavefront
// buffers live in shared memory as well; the history, which the
// traceback needs, goes to a device-memory scratch and keeps only the
// live diagonals of each step: (emax + 1)^2 int32 per pair, 16.8 MB at
// emax 2048 (the full-width rows of the Pallas version take 34.6 MB).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kNeg = -(1 << 20);     // inactive diagonal
constexpr int kNegH = -(1 << 19);    // activity threshold
constexpr int kQPad = 5, kTPad = 6;
constexpr int kSub = 1, kIns = 2, kDel = 3;

// eight 4-bit codes starting at position p (position p in bits 0..3)
__device__ __forceinline__ uint32_t nib8(const uint32_t* w, int p) {
    const int k = p >> 3;
    return __funnelshift_r(w[k], w[k + 1], (p & 7) * 4);
}

// furthest point of diagonal (i, j) along exact matches; the pads make
// every position at or past a sequence end a mismatch
__device__ int slide(const uint32_t* qn, const uint32_t* tn, int i, int j) {
    while (true) {
        const uint32_t x = nib8(qn, i) ^ nib8(tn, j);
        if (x) return i + ((__ffs(x) - 1) >> 2);
        i += 8;
        j += 8;
    }
}

// one row of codes as 4-bit words; positions >= len (or >= the stored
// width) hold the pad
__device__ void pack_codes(uint32_t* out, int nwords, const uint8_t* src,
                           int len, int width, int pad) {
    const int lim = min(len, width);
    for (int k = threadIdx.x; k < nwords; k += blockDim.x) {
        uint32_t w = 0;
        for (int m = 0; m < 8; ++m) {
            const int p = 8 * k + m;
            const uint32_t c = p < lim ? src[p] : pad;
            w |= (c & 15u) << (4 * m);
        }
        out[k] = w;
    }
}

__global__ void align_wfa_kernel(const uint8_t* __restrict__ q,
                                 const uint8_t* __restrict__ t,
                                 const int* __restrict__ qlen,
                                 const int* __restrict__ tlen,
                                 int* __restrict__ tape,
                                 int* __restrict__ meta,
                                 int* __restrict__ hist_all, int lq,
                                 int emax, int tape_w) {
    extern __shared__ int smem[];
    // first step whose final diagonal reached ql (INT_MAX: none yet);
    // only the owner of that diagonal writes it, and a thread reads it
    // right after a step's barrier as "done at a step <= e", so a
    // faster thread's write during step e + 1 is never mistaken
    __shared__ int s_done;
    const int b = blockIdx.x;
    // lengths past the stored width are cut to it (the rows hold no
    // more); the wrapper's inputs never exceed it
    const int ql = min(qlen[b], lq), tl = min(tlen[b], lq);
    int* mo = meta + 8LL * b;
    if (!(ql > 0 && tl > 0 && abs(tl - ql) <= emax)) {
        if (threadIdx.x == 0) { mo[0] = kBig; mo[1] = 0; }
        return;
    }
    const int nib = (lq + 16) / 8 + 2;
    uint32_t* qn = reinterpret_cast<uint32_t*>(smem);
    uint32_t* tn = qn + nib;
    const int span = 2 * emax + 5;            // d in [-emax-2, emax+2]
    int* fa = reinterpret_cast<int*>(tn + nib) + emax + 2;
    int* fb = fa + span;
    int* hist = hist_all + (long long)b * (emax + 1) * (emax + 1);

    pack_codes(qn, nib, q + (long long)b * lq, ql, lq, kQPad);
    pack_codes(tn, nib, t + (long long)b * lq, tl, lq, kTPad);
    for (int k = threadIdx.x; k < span; k += blockDim.x) {
        fa[k - emax - 2] = kNeg;
        fb[k - emax - 2] = kNeg;
    }
    if (threadIdx.x == 0) s_done = INT_MAX;
    __syncthreads();

    const int fin = tl - ql;
    if (threadIdx.x == 0) {
        const int f0 = slide(qn, tn, 0, 0);
        fa[0] = f0;
        hist[0] = f0;
        if (fin == 0 && f0 >= ql) s_done = 0;
    }
    __syncthreads();
    int dist = s_done <= 0 ? 0 : kBig;
    int* prev = fa;
    int* cur = fb;
    for (int e = 1; e <= emax && dist == kBig; ++e) {
        int* hrow = hist + (long long)e * e + e;     // row e, indexed by d
        for (int d = -e + (int)threadIdx.x; d <= e; d += blockDim.x) {
            const int nl = prev[d - 1], v0 = prev[d], nr = prev[d + 1];
            const int vdel = (nl > kNegH && nl + d <= tl) ? nl : kNeg;
            const int vsub = (v0 > kNegH && v0 + 1 <= ql && v0 + 1 + d <= tl)
                                 ? v0 + 1 : kNeg;
            const int vins = (nr > kNegH && nr + 1 <= ql) ? nr + 1 : kNeg;
            int f = max(max(vdel, vsub), vins);
            if (f > kNegH && f < ql) f = slide(qn, tn, f, f + d);
            cur[d] = f;
            hrow[d] = f;
            if (d == fin && f >= ql) s_done = e;
        }
        __syncthreads();
        if (s_done <= e) dist = e;
        int* tmp = prev; prev = cur; cur = tmp;
    }
    if (threadIdx.x != 0) return;
    if (dist == kBig) { mo[0] = kBig; mo[1] = 0; return; }

    // traceback: from (dist, fin) down to e = 0
    int* out = tape + (long long)b * tape_w;
    int i = ql, d = fin, n = 0;
    for (int e = dist; e > 0; --e) {
        const int r = e - 1;
        const int* hr = hist + (long long)r * r + r;
        const int vm1 = (d - 1 >= -r && d - 1 <= r) ? hr[d - 1] : kNeg;
        const int v0 = (d >= -r && d <= r) ? hr[d] : kNeg;
        const int vp1 = (d + 1 >= -r && d + 1 <= r) ? hr[d + 1] : kNeg;
        const int del_c = (vm1 > kNegH && vm1 + d <= tl) ? vm1 : kNeg;
        const int sub_c = (v0 > kNegH && v0 + 1 <= ql && v0 + 1 + d <= tl)
                              ? v0 + 1 : kNeg;
        const int ins_c = (vp1 > kNegH && vp1 + 1 <= ql) ? vp1 + 1 : kNeg;
        const int i0 = max(max(del_c, sub_c), ins_c);
        const bool is_ins = ins_c > kNegH && ins_c == i0;
        const bool is_sub = !is_ins && sub_c > kNegH && sub_c == i0;
        out[n++] = (i - i0) * 4 + (is_ins ? kIns : is_sub ? kSub : kDel);
        i = (is_ins || is_sub) ? i0 - 1 : i0;
        d = is_ins ? d + 1 : is_sub ? d : d - 1;
    }
    out[n++] = i * 4;
    mo[0] = dist;
    mo[1] = n;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// Launches one block per pair on ``stream``; returns cudaGetLastError()
// after the launch (0 = launched).  ``smem`` is the dynamic shared
// memory the wrapper computed (align_wfa.smem_bytes).
int align_wfa_launch(const void* q, const void* t, const void* ql,
                     const void* tl, void* tape, void* meta, void* hist,
                     int b, int lq, int emax, int tape_w, int smem,
                     void* stream) {
    if (b <= 0 || emax < 1 || lq < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        align_wfa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    align_wfa_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int*)ql,
        (const int*)tl, (int*)tape, (int*)meta, (int*)hist, lq, emax,
        tape_w);
    return (int)cudaGetLastError();
}

const char* align_wfa_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
