// One round of the lockstep POA engine on Hopper (sm_90a).
//
// Replaces racon_tpu/tpu/poa.py:_poa_kernel and _poa_kernel_banded, two
// XLA jax.jit kernels (lax.scan over graph ranks): a global NW of every
// lane's layer `seq` against its DAG (bases / preds / sinks in
// topological rank order, exported by native/poa_batch.cpp), then the
// traceback from the best sink into reversed node / seq tapes.  The
// function is the JAX kernels' exactly, float32 included (the wrapper's
// docstring, cuda/poa_lockstep.py, states it); the design is not their
// scan:
//
// * One block per lane.  Rank r needs its preds' rows, so the ranks run
//   in order inside the block; its 256 threads own the row's columns,
//   CPT contiguous columns each, 2-16 (a band of wb columns, or the
//   whole row of l + 1 when unbanded).  A lane stops at its own nrows:
//   no traceback reads a row past it (the JAX scan runs every lane to
//   the bucket's V).
// * Each rank row: the <= P pred rows come from a per-lane ring in device
//   memory (L2-resident; 2k rows, so a pred row k back is never the slot
//   the rank writes), the diagonal and vertical candidates' max, then
//   the in-row gap chain H[j] = max_{c<=j} T[c] + (j - c) gap closed by a
//   block-wide prefix max of T[c] - c gap (per-thread scan, warp
//   shuffles, one shared-memory pass over the warp totals).
// * Direction codes keep the JAX preference: the first candidate equal
//   to the row value among [diag(p) for p] + [vert(p) for p] + [horiz],
//   0 when none is (argmax of an all-false vector); a uint8 per cell in
//   the tape [B, V, cols] in device memory.
// * Banded rows start at ((r * slen) // nrows - wb / 2) // q quanta (q =
//   wb / 4, floor division as in JAX; C's / truncates, so floordiv()),
//   clamped to [0, smax_q]; a pred whose band lags d quanta is read d*q
//   columns over, and one lagging 5 or more reads as -inf.
// * Sink scores fold with a strict > in rank order, so the earliest rank
//   wins a tie.
// * Traceback: thread 0 walks at most V + L steps over the tape and the
//   preds, writing the reversed tapes; the block then fills the rest
//   with PATH_DONE.
// * Numbers: float32 with -inf = -2^28, as in JAX.  Near -2^28 the
//   float32 spacing is 16-32, so -inf + gap rounds; every add here is an
//   explicit __fadd_rn / __fsub_rn in the JAX order (and j * gap is
//   exact), so the rounding is the same bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNShift = 5;
constexpr float kNeg = -268435456.0f;        // -2^28
constexpr int kPathNone = -1;
constexpr int kPathDone = -3;
constexpr int kMaxP = 32;

__device__ __forceinline__ int floordiv(int a, int b) {   // b > 0
    int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Band {
    int q, nr, sl, wb, smax_q;
    __device__ __forceinline__ int start_q(int r) const {
        int c = floordiv(floordiv(r * sl, nr) - wb / 2, q);
        return min(max(c, 0), smax_q);
    }
};

// One rank's view of its pred rows.  pred(pid, sh, x): the value at index
// x of pred row pid (0 = the virtual start row, < 0 = pad): unbanded, x is
// the column; banded, x indexes this rank's band extended by one column
// on the left (column x - 1), read sh columns over in the pred's own band
// (sh < 0: the pred lags 5 quanta or more and reads as -inf).
template <bool BANDED>
struct Row {
    const float* rg;
    int ring_rows, cols, wb, s_r, sq_r;
    float gap;
    Band band;

    __device__ __forceinline__ float pred(int pid, int sh, int x) const {
        if (pid > 0) {
            const float* prow = rg + (size_t)((pid - 1) & (ring_rows - 1))
                                         * cols;
            if (BANDED) {
                const int idx = sh + x - 1;
                return (sh < 0 || idx < 0 || idx >= wb) ? kNeg : prow[idx];
            }
            return prow[x];
        }
        if (pid == 0) {
            if (BANDED) {
                const int j = s_r + x - 1;
                return j >= 0 ? __fmul_rn((float)j, gap) : kNeg;
            }
            return __fmul_rn((float)x, gap);
        }
        return kNeg;
    }
    __device__ __forceinline__ int shift(int pid) const {
        if (!BANDED || pid <= 0) return 0;
        const int dq = sq_r - band.start_q(pid);
        return (dq >= 0 && dq < kNShift) ? dq * band.q : -1;
    }
    // the diagonal and vertical candidates of column c
    __device__ __forceinline__ float diag(int pid, int sh, int c,
                                          float sb) const {
        if (BANDED) return __fadd_rn(pred(pid, sh, c), sb);
        return c == 0 ? kNeg : __fadd_rn(pred(pid, sh, c - 1), sb);
    }
    __device__ __forceinline__ float vert(int pid, int sh, int c) const {
        return __fadd_rn(pred(pid, sh, BANDED ? c + 1 : c), gap);
    }
};

template <int CPT, bool BANDED>
__global__ void __launch_bounds__(kThreads)
poa_lockstep_kernel(const uint8_t* __restrict__ bases,
                    const int16_t* __restrict__ preds,
                    const int32_t* __restrict__ nrows,
                    const uint8_t* __restrict__ sinks,
                    const uint8_t* __restrict__ seq,
                    const int32_t* __restrict__ slen,
                    float* __restrict__ ring, uint8_t* __restrict__ dirs,
                    int32_t* __restrict__ node_tape,
                    int32_t* __restrict__ seq_tape, int v, int l, int p,
                    int k, int wb, float match, float mismatch, float gap) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int cols = BANDED ? wb : l + 1;
    float* hr_s = reinterpret_cast<float*>(smem);            // [cols]
    float* wtot = hr_s + cols;                               // [kWarps]
    int* misc = reinterpret_cast<int*>(wtot + kWarps);       // [4]
    uint8_t* seq_s = reinterpret_cast<uint8_t*>(misc + 4);   // [l]

    const int lane_id = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, wl = tid & 31;
    const int sl = slen[lane_id];
    const int nrow = nrows[lane_id];
    const int rmax = min(nrow, v);
    const int ring_rows = 2 * k;
    const uint8_t* bs = bases + (size_t)lane_id * v;
    const int16_t* pr = preds + (size_t)lane_id * v * p;
    const uint8_t* sk = sinks + (size_t)lane_id * v;
    float* rg = ring + (size_t)lane_id * ring_rows * cols;
    uint8_t* dr = dirs + (size_t)lane_id * v * cols;

    for (int i = tid; i < l; i += kThreads)
        seq_s[i] = seq[(size_t)lane_id * l + i];
    float* best_score = reinterpret_cast<float*>(misc);
    if (tid == 0) {
        *best_score = kNeg;
        misc[1] = 0;                                         // best row
    }

    Band band;
    band.q = BANDED ? wb / 4 : 1;
    band.nr = max(nrow, 1);
    band.sl = sl;
    band.wb = wb;
    band.smax_q = BANDED ? floordiv(max(sl + 1 - wb, 0) + band.q - 1,
                                    band.q) : 0;
    const int c0 = tid * CPT;
    float cg[CPT];                                           // c * gap
#pragma unroll
    for (int i = 0; i < CPT; ++i) cg[i] = __fmul_rn((float)(c0 + i), gap);
    __syncthreads();

    for (int r = 1; r <= rmax; ++r) {
        const int base = bs[r - 1];
        const int16_t* prow = pr + (size_t)(r - 1) * p;
        const int sq_r = BANDED ? band.start_q(r) : 0;
        const int s_r = sq_r * band.q;
        // the layer base each column's diagonal compares
        float sub[CPT];
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
            const int c = c0 + i;
            if (BANDED) {
                const int j = s_r + c - 1;
                sub[i] = (j >= 0 && j < sl && seq_s[j] == base) ? match
                                                                : mismatch;
            } else {
                sub[i] = (c >= 1 && c <= l && seq_s[c - 1] == base)
                             ? match : mismatch;
            }
        }
        const Row<BANDED> row{rg, ring_rows, cols, wb, s_r, sq_r, gap, band};
        // pass 1: T[c] = max over preds of the diagonal and vertical
        float t[CPT];
#pragma unroll
        for (int i = 0; i < CPT; ++i) t[i] = -INFINITY;
        for (int pp = 0; pp < p; ++pp) {
            const int pid = prow[pp];
            const int sh = row.shift(pid);
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                const int c = c0 + i;
                if (c < cols)
                    t[i] = fmaxf(t[i], fmaxf(row.diag(pid, sh, c, sub[i]),
                                             row.vert(pid, sh, c)));
            }
        }
        // gap chain: inclusive prefix max of T[c] - c gap over the row
        float run = -INFINITY;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
            if (c0 + i < cols) run = fmaxf(run, __fsub_rn(t[i], cg[i]));
            t[i] = run;                          // local inclusive scan
        }
        float incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float y = __shfl_up_sync(0xffffffffu, incl, o);
            if (wl >= o) incl = fmaxf(incl, y);
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (wl == 0) excl = -INFINITY;
        if (wl == 31) wtot[warp] = incl;
        __syncthreads();
        for (int w = 0; w < warp; ++w) excl = fmaxf(excl, wtot[w]);
        float hr[CPT];
        float* rrow = rg + (size_t)((r - 1) & (ring_rows - 1)) * cols;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
            const int c = c0 + i;
            hr[i] = __fadd_rn(fmaxf(excl, t[i]), cg[i]);
            if (c < cols) {
                hr_s[c] = hr[i];
                rrow[c] = hr[i];
            }
        }
        __syncthreads();

        // pass 2: direction codes against the final row value
        uint8_t* drow = dr + (size_t)(r - 1) * cols;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
            const int c = c0 + i;
            if (c >= cols) continue;
            const float h = hr[i];
            int code = -1;
            for (int pp = 0; pp < p && code < 0; ++pp) {
                const int pid = prow[pp];
                if (row.diag(pid, row.shift(pid), c, sub[i]) == h) code = pp;
            }
            for (int pp = 0; pp < p && code < 0; ++pp) {
                const int pid = prow[pp];
                if (row.vert(pid, row.shift(pid), c) == h) code = p + pp;
            }
            if (code < 0) {
                const float hz = c == 0 ? kNeg : __fadd_rn(hr_s[c - 1], gap);
                code = hz == h ? 2 * p : 0;
            }
            drow[c] = (uint8_t)code;
        }
        // fold the sink's end score (rank order: earliest wins ties)
        if (sk[r - 1] > 0) {
            const int c_end = BANDED ? sl - s_r : sl;
            const int cc = BANDED ? min(max(c_end, 0), wb - 1) : c_end;
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                // a constant index keeps hr in registers
                if (cc == c0 + i && (!BANDED || c_end < wb)
                    && hr[i] > *best_score) {
                    *best_score = hr[i];
                    misc[1] = r;
                }
            }
        }
        __syncthreads();
    }

    // traceback: one thread walks the tape
    const int tlen = v + l;
    int32_t* nt = node_tape + (size_t)lane_id * tlen;
    int32_t* st = seq_tape + (size_t)lane_id * tlen;
    if (tid == 0) {
        int r = misc[1], j = sl, t = 0;
        for (; t < tlen; ++t) {
            if (r == 0 && j == 0) break;
            int code = 0;
            const bool live = r > 0;
            if (live) {
                const int c = BANDED
                    ? min(max(j - band.start_q(r) * band.q, 0), wb - 1) : j;
                code = dr[(size_t)(r - 1) * cols + c];
            }
            const bool is_diag = live && code < p;
            const bool is_vert = live && code >= p && code < 2 * p;
            int slot = is_diag ? code : code - p;
            slot = min(max(slot, 0), p - 1);
            const int pred_r = pr[(size_t)max(r - 1, 0) * p + slot];
            nt[t] = (is_diag || is_vert) ? r - 1 : kPathNone;
            st[t] = is_vert ? kPathNone : j - 1;
            if (is_diag || is_vert) r = pred_r;
            if (!is_vert) j = max(j - 1, 0);
        }
        misc[2] = t;
    }
    __syncthreads();
    for (int t = misc[2] + tid; t < tlen; t += kThreads) {
        nt[t] = kPathDone;
        st[t] = kPathDone;
    }
}

size_t smem_bytes(int l, int cols) {
    return (size_t)4 * (cols + kWarps + 4) + (size_t)((l + 15) & ~15);
}

template <int CPT>
cudaError_t launch_cpt(bool banded, int b, size_t smem, cudaStream_t s,
                       const uint8_t* bases, const int16_t* preds,
                       const int32_t* nrows, const uint8_t* sinks,
                       const uint8_t* seq, const int32_t* slen, float* ring,
                       uint8_t* dirs, int32_t* nt, int32_t* st, int v,
                       int l, int p, int k, int wb, float match,
                       float mismatch, float gap) {
    auto kern = banded ? poa_lockstep_kernel<CPT, true>
                       : poa_lockstep_kernel<CPT, false>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kern<<<b, kThreads, smem, s>>>(bases, preds, nrows, sinks, seq, slen,
                                   ring, dirs, nt, st, v, l, p, k, wb,
                                   match, mismatch, gap);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// One round on ``stream``: inputs as cuda/poa_lockstep.py states them;
// ``ring`` is float32 scratch [b, 2k, cols] and ``dirs`` uint8 scratch
// [b, v, cols] (cols = wb, or l + 1 when wb == 0); ``node_tape`` /
// ``seq_tape`` int32 [b, v + l].  Returns cudaGetLastError() after the
// launch (0 = launched); a shape the kernel does not take is refused.
int poa_lockstep_launch(const void* bases, const void* preds,
                        const void* nrows, const void* sinks,
                        const void* seq, const void* slen, void* ring,
                        void* dirs, void* node_tape, void* seq_tape, int b,
                        int v, int l, int p, int k, int wb, int match,
                        int mismatch, int gap, void* stream) {
    const int cols = wb ? wb : l + 1;
    if (b <= 0 || v < 1 || l < 1 || p < 1 || p > kMaxP || k < 1
        || (k & (k - 1)) || (wb && (wb % 4 || wb < 4))
        || cols > 16 * kThreads || 2 * p + 1 > 255)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(l, cols);
    const bool banded = wb != 0;
    auto s = (cudaStream_t)stream;
    auto args = [&](auto launch) {
        return launch(banded, b, smem, s, (const uint8_t*)bases,
                      (const int16_t*)preds, (const int32_t*)nrows,
                      (const uint8_t*)sinks, (const uint8_t*)seq,
                      (const int32_t*)slen, (float*)ring, (uint8_t*)dirs,
                      (int32_t*)node_tape, (int32_t*)seq_tape, v, l, p, k,
                      wb, (float)match, (float)mismatch, (float)gap);
    };
    // two columns a thread at least: ptxas held the one-column variant
    // to 32 registers and spilled
    cudaError_t e;
    if (cols <= 2 * kThreads) e = args(launch_cpt<2>);
    else if (cols <= 4 * kThreads) e = args(launch_cpt<4>);
    else if (cols <= 8 * kThreads) e = args(launch_cpt<8>);
    else e = args(launch_cpt<16>);
    return (int)e;
}

const char* poa_lockstep_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
