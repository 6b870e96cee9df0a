// One round of the lockstep POA engine on Hopper (sm_90a).
//
// Replaces racon_tpu/tpu/poa.py:_poa_kernel and _poa_kernel_banded, two
// XLA jax.jit kernels (lax.scan over graph ranks): a global NW of every
// lane's layer `seq` against its DAG (bases / preds / sinks in
// topological rank order, exported by native/poa_batch.cpp), then the
// traceback from the best sink into reversed node / seq tapes.  The
// function is the JAX kernels' exactly, float32 included (the wrapper's
// docstring, cuda/poa_lockstep.py, states it); the design is not their
// scan.
//
// What bounds it: a lane's ranks are a chain (rank r reads its preds'
// rows), so a launch lasts as long as its deepest lane's chain of
// ranks, each a few hundred dependent instructions; the cells' bytes
// and operations are far below the card's rates.  The design shortens
// the chain a rank and keeps several lanes' warps on every scheduler:
//
// * One block of W warps (2 or 4) per lane.  A thread owns CPT
//   contiguous columns (4 or 8) of a tile of 32 * CPT * W; the round's
//   columns choose both (choose_build: 4 columns a thread up to 512
//   columns, a lane's warps spread over the SM's schedulers).  A row
//   wider than one tile is walked tile by tile, the gap chain's running
//   max carried from one tile to the next, so no width is refused.  Two
//   block barriers a tile: the warps' gap-chain totals, then the row's
//   boundary columns.
// * Rows live in registers while a rank is computed; the newest S rows
//   (up to 16, as many as fit the block's shared memory) stay in a
//   shared-memory ring padded one word every CPT columns (a warp's
//   shifted reads fall in distinct banks).  A pred further back reads
//   the lane's device ring of 2k rows, which holds only the rows some
//   later rank reads from there (a bitset made from the preds before
//   the first rank).
// * Each rank's pred list is staged 32 ranks at a time, half a chunk
//   ahead into a second buffer: one thread a rank loads its preds,
//   band start and per-pred band shift (the integer divisions leave
//   the chain), and the rank loops over its real slots only, plus the
//   first pad slot (every pad reads as -inf, so only the first can be
//   the first match).
// * One pass over the preds: per column the first slot reaching the
//   diagonal max and the vertical max.  The row value h is at least
//   every candidate except where float32 rounding near -2^28 bites,
//   so when the diagonal max equals h its first slot is the first
//   diagonal equal to h, and likewise the vertical; a column where a
//   max lies above h (rounding) re-reads its preds (the slow path, out
//   of the unrolled columns).  Codes keep the JAX preference: the first
//   candidate equal to the row value among [diag(p) for p] + [vert(p)
//   for p] + [horiz], 0 when none is; a uint8 per cell in the tape
//   [B, V, cols].
// * Banded rows start at ((r * slen) // nrows - wb / 2) // q quanta (q =
//   wb / 4, floor division as in JAX), clamped to [0, smax_q]; a pred
//   whose band lags d quanta is read d*q columns over, and one lagging
//   5 or more reads as -inf.
// * Sink scores fold with a strict > in rank order, so the earliest rank
//   wins a tie.
// * Traceback: warp 0 walks the tape in step (each thread the same
//   path), from a block of 32 rows x 64 columns of codes and the rows'
//   preds staged in shared memory, restaged when the path leaves it;
//   lane 0 writes the reversed tapes, then the warp fills the rest with
//   PATH_DONE.
// * Numbers: float32 with -inf = -2^28, as in JAX.  Near -2^28 the
//   float32 spacing is 16-32, so -inf + gap rounds; every add here is an
//   explicit __fadd_rn / __fsub_rn in the JAX order (and j * gap is
//   exact), so the rounding is the same bit for bit.
// * With `meta`, a build that reads clock64() per phase writes per lane
//   (warp 0's clock): cycles of pred fetch (staging), candidate max,
//   gap-chain scan (with the row's shared and device stores), direction
//   codes (with the tape's store), sink fold, barrier waits and
//   traceback, then the pred rows read from the device ring and the
//   columns that took the slow path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNShift = 5;
constexpr float kNeg = -268435456.0f;        // -2^28
constexpr int kPathNone = -1;
constexpr int kPathDone = -3;
constexpr int kMaxP = 32;
constexpr int kMaxRing = 16;                  // shared rows at most
constexpr int kMaxWarps = 4;
constexpr int kChunk = 32;                    // ranks staged at a time
constexpr int kTbCols = 64;                   // traceback window columns
constexpr int kMeta = 9;
constexpr unsigned kFull = 0xffffffffu;
// meta's columns
constexpr int kPhFetch = 0, kPhCand = 1, kPhScan = 2, kPhCodes = 3,
              kPhSink = 4, kPhBarrier = 5, kPhTrace = 6, kCntFar = 7,
              kCntSlow = 8;
// how a staged pred slot reads: -inf, the virtual start row, the shared
// ring, the device ring
constexpr int kKindNeg = 0, kKindVirt = 1, kKindNear = 2, kKindFar = 3;

__host__ __device__ constexpr int log2_cpt(int cpt) {
    return cpt == 4 ? 2 : 3;
}

// ring row stride (floats) of a round: whole tiles, one pad word every
// CPT columns
__host__ __device__ inline int ring_stride(int cols, int cpt, int warps) {
    const int tw = kWarp * cpt * warps;
    return (cols + tw - 1) / tw * tw / cpt * (cpt + 1);
}

// the block's shared memory, in bytes from its start; the staged chunk
// arrays twice (the next chunk is staged while this one is read)
struct Smem {
    int ring, far, st_pid, st_aux, st_mask, st_s, tb_s, tb_lo, misc,
        tb_pred, st_base, st_sink, tb_code, seq, total;
    __host__ __device__ Smem(int v, int l, int p, int rs, int s,
                             bool seq_in) {
        int o = 0;
        ring = o;    o += 4 * s * rs;
        far = o;     o += 4 * ((v >> 5) + 2);
        st_pid = o;  o += 4 * 2 * kChunk * p;
        st_aux = o;  o += 4 * 2 * kChunk * p;
        st_mask = o; o += 4 * 2 * kChunk;
        st_s = o;    o += 4 * 2 * kChunk;
        tb_s = o;    o += 4 * kChunk;
        tb_lo = o;   o += 4 * kChunk;
        misc = o;    o += 4 * (2 * kMaxWarps + 4);
        tb_pred = o; o += 2 * kChunk * p;
        o = (o + 15) & ~15;
        st_base = o; o += 2 * kChunk;
        st_sink = o; o += 2 * kChunk;
        tb_code = o; o += kChunk * kTbCols;
        seq = o;     o += seq_in ? ((l + 15) & ~15) : 0;
        total = o;
    }
};

__device__ __forceinline__ int floordiv(int a, int b) {   // b > 0
    int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Band {
    int q, nr, sl, wb, smax_q;
    __device__ __forceinline__ int start_q(int r) const {
        // r * slen in 64 bits, as the plain version (the JAX kernels'
        // int32 product holds it for ranks below 2^15 and layers up to
        // 2^16, the int16 preds' reach)
        const int d = (int)((long long)r * sl / nr);
        return min(max(floordiv(d - wb / 2, q), 0), smax_q);
    }
};

// The CPT + 1 values P(x0 + i), i in [0, CPT], of one staged pred slot:
// the pred row realigned to this rank's columns (banded: read sh columns
// over in the pred's own band; -inf outside it).
template <int CPT, bool BANDED>
__device__ __forceinline__ void load_pred(
        float (&pv)[CPT + 1], int kind, int pid, int sh, int x0, int s_r,
        int cols, int rs, int s_rows, int ring_rows, const float* ring_s,
        const float* rg, float gap) {
    constexpr int LOG = log2_cpt(CPT);
    if (kind == kKindNeg) {
#pragma unroll
        for (int i = 0; i <= CPT; ++i) pv[i] = kNeg;
    } else if (kind == kKindVirt) {
#pragma unroll
        for (int i = 0; i <= CPT; ++i) {
            if (BANDED) {
                const int j = s_r + x0 + i;
                pv[i] = j >= 0 ? __fmul_rn((float)j, gap) : kNeg;
            } else {
                pv[i] = __fmul_rn((float)(x0 + i), gap);
            }
        }
    } else if (kind == kKindNear) {
        const float* row = ring_s + ((pid - 1) & (s_rows - 1)) * rs;
#pragma unroll
        for (int i = 0; i <= CPT; ++i) {
            const int idx = sh + x0 + i;
            pv[i] = (unsigned)idx < (unsigned)cols ? row[idx + (idx >> LOG)]
                                                   : kNeg;
        }
    } else {
        const float* row = rg + (size_t)((pid - 1) & (ring_rows - 1)) * cols;
#pragma unroll
        for (int i = 0; i <= CPT; ++i) {
            const int idx = sh + x0 + i;
            pv[i] = (unsigned)idx < (unsigned)cols ? row[idx] : kNeg;
        }
    }
}

// One value P(x) of a staged pred slot (the slow path's re-read).
template <int CPT, bool BANDED>
__device__ __forceinline__ float pred_at(
        int kind, int pid, int sh, int x, int s_r, int cols, int rs,
        int s_rows, int ring_rows, const float* ring_s, const float* rg,
        float gap) {
    constexpr int LOG = log2_cpt(CPT);
    if (kind == kKindNeg) return kNeg;
    if (kind == kKindVirt) {
        if (BANDED) {
            const int j = s_r + x;
            return j >= 0 ? __fmul_rn((float)j, gap) : kNeg;
        }
        return __fmul_rn((float)x, gap);
    }
    const int idx = sh + x;
    if ((unsigned)idx >= (unsigned)cols) return kNeg;
    if (kind == kKindNear)
        return ring_s[((pid - 1) & (s_rows - 1)) * rs + idx + (idx >> LOG)];
    return rg[(size_t)((pid - 1) & (ring_rows - 1)) * cols + idx];
}

template <int CPT, int W, bool BANDED, bool TIMED>
__global__ void __launch_bounds__(kWarp * W, 1)
poa_lockstep_kernel(const uint8_t* __restrict__ bases,
                    const int16_t* __restrict__ preds,
                    const int32_t* __restrict__ nrows,
                    const uint8_t* __restrict__ sinks,
                    const uint8_t* __restrict__ seq,
                    const int32_t* __restrict__ slen,
                    float* __restrict__ ring, uint8_t* __restrict__ dirs,
                    int32_t* __restrict__ node_tape,
                    int32_t* __restrict__ seq_tape,
                    long long* __restrict__ meta, int v, int l, int p,
                    int k, int wb, int s_rows, int seq_in, float match,
                    float mismatch, float gap) {
    constexpr int NT = kWarp * W;
    constexpr int TW = NT * CPT;
    constexpr int LOG = log2_cpt(CPT);
    extern __shared__ __align__(16) unsigned char smem[];
    const int cols = BANDED ? wb : l + 1;
    const int ntiles = (cols + TW - 1) / TW;
    const int rs = ring_stride(cols, CPT, W);
    const Smem lay(v, l, p, rs, s_rows, seq_in != 0);
    float* ring_s = reinterpret_cast<float*>(smem + lay.ring);
    uint32_t* far = reinterpret_cast<uint32_t*>(smem + lay.far);
    int* tb_s = reinterpret_cast<int*>(smem + lay.tb_s);
    int* tb_lo = reinterpret_cast<int*>(smem + lay.tb_lo);
    float* wtot = reinterpret_cast<float*>(smem + lay.misc);   // [W]
    float* lasth = wtot + kMaxWarps;                            // [W]
    float* s_best = lasth + kMaxWarps;
    int* s_best_row = reinterpret_cast<int*>(s_best + 1);
    int* s_slow = s_best_row + 1;
    int16_t* tb_pred = reinterpret_cast<int16_t*>(smem + lay.tb_pred);
    uint8_t* tb_code = smem + lay.tb_code;

    const int lane_id = blockIdx.x;
    const int t = threadIdx.x;
    const int wl = t & (kWarp - 1), warp = t / kWarp;
    const int sl = slen[lane_id];
    const int nrow = nrows[lane_id];
    const int rmax = min(nrow, v);
    const int ring_rows = 2 * k;
    const uint8_t* bs = bases + (size_t)lane_id * v;
    const int16_t* pr = preds + (size_t)lane_id * v * p;
    const uint8_t* sk = sinks + (size_t)lane_id * v;
    float* rg = ring + (size_t)lane_id * ring_rows * cols;
    uint8_t* dr = dirs + (size_t)lane_id * v * cols;
    const uint8_t* sq = seq + (size_t)lane_id * l;

    long long clk[kMeta];
#pragma unroll
    for (int i = 0; i < kMeta; ++i) clk[i] = 0;
    long long tc = TIMED ? clock64() : 0;
    auto lap = [&](int phase) {
        if (TIMED) {
            const long long now = clock64();
            clk[phase] += now - tc;
            tc = now;
        }
    };

    if (seq_in) {
        uint8_t* ss = smem + lay.seq;
        for (int i = t; i < l; i += NT) ss[i] = sq[i];
        sq = ss;
    }
    Band band;
    band.q = BANDED ? wb / 4 : 1;
    band.nr = max(nrow, 1);
    band.sl = sl;
    band.wb = wb;
    band.smax_q = BANDED ? floordiv(max(sl + 1 - wb, 0) + band.q - 1,
                                    band.q) : 0;

    // the rows some rank reads from the device ring (s_rows or more back)
    const int nfar = (v >> 5) + 2;
    for (int i = t; i < nfar; i += NT) far[i] = 0;
    if (t == 0) {
        *s_best = kNeg;
        *s_best_row = 0;
        *s_slow = 0;
    }
    __syncthreads();
    for (int rr = 1 + t; rr <= rmax; rr += NT) {
        const int16_t* row = pr + (size_t)(rr - 1) * p;
        for (int pp = 0; pp < p; ++pp) {
            const int pid = row[pp];
            if (pid > 0 && rr - pid >= s_rows)
                atomicOr(&far[pid >> 5], 1u << (pid & 31));
        }
    }
    const unsigned all_slots = p >= 32 ? kFull : (1u << p) - 1;
    // warp 0 stages ranks r0 .. r0 + 31 into buffer ((r0 - 1) / 32) & 1
    auto stage = [&](int r0) {
        const int buf = ((r0 - 1) / kChunk) & 1;
        int* st_pid = reinterpret_cast<int*>(smem + lay.st_pid)
            + buf * kChunk * p;
        int* st_aux = reinterpret_cast<int*>(smem + lay.st_aux)
            + buf * kChunk * p;
        const int rr = r0 + wl;
        if (rr <= rmax) {
            const int16_t* row = pr + (size_t)(rr - 1) * p;
            const int sq_r = BANDED ? band.start_q(rr) : 0;
            unsigned real = 0;
            for (int pp = 0; pp < p; ++pp) {
                const int pid = row[pp];
                int kind = kKindNeg, sh = 0;
                if (pid == 0) {
                    kind = kKindVirt;
                } else if (pid > 0) {
                    const int near = rr - pid < s_rows ? kKindNear
                                                       : kKindFar;
                    if (BANDED) {
                        const int dq = sq_r - band.start_q(pid);
                        sh = dq * band.q;
                        kind = (dq >= 0 && dq < kNShift) ? near : kKindNeg;
                    } else {
                        kind = near;
                    }
                }
                if (pid >= 0) real |= 1u << pp;
                st_pid[wl * p + pp] = pid;
                st_aux[wl * p + pp] = sh * 4 + kind;
            }
            const unsigned pad = ~real & all_slots;
            reinterpret_cast<uint32_t*>(smem + lay.st_mask)[
                buf * kChunk + wl] = real | (pad & (0u - pad));
            reinterpret_cast<int*>(smem + lay.st_s)[buf * kChunk + wl] =
                sq_r * band.q;
            smem[lay.st_base + buf * kChunk + wl] = bs[rr - 1];
            smem[lay.st_sink + buf * kChunk + wl] = sk[rr - 1];
        }
    };
    if (warp == 0) stage(1);
    __syncthreads();
    lap(kPhFetch);

    int slow_cols = 0;
    for (int r = 1; r <= rmax; ++r) {
        const int u = (r - 1) & (kChunk - 1);
        const int slot = ((r - 1) / kChunk & 1) * kChunk + u;
        if (u == kChunk / 2 && warp == 0) {
            // the next chunk, into the other buffer: every warp has left
            // the last chunk (a barrier a rank at least)
            stage(r - u + kChunk);
            lap(kPhFetch);
        }
        const int* rp = reinterpret_cast<const int*>(smem + lay.st_pid)
            + slot * p;
        const int* ra = reinterpret_cast<const int*>(smem + lay.st_aux)
            + slot * p;
        const unsigned mask =
            reinterpret_cast<const uint32_t*>(smem + lay.st_mask)[slot];
        const int s_r = reinterpret_cast<const int*>(smem + lay.st_s)[slot];
        const int base = smem[lay.st_base + slot];
        const bool wfar = (far[r >> 5] >> (r & 31)) & 1u;
        float* wrow_s = ring_s + (s_rows ? ((r - 1) & (s_rows - 1)) * rs : 0);
        float* wrow_g = rg + (size_t)((r - 1) & (ring_rows - 1)) * cols;
        uint8_t* drow = dr + (size_t)(r - 1) * cols;
        int c_sink = -1;
        if (smem[lay.st_sink + slot]) {
            if (BANDED) {
                const int c_end = sl - s_r;
                if (c_end < wb) c_sink = min(max(c_end, 0), wb - 1);
            } else {
                c_sink = sl;
            }
        }
        float carry = -INFINITY;     // the gap chain's max left of the tile
        float hleft = kNeg;          // h of the column left of the tile
        for (int tile = 0; tile < ntiles; ++tile) {
            const int c0 = tile * TW + t * CPT;
            float sub[CPT];
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                const int c = c0 + i;
                bool ok;
                if (BANDED) {
                    const int j = s_r + c - 1;
                    ok = j >= 0 && j < sl && sq[j] == base;
                } else {
                    ok = c >= 1 && c <= l && sq[c - 1] == base;
                }
                sub[i] = ok ? match : mismatch;
            }
            // pass over the real preds: each column's diagonal and
            // vertical max and the first slot reaching each
            float dmax[CPT], vmax[CPT];
            int dsl[CPT], vsl[CPT];
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                dmax[i] = -INFINITY;
                vmax[i] = -INFINITY;
                dsl[i] = 0;
                vsl[i] = 0;
            }
            for (unsigned m = mask; m; m &= m - 1) {
                const int pp = __ffs(m) - 1;
                const int aux = ra[pp];
                const int kind = aux & 3;
                if (TIMED && tile == 0 && kind == kKindFar) ++clk[kCntFar];
                float pv[CPT + 1];
                load_pred<CPT, BANDED>(pv, kind, rp[pp], aux >> 2, c0 - 1,
                                       s_r, cols, rs, s_rows, ring_rows,
                                       ring_s, rg, gap);
#pragma unroll
                for (int i = 0; i < CPT; ++i) {
                    float d = __fadd_rn(pv[i], sub[i]);
                    if (!BANDED && c0 + i == 0) d = kNeg;
                    const float vv = __fadd_rn(pv[i + 1], gap);
                    if (d > dmax[i]) {
                        dmax[i] = d;
                        dsl[i] = pp;
                    }
                    if (vv > vmax[i]) {
                        vmax[i] = vv;
                        vsl[i] = pp;
                    }
                }
            }
            lap(kPhCand);
            // gap chain: inclusive prefix max of T[c] - c gap over the row
            float h[CPT];
            float run = -INFINITY;
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                if (c0 + i < cols)
                    run = fmaxf(run, __fsub_rn(fmaxf(dmax[i], vmax[i]),
                                               __fmul_rn((float)(c0 + i),
                                                         gap)));
                h[i] = run;
            }
            float incl = run;
#pragma unroll
            for (int o = 1; o < kWarp; o <<= 1) {
                const float y = __shfl_up_sync(kFull, incl, o);
                if (wl >= o) incl = fmaxf(incl, y);
            }
            float excl = __shfl_up_sync(kFull, incl, 1);
            if (wl == 0) excl = -INFINITY;
            excl = fmaxf(excl, carry);
            if (wl == kWarp - 1) wtot[warp] = incl;
            lap(kPhScan);
            __syncthreads();
            lap(kPhBarrier);
#pragma unroll
            for (int w = 0; w < W; ++w) {
                const float tot = wtot[w];
                if (w < warp) excl = fmaxf(excl, tot);
                carry = fmaxf(carry, tot);
            }
#pragma unroll
            for (int i = 0; i < CPT; ++i)
                h[i] = __fadd_rn(fmaxf(excl, h[i]),
                                 __fmul_rn((float)(c0 + i), gap));
            float hl = __shfl_up_sync(kFull, h[CPT - 1], 1);
            // the row: shared ring, device ring (when read from there)
            if (s_rows) {
#pragma unroll
                for (int i = 0; i < CPT; ++i) {
                    const int c = c0 + i;
                    wrow_s[c + (c >> LOG)] = h[i];
                }
            }
            if (wfar) {
                if (cols % CPT == 0) {
                    if (c0 < cols) {
#pragma unroll
                        for (int i = 0; i < CPT; i += 4)
                            *reinterpret_cast<float4*>(wrow_g + c0 + i) =
                                make_float4(h[i], h[i + 1], h[i + 2],
                                            h[i + 3]);
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < CPT; ++i)
                        if (c0 + i < cols) wrow_g[c0 + i] = h[i];
                }
            }
            if (wl == kWarp - 1) lasth[warp] = h[CPT - 1];
            lap(kPhScan);
            // fold the sink's end score (rank order: earliest wins ties):
            // the column's owner alone, before the rank's last barrier
            if (c_sink >= c0 && c_sink < c0 + CPT) {
                float hv = kNeg;
#pragma unroll
                for (int i = 0; i < CPT; ++i)
                    if (c0 + i == c_sink) hv = h[i];
                if (hv > *s_best) {
                    *s_best = hv;
                    *s_best_row = r;
                }
            }
            lap(kPhSink);
            __syncthreads();
            lap(kPhBarrier);
            if (wl == 0) hl = warp == 0 ? hleft : lasth[warp - 1];
            hleft = lasth[W - 1];
            // direction codes against the final row value
            uint32_t packed[CPT / 4];
#pragma unroll
            for (int i = 0; i < CPT / 4; ++i) packed[i] = 0;
            unsigned slow = 0;
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                const float hh = h[i];
                const float hz = c0 + i == 0 ? kNeg
                    : __fadd_rn(i == 0 ? hl : h[i - 1], gap);
                int code = 0;
                if (dmax[i] == hh) code = dsl[i];
                else if (dmax[i] < hh && vmax[i] == hh) code = p + vsl[i];
                else if (dmax[i] < hh && vmax[i] < hh)
                    code = hz == hh ? 2 * p : 0;
                else slow |= 1u << i;
                packed[i / 4] |= (uint32_t)code << (8 * (i % 4));
            }
            if (slow) {
                // a max above h (float32 rounding near -2^28): the first
                // candidate equal to h, its preds re-read in slot order
                float hs[CPT], ss[CPT], zs[CPT];
                int cs[CPT];
#pragma unroll
                for (int i = 0; i < CPT; ++i) {
                    hs[i] = h[i];
                    ss[i] = sub[i];
                    zs[i] = c0 + i == 0 ? kNeg
                        : __fadd_rn(i == 0 ? hl : h[i - 1], gap);
                    cs[i] = 0;
                }
                for (unsigned sm = slow; sm; sm &= sm - 1) {
                    const int i = __ffs(sm) - 1;
                    const int c = c0 + i;
                    int code = -1;
                    for (unsigned m = mask; m && code < 0; m &= m - 1) {
                        const int pp = __ffs(m) - 1;
                        const int aux = ra[pp];
                        float d = __fadd_rn(pred_at<CPT, BANDED>(
                            aux & 3, rp[pp], aux >> 2, c - 1, s_r, cols, rs,
                            s_rows, ring_rows, ring_s, rg, gap), ss[i]);
                        if (!BANDED && c == 0) d = kNeg;
                        if (d == hs[i]) code = pp;
                    }
                    for (unsigned m = mask; m && code < 0; m &= m - 1) {
                        const int pp = __ffs(m) - 1;
                        const int aux = ra[pp];
                        const float vv = __fadd_rn(pred_at<CPT, BANDED>(
                            aux & 3, rp[pp], aux >> 2, c, s_r, cols, rs,
                            s_rows, ring_rows, ring_s, rg, gap), gap);
                        if (vv == hs[i]) code = p + pp;
                    }
                    if (code < 0) code = zs[i] == hs[i] ? 2 * p : 0;
                    cs[i] = code;
                    if (TIMED) ++slow_cols;
                }
#pragma unroll
                for (int i = 0; i < CPT; ++i)
                    packed[i / 4] |= (uint32_t)cs[i] << (8 * (i % 4));
            }
            // the codes to the tape
            if (cols % CPT == 0) {
                if (c0 < cols) {
                    if (CPT == 8) {
                        *reinterpret_cast<uint2*>(drow + c0) = make_uint2(
                            packed[0], packed[CPT / 4 > 1 ? 1 : 0]);
                    } else {
                        *reinterpret_cast<uint32_t*>(drow + c0) = packed[0];
                    }
                }
            } else {
#pragma unroll
                for (int i = 0; i < CPT; ++i)
                    if (c0 + i < cols)
                        drow[c0 + i] =
                            (uint8_t)(packed[i / 4] >> (8 * (i % 4)));
            }
            lap(kPhCodes);
        }
    }
    if (TIMED && slow_cols) atomicAdd(s_slow, slow_cols);
    __syncthreads();

    // traceback: warp 0 walks in step from a staged block of the tape
    if (warp != 0) return;
    const int tlen = v + l;
    int32_t* nt = node_tape + (size_t)lane_id * tlen;
    int32_t* stp = seq_tape + (size_t)lane_id * tlen;
    int top = -1;            // the staged block's top rank (none yet)
    auto restage = [&](int r0, int j0) {
        __syncwarp();                    // every thread read the old block
        const int rr = r0 - wl;
        if (rr >= 1) {
            const int s = BANDED ? band.start_q(rr) * band.q : 0;
            const int lo = min(max(j0 - s - (kTbCols - 16), 0), cols - 1)
                & ~15;
            tb_s[wl] = s;
            tb_lo[wl] = lo;
            const uint8_t* src = dr + (size_t)(rr - 1) * cols + lo;
            uint8_t* dst = tb_code + wl * kTbCols;
            if (cols % 16 == 0) {
#pragma unroll
                for (int i = 0; i < kTbCols; i += 16)
                    if (lo + i < cols)
                        *reinterpret_cast<uint4*>(dst + i) =
                            *reinterpret_cast<const uint4*>(src + i);
            } else {
                for (int i = 0; i < kTbCols && lo + i < cols; ++i)
                    dst[i] = src[i];
            }
            const int16_t* prow = pr + (size_t)(rr - 1) * p;
            for (int pp = 0; pp < p; ++pp) tb_pred[wl * p + pp] = prow[pp];
        }
        __syncwarp();
        top = r0;
    };
    int r = *s_best_row, j = sl, step = 0;
    for (; step < tlen; ++step) {
        if (r == 0 && j == 0) break;
        int code = 0, u = 0;
        const bool live = r > 0;
        if (live) {
            if (top < 0 || top - r < 0 || top - r >= kChunk) restage(r, j);
            u = top - r;
            const int c = BANDED ? min(max(j - tb_s[u], 0), wb - 1) : j;
            if (c < tb_lo[u] || c >= tb_lo[u] + kTbCols) {
                restage(r, j);
                u = 0;
            }
            code = tb_code[u * kTbCols + c - tb_lo[u]];
        }
        const bool is_diag = live && code < p;
        const bool is_vert = live && code >= p && code < 2 * p;
        if (wl == 0) {
            nt[step] = (is_diag || is_vert) ? r - 1 : kPathNone;
            stp[step] = is_vert ? kPathNone : j - 1;
        }
        if (is_diag || is_vert) {
            const int slot = min(max(is_diag ? code : code - p, 0), p - 1);
            r = tb_pred[u * p + slot];
        }
        if (!is_vert) j = max(j - 1, 0);
    }
    for (int i = step + wl; i < tlen; i += kWarp) {
        nt[i] = kPathDone;
        stp[i] = kPathDone;
    }
    lap(kPhTrace);
    if (TIMED && wl == 0) {
        clk[kCntSlow] = *s_slow;
#pragma unroll
        for (int i = 0; i < kMeta; ++i)
            meta[(size_t)lane_id * kMeta + i] = clk[i];
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// columns a thread and warps a lane of a round of ``cols`` columns
void choose_build(int cols, int* cpt, int* warps) {
    if (cols <= 8 * kWarp) {
        *cpt = 4;
        *warps = 2;
    } else if (cols <= 16 * kWarp) {
        *cpt = 4;
        *warps = 4;
    } else {
        *cpt = 8;
        *warps = 4;
    }
}

int smem_optin() {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&bytes,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev) != cudaSuccess)
        return 48 * 1024;
    return bytes;
}

// A round's plan: columns a thread, warps a lane, shared ring rows,
// whether the layer sits in shared memory, the block's shared bytes (0:
// does not fit).  Rounds of up to 512 columns keep a block under 64 KB
// (several lanes an SM); wider rounds may take the whole opt-in limit.
struct Plan {
    int cpt, warps, s_rows, seq_in;
    size_t smem;
};

Plan make_plan(int v, int l, int p, int cols, int limit) {
    Plan pl{4, 2, 0, 1, 0};
    choose_build(cols, &pl.cpt, &pl.warps);
    const int rs = ring_stride(cols, pl.cpt, pl.warps);
    if (Smem(v, l, p, rs, 0, true).total > limit) pl.seq_in = 0;
    const int target = cols <= 16 * kWarp ? min(64 * 1024, limit) : limit;
    for (int s = kMaxRing; s >= 2; s >>= 1) {
        if (Smem(v, l, p, rs, s, pl.seq_in).total <= target) {
            pl.s_rows = s;
            break;
        }
    }
    const int total = Smem(v, l, p, rs, pl.s_rows, pl.seq_in).total;
    pl.smem = total <= limit ? (size_t)total : 0;
    return pl;
}

struct Args {
    const uint8_t* bases;
    const int16_t* preds;
    const int32_t* nrows;
    const uint8_t* sinks;
    const uint8_t* seq;
    const int32_t* slen;
    float* ring;
    uint8_t* dirs;
    int32_t* nt;
    int32_t* st;
    long long* meta;
    int v, l, p, k, wb;
    float match, mismatch, gap;
};

template <int CPT, int W, bool BANDED, bool TIMED>
cudaError_t prepare_one(int limit) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(
        &attr, poa_lockstep_kernel<CPT, W, BANDED, TIMED>);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        poa_lockstep_kernel<CPT, W, BANDED, TIMED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
}

template <int CPT, int W, bool BANDED, bool TIMED>
cudaError_t launch_one(const Args& a, const Plan& pl, int b,
                       cudaStream_t s) {
    // poa_lockstep_prepare opted every instantiation in to the limit
    auto kern = poa_lockstep_kernel<CPT, W, BANDED, TIMED>;
    kern<<<b, kWarp * W, pl.smem, s>>>(
        a.bases, a.preds, a.nrows, a.sinks, a.seq, a.slen, a.ring, a.dirs,
        a.nt, a.st, a.meta, a.v, a.l, a.p, a.k, a.wb, pl.s_rows, pl.seq_in,
        a.match, a.mismatch, a.gap);
    return cudaGetLastError();
}

// one build (columns a thread, warps a lane): banded or not, timed or not
template <int CPT, int W>
struct Build {
    static cudaError_t prepare(int limit) {
        cudaError_t e;
        if ((e = prepare_one<CPT, W, false, false>(limit)) != cudaSuccess
            || (e = prepare_one<CPT, W, true, false>(limit)) != cudaSuccess
            || (e = prepare_one<CPT, W, false, true>(limit)) != cudaSuccess)
            return e;
        return prepare_one<CPT, W, true, true>(limit);
    }
    static cudaError_t launch(const Args& a, const Plan& pl, int b,
                              cudaStream_t s) {
        const bool banded = a.wb != 0, timed = a.meta != nullptr;
        if (banded)
            return timed ? launch_one<CPT, W, true, true>(a, pl, b, s)
                         : launch_one<CPT, W, true, false>(a, pl, b, s);
        return timed ? launch_one<CPT, W, false, true>(a, pl, b, s)
                     : launch_one<CPT, W, false, false>(a, pl, b, s);
    }
};

// every build the library holds
#define POA_LOCKSTEP_BUILDS(X) X(4, 2) X(4, 4) X(8, 4)

}  // namespace

extern "C" {

// Load every build of the kernel on the current device and let each
// take the whole opt-in shared memory (CUDA loads a module at first
// use: a caller that prepares before its timer's first mark keeps the
// load out of its event window).  Returns a cudaError_t (0 = loaded).
int poa_lockstep_prepare() {
    const int limit = smem_optin();
    cudaError_t e = cudaSuccess;
#define X(C, W) if (e == cudaSuccess) e = Build<C, W>::prepare(limit);
    POA_LOCKSTEP_BUILDS(X)
#undef X
    return (int)e;
}

// The plan of a round on the current device: out[0] columns a thread,
// out[1] warps a lane, out[2] shared ring rows, out[3] 1 when the layer
// sits in shared memory, out[4] the block's shared bytes (0: the round
// does not fit).
void poa_lockstep_plan(int v, int l, int p, int wb, int* out) {
    const Plan pl = make_plan(v, l, p, wb ? wb : l + 1, smem_optin());
    out[0] = pl.cpt;
    out[1] = pl.warps;
    out[2] = pl.s_rows;
    out[3] = pl.seq_in;
    out[4] = (int)pl.smem;
}

// One round on ``stream``: inputs as cuda/poa_lockstep.py states them;
// ``ring`` is float32 scratch [b, 2k, cols] and ``dirs`` uint8 scratch
// [b, v, cols] (cols = wb, or l + 1 when wb == 0); ``node_tape`` /
// ``seq_tape`` int32 [b, v + l]; ``meta`` null, or int64 [b, 9] for the
// build that counts its phases' cycles.  Returns cudaGetLastError()
// after the launch (0 = launched); a shape the kernel does not take is
// refused.
int poa_lockstep_launch(const void* bases, const void* preds,
                        const void* nrows, const void* sinks,
                        const void* seq, const void* slen, void* ring,
                        void* dirs, void* node_tape, void* seq_tape,
                        void* meta, int b, int v, int l, int p, int k,
                        int wb, int match, int mismatch, int gap,
                        void* stream) {
    if (b <= 0 || v < 1 || l < 1 || p < 1 || p > kMaxP || k < 1
        || (k & (k - 1)) || (wb && (wb % 4 || wb < 4)) || 2 * p + 1 > 255)
        return (int)cudaErrorInvalidValue;
    const Plan pl = make_plan(v, l, p, wb ? wb : l + 1, smem_optin());
    if (pl.smem == 0) return (int)cudaErrorInvalidValue;
    const Args a{(const uint8_t*)bases, (const int16_t*)preds,
                 (const int32_t*)nrows, (const uint8_t*)sinks,
                 (const uint8_t*)seq, (const int32_t*)slen, (float*)ring,
                 (uint8_t*)dirs, (int32_t*)node_tape, (int32_t*)seq_tape,
                 (long long*)meta, v, l, p, k, wb, (float)match,
                 (float)mismatch, (float)gap};
    auto s = (cudaStream_t)stream;
#define X(C, W)                                                         \
    if (pl.cpt == C && pl.warps == W)                                   \
        return (int)Build<C, W>::launch(a, pl, b, s);
    POA_LOCKSTEP_BUILDS(X)
#undef X
    return (int)cudaErrorInvalidValue;
}

const char* poa_lockstep_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
