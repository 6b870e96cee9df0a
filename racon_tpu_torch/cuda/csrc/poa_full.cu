// Whole-window partial-order-alignment consensus on Hopper (sm_90a).
//
// Replaces racon_tpu/tpu/poa_pallas.py:_kernel.  One warp runs the
// entire POA of one window: the graph seeded from the backbone, then
// per layer a banded graph-vs-sequence DP over the topological list,
// traceback and merge, and finally the heaviest-bundle consensus and
// the TGS trim.  The results (consensus characters, mout[0:5]: length,
// status, fail code, nodes used, DP rank steps) equal the Pallas
// kernel's, tie rules included; mout[5:8] hold the window's clock64()
// cycles in the DP walk, in traceback + merge, and in the rest (seed,
// staging, consensus, output).
//
// What bounds it: the DP is a serial chain of ranks (one graph node
// after another), each rank's row depending on its predecessors' rows,
// and the traceback and merge are serial walks over the graph, so the
// kernel is bound by the latency of those chains, not by bytes or
// operations.  The design shortens the chains and keeps more of them in
// flight:
//
// * The window graph lives in shared memory, as the Pallas kernel kept
//   it in SMEM: per-node scalars as u8/u16 arrays (base, pcnt, scnt,
//   gcnt, bq; nseq, anch, minsucc, nxt, glast, visit), the first kPM
//   predecessor ids per node as u16, the staged layer's characters and
//   weights as bytes, and a ring of the kR most recently written DP
//   rows.  The ring region doubles as the path tape and, at the end,
//   as the consensus scores; the consensus keeps its other per-node
//   values in arrays the merge leaves dead.
// * Two passes.  The first sizes that graph for vs = 21/32 of the node
//   cap (1,344 of 2,048 nodes: 44 KB of dynamic shared memory, five
//   blocks per SM); a window whose graph outgrows it hands itself to
//   the second pass through a device-side queue, and the second pass
//   runs those windows with the whole cap (64 KB, three per SM).  Both
//   compute the same function; the second only has room for more nodes.
// * Device memory (a scratch slice per resident block, not per window)
//   holds what only the DP's rare paths, the traceback, the merge and
//   the consensus read: every DP row by rank (packed score << 6 | code,
//   written each rank, read on a ring miss and by the traceback), pred
//   slots kPM.., the pred weights and the aligned-sibling rows.
// * One warp per window, CPL = WB / 32 band columns per lane: each lane
//   closes the in-row gap chain H[j] = max(M[j], H[j-1] + gap) over its
//   own columns, then a 5-step shuffle scan joins the lanes; the
//   diagonal neighbour comes through a shuffle.  No block barrier: one
//   __syncwarp per rank publishes the row.
// * The traceback runs on every lane (lane 0 writes the tape) so that
//   the other lanes can ask L1 for the rows the path will read next.
// * Persistent blocks: each pass's grid is the card's resident slots
//   (SMs x blocks per SM) and each block pulls the next window index
//   from a device counter, so deep windows (the caller sorts them first)
//   do not leave the tail of the launch to a few blocks.
//
// Scores are exact int32; stored rows pack score << 6 | code with the
// score clipped to +-2^24, and -2^28 stands for -inf.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 128;            // band-start quantum
constexpr int kNShift = 4;         // a pred band may lag <= 3 quanta
constexpr int kNeg = -(1 << 28);
constexpr int kClip = 1 << 24;
constexpr int kSinkFloor = -(1 << 22);
constexpr int kInf16 = 0xFFFF;     // "no successor" anchor sentinel
constexpr int kFullSpanEnd = 0xFFFE;
constexpr int kPM = 4;             // pred ids per node mirrored in smem
                                   // (one 8-byte load)
constexpr int kR = 8;              // DP rows in the shared-memory ring
constexpr int kMaxP = 16;          // pred slots (consensus masks are u16)
constexpr uint16_t kNone = 0xFFFF; // u16 "no node" / "not visited"
constexpr unsigned kFull = 0xffffffffu;

enum { kFailVcap = 1, kFailEdge = 2, kFailKcap = 3, kFailAligned = 4,
       kFailPath = 5 };

struct Params {
    int v, vs, second, lp, d1, wb, p, s, a, b;  // vs: smem graph nodes
    int match, mismatch, gap, wtype, trim, pkr;
    long long words;
};

__host__ __device__ inline size_t a16(size_t x) {
    return (x + 15) & ~size_t(15);
}

// ring region: kR rows or the path tape (v + lp), whichever is
// larger; it also holds the consensus scores (v).  v is the node
// capacity of the shared-memory graph.
__host__ __device__ inline size_t ring_bytes(int v, int lp, int wb) {
    const size_t r = (size_t)kR * wb * 4, t = (size_t)(v + lp) * 4;
    return r > t ? r : t;
}

// dynamic shared memory of one window (cuda/poa_full.py:smem_bytes
// computes the same sum)
__host__ __device__ inline size_t smem_total(int v, int lp, int wb) {
    return a16(ring_bytes(v, lp, wb)) + a16((size_t)v * kPM * 2)
        + 6 * a16((size_t)v * 2) + 5 * a16((size_t)v) + a16(lp + 256)
        + a16(lp);
}

// one window's graph in shared memory
struct Smem {
    int* ring;                        // [kR, wb] | path tape | scores
    uint16_t* predm;                  // [v, kPM] first pred ids
    uint16_t *nseq, *anch, *minsucc, *nxt, *glast, *visit;
    uint8_t *base, *pcnt, *scnt, *gcnt, *bq;
    uint8_t *chars, *lw;              // staged layer [lp + 256], [lp]
};

__device__ __forceinline__ Smem carve_smem(unsigned char* p, int v, int lp,
                                           int wb) {
    Smem s;
    s.ring = (int*)p;                 p += a16(ring_bytes(v, lp, wb));
    s.predm = (uint16_t*)p;           p += a16((size_t)v * kPM * 2);
    const size_t w16 = a16((size_t)v * 2), w8 = a16((size_t)v);
    s.nseq = (uint16_t*)p;            p += w16;
    s.anch = (uint16_t*)p;            p += w16;
    s.minsucc = (uint16_t*)p;         p += w16;
    s.nxt = (uint16_t*)p;             p += w16;
    s.glast = (uint16_t*)p;           p += w16;
    s.visit = (uint16_t*)p;           p += w16;
    s.base = p;                       p += w8;
    s.pcnt = p;                       p += w8;
    s.scnt = p;                       p += w8;
    s.gcnt = p;                       p += w8;
    s.bq = p;                         p += w8;
    s.chars = p;                      p += a16(lp + 256);
    s.lw = p;
    return s;
}

// one resident block's device-memory scratch
struct Dev {
    int* rows;                        // [v, wb] packed score<<6|code,
                                      // by rank in the layer's walk
    int* predx;                       // [v, p - kPM] pred ids kPM..
    int* predw;                       // [v, p]
    int* alig;                        // [v, a]
};

__device__ __forceinline__ Dev carve_dev(int* w, const Params& P) {
    Dev g;
    const long long v = P.v;
    g.rows = w;            w += v * P.wb;
    g.predx = w;           w += v * (P.p > kPM ? P.p - kPM : 0);
    g.predw = w;           w += v * P.p;
    g.alig = w;
    return g;
}

__device__ __forceinline__ int node_of(uint16_t x) {
    return x == kNone ? -1 : (int)x;
}

__device__ __forceinline__ int pred_id(const Smem& s, const Dev& g,
                                       const Params& P, int node, int t) {
    return t < kPM ? (int)s.predm[node * kPM + t]
                   : __ldcg(g.predx + (long long)node * (P.p - kPM) + t - kPM);
}

__device__ __forceinline__ void set_pred(const Smem& s, const Dev& g,
                                         const Params& P, int node, int t,
                                         int pid) {
    if (t < kPM)
        s.predm[node * kPM + t] = (uint16_t)pid;
    else
        g.predx[(long long)node * (P.p - kPM) + t - kPM] = pid;
}

// graph state lane 0 mutates during the merge
struct MergeState {
    int head, nodes, fail;
    bool retry;                       // the window outgrew the smem graph
};

__device__ __forceinline__ int new_node(const Smem& s, const Params& P,
                                        MergeState& st, int c, int anchor,
                                        int pos) {
    const int nid = st.nodes;
    if (nid >= P.vs && P.vs < P.v) {     // past the smem graph: retry
        st.retry = true;
        return 0;
    }
    if (nid >= P.v) {
        if (st.fail == 0) st.fail = kFailVcap;
        return 0;
    }
    s.base[nid] = (uint8_t)c;
    s.nseq[nid] = 0;
    s.anch[nid] = (uint16_t)anchor;
    s.minsucc[nid] = kInf16;
    s.glast[nid] = (uint16_t)nid;
    s.gcnt[nid] = 0;
    s.visit[nid] = kNone;
    s.bq[nid] = 0;
    s.pcnt[nid] = 0;
    s.scnt[nid] = 0;
    st.nodes = nid + 1;
    if (pos >= 0) {
        s.nxt[nid] = s.nxt[pos];
        s.nxt[pos] = (uint16_t)nid;
    } else {
        s.nxt[nid] = st.head < 0 ? kNone : (uint16_t)st.head;
        st.head = nid;
    }
    return nid;
}

// edge nu -> t of weight w: an existing edge gains the weight (a
// fire-and-forget reduction: nothing waits on it), a new one takes the
// next pred slot of t
__device__ __forceinline__ void add_edge(const Smem& s, const Dev& g,
                                         const Params& P, MergeState& st,
                                         int nu, int t, int w) {
    const int cnt = s.pcnt[t];
    const uint2 pm = *reinterpret_cast<const uint2*>(s.predm + t * kPM);
    const int pid[kPM] = {(int)(pm.x & 0xFFFF), (int)(pm.x >> 16),
                          (int)(pm.y & 0xFFFF), (int)(pm.y >> 16)};
    int hit = -1;
#pragma unroll
    for (int k = kPM - 1; k >= 0; --k)
        if (k < cnt && pid[k] == nu) hit = k;
    for (int k = kPM; hit < 0 && k < cnt; ++k)
        if (pred_id(s, g, P, t, k) == nu) hit = k;
    if (hit >= 0) {
        atomicAdd(g.predw + (long long)t * P.p + hit, w);
        return;
    }
    const int free = s.scnt[nu];
    if (free < P.s && cnt < P.p) {
        s.minsucc[nu] = (uint16_t)min((int)s.minsucc[nu], (int)s.anch[t]);
        set_pred(s, g, P, t, cnt, nu);
        s.scnt[nu] = (uint8_t)(free + 1);
        s.pcnt[t] = (uint8_t)(cnt + 1);
        g.predw[(long long)t * P.p + cnt] = w;
    } else if (st.fail == 0) {
        st.fail = kFailEdge;
    }
}

// Counters a window reports in ``stats`` (when given): pred rows read
// from the ring, pred rows read from device memory, pred slots >= kPM
// read by the DP walk.
struct Stats {
    int ring_hits, ring_misses, pred_overflow;
};

// pred row at band lag dq: this lane's CPL columns >> 6, -inf past
// the band
template <int CPL>
__device__ __forceinline__ void load_row(const Smem& s, const Dev& g,
                                         int wb, int r, int vis, int dq,
                                         int c0, int* h, Stats& st) {
    const int col = c0 + dq * kQ;
    // the slot of rank r - kR is this rank's own: a row is read from
    // the ring only while it is younger
    const bool hit = r - vis < kR;
    if (hit) ++st.ring_hits; else ++st.ring_misses;
    if (col >= wb) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) h[j] = kNeg;
        return;
    }
    const int4* row = reinterpret_cast<const int4*>(
        hit ? s.ring + (vis % kR) * wb + col
            : g.rows + (long long)vis * wb + col);
#pragma unroll
    for (int k = 0; k < CPL / 4; ++k) {
        const int4 q = hit ? row[k] : __ldcg(row + k);
        h[4 * k] = q.x >> 6; h[4 * k + 1] = q.y >> 6;
        h[4 * k + 2] = q.z >> 6; h[4 * k + 3] = q.w >> 6;
    }
}

// this lane's CPL staged characters (an aligned vector load)
template <int CPL>
__device__ __forceinline__ void load_chars(const uint8_t* p, int* cv) {
    static_assert(CPL % 8 == 0, "a multiple of 8 columns per lane");
#pragma unroll
    for (int k = 0; k < CPL / 8; ++k) {
        const uint2 w = reinterpret_cast<const uint2*>(p)[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            cv[8 * k + j] = (w.x >> (8 * j)) & 0xFF;
            cv[8 * k + 4 + j] = (w.y >> (8 * j)) & 0xFF;
        }
    }
}

// fold one real pred's row into the column maxima (first real slot
// wins every column over the -inf start; later slots only when higher)
template <int CPL>
__device__ __forceinline__ void fold(int* acc, int* arg, const int* h,
                                     int t, bool& have) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        if (!have) {
            acc[j] = h[j];
            arg[j] = h[j] > kNeg ? t : 0;
        } else if (h[j] > acc[j]) {
            acc[j] = h[j];
            arg[j] = t;
        }
    }
    have = true;
}

// One layer's banded DP walk over the topological list: one row per
// subset node, CPL columns per lane.  Returns the number of ranks;
// sets the best subset sink and the KCAP flag.
template <int CPL>
__device__ __forceinline__ int dp_walk(const Smem& s, const Dev& g,
                                       const Params& P, int head, int begin,
                                       int end, int fsp, int m, int bblm,
                                       int nodes0, int lane, int& best_node,
                                       bool& bad_any, Stats& st) {
    const int wb = P.wb, gap = P.gap, p = P.p;
    const int end_eff = fsp > 0 ? kFullSpanEnd : end;
    const int smax = (max(m + 1 - wb, 0) + kQ - 1) / kQ;
    const int span = max(end - begin, 1);
    const int nr_est = fsp > 0 ? nodes0
                               : max(1, (span * nodes0) / max(bblm, 1));
    const int slope = (m * 256) / max(nr_est, 1);
    const int c0 = lane * CPL;
    int best = kSinkFloor;
    best_node = -1;
    int nvis = 0;
    for (int node = head; node >= 0;) {
        // every read that depends only on the node, issued together
        const int anc = s.anch[node];
        const int nx = node_of(s.nxt[node]);
        const int msucc = s.minsucc[node];
        const int cnt = s.pcnt[node];
        const int bnode = s.base[node];
        const uint2 pm =
            *reinterpret_cast<const uint2*>(s.predm + node * kPM);
        if (fsp > 0 || (anc >= begin && anc <= end)) {
            const bool is_sink = msucc > end_eff;
            const int sq_r = is_sink ? smax
                : min(max((((nvis * slope) >> 8) - kQ / 2) >> 7, 0), smax);
            const int s_r = sq_r * kQ;
            int cv[CPL];
            load_chars<CPL>(s.chars + s_r + c0, cv);
            // the mirrored preds' ranks and band lags, then their rows
            const int pid[kPM] = {(int)(pm.x & 0xFFFF), (int)(pm.x >> 16),
                                  (int)(pm.y & 0xFFFF), (int)(pm.y >> 16)};
            int vis[kPM], dq[kPM];
#pragma unroll
            for (int t = 0; t < kPM; ++t) {
                vis[t] = kNone;
                dq[t] = 0;
                if (t < cnt) {
                    vis[t] = s.visit[pid[t]];
                    dq[t] = sq_r - s.bq[pid[t]];
                }
            }
            int acc[CPL], arg[CPL];
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                acc[j] = kNeg;
                arg[j] = 0;
            }
            int nreal = 0;
            bool have = false;
#pragma unroll
            for (int t = 0; t < kPM; ++t) {
                if (vis[t] == kNone) continue;
                ++nreal;
                if (dq[t] < 0 || dq[t] >= kNShift) {
                    bad_any = true;
                    continue;
                }
                int h[CPL];
                load_row<CPL>(s, g, wb, nvis, vis[t], dq[t], c0, h, st);
                fold<CPL>(acc, arg, h, t, have);
            }
            for (int t = kPM; t < cnt; ++t) {   // pred slots in device memory
                ++st.pred_overflow;
                const int pidx = pred_id(s, g, P, node, t);
                const int visx = s.visit[pidx];
                if (visx == kNone) continue;
                ++nreal;
                const int dqx = sq_r - s.bq[pidx];
                if (dqx < 0 || dqx >= kNShift) {
                    bad_any = true;
                    continue;
                }
                int h[CPL];
                load_row<CPL>(s, g, wb, nvis, visx, dqx, c0, h, st);
                fold<CPL>(acc, arg, h, t, have);
            }
            if (nreal == 0) {                 // virtual start row
#pragma unroll
                for (int j = 0; j < CPL; ++j) acc[j] = (s_r + c0 + j) * gap;
            }
            // diagonal candidates (acc + substitution) of this lane's
            // columns; column c0 - 1's comes from the lane before
            int x[CPL];
#pragma unroll
            for (int j = 0; j < CPL; ++j)
                x[j] = acc[j] + (cv[j] == bnode ? P.match : P.mismatch);
            int xl = __shfl_up_sync(kFull, x[CPL - 1], 1);
            int al = __shfl_up_sync(kFull, arg[CPL - 1], 1);
            if (lane == 0) {
                xl = kNeg;
                al = 0;
            }
            // in-lane inclusive prefix max of max(diag, vert) - c * gap
            int z[CPL];
            int run = INT_MIN;
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                const int dmax = j ? x[j - 1] : xl;
                run = max(run, max(dmax, acc[j] + gap) - (c0 + j) * gap);
                z[j] = run;
            }
            // across lanes: exclusive prefix max of the lane totals
            int incl = run;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl = max(incl, y);
            }
            int excl = __shfl_up_sync(kFull, incl, 1);
            if (lane == 0) excl = INT_MIN;
            const int cend = m - s_r;
            int hsink = 0;
            int out[CPL];
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                const int c = c0 + j;
                const int dmax = j ? x[j - 1] : xl;
                const int argd = j ? arg[j - 1] : al;
                const int vmax = acc[j] + gap;
                const int hr = max(z[j], excl) + c * gap;
                const int code = dmax == hr ? argd
                    : (vmax == hr ? arg[j] + p : 2 * p);
                out[j] = min(max(hr, -kClip), kClip) * 64 + code;
                if (c == cend) hsink = hr;
            }
            int4* rr = reinterpret_cast<int4*>(
                s.ring + (nvis % kR) * wb + c0);
            int4* gr = reinterpret_cast<int4*>(
                g.rows + (long long)nvis * wb + c0);
#pragma unroll
            for (int k = 0; k < CPL / 4; ++k) {
                const int4 q = make_int4(out[4 * k], out[4 * k + 1],
                                         out[4 * k + 2], out[4 * k + 3]);
                rr[k] = q;
                gr[k] = q;
            }
            if (is_sink) {
                hsink = __shfl_sync(kFull, hsink, cend / CPL);
                if (hsink > best) {
                    best = hsink;
                    best_node = node;
                }
            }
            if (lane == 0) {
                s.visit[node] = (uint16_t)nvis;
                s.bq[node] = (uint8_t)sq_r;
            }
            ++nvis;
            __syncwarp();
        }
        node = nx;
    }
    return nvis;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// Traceback of one layer from the best sink: the reversed path packed
// (node+2)*pkr + (spos+2) into the tape.  Every lane walks it (lane 0
// writes the tape); every 8 steps lane k asks L1 for the cell the path
// would read k + 1 ranks back on a diagonal, so the walk's dependent
// device-memory reads mostly find their rows in L1.  Returns its length.
__device__ __forceinline__ int traceback(const Smem& s, const Dev& g,
                                         const Params& P, int best_node,
                                         int m, int lane, int& fail,
                                         bool& retry) {
    const int p = P.p, wb = P.wb, tape = P.v + P.lp, cap = P.vs + P.lp;
    int* path = s.ring;
    int step = 0, tn = best_node, jj = m;
    while ((tn >= 0 || jj > 0) && step < tape) {
        bool is_diag = false, is_vert = false;
        int pnode = -1;
        if (tn >= 0) {
            const int rt = s.visit[tn];
            const int s0 = s.bq[tn] * kQ;
            if ((step & 7) == 0) {
                const int k = lane + 1;
                if (rt - k >= 0)
                    prefetch_l1(g.rows + (long long)(rt - k) * wb
                                + min(max(jj - k - s0, 0), wb - 1));
            }
            const int cc = min(max(jj - s0, 0), wb - 1);
            // a plain (L1-cached) load: this block wrote the row
            const int code = g.rows[(long long)rt * wb + cc] & 63;
            is_diag = code < p;
            is_vert = code >= p && code < 2 * p;
            const int slot = min(max(is_diag ? code : code - p, 0), p - 1);
            // an unused slot holds no pred
            const int pid = slot < s.pcnt[tn] ? pred_id(s, g, P, tn, slot)
                                              : -1;
            if (pid >= 0 && s.visit[pid] != kNone) pnode = pid;
        }
        const bool take = is_diag || is_vert;
        const int en = take ? tn : -1;
        const int es = is_vert ? -1 : jj - 1;
        if (step >= cap) {                // the smem tape is full: retry
            retry = true;
            return step;
        }
        if (lane == 0) path[step] = (en + 2) * P.pkr + (es + 2);
        if (take) tn = pnode;
        if (!is_vert) jj = max(jj - 1, 0);
        ++step;
    }
    if (step >= tape) fail = kFailPath;
    return step;
}

// Merge the path into the graph, forward order.  Lane 0.
__device__ __forceinline__ void merge(const Smem& s, const Dev& g,
                                      const Params& P, MergeState& st,
                                      int step, int begin) {
    const int a = P.a;
    const int* path = s.ring;
    int prev = -1, prev_w = 0;
    for (int t = 0; t < step; ++t) {
        const int packed = path[step - 1 - t];
        const int nid = packed / P.pkr - 2;
        const int jj = packed % P.pkr - 2;
        if (jj < 0) continue;
        const int ch = s.chars[jj];
        const int w = s.lw[jj];
        int target;
        if (nid >= 0 && s.base[nid] == ch) {
            target = nid;
        } else if (nid < 0) {
            const int anchor = prev < 0 ? begin : s.anch[prev];
            const int pos = prev < 0 ? -1 : s.glast[prev];
            target = new_node(s, P, st, ch, anchor, pos);
            if (st.retry) return;
        } else {
            // mismatch: reuse an aligned sibling with the same base,
            // else create one in nid's column
            const int gc = s.gcnt[nid];
            int* row = g.alig + (long long)nid * a;
            int found = -1;
            for (int k = 0; k < gc; ++k) {
                const int e = __ldcg(row + k);
                const int sib = e / 256;
                if (e % 256 == ch && (found < 0 || sib < found)) found = sib;
            }
            if (found >= 0) {
                target = found;
            } else {
                const int tgt = new_node(s, P, st, ch, s.anch[nid],
                                         s.glast[nid]);
                if (st.retry) return;
                if (gc >= a) {
                    st.fail = kFailAligned;
                } else {
                    // entries past a node's gcnt are never read
                    int* trow = g.alig + (long long)tgt * a;
                    for (int k = 0; k < gc; ++k) trow[k] = __ldcg(row + k);
                    trow[gc] = nid * 256 + s.base[nid];
                    s.gcnt[tgt] = (uint8_t)(gc + 1);
                    for (int k = 0; k < gc; ++k) {
                        const int sib = __ldcg(row + k) / 256;
                        const int gs = s.gcnt[sib];
                        if (gs < a) {
                            g.alig[(long long)sib * a + gs] = tgt * 256 + ch;
                            s.gcnt[sib] = (uint8_t)(gs + 1);
                        }
                        s.glast[sib] = (uint16_t)tgt;
                    }
                    row[gc] = tgt * 256 + ch;
                    s.gcnt[nid] = (uint8_t)(gc + 1);
                    s.glast[nid] = (uint16_t)tgt;
                }
                target = tgt;
            }
        }
        s.nseq[target] = (uint16_t)(s.nseq[target] + 1);
        if (prev >= 0) add_edge(s, g, P, st, prev, target, prev_w + w);
        prev = target;
        prev_w = w;
    }
}

__device__ __forceinline__ int clip_cycles(long long c) {
    return (int)min(c, (long long)INT_MAX);
}

// One window.  Returns false when the window outgrew the shared-memory
// graph (P.vs nodes < P.v) and must run again with the full one; its
// outputs are then not written.
template <int CPL>
__device__ __forceinline__ bool run_window(
        const Smem& s, const Dev& g, const Params& P, int b,
        const uint8_t* __restrict__ seqs, const uint8_t* __restrict__ wts,
        const int* __restrict__ meta, int nl, int bbl,
        int* __restrict__ cons, int* __restrict__ mout,
        int* __restrict__ stats, int lane) {
    const long long t_start = clock64();
    const int v = P.v, vs = P.vs, lp = P.lp, p = P.p;
    const uint8_t* sq = seqs + (long long)b * P.d1 * lp;
    const uint8_t* wq = wts + (long long)b * P.d1 * lp;
    const int* mt = meta + (long long)b * P.d1 * 8;
    const int bblm = min(bbl, v);
    if (bblm > vs) return false;

    // ---- initialise every node slot; seed the backbone chain ----
    for (int i = lane; i < vs; i += 32) {
        const bool has = i < bblm;
        const bool has_nxt = has && i + 1 < bbl;
        s.base[i] = has ? sq[i] : 0;
        s.nseq[i] = has ? 1 : 0;
        s.anch[i] = has ? (uint16_t)i : 0;
        s.minsucc[i] = has_nxt ? (uint16_t)(i + 1) : kInf16;
        s.nxt[i] = has_nxt ? (uint16_t)(i + 1) : kNone;
        s.glast[i] = (uint16_t)i;
        s.pcnt[i] = has && i > 0 ? 1 : 0;
        s.scnt[i] = has_nxt ? 1 : 0;
        s.gcnt[i] = 0;
        s.bq[i] = 0;
        if (has && i > 0) {
            s.predm[i * kPM] = (uint16_t)(i - 1);
            g.predw[(long long)i * p] = wq[i - 1] + wq[i];
        }
    }
    int fail = bbl > v ? kFailVcap : 0;
    int head = 0, nodes = bblm, n_incl = 1, rank_steps = 0;
    long long t_dp = 0, t_tm = 0;
    Stats st{0, 0, 0};
    __syncwarp();

    for (int d = 1; d <= nl; ++d) {
        if (fail != 0) break;
        const int begin = mt[d * 8 + 0], end = mt[d * 8 + 1];
        const int fsp = mt[d * 8 + 2], m = mt[d * 8 + 3];
        if (m > 0) ++n_incl;
        // stage the layer (16-byte copies) and clear the visit marks
        const uint4* src =
            reinterpret_cast<const uint4*>(sq + (long long)d * lp);
        const uint4* wsrc =
            reinterpret_cast<const uint4*>(wq + (long long)d * lp);
        uint4* cdst = reinterpret_cast<uint4*>(s.chars);
        uint4* wdst = reinterpret_cast<uint4*>(s.lw);
        const uint4 zero = make_uint4(0, 0, 0, 0);
        for (int i = lane; i < lp / 16 + 16; i += 32)
            cdst[i] = i < lp / 16 ? src[i] : zero;
        for (int i = lane; i < lp / 16; i += 32) wdst[i] = wsrc[i];
        const uint4 none = make_uint4(kFull, kFull, kFull, kFull);
        for (int i = lane; i < vs / 8; i += 32)
            reinterpret_cast<uint4*>(s.visit)[i] = none;
        __syncwarp();

        const long long t0 = clock64();
        int best_node;
        bool bad = false;
        const int nvis = dp_walk<CPL>(s, g, P, head, begin, end, fsp, m,
                                      bblm, nodes, lane, best_node, bad, st);
        const long long t1 = clock64();
        t_dp += t1 - t0;
        rank_steps += nvis;
        if (bad) fail = kFailKcap;
        if (best_node < 0 && nvis > 0) fail = kFailKcap;

        bool retry = false;
        if (fail == 0) {
            const int step = traceback(s, g, P, best_node, m, lane, fail,
                                       retry);
            __syncwarp();
            if (lane == 0 && fail == 0 && !retry) {
                MergeState ms{head, nodes, fail, false};
                merge(s, g, P, ms, step, begin);
                head = ms.head;
                nodes = ms.nodes;
                fail = ms.fail;
                retry = ms.retry;
            }
        }
        head = __shfl_sync(kFull, head, 0);
        nodes = __shfl_sync(kFull, nodes, 0);
        fail = __shfl_sync(kFull, fail, 0);
        if (__shfl_sync(kFull, (int)retry, 0)) return false;
        __syncwarp();
        t_tm += clock64() - t1;
    }

    // ---- outputs; consensus by heaviest bundle over the full graph ----
    int* mo = mout + (long long)b * 8;
    if (stats != nullptr && lane == 0) {
        stats[3LL * b] = st.ring_hits;
        stats[3LL * b + 1] = st.ring_misses;
        stats[3LL * b + 2] = st.pred_overflow;
    }
    if (fail != 0) {
        if (lane == 0) {
            mo[0] = -1; mo[1] = 0; mo[2] = fail; mo[3] = nodes;
            mo[4] = rank_steps; mo[5] = clip_cycles(t_dp);
            mo[6] = clip_cycles(t_tm);
            mo[7] = clip_cycles(clock64() - t_start - t_dp - t_tm);
        }
        return true;
    }
    // per node, in parallel: the heaviest pred weight and the mask of
    // pred slots that carry it (only those can win the bundle)
    // the consensus reuses what the merge leaves dead: scores in the
    // ring, the masks in visit, cpred in glast, and each node's best
    // weight split over anch (bits 0-15), gcnt (16-23) and bq (24-31)
    int* score = s.ring;
    uint16_t* mask = s.visit;
    uint16_t* cpred = s.glast;
    for (int i = lane; i < nodes; i += 32) {
        const int cnt = s.pcnt[i];
        int mw = -1;
        unsigned mk = 0;
        for (int t = 0; t < cnt; ++t) {
            const int w = __ldcg(g.predw + (long long)i * p + t);
            if (w > mw) {
                mw = w;
                mk = 1u << t;
            } else if (w == mw) {
                mk |= 1u << t;
            }
        }
        s.anch[i] = (uint16_t)mw;
        s.gcnt[i] = (uint8_t)(mw >> 16);
        s.bq[i] = (uint8_t)(mw >> 24);
        mask[i] = (uint16_t)mk;
    }
    __syncwarp();
    int clen = 0, cbegin = 0, length = 0, status = 0;
    if (lane == 0) {
        // a slot of the heaviest weight replaces the first one only
        // with a strictly higher score: the kernel's tie rule
        int best_sink = -1;
        for (int node = head; node >= 0; node = node_of(s.nxt[node])) {
            unsigned mk = mask[node];
            int bu = -1;
            while (mk) {
                const int t = __ffs(mk) - 1;
                mk &= mk - 1;
                const int pid = pred_id(s, g, P, node, t);
                if (bu < 0 || score[pid] > score[bu]) bu = pid;
            }
            const int bw = (int)s.anch[node] | (int)s.gcnt[node] << 16
                | (int)s.bq[node] << 24;
            score[node] = bu >= 0 ? score[bu] + bw : 0;
            cpred[node] = bu >= 0 ? (uint16_t)bu : kNone;
            if (s.minsucc[node] >= kInf16 &&
                (best_sink < 0 || score[node] > score[best_sink]))
                best_sink = node;
        }
        // the consensus walk, sink first, over the dead scores
        int* walk = s.ring;
        for (int node = best_sink; node >= 0; node = node_of(cpred[node]))
            walk[clen++] = node;
        int cend = clen - 1;
        if (P.wtype == 1 && P.trim) {
            const int avg = (n_incl - 1) / 2;
            int first = -1, last = -1;
            for (int t = 0; t < clen; ++t) {
                if (s.nseq[walk[clen - 1 - t]] >= avg) {
                    if (first < 0) first = t;
                    last = t;
                }
            }
            if (first < 0 || first >= last) {
                status = 2;
            } else {
                cbegin = first;
                cend = last;
            }
        }
        length = max(cend - cbegin + 1, 0);
    }
    clen = __shfl_sync(kFull, clen, 0);
    cbegin = __shfl_sync(kFull, cbegin, 0);
    length = __shfl_sync(kFull, length, 0);
    __syncwarp();
    int* out = cons + (long long)b * v;
    for (int t = lane; t < length; t += 32)
        out[t] = s.base[s.ring[clen - 1 - (cbegin + t)]];
    if (lane == 0) {
        mo[0] = length; mo[1] = status; mo[2] = 0; mo[3] = nodes;
        mo[4] = rank_steps; mo[5] = clip_cycles(t_dp);
        mo[6] = clip_cycles(t_tm);
        mo[7] = clip_cycles(clock64() - t_start - t_dp - t_tm);
    }
    return true;
}

// queue words: the first pass's window counter, the number of windows
// it handed to the second pass, the second pass's counter, then those
// windows
enum { kQFirst = 0, kQRetried = 1, kQSecond = 2, kQList = 3 };

// Persistent one-warp blocks.  The first pass (P.second == 0) takes
// windows 0..b-1 from the queue and hands the ones that outgrow its
// P.vs-node graph on; the second pass (P.vs == P.v) runs those.
template <int CPL>
__global__ void __launch_bounds__(32, 1)
poa_full_kernel(const uint8_t* __restrict__ seqs,
                const uint8_t* __restrict__ wts,
                const int* __restrict__ meta, const int* __restrict__ nlay,
                const int* __restrict__ bblen, int* __restrict__ cons,
                int* __restrict__ mout, int* __restrict__ stats,
                int* scratch, int* queue, Params P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const Smem s = carve_smem(smem_raw, P.vs, P.lp, P.wb);
    const Dev g = carve_dev(scratch + (long long)blockIdx.x * P.words, P);
    const int lane = threadIdx.x;
    const int n = P.second ? __ldcg(queue + kQRetried) : P.b;
    for (;;) {
        int q = 0;
        if (lane == 0)
            q = atomicAdd(queue + (P.second ? kQSecond : kQFirst), 1);
        q = __shfl_sync(kFull, q, 0);
        if (q >= n) break;
        const int b = P.second ? __ldcg(queue + kQList + q) : q;
        const bool done = run_window<CPL>(s, g, P, b, seqs, wts, meta,
                                          nlay[b], bblen[b], cons, mout,
                                          stats, lane);
        if (!done && lane == 0)
            queue[kQList + atomicAdd(queue + kQRetried, 1)] = b;
        __syncwarp();
    }
}

// the instantiations, one a band width (CPL = wb / 32): the band of
// every window cap the polisher fits (LP <= 1024, so WB 256)
constexpr int kWidths[] = {256};
constexpr int kInstances = sizeof(kWidths) / sizeof(kWidths[0]);

// the instantiation's index for a band width, or -1
int instance_of(int wb) {
    for (int i = 0; i < kInstances; ++i)
        if (kWidths[i] == wb) return i;
    return -1;
}

// the instantiation for a band width; null for a width without one
const void* kernel_for(int wb) {
    switch (instance_of(wb)) {
        case 0: return (const void*)poa_full_kernel<8>;
        default: return nullptr;
    }
}

// per device and instantiation: the dynamic shared memory it is opted
// in to
int g_opted[64][kInstances];

// opt the instantiation of band width ``wb`` in to ``smem`` bytes of
// dynamic shared memory, unless it already is (poa_full_prepare opts
// each in to the limit)
cudaError_t prepare(int wb, size_t smem) {
    const void* k = kernel_for(wb);
    if (k == nullptr) return cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    int& opted = g_opted[dev & 63][instance_of(wb)];
    if (err != cudaSuccess || (long long)smem <= opted) return err;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) opted = (int)smem;
    return err;
}

}  // namespace

extern "C" {

// Loads every instantiation on the current device and opts each in to
// the most dynamic shared memory a block may take, once a device.  CUDA
// loads a module at a kernel's first use, so a launch (or an occupancy
// query) that came first would pay for the load inside its dispatch's
// event window; poa_full_buffers calls this before the window.
// Returns a CUDA error code (0 = ready).
int poa_full_prepare() {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int i = 0; i < kInstances && err == cudaSuccess; ++i) {
        if (g_opted[dev & 63][i] > 0) continue;
        cudaFuncAttributes a;
        err = cudaFuncGetAttributes(&a, kernel_for(kWidths[i]));
        if (err == cudaSuccess)
            err = prepare(kWidths[i],
                          (size_t)(optin - (int)a.sharedSizeBytes));
    }
    return (int)err;
}

// Resident blocks the card holds for this shape (SMs x blocks per SM)
// with a shared-memory graph of ``vs`` nodes, or minus a CUDA error.
int poa_full_slots(int vs, int lp, int wb) {
    const void* k = kernel_for(wb);
    if (k == nullptr) return -(int)cudaErrorInvalidValue;
    const size_t smem = smem_total(vs, lp, wb);
    cudaError_t err = prepare(wb, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, 32,
                                                            smem);
    if (err != cudaSuccess) return -(int)err;
    return sms * per_sm;
}

// Launches one pass of ``grid`` persistent one-warp blocks on
// ``stream``: the first (second == 0) over the batch's ``b`` windows
// with a shared-memory graph of ``vs`` nodes, the second (vs == v)
// over the windows the first handed on.  ``queue`` ([3 + b] int32,
// zeroed by the caller before the first pass) carries the counters and
// the handed-on windows; ``scratch`` holds ``words`` int32 per block;
// ``stats`` (may be null) is [b, 3] int32.  Returns cudaGetLastError()
// after the launch (0 = launched).
int poa_full_launch(const void* seqs, const void* wts, const void* meta,
                    const void* nlay, const void* bblen, void* cons,
                    void* mout, void* stats, void* scratch, void* queue,
                    long long words, int b, int grid, int v, int vs,
                    int second, int lp, int d1, int wb, int p, int s, int a,
                    int match, int mismatch, int gap, int wtype, int trim,
                    void* stream) {
    const void* k = kernel_for(wb);
    if (k == nullptr || p > kMaxP || p < 1 || b <= 0 || grid <= 0 ||
        vs > v || vs % 16 != 0 || lp % 16 != 0 || (second && vs != v))
        return (int)cudaErrorInvalidValue;
    Params P;
    P.v = v; P.vs = vs; P.second = second; P.lp = lp; P.d1 = d1;
    P.wb = wb; P.p = p; P.s = s; P.a = a; P.b = b;
    P.match = match; P.mismatch = mismatch; P.gap = gap;
    P.wtype = wtype; P.trim = trim; P.words = words;
    P.pkr = 1;
    while (P.pkr < lp + 8) P.pkr <<= 1;
    const size_t smem = smem_total(vs, lp, wb);
    cudaError_t err = prepare(wb, smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&seqs, (void*)&wts, (void*)&meta, (void*)&nlay,
                    (void*)&bblen, (void*)&cons, (void*)&mout, (void*)&stats,
                    (void*)&scratch, (void*)&queue, (void*)&P};
    err = cudaLaunchKernel(k, dim3(grid), dim3(32), args, smem,
                           (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* poa_full_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
