// Whole-window partial-order-alignment consensus on Hopper (sm_90a).
//
// Replaces racon_tpu/tpu/poa_pallas.py:_kernel.  One thread block runs
// the entire POA of one window: the graph seeded from the backbone,
// then per layer a banded graph-vs-sequence DP over the topological
// list, traceback and merge, and finally the heaviest-bundle consensus
// and the TGS trim.  The results (consensus characters, the mout row:
// length, status, fail code, nodes used, DP rank steps) equal the
// Pallas kernel's, tie rules included.
//
// What bounds it: the DP is a serial chain of ranks (one graph node
// after another), and each rank's row depends on its predecessors'
// rows, so the kernel is bound by the latency of that chain, not by
// bytes or operations.  One block per window is the first answer to
// that: a batch of thousands of windows keeps every SM busy with many
// independent chains.  Inside a block the band columns run across the
// threads (one thread per column) and the in-row gap chain
// H[j] = max(M[j], H[j-1] + gap) is closed as a block-wide max-plus
// prefix scan (warp shuffles, then across warps).  The serial graph
// work (traceback, merge, consensus) runs on thread 0.
//
// Memory layout: the graph does not fit in shared memory at V = 2048
// (the DP rows alone are V x WB int32 = 2 MB), so each window's graph
// and rows live in a device-memory scratch slice the wrapper allocates
// (mostly L2-resident); shared memory holds the staged layer, the two
// band rows the column shift reads and the scan's warp totals.  Every
// block initialises all of its own state.
//
// Scores are exact int32 (the Pallas kernel's float32 accumulator holds
// exact integers below 2^24); stored rows pack score << 6 | code with
// the score clipped to +-2^24, and -2^28 stands for -inf.

#include <climits>
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
constexpr int kMaxAligned = 32;

enum { kFailVcap = 1, kFailEdge = 2, kFailKcap = 3, kFailAligned = 4,
       kFailPath = 5 };

struct Params {
    int v, lp, d1, wb, p, s, a;
    int match, mismatch, gap, wtype, trim, pkr;
    long long words;
};

// one window's scratch slice, carved into arrays
struct Graph {
    int *ring;                        // [v, wb] packed score<<6|code
    int *preds, *predw, *succs, *alig;  // [v, p] [v, p] [v, s] [v, a]
    int *base, *nseq, *anch, *minsucc, *nxt, *glast;
    int *pcnt, *scnt, *gcnt, *epoch, *bq, *cpred;
    int *path;                        // [v + lp]; consensus scores alias it
};

__device__ Graph carve(int* w, const Params& P) {
    Graph g;
    const long long v = P.v;
    g.ring = w;            w += v * P.wb;
    g.preds = w;           w += v * P.p;
    g.predw = w;           w += v * P.p;
    g.succs = w;           w += v * P.s;
    g.alig = w;            w += v * P.a;
    g.base = w;            w += v;
    g.nseq = w;            w += v;
    g.anch = w;            w += v;
    g.minsucc = w;         w += v;
    g.nxt = w;             w += v;
    g.glast = w;           w += v;
    g.pcnt = w;            w += v;
    g.scnt = w;            w += v;
    g.gcnt = w;            w += v;
    g.epoch = w;           w += v;
    g.bq = w;              w += v;
    g.cpred = w;           w += v;
    g.path = w;
    return g;
}

// inclusive prefix max over the block (one value per thread)
__device__ int block_scan_max(int x, int* warp_tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x = max(x, y);
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    for (int k = 0; k < warp; ++k) x = max(x, warp_tot[k]);
    return x;
}

// graph state thread 0 mutates during the merge
struct MergeState {
    int head, nodes, fail;
};

__device__ int new_node(const Graph& g, const Params& P, MergeState& st,
                        int c, int anchor, int pos) {
    const int nid = st.nodes;
    if (nid >= P.v) {
        if (st.fail == 0) st.fail = kFailVcap;
        return 0;
    }
    g.base[nid] = c;
    g.nseq[nid] = 0;
    g.anch[nid] = anchor;
    g.minsucc[nid] = kInf16;
    g.glast[nid] = nid;
    g.gcnt[nid] = 0;
    g.epoch[nid] = 0;
    g.bq[nid] = 0;
    g.pcnt[nid] = 0;
    g.scnt[nid] = 0;
    g.preds[(long long)nid * P.p] = -1;
    st.nodes = nid + 1;
    if (pos >= 0) {
        g.nxt[nid] = g.nxt[pos];
        g.nxt[pos] = nid;
    } else {
        g.nxt[nid] = st.head;
        st.head = nid;
    }
    return nid;
}

__device__ void add_edge(const Graph& g, const Params& P, MergeState& st,
                         int nu, int t, int w) {
    int* row = g.preds + (long long)t * P.p;
    for (int k = 0; k < P.p; ++k) {
        if (row[k] == nu) {
            g.predw[(long long)t * P.p + k] += w;
            return;
        }
    }
    const int free = g.scnt[nu], pfree = g.pcnt[t];
    if (free < P.s && pfree < P.p) {
        g.succs[(long long)nu * P.s + free] = t;
        g.minsucc[nu] = min(g.minsucc[nu], g.anch[t]);
        row[pfree] = nu;
        g.scnt[nu] = free + 1;
        g.pcnt[t] = pfree + 1;
        g.predw[(long long)t * P.p + pfree] = w;
    } else if (st.fail == 0) {
        st.fail = kFailEdge;
    }
}

__global__ void poa_full_kernel(const uint8_t* __restrict__ seqs,
                                const uint8_t* __restrict__ wts,
                                const int* __restrict__ meta,
                                const int* __restrict__ nlay,
                                const int* __restrict__ bblen,
                                int* __restrict__ cons,
                                int* __restrict__ mout,
                                int* scratch, Params P) {
    extern __shared__ int smem[];
    int* chars = smem;                     // [lp + 256] staged layer
    int* xrow = chars + P.lp + 256;        // [wb] diag candidates
    int* arow = xrow + P.wb;               // [wb] their pred slots
    int* warp_tot = arow + P.wb;           // [32] scan totals
    __shared__ int s_fail, s_head, s_nodes, s_best, s_best_node;

    const int b = blockIdx.x, c = threadIdx.x, nt = blockDim.x;
    const int v = P.v, lp = P.lp, wb = P.wb, p = P.p, gap = P.gap;
    const Graph g = carve(scratch + (long long)b * P.words, P);
    const uint8_t* sq = seqs + (long long)b * P.d1 * lp;
    const uint8_t* wq = wts + (long long)b * P.d1 * lp;
    const int* mt = meta + (long long)b * P.d1 * 8;
    const int bbl = bblen[b], nl = nlay[b];
    const int bblm = min(bbl, v);
    const int tape = v + lp;

    // ---- initialise every node slot; seed the backbone chain ----
    for (int i = c; i < v; i += nt) {
        const long long ip = (long long)i * p;
        for (int k = 0; k < p; ++k) {
            g.preds[ip + k] = -1;
            g.predw[ip + k] = 0;
        }
        for (int k = 0; k < P.s; ++k) g.succs[(long long)i * P.s + k] = -1;
        for (int k = 0; k < P.a; ++k) g.alig[(long long)i * P.a + k] = 0;
        g.gcnt[i] = 0;
        g.epoch[i] = 0;
        g.bq[i] = 0;
        g.cpred[i] = -1;
        g.glast[i] = i;
        g.base[i] = 0;
        g.nseq[i] = 0;
        g.anch[i] = 0;
        g.minsucc[i] = kInf16;
        g.nxt[i] = -1;
        g.pcnt[i] = 0;
        g.scnt[i] = 0;
        if (i < bblm) {
            const bool has_nxt = i + 1 < bbl;
            g.base[i] = sq[i];
            g.nseq[i] = 1;
            g.anch[i] = i;
            g.minsucc[i] = has_nxt ? i + 1 : kInf16;
            g.nxt[i] = has_nxt ? i + 1 : -1;
            g.pcnt[i] = i > 0 ? 1 : 0;
            g.scnt[i] = has_nxt ? 1 : 0;
            if (i > 0) {
                g.preds[ip] = i - 1;
                g.predw[ip] = wq[i - 1] + wq[i];
            }
            if (i < bblm - 1) g.succs[(long long)i * P.s] = i + 1;
        }
    }
    for (int i = c; i < tape; i += nt) g.path[i] = 0;
    if (c == 0) {
        s_fail = bbl > v ? kFailVcap : 0;
        s_head = 0;
        s_nodes = bblm;
    }
    int n_incl = 1, rank_steps = 0;
    __syncthreads();

    for (int d = 1; d <= nl; ++d) {
        if (s_fail != 0) break;
        const int begin = mt[d * 8 + 0], end = mt[d * 8 + 1];
        const int fsp = mt[d * 8 + 2], m = mt[d * 8 + 3];
        if (m > 0) ++n_incl;
        for (int i = c; i < lp + 256; i += nt)
            chars[i] = i < lp ? sq[(long long)d * lp + i] : 0;
        const int nodes0 = s_nodes;
        const int end_eff = fsp > 0 ? kFullSpanEnd : end;
        const int smax = (max(m + 1 - wb, 0) + kQ - 1) / kQ;
        const int span = max(end - begin, 1);
        const int nr_est = fsp > 0 ? nodes0 : max(1, (span * nodes0) / max(bblm, 1));
        const int slope = (m * 256) / max(nr_est, 1);
        int node = s_head;
        __syncthreads();
        if (c == 0) {
            s_best_node = -1;
            s_best = kSinkFloor;
        }

        // 1+2) walk the topological list; one banded DP row per
        // subset node, column c on thread c
        int nvis = 0;
        while (node >= 0) {
            const int anc = g.anch[node];
            if (fsp > 0 || (anc >= begin && anc <= end)) {
                const bool is_sink = g.minsucc[node] > end_eff;
                const int sq_r = is_sink ? smax
                    : min(max((((nvis * slope) >> 8) - kQ / 2) >> 7, 0),
                          smax);
                const int s_r = sq_r * kQ;
                const int cnt = g.pcnt[node];
                int acc = kNeg, arg = 0, nreal = 0;
                bool have = false, bad = false;
                for (int t = 0; t < cnt; ++t) {
                    const int pid = g.preds[(long long)node * p + t];
                    if (pid < 0 || g.epoch[pid] != d) continue;
                    ++nreal;
                    const int dq = sq_r - g.bq[pid];
                    if (dq < 0 || dq >= kNShift) {
                        bad = true;
                        continue;
                    }
                    const int col = c + dq * kQ;
                    const int h = col < wb
                        ? (g.ring[(long long)pid * wb + col] >> 6) : kNeg;
                    if (!have) {
                        acc = h;
                        arg = h > kNeg ? t : 0;
                        have = true;
                    } else if (h > acc) {
                        acc = h;
                        arg = t;
                    }
                }
                if (nreal == 0) {            // virtual start row
                    acc = (s_r + c) * gap;
                    arg = 0;
                }
                const int sub = chars[s_r + c] == g.base[node]
                    ? P.match : P.mismatch;
                xrow[c] = acc + sub;
                arow[c] = arg;
                __syncthreads();
                const int dmax = c > 0 ? xrow[c - 1] : kNeg;
                const int argd = c > 0 ? arow[c - 1] : 0;
                const int vmax = acc + gap;
                const int x = block_scan_max(max(dmax, vmax) - c * gap,
                                             warp_tot);
                const int hr = x + c * gap;
                const int code = dmax == hr ? argd
                    : (vmax == hr ? arg + p : 2 * p);
                g.ring[(long long)node * wb + c] =
                    min(max(hr, -kClip), kClip) * 64 + code;
                if (is_sink && c == m - s_r && hr > s_best) {
                    s_best = hr;
                    s_best_node = node;
                }
                if (c == 0) {
                    g.epoch[node] = d;
                    g.bq[node] = sq_r;
                    if (bad) s_fail = kFailKcap;
                }
                ++nvis;
                __syncthreads();
            }
            node = g.nxt[node];
        }
        rank_steps += nvis;

        if (c == 0) {
            MergeState st{s_head, s_nodes, s_fail};
            if (s_best_node < 0 && nvis > 0) st.fail = kFailKcap;
            // 3) traceback -> reversed path packed (node+2)*pkr + (spos+2)
            int step = 0;
            if (st.fail == 0) {
                int tn = s_best_node, jj = m;
                while ((tn >= 0 || jj > 0) && step < tape) {
                    const int nodec = max(tn, 0);
                    const int s0 = tn >= 0 ? g.bq[nodec] * kQ : 0;
                    const int cc = min(max(jj - s0, 0), wb - 1);
                    const int code = g.ring[(long long)nodec * wb + cc] & 63;
                    const bool is_diag = code < p && tn >= 0;
                    const bool is_vert = code >= p && code < 2 * p && tn >= 0;
                    const bool take = is_diag || is_vert;
                    const int slot = min(max(is_diag ? code : code - p, 0),
                                         p - 1);
                    const int pid = g.preds[(long long)nodec * p + slot];
                    const int pnode = (pid >= 0 && g.epoch[pid] == d)
                        ? pid : -1;
                    const int en = take ? tn : -1;
                    const int es = is_vert ? -1 : jj - 1;
                    g.path[step] = (en + 2) * P.pkr + (es + 2);
                    tn = take ? pnode : tn;
                    jj = is_vert ? jj : max(jj - 1, 0);
                    ++step;
                }
                if (step >= tape) st.fail = kFailPath;
            }
            // 4) merge the path into the graph, forward order
            if (st.fail == 0) {
                int prev = -1, prev_w = 0;
                const uint8_t* lw = wq + (long long)d * lp;
                for (int t = 0; t < step; ++t) {
                    const int packed = g.path[step - 1 - t];
                    const int nid = packed / P.pkr - 2;
                    const int jj = packed % P.pkr - 2;
                    if (jj < 0) continue;
                    const int ch = chars[jj];
                    const int w = lw[jj];
                    int target;
                    if (nid >= 0 && g.base[nid] == ch) {
                        target = nid;
                    } else if (nid < 0) {
                        const int anchor = prev < 0 ? begin : g.anch[prev];
                        const int pos = prev < 0 ? -1 : g.glast[prev];
                        target = new_node(g, P, st, ch, anchor, pos);
                    } else {
                        // mismatch: reuse an aligned sibling with the
                        // same base, else create one in nid's column
                        const int gc = g.gcnt[nid];
                        int row[kMaxAligned];
                        for (int k = 0; k < P.a; ++k)
                            row[k] = g.alig[(long long)nid * P.a + k];
                        int found = -1;
                        for (int k = 0; k < gc; ++k) {
                            const int sib = row[k] / 256;
                            if (row[k] % 256 == ch && (found < 0 || sib < found))
                                found = sib;
                        }
                        if (found >= 0) {
                            target = found;
                        } else {
                            const int tgt = new_node(g, P, st, ch, g.anch[nid],
                                                     g.glast[nid]);
                            if (gc >= P.a) {
                                st.fail = kFailAligned;
                            } else {
                                int* trow = g.alig + (long long)tgt * P.a;
                                for (int k = 0; k < P.a; ++k)
                                    trow[k] = k == gc
                                        ? nid * 256 + g.base[nid] : row[k];
                                g.gcnt[tgt] = gc + 1;
                                for (int k = 0; k < gc; ++k) {
                                    const int sib = row[k] / 256;
                                    const int gs = g.gcnt[sib];
                                    if (gs < P.a) {
                                        g.alig[(long long)sib * P.a + gs] =
                                            tgt * 256 + ch;
                                        g.gcnt[sib] = gs + 1;
                                    }
                                    g.glast[sib] = tgt;
                                }
                                int* nrow = g.alig + (long long)nid * P.a;
                                for (int k = 0; k < P.a; ++k)
                                    nrow[k] = k == gc ? tgt * 256 + ch : row[k];
                                g.gcnt[nid] = gc + 1;
                                g.glast[nid] = tgt;
                            }
                            target = tgt;
                        }
                    }
                    g.nseq[target] += 1;
                    if (prev >= 0) add_edge(g, P, st, prev, target, prev_w + w);
                    prev = target;
                    prev_w = w;
                }
            }
            s_head = st.head;
            s_nodes = st.nodes;
            s_fail = st.fail;
        }
        __syncthreads();
    }

    // ---- outputs; consensus by heaviest bundle over the full graph ----
    if (c != 0) return;
    const int fail = s_fail;
    int* mo = mout + (long long)b * 8;
    for (int r = 0; r < 8; ++r) mo[r] = 0;
    mo[2] = fail;
    mo[3] = s_nodes;
    mo[4] = rank_steps;
    if (fail != 0) {
        mo[0] = -1;
        return;
    }
    int* score = g.path;
    int best_sink = -1;
    for (int node = s_head; node >= 0; node = g.nxt[node]) {
        int bu = -1, bw = -1;
        const int cnt = g.pcnt[node];
        for (int t = 0; t < cnt; ++t) {
            const int pid = g.preds[(long long)node * p + t];
            const int w = g.predw[(long long)node * p + t];
            if (pid >= 0 && (w > bw || (w == bw && bu >= 0 &&
                                        score[pid] > score[bu]))) {
                bu = pid;
                bw = w;
            }
        }
        score[node] = bu >= 0 ? score[bu] + bw : 0;
        g.cpred[node] = bu;
        if (g.minsucc[node] >= kInf16 &&
            (best_sink < 0 || score[node] > score[best_sink]))
            best_sink = node;
    }
    int clen = 0;
    for (int node = best_sink; node >= 0; node = g.cpred[node])
        g.path[clen++] = (node + 2) * P.pkr + 2;
    int cbegin = 0, cend = clen - 1, status = 0;
    if (P.wtype == 1 && P.trim) {
        const int avg = (n_incl - 1) / 2;
        int first = -1, last = -1;
        for (int t = 0; t < clen; ++t) {
            const int node = g.path[clen - 1 - t] / P.pkr - 2;
            if (g.nseq[node] >= avg) {
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
    const int length = max(cend - cbegin + 1, 0);
    int* out = cons + (long long)b * v;
    for (int t = 0; t < length; ++t)
        out[t] = g.base[g.path[clen - 1 - (cbegin + t)] / P.pkr - 2];
    mo[0] = length;
    mo[1] = status;
}

}  // namespace

extern "C" {

// Launches one block per window on ``stream``; returns
// cudaGetLastError() after the launch (0 = launched).
int poa_full_launch(const void* seqs, const void* wts, const void* meta,
                    const void* nlay, const void* bblen, void* cons,
                    void* mout, void* scratch, long long words, int b,
                    int v, int lp, int d1, int wb, int p, int s, int a,
                    int match, int mismatch, int gap, int wtype, int trim,
                    void* stream) {
    Params P;
    P.v = v; P.lp = lp; P.d1 = d1; P.wb = wb; P.p = p; P.s = s; P.a = a;
    P.match = match; P.mismatch = mismatch; P.gap = gap;
    P.wtype = wtype; P.trim = trim; P.words = words;
    P.pkr = 1;
    while (P.pkr < lp + 8) P.pkr <<= 1;
    if (a > kMaxAligned || wb % 32 != 0 || wb > 1024)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(int) * ((lp + 256) + 2 * wb + 64);
    poa_full_kernel<<<b, wb, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)seqs, (const uint8_t*)wts, (const int*)meta,
        (const int*)nlay, (const int*)bblen, (int*)cons, (int*)mout,
        (int*)scratch, P);
    return (int)cudaGetLastError();
}

const char* poa_full_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
