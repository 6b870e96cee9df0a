// Lockstep batch API over PoaGraph for the port's lockstep POA engine.
//
// racon_tpu_torch/cuda/poa.py advances a batch of windows one layer per
// round: the card runs one batched NW-against-graph DP + traceback for
// every window's d-th layer at once (cuda/csrc/poa_lockstep.cu), while
// the graphs themselves live here on the host.  This file provides the
// per-round export of each window's current (sub)graph as fixed-shape
// arrays for the kernel, and the application of the returned alignment
// paths (spoa add_alignment semantics).  It stands in for what
// racon-gpu gets from cudapoa's device-resident graphs (reference:
// src/cuda/cudabatch.cpp:71-265); the rejection/overflow statuses
// mirror cudabatch.cpp:124-155.
//
// All functions are safe to call concurrently for DIFFERENT window
// indices (each window owns an independent graph); calls release the
// GIL on the Python side.

#include "poa_graph.hpp"

#include <cstring>
#include <memory>
#include <numeric>
#include <vector>

using namespace racon_native;

namespace {

struct WindowState {
    PoaGraph graph;
    int32_t backbone_len = 0;
    int32_t n_seqs = 0;            // sequences incorporated (incl backbone)
    // scratch reused across rounds (per window -> per thread safe)
    std::vector<uint8_t> subset;
    std::vector<int32_t> weights;
};

struct Batch {
    std::vector<WindowState> windows;
};

}  // namespace

extern "C" {

void* rt_poab_create(int32_t n_windows) {
    auto* b = new Batch();
    b->windows.resize(n_windows);
    return b;
}

void rt_poab_destroy(void* h) {
    delete static_cast<Batch*>(h);
}

// Seed window w's graph with its backbone (layer 0).
void rt_poab_seed(void* h, int32_t w, const char* backbone, int32_t blen,
                  const char* qual, uint8_t has_qual) {
    WindowState& ws = static_cast<Batch*>(h)->windows[w];
    ws.backbone_len = blen;
    ws.graph.nodes.reserve(blen * 2);
    make_weights(qual, has_qual, blen, ws.weights);
    ws.graph.add_alignment(AlignmentPath(), backbone, blen,
                           ws.weights.data(), 0);
    ws.n_seqs = 1;
}

// Export the subgraph for aligning a layer spanning [begin, end]
// backbone anchors (full_span: whole graph, reference
// src/window.cpp:87-103).  Writes, in topological rank order:
//   bases[vcap]          node base (uint8)
//   preds[vcap * pcap]   predecessor DP-row indices (rank+1; 0 = the
//                        virtual start row; -1 pad)
//   sinks[vcap]          1 if the node has no successor in the subset
//   rank2node[vcap]      node id per rank (for path translation)
// Returns n_rows, or -1 if the subset exceeds vcap (window must fall
// back to the CPU path), -2 if a node's in-degree exceeds pcap, or -3
// if an in-edge reaches back more than kcap ranks (the device DP keeps
// only a kcap-row ring buffer of score rows).
int32_t rt_poab_export(void* h, int32_t w, int32_t begin, int32_t end,
                       int32_t full_span, int32_t vcap, int32_t pcap,
                       int32_t kcap, uint8_t* bases, int16_t* preds,
                       uint8_t* sinks, int32_t* rank2node) {
    WindowState& ws = static_cast<Batch*>(h)->windows[w];
    const PoaGraph& g = ws.graph;
    const size_t n = g.nodes.size();

    ws.subset.assign(n, 0);
    if (full_span) {
        std::fill(ws.subset.begin(), ws.subset.end(), 1);
    } else {
        for (size_t v = 0; v < n; ++v) {
            int32_t a = g.nodes[v].anchor;
            ws.subset[v] = (a >= begin && a <= end) ? 1 : 0;
        }
    }

    std::vector<int32_t> order = g.topo_order(ws.subset);
    const int32_t rows = static_cast<int32_t>(order.size());
    // preds stores rank+1 as int16: reject rows beyond its range even
    // when the caller's vcap is larger (user-settable -w can push
    // vcap past 32767), so the cast below can never overflow
    if (rows > vcap || rows > INT16_MAX - 1) return -1;

    std::vector<int32_t> rank(n, -1);
    for (int32_t r = 0; r < rows; ++r) rank[order[r]] = r;

    std::memset(preds, 0xFF, sizeof(int16_t) * vcap * pcap);  // -1 pad
    std::memset(sinks, 0, vcap);
    for (int32_t r = 0; r < rows; ++r) {
        const Node& node = g.nodes[order[r]];
        bases[r] = static_cast<uint8_t>(node.base);
        rank2node[r] = order[r];
        int32_t np = 0;
        for (int32_t e : node.in_edges) {
            int32_t u = g.edges[e].from;
            if (rank[u] >= 0) {
                if (np >= pcap) return -2;
                if (r - rank[u] > kcap) return -3;
                preds[r * pcap + np++] = static_cast<int16_t>(rank[u] + 1);
            }
        }
        if (np == 0) preds[r * pcap] = 0;  // virtual start row
        bool sink = true;
        for (int32_t e : node.out_edges) {
            if (rank[g.edges[e].to] >= 0) { sink = false; break; }
        }
        sinks[r] = sink ? 1 : 0;
    }
    return rows;
}

// Incorporate a layer along the device-produced path.  path_nodes holds
// node IDS (already translated from ranks via rank2node; -1 = none),
// path_seq holds sequence positions (-1 = node skipped).
void rt_poab_apply(void* h, int32_t w, const int32_t* path_nodes,
                   const int32_t* path_seq, int32_t path_len,
                   const char* seq, int32_t slen, const char* qual,
                   uint8_t has_qual, int32_t begin_anchor) {
    WindowState& ws = static_cast<Batch*>(h)->windows[w];
    AlignmentPath path;
    path.reserve(path_len);
    for (int32_t i = 0; i < path_len; ++i) {
        path.emplace_back(path_nodes[i], path_seq[i]);
    }
    make_weights(qual, has_qual, slen, ws.weights);
    ws.graph.add_alignment(path, seq, slen, ws.weights.data(),
                           begin_anchor);
    ++ws.n_seqs;
}

int32_t rt_poab_num_nodes(void* h, int32_t w) {
    return static_cast<int32_t>(
        static_cast<Batch*>(h)->windows[w].graph.nodes.size());
}

// Heaviest-bundle consensus + TGS trim for window w; same semantics as
// rt_poa_consensus's tail (poa.cpp), with n_seqs = layers actually
// incorporated (device-rejected layers only reduce coverage, mirroring
// cudabatch.cpp:136-155).
int64_t rt_poab_consensus(void* h, int32_t w, int32_t window_type,
                          int32_t trim, char* out, int64_t out_cap,
                          int32_t* status) {
    WindowState& ws = static_cast<Batch*>(h)->windows[w];
    *status = 0;

    std::vector<int32_t> cons = ws.graph.consensus_path();
    std::vector<int32_t> coverages(cons.size());
    for (size_t i = 0; i < cons.size(); ++i) {
        coverages[i] = ws.graph.nodes[cons[i]].nseqs;
    }

    int64_t begin = 0, end = static_cast<int64_t>(cons.size()) - 1;
    if (window_type == 1 && trim) {  // kTGS
        int32_t average_coverage = (ws.n_seqs - 1) / 2;
        for (; begin < (int64_t)cons.size(); ++begin) {
            if (coverages[begin] >= average_coverage) break;
        }
        for (; end >= 0; --end) {
            if (coverages[end] >= average_coverage) break;
        }
        if (begin >= end) {
            *status = 2;  // chimeric warning; keep untrimmed
            begin = 0;
            end = static_cast<int64_t>(cons.size()) - 1;
        }
    }

    int64_t length = end - begin + 1;
    if (length < 0) length = 0;
    if (length + 1 > out_cap) return -1;
    for (int64_t i = 0; i < length; ++i) {
        out[i] = ws.graph.nodes[cons[begin + i]].base;
    }
    out[length] = '\0';
    return length;
}

}  // extern "C"
