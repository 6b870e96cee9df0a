// Partial-order-alignment consensus engine (spoa-equivalent).
//
// Re-provides, for the CPU fallback path, what racon gets from the
// vendored spoa library (reference: vendor/spoa; call sites
// src/window.cpp:73-116 and src/polisher.cpp:181-184): a POA graph
// seeded with the window backbone, global (kNW, linear gap) alignment of
// each read layer against the graph (or against the subgraph spanning
// the layer's backbone interval for partial-span layers), quality-
// weighted alignment incorporation, and a heaviest-bundle consensus walk
// returning per-base coverages.  The whole per-window consensus --
// including layer ordering by start position and the TGS coverage trim
// (src/window.cpp:84-85,118-139) -- runs natively behind one C call so
// Python threads can release the GIL around it.
//
// Semantics mirrored from the reference's call sites:
//   * base weights: Phred quality char minus 33, or 1 when the layer has
//     no qualities (cudapoa uses the same convention,
//     src/cuda/cudabatch.cpp:177-186);
//   * edge weight accumulates (w[prev] + w[cur]) per traversing sequence;
//   * consensus = heaviest-bundle: per node pick the heaviest in-edge
//     (ties -> higher predecessor score), then backtrack from the best
//     sink; coverage of a consensus base = number of sequences whose
//     path visits that node;
//   * TGS trim: cut consensus ends while coverage < (n_seqs - 1) / 2,
//     warn (status=2) without trimming when everything is below.

#include "poa_graph.hpp"

#include <cstring>
#include <numeric>
#include <vector>

using namespace racon_native;

extern "C" {

// Consensus over one window.  Sequence 0 is the backbone; begins/ends are
// window-relative layer spans.  Returns consensus length, or -1 if
// out_cap is too small.  status: 0 ok, 2 chimeric warning (TGS trim found
// no coverage plateau; consensus kept untrimmed).
int64_t rt_poa_consensus(const char* seqs_blob, const int64_t* offsets,
                         const char* quals_blob, const uint8_t* has_qual,
                         const int32_t* begins, const int32_t* ends,
                         int32_t n_seqs, int32_t window_type, int32_t trim,
                         int32_t match, int32_t mismatch, int32_t gap,
                         char* out, int64_t out_cap, int32_t* status) {
    *status = 0;
    const char* backbone = seqs_blob + offsets[0];
    const int32_t backbone_len =
        static_cast<int32_t>(offsets[1] - offsets[0]);

    PoaGraph graph;
    graph.nodes.reserve(backbone_len * 3);
    std::vector<int32_t> weights;
    make_weights(quals_blob + offsets[0], has_qual[0], backbone_len, weights);
    graph.add_alignment(AlignmentPath(), backbone, backbone_len,
                        weights.data(), 0);

    // layer order: ascending start position (src/window.cpp:84-85)
    std::vector<int32_t> rank(n_seqs - 1);
    std::iota(rank.begin(), rank.end(), 1);
    std::stable_sort(rank.begin(), rank.end(), [&](int32_t a, int32_t b) {
        return begins[a] < begins[b];
    });

    const int32_t offset = static_cast<int32_t>(0.01 * backbone_len);
    std::vector<uint8_t> subset;
    for (int32_t idx : rank) {
        const char* seq = seqs_blob + offsets[idx];
        const int32_t m = static_cast<int32_t>(offsets[idx + 1] -
                                               offsets[idx]);
        if (m == 0) continue;
        make_weights(quals_blob + offsets[idx], has_qual[idx], m, weights);

        subset.assign(graph.nodes.size(), 0);
        bool full_span = begins[idx] < offset &&
                         ends[idx] > backbone_len - offset;
        if (full_span) {
            std::fill(subset.begin(), subset.end(), 1);
        } else {
            for (size_t v = 0; v < graph.nodes.size(); ++v) {
                int32_t a = graph.nodes[v].anchor;
                subset[v] = (a >= begins[idx] && a <= ends[idx]) ? 1 : 0;
            }
        }
        AlignmentPath path = graph.align(seq, m, subset, match, mismatch,
                                         gap);
        graph.add_alignment(path, seq, m, weights.data(), begins[idx]);
    }

    std::vector<int32_t> cons = graph.consensus_path();
    std::vector<int32_t> coverages(cons.size());
    for (size_t i = 0; i < cons.size(); ++i) {
        coverages[i] = graph.nodes[cons[i]].nseqs;
    }

    int64_t begin = 0, end = static_cast<int64_t>(cons.size()) - 1;
    if (window_type == 1 && trim) {  // kTGS
        int32_t average_coverage = (n_seqs - 1) / 2;
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
        out[i] = graph.nodes[cons[begin + i]].base;
    }
    out[length] = '\0';
    return length;
}

}  // extern "C"
