// POA graph engine shared by the single-window CPU entry point
// (poa.cpp) and the lockstep batch API (poa_batch.cpp).
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace racon_native {

constexpr int32_t kNegInf = INT32_MIN / 4;

struct Edge {
    int32_t from, to;
    int64_t weight;
};

struct Node {
    char base;
    int32_t anchor;               // backbone position this node hangs off
    int32_t nseqs = 0;            // sequences whose path includes the node
    std::vector<int32_t> in_edges;    // edge ids
    std::vector<int32_t> out_edges;   // edge ids
    std::vector<int32_t> aligned;     // node ids in the same column
};

// One alignment column: node id (-1 = none) and sequence position (-1 =
// node skipped).  Same convention as spoa::Alignment.
using AlignmentPath = std::vector<std::pair<int32_t, int32_t>>;

class PoaGraph {
  public:
    std::vector<Node> nodes;
    std::vector<Edge> edges;

    int32_t add_node(char base, int32_t anchor) {
        nodes.push_back(Node{base, anchor});
        return static_cast<int32_t>(nodes.size()) - 1;
    }

    void add_edge(int32_t u, int32_t v, int64_t w) {
        for (int32_t e : nodes[u].out_edges) {
            if (edges[e].to == v) {
                edges[e].weight += w;
                return;
            }
        }
        edges.push_back(Edge{u, v, w});
        int32_t e = static_cast<int32_t>(edges.size()) - 1;
        nodes[u].out_edges.push_back(e);
        nodes[v].in_edges.push_back(e);
    }

    // Kahn topological order over a node subset (subset[v] true).
    std::vector<int32_t> topo_order(const std::vector<uint8_t>& subset) const {
        std::vector<int32_t> indeg(nodes.size(), 0), order;
        order.reserve(nodes.size());
        for (size_t v = 0; v < nodes.size(); ++v) {
            if (!subset[v]) continue;
            int32_t d = 0;
            for (int32_t e : nodes[v].in_edges) {
                if (subset[edges[e].from]) ++d;
            }
            indeg[v] = d;
            if (d == 0) order.push_back(static_cast<int32_t>(v));
        }
        // process in ascending id for determinism
        std::vector<int32_t> queue = order;
        std::make_heap(queue.begin(), queue.end(), std::greater<int32_t>());
        order.clear();
        while (!queue.empty()) {
            std::pop_heap(queue.begin(), queue.end(), std::greater<int32_t>());
            int32_t v = queue.back();
            queue.pop_back();
            order.push_back(v);
            for (int32_t e : nodes[v].out_edges) {
                int32_t u = edges[e].to;
                if (!subset[u]) continue;
                if (--indeg[u] == 0) {
                    queue.push_back(u);
                    std::push_heap(queue.begin(), queue.end(),
                                   std::greater<int32_t>());
                }
            }
        }
        return order;
    }

    // Global NW of seq vs the subgraph induced by `subset`.
    AlignmentPath align(const char* seq, int32_t m,
                        const std::vector<uint8_t>& subset,
                        int32_t match, int32_t mismatch, int32_t gap) const {
        std::vector<int32_t> order = topo_order(subset);
        const int32_t rows = static_cast<int32_t>(order.size());
        std::vector<int32_t> rank(nodes.size(), -1);
        for (int32_t r = 0; r < rows; ++r) rank[order[r]] = r;

        const int64_t stride = m + 1;
        std::vector<int32_t> H(static_cast<size_t>(rows + 1) * stride,
                               kNegInf);
        // virtual start row
        for (int32_t j = 0; j <= m; ++j) H[j] = j * gap;

        // per row: predecessors within the subset (row indices, 0=virtual)
        std::vector<std::vector<int32_t>> pred_rows(rows);
        for (int32_t r = 0; r < rows; ++r) {
            const Node& node = nodes[order[r]];
            for (int32_t e : node.in_edges) {
                int32_t u = edges[e].from;
                if (rank[u] >= 0) pred_rows[r].push_back(rank[u] + 1);
            }
            if (pred_rows[r].empty()) pred_rows[r].push_back(0);
        }

        for (int32_t r = 0; r < rows; ++r) {
            const Node& node = nodes[order[r]];
            int32_t* row = &H[static_cast<size_t>(r + 1) * stride];
            int32_t best0 = kNegInf;
            for (int32_t pr : pred_rows[r]) {
                best0 = std::max(best0,
                                 H[static_cast<size_t>(pr) * stride] + gap);
            }
            row[0] = best0;
            for (int32_t pi = 0; pi < (int32_t)pred_rows[r].size(); ++pi) {
                const int32_t* prow =
                    &H[static_cast<size_t>(pred_rows[r][pi]) * stride];
                if (pi == 0) {
                    for (int32_t j = 1; j <= m; ++j) {
                        int32_t diag = prow[j - 1] +
                            (node.base == seq[j - 1] ? match : mismatch);
                        int32_t vert = prow[j] + gap;
                        row[j] = std::max(diag, vert);
                    }
                } else {
                    for (int32_t j = 1; j <= m; ++j) {
                        int32_t diag = prow[j - 1] +
                            (node.base == seq[j - 1] ? match : mismatch);
                        int32_t vert = prow[j] + gap;
                        int32_t cand = std::max(diag, vert);
                        if (cand > row[j]) row[j] = cand;
                    }
                }
            }
            for (int32_t j = 1; j <= m; ++j) {
                int32_t horiz = row[j - 1] + gap;
                if (horiz > row[j]) row[j] = horiz;
            }
        }

        // end: best sink (no out-edges within subset) at column m
        int32_t best_row = 0, best_score = H[m];  // virtual row if no rows
        bool found_sink = false;
        for (int32_t r = 0; r < rows; ++r) {
            const Node& node = nodes[order[r]];
            bool sink = true;
            for (int32_t e : node.out_edges) {
                if (rank[edges[e].to] >= 0) { sink = false; break; }
            }
            if (!sink) continue;
            int32_t s = H[static_cast<size_t>(r + 1) * stride + m];
            if (!found_sink || s > best_score) {
                best_score = s;
                best_row = r + 1;
                found_sink = true;
            }
        }

        // traceback (recompute candidate scores; integer-exact)
        AlignmentPath path;
        path.reserve(rows + m);
        int32_t r = best_row, j = m;
        while (r > 0 || j > 0) {
            int32_t cur = H[static_cast<size_t>(r) * stride + j];
            bool moved = false;
            if (r > 0) {
                const Node& node = nodes[order[r - 1]];
                for (int32_t pr : pred_rows[r - 1]) {
                    const int32_t* prow = &H[static_cast<size_t>(pr) * stride];
                    if (j > 0 && cur == prow[j - 1] +
                            (node.base == seq[j - 1] ? match : mismatch)) {
                        path.emplace_back(order[r - 1], j - 1);
                        r = pr;
                        --j;
                        moved = true;
                        break;
                    }
                    if (cur == prow[j] + gap) {
                        path.emplace_back(order[r - 1], -1);
                        r = pr;
                        moved = true;
                        break;
                    }
                }
            }
            if (!moved) {
                // horizontal: seq char consumed without a node
                path.emplace_back(-1, j - 1);
                --j;
            }
        }
        std::reverse(path.begin(), path.end());
        return path;
    }

    // Incorporate an aligned sequence (spoa Graph::add_alignment).
    void add_alignment(const AlignmentPath& path, const char* seq, int32_t m,
                       const int32_t* weights, int32_t begin_anchor) {
        AlignmentPath full;
        const AlignmentPath* use = &path;
        const bool initial = path.empty();
        if (initial) {
            full.reserve(m);
            for (int32_t j = 0; j < m; ++j) full.emplace_back(-1, j);
            use = &full;
        }
        int32_t prev = -1, prev_j = -1;
        for (const auto& [node_id, j] : *use) {
            if (j == -1) continue;  // graph node skipped by this sequence
            char c = seq[j];
            int32_t target;
            if (node_id == -1) {
                // the initial (backbone) chain defines the anchor system:
                // node anchor == backbone position; later insertions hang
                // off the previous node's anchor
                int32_t anchor = initial ? begin_anchor + j
                                 : prev == -1 ? begin_anchor
                                              : nodes[prev].anchor;
                target = add_node(c, anchor);
            } else if (nodes[node_id].base == c) {
                target = node_id;
            } else {
                target = -1;
                for (int32_t a : nodes[node_id].aligned) {
                    if (nodes[a].base == c) { target = a; break; }
                }
                if (target == -1) {
                    target = add_node(c, nodes[node_id].anchor);
                    std::vector<int32_t> group = nodes[node_id].aligned;
                    group.push_back(node_id);
                    for (int32_t a : group) {
                        nodes[a].aligned.push_back(target);
                        nodes[target].aligned.push_back(a);
                    }
                }
            }
            ++nodes[target].nseqs;
            if (prev != -1) {
                add_edge(prev, target, static_cast<int64_t>(weights[prev_j]) +
                                       weights[j]);
            }
            prev = target;
            prev_j = j;
        }
    }

    // Heaviest-bundle consensus; fills coverages with per-base nseqs.
    std::vector<int32_t> consensus_path() const {
        std::vector<uint8_t> all(nodes.size(), 1);
        std::vector<int32_t> order = topo_order(all);
        std::vector<int64_t> score(nodes.size(), 0);
        std::vector<int32_t> pred(nodes.size(), -1);
        for (int32_t v : order) {
            int64_t best_w = -1;
            int32_t best_u = -1;
            for (int32_t e : nodes[v].in_edges) {
                const Edge& ed = edges[e];
                if (ed.weight > best_w ||
                    (ed.weight == best_w && best_u >= 0 &&
                     score[ed.from] > score[best_u])) {
                    best_w = ed.weight;
                    best_u = ed.from;
                }
            }
            if (best_u >= 0) {
                pred[v] = best_u;
                score[v] = score[best_u] + best_w;
            }
        }
        int32_t best_sink = -1;
        for (int32_t v : order) {
            if (!nodes[v].out_edges.empty()) continue;
            if (best_sink == -1 || score[v] > score[best_sink]) {
                best_sink = v;
            }
        }
        std::vector<int32_t> path;
        for (int32_t v = best_sink; v != -1; v = pred[v]) path.push_back(v);
        std::reverse(path.begin(), path.end());
        return path;
    }
};

inline void make_weights(const char* qual, uint8_t has_qual, int32_t n,
                  std::vector<int32_t>& w) {
    w.resize(n);
    if (has_qual) {
        for (int32_t i = 0; i < n; ++i) {
            w[i] = static_cast<int32_t>(qual[i]) - 33;
        }
    } else {
        std::fill(w.begin(), w.end(), 1);
    }
}

}  // namespace racon_native
