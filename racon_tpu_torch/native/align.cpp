// Global Levenshtein alignment with traceback -> CIGAR, plus a
// score-only edit distance.  This is the CPU fallback / accuracy-oracle
// aligner re-providing what racon gets from edlib
// (reference: vendor/edlib, call site src/overlap.cpp:205-224): global
// (NW) alignment of an overlap's query span vs target span, emitting a
// standard CIGAR where 'M' covers both matches and mismatches, 'I'
// consumes query and 'D' consumes target.
//
// Primary algorithm: furthest-reaching edit wavefronts (Landau-Vishkin /
// WFA for unit costs).  L[e][d] is the furthest query row i whose cell
// (i, i+d) on diagonal d = j - i costs exactly e after sliding along
// exact matches; time and memory are O(N + D^2) for distance D, so a
// typical 10 kb ONT overlap (D ~ 500-2000) costs ~1-4 M steps instead of
// the ~10^8 cells of a banded DP.  The full wavefront history is kept
// for direct traceback; if D^2 would exceed a memory cap the aligner
// falls back to the original Ukkonen banded DP with band doubling
// (kept below), which is O((|q|+|t|) * k) time but bounded memory.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int32_t kInf = INT32_MAX / 4;
constexpr int32_t kNeg = INT32_MIN / 4;

// Run-length encode a reversed op-char string into a CIGAR.
std::string rle_cigar(const std::string& ops) {
    std::string cigar;
    cigar.reserve(ops.size() / 8 + 8);
    for (size_t p = ops.size(); p > 0;) {
        char op = ops[p - 1];
        size_t run = 0;
        while (p > 0 && ops[p - 1] == op) { --p; ++run; }
        cigar += std::to_string(run);
        cigar.push_back(op);
    }
    return cigar;
}

// Extend exact matches along diagonal d starting from query row i
// (word-at-a-time, the LCP "slide" step of the wavefront recurrence).
inline int32_t slide(const char* q, int32_t qn, const char* t, int32_t tn,
                     int32_t i, int32_t d) {
    int32_t j = i + d;
    while (i + 8 <= qn && j + 8 <= tn) {
        uint64_t a, b;
        std::memcpy(&a, q + i, 8);
        std::memcpy(&b, t + j, 8);
        uint64_t x = a ^ b;
        if (x) return i + (__builtin_ctzll(x) >> 3);
        i += 8;
        j += 8;
    }
    while (i < qn && j < tn && q[i] == t[j]) { ++i; ++j; }
    return i;
}

// Wavefront e lives at hist[e*e .. e*e + 2e], entry d at hist[e*e + d + e].
inline size_t wf_base(int32_t e) {
    return static_cast<size_t>(e) * static_cast<size_t>(e);
}

// Compute the best pre-slide row for wavefront (e, d) from wavefront
// e-1 (stored at prev).  Candidates: deletion keeps i (from d-1),
// substitution and insertion advance i (from d and d+1).  Invalid or
// out-of-matrix candidates yield kNeg.
inline int32_t wf_candidate(const int32_t* prev, int32_t e1, int32_t d,
                            int32_t qn, int32_t tn) {
    int32_t best = kNeg;
    if (d - 1 >= -e1 && d - 1 <= e1) {       // deletion: (i, j-1)
        int32_t v = prev[d - 1 + e1];
        if (v > kNeg && v + d <= tn && v >= best) best = v;
    }
    if (d >= -e1 && d <= e1) {               // substitution: (i-1, j-1)
        int32_t v = prev[d + e1];
        if (v > kNeg && v + 1 <= qn && v + 1 + d <= tn && v + 1 > best)
            best = v + 1;
    }
    if (d + 1 >= -e1 && d + 1 <= e1) {       // insertion: (i-1, j)
        int32_t v = prev[d + 1 + e1];
        if (v > kNeg && v + 1 <= qn && v + 1 > best) best = v + 1;
    }
    return best;
}

// Full-history wavefront alignment.  On success fills *cigar and
// *distance and returns true; returns false if the history would exceed
// max_entries (caller falls back to the banded DP).
bool wfa_align(const char* q, int32_t qn, const char* t, int32_t tn,
               size_t max_entries, std::string* cigar,
               int32_t* distance) {
    const int32_t final_d = tn - qn;
    std::vector<int32_t> hist;
    hist.reserve(4096);
    hist.push_back(slide(q, qn, t, tn, 0, 0));
    int32_t dist = -1;
    if (final_d == 0 && hist[0] >= qn) {
        dist = 0;
    } else {
        for (int32_t e = 1;; ++e) {
            size_t need = wf_base(e + 1);
            if (need > max_entries) return false;
            hist.resize(need, kNeg);
            // take pointers only after the resize (it may reallocate)
            int32_t* cur = hist.data() + wf_base(e);
            const int32_t* prev = hist.data() + wf_base(e - 1);
            const int32_t dlo = std::max(-e, -qn);
            const int32_t dhi = std::min(e, tn);
            for (int32_t d = dlo; d <= dhi; ++d) {
                int32_t i0 = wf_candidate(prev, e - 1, d, qn, tn);
                if (i0 <= kNeg) continue;
                cur[d + e] = slide(q, qn, t, tn, i0, d);
            }
            if (final_d >= -e && final_d <= e &&
                cur[final_d + e] >= qn) {
                dist = e;
                break;
            }
        }
    }

    // Traceback: walk wavefronts backwards, re-deriving each pre-slide
    // row with the same candidate rule as the forward pass.
    std::string ops;  // reversed op chars
    ops.reserve(static_cast<size_t>(qn) + 16);
    int32_t e = dist, d = final_d;
    int32_t i = hist[wf_base(e) + d + e];
    while (e > 0) {
        const int32_t* prev = hist.data() + wf_base(e - 1);
        const int32_t e1 = e - 1;
        int32_t i0 = wf_candidate(prev, e1, d, qn, tn);
        ops.append(static_cast<size_t>(i - i0), 'M');  // slid matches
        // which predecessor attained i0? (same preference as forward)
        int32_t ins_v = (d + 1 >= -e1 && d + 1 <= e1) ? prev[d + 1 + e1]
                                                      : kNeg;
        int32_t sub_v = (d >= -e1 && d <= e1) ? prev[d + e1] : kNeg;
        if (ins_v > kNeg && ins_v + 1 <= qn && ins_v + 1 == i0) {
            ops.push_back('I');
            i = i0 - 1;
            ++d;
        } else if (sub_v > kNeg && sub_v + 1 <= qn &&
                   sub_v + 1 + d <= tn && sub_v + 1 == i0) {
            ops.push_back('M');  // mismatch
            i = i0 - 1;
        } else {
            ops.push_back('D');
            i = i0;
            --d;
        }
        --e;
    }
    ops.append(static_cast<size_t>(i), 'M');  // e == 0 slide from origin
    *cigar = rle_cigar(ops);
    *distance = dist;
    return true;
}

// Score-only wavefront distance with two rolling wavefronts -- O(D)
// memory, no cap needed.
int32_t wfa_distance(const char* q, int32_t qn, const char* t, int32_t tn) {
    const int32_t final_d = tn - qn;
    std::vector<int32_t> prev(1, slide(q, qn, t, tn, 0, 0)), cur;
    if (final_d == 0 && prev[0] >= qn) return 0;
    for (int32_t e = 1;; ++e) {
        cur.assign(2 * static_cast<size_t>(e) + 1, kNeg);
        const int32_t dlo = std::max(-e, -qn);
        const int32_t dhi = std::min(e, tn);
        for (int32_t d = dlo; d <= dhi; ++d) {
            int32_t i0 = wf_candidate(prev.data(), e - 1, d, qn, tn);
            if (i0 <= kNeg) continue;
            cur[d + e] = slide(q, qn, t, tn, i0, d);
        }
        if (final_d >= -e && final_d <= e && cur[final_d + e] >= qn)
            return e;
        std::swap(prev, cur);
    }
}

enum Dir : uint8_t { DIAG = 0, DEL = 1, INS = 2, NONE = 3 };
// DIAG: from (i-1, j-1)  -> 'M'
// DEL : from (i,   j-1)  -> 'D' (consumes target)
// INS : from (i-1, j  )  -> 'I' (consumes query)

struct BandedResult {
    int32_t distance = -1;
    bool within_band = false;
};

// One banded pass.  dirs (if non-null) receives 2-bit packed directions,
// rows of width `band_w` cells starting at diagonal `dmin`.
BandedResult banded_pass(const char* q, int32_t qn, const char* t,
                         int32_t tn, int32_t k, std::vector<uint8_t>* dirs,
                         int32_t* out_dmin, int32_t* out_band_w) {
    const int32_t d_lo = std::min(0, tn - qn) - k;
    const int32_t d_hi = std::max(0, tn - qn) + k;
    const int32_t band_w = d_hi - d_lo + 1;
    *out_dmin = d_lo;
    *out_band_w = band_w;

    std::vector<int32_t> prev(band_w, kInf), cur(band_w, kInf);
    if (dirs) {
        dirs->assign(static_cast<size_t>(qn + 1) *
                         ((band_w + 3) / 4), 0xFF);
    }
    auto set_dir = [&](int32_t i, int32_t b, Dir d) {
        if (!dirs) return;
        size_t idx = static_cast<size_t>(i) * ((band_w + 3) / 4) + b / 4;
        int shift = (b % 4) * 2;
        (*dirs)[idx] = ((*dirs)[idx] & ~(uint8_t(3) << shift)) |
                       (uint8_t(d) << shift);
    };

    // row 0: (0, j), j = d - 0
    for (int32_t b = 0; b < band_w; ++b) {
        int32_t j = d_lo + b;
        if (j < 0 || j > tn) continue;
        prev[b] = j;
        set_dir(0, b, j == 0 ? NONE : DEL);
    }

    for (int32_t i = 1; i <= qn; ++i) {
        std::fill(cur.begin(), cur.end(), kInf);
        for (int32_t b = 0; b < band_w; ++b) {
            int32_t j = i + d_lo + b;
            if (j < 0 || j > tn) continue;
            int32_t best = kInf;
            Dir dir = NONE;
            if (j > 0) {
                // (i-1, j-1) is the same band index b in row i-1
                int32_t v = prev[b];
                if (v < kInf) {
                    int32_t c = v + (q[i - 1] == t[j - 1] ? 0 : 1);
                    if (c < best) { best = c; dir = DIAG; }
                }
            }
            if (b + 1 < band_w) {  // (i-1, j) is band index b+1 in row i-1
                int32_t v = prev[b + 1];
                if (v < kInf && v + 1 < best) { best = v + 1; dir = INS; }
            }
            if (b > 0) {           // (i, j-1) is band index b-1, same row
                int32_t v = cur[b - 1];
                if (v < kInf && v + 1 < best) { best = v + 1; dir = DEL; }
            }
            cur[b] = best;
            if (dir != NONE) set_dir(i, b, dir);
        }
        std::swap(prev, cur);
    }

    int32_t end_b = tn - qn - d_lo;
    BandedResult r;
    if (end_b >= 0 && end_b < band_w && prev[end_b] < kInf) {
        r.distance = prev[end_b];
        r.within_band = r.distance <= k ||
                        (d_hi - d_lo >= qn + tn);  // band covers everything
    }
    return r;
}

std::string traceback_cigar(int32_t qn, int32_t tn,
                            const std::vector<uint8_t>& dirs,
                            int32_t dmin, int32_t band_w) {
    auto get_dir = [&](int32_t i, int32_t j) -> Dir {
        int32_t b = j - i - dmin;
        size_t idx = static_cast<size_t>(i) * ((band_w + 3) / 4) + b / 4;
        int shift = (b % 4) * 2;
        return Dir((dirs[idx] >> shift) & 3);
    };
    std::string ops;  // reversed op chars
    ops.reserve(qn + tn);
    int32_t i = qn, j = tn;
    while (i > 0 || j > 0) {
        Dir d = get_dir(i, j);
        switch (d) {
            case DIAG: ops.push_back('M'); --i; --j; break;
            case INS:  ops.push_back('I'); --i; break;
            case DEL:  ops.push_back('D'); --j; break;
            default:   return std::string();  // corrupt band; caller retries
        }
    }
    return rle_cigar(ops);
}

}  // namespace

extern "C" {

// Score-only global edit distance (test oracle; the reference's tests use
// edlib's default config the same way, test/racon_test.cpp:16-25).
int32_t rt_edit_distance(const char* q, int32_t qn, const char* t,
                         int32_t tn) {
    if (qn == 0) return tn;
    if (tn == 0) return qn;
    // O(N + D^2) wavefront distance, O(D) memory
    return wfa_distance(q, qn, t, tn);
}

// Global alignment with CIGAR.  Returns the CIGAR length written (excl.
// NUL), or -1 if cigar_cap is too small, or -2 on internal failure.
int64_t rt_align(const char* q, int32_t qn, const char* t, int32_t tn,
                 char* cigar_out, int64_t cigar_cap, int32_t* distance_out) {
    if (qn == 0 || tn == 0) {
        std::string cigar;
        if (qn > 0) cigar = std::to_string(qn) + "I";
        else if (tn > 0) cigar = std::to_string(tn) + "D";
        if ((int64_t)cigar.size() + 1 > cigar_cap) return -1;
        std::memcpy(cigar_out, cigar.c_str(), cigar.size() + 1);
        if (distance_out) *distance_out = qn + tn;
        return (int64_t)cigar.size();
    }
    // Primary: wavefront alignment, O(N + D^2).  History cap 256 MB of
    // int32 entries (D up to ~8k, comfortably above real ONT overlap
    // distances) -- the cap is PER CALL, so keep it modest: pool
    // threads align concurrently and each may grow toward it before
    // falling back.  RACON_TPU_TORCH_WFA_MAX_MB overrides.
    size_t max_mb = 256;
    if (const char* env = std::getenv("RACON_TPU_TORCH_WFA_MAX_MB")) {
        long v = std::atol(env);
        if (v > 0) max_mb = static_cast<size_t>(v);
    }
    {
        std::string cigar;
        int32_t dist = 0;
        if (wfa_align(q, qn, t, tn, max_mb * (1024 * 1024 / 4), &cigar,
                      &dist)) {
            if ((int64_t)cigar.size() + 1 > cigar_cap) return -1;
            std::memcpy(cigar_out, cigar.c_str(), cigar.size() + 1);
            if (distance_out) *distance_out = dist;
            return (int64_t)cigar.size();
        }
    }
    // Fallback for distances past the cap: banded DP with band doubling.
    int32_t k = std::max<int32_t>(64, std::abs(tn - qn) / 8 + 16);
    const int32_t k_cap = qn + tn;
    while (true) {
        std::vector<uint8_t> dirs;
        int32_t dmin = 0, band_w = 0;
        BandedResult r = banded_pass(q, qn, t, tn, k, &dirs, &dmin, &band_w);
        if (r.distance >= 0 && r.within_band) {
            std::string cigar = traceback_cigar(qn, tn, dirs, dmin,
                                                band_w);
            if (!cigar.empty()) {
                if ((int64_t)cigar.size() + 1 > cigar_cap) return -1;
                std::memcpy(cigar_out, cigar.c_str(), cigar.size() + 1);
                if (distance_out) *distance_out = r.distance;
                return (int64_t)cigar.size();
            }
        }
        if (k >= k_cap) return -2;
        k = std::min(k * 2, k_cap);
    }
}

// CIGAR string -> runs ("MIDNSHP=X" code indices), with the semantics of
// a findall of (\d+)([MIDNSHP=X]): every digit run directly followed by
// an op letter is one run, anything else is skipped.  Returns the number
// of runs written, or -1 if cap is too small.
int64_t rt_cigar_runs(const char* cigar, int64_t n, int64_t* lengths,
                      int64_t* codes, int64_t cap) {
    static const char kOps[] = "MIDNSHP=X";
    int64_t out = 0;
    int64_t p = 0;
    while (p < n) {
        if (cigar[p] < '0' || cigar[p] > '9') { ++p; continue; }
        int64_t v = 0;
        while (p < n && cigar[p] >= '0' && cigar[p] <= '9') {
            v = v * 10 + (cigar[p] - '0');
            ++p;
        }
        if (p == n) break;
        const char* op = std::strchr(kOps, cigar[p]);
        if (op == nullptr || *op == '\0') continue;
        if (out == cap) return -1;
        lengths[out] = v;
        codes[out] = op - kOps;
        ++out;
        ++p;
    }
    return out;
}

// Window breaking points of n alignments (reference:
// src/overlap.cpp:226-292).  Alignment i is the runs [run_off[i],
// run_off[i + 1]) of (lengths, codes) in "MIDNSHP=X" indices: M = X
// advance both sequences, I the query, D and N the target, S H P
// neither.  Its first target column is t_begin[i] and its first query
// column q_start[i].  A column that advances the target to t with
// (t + 1) % w == 0 and t < t_end - 1, or to t_end - 1, closes a segment;
// for every segment that holds a match column, the (t, q) of its first
// match and one past its last match are written as two rows of pts
// (int64 pairs) from row 2 * seg_off[i] on, and n_out[i] counts the
// rows.  Match columns after the last boundary belong to no segment.
// Returns 0, -1 if alignment i has more segments than seg_off[i + 1] -
// seg_off[i], or -2 on a code outside 0..8.
int64_t rt_breaking_points(int64_t n, const int64_t* run_off,
                           const int64_t* lengths, const int64_t* codes,
                           const int64_t* t_begin, const int64_t* t_end,
                           const int64_t* q_start, int64_t w,
                           const int64_t* seg_off, int64_t* pts,
                           int64_t* n_out) {
    //                             M  I  D  N  S  H  P  =  X
    static const bool kAdvT[9] = {1, 0, 1, 1, 0, 0, 0, 1, 1};
    static const bool kAdvQ[9] = {1, 1, 0, 0, 0, 0, 0, 1, 1};
    for (int64_t i = 0; i < n; ++i) {
        int64_t t = t_begin[i] - 1;     // target column last advanced to
        int64_t q = q_start[i] - 1;     // query column last advanced to
        const int64_t last_t = t_end[i] - 1;
        int64_t seg = seg_off[i];
        bool has = false;               // the open segment holds a match
        int64_t ft = 0, fq = 0, lt = 0, lq = 0;
        n_out[i] = 0;
        for (int64_t r = run_off[i]; r < run_off[i + 1]; ++r) {
            const int64_t c = codes[r];
            if (c < 0 || c > 8) return -2;
            int64_t left = lengths[r];
            if (!kAdvT[c]) {            // I, or S H P
                if (kAdvQ[c]) q += left;
                continue;
            }
            const bool match = kAdvQ[c];
            // the run's columns reach targets t + 1 .. t + left: walk
            // them boundary to boundary
            while (left > 0) {
                const int64_t t0 = t + 1;
                // first target >= t0 with (b + 1) % w == 0; the last
                // column closes a segment too
                int64_t b = ((t0 + w) / w) * w - 1;
                if (b >= last_t) b = last_t;
                const bool closes = b >= t0 && b - t0 < left;
                const int64_t take = closes ? b - t0 + 1 : left;
                if (match) {
                    if (!has) { ft = t0; fq = q + 1; has = true; }
                    lt = t0 + take - 1;
                    lq = q + take;
                    q += take;
                }
                t += take;
                left -= take;
                if (closes && has) {
                    if (seg >= seg_off[i + 1]) return -1;
                    pts[4 * seg + 0] = ft;
                    pts[4 * seg + 1] = fq;
                    pts[4 * seg + 2] = lt + 1;
                    pts[4 * seg + 3] = lq + 1;
                    ++seg;
                    n_out[i] += 2;
                }
                if (closes) has = false;
            }
        }
    }
    return 0;
}

}  // extern "C"
