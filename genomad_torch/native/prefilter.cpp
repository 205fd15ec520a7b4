// Native prefilter: query k-mer lookup + ungapped diagonal extension.
//
// C++ counterpart of genomad_torch.ops.protein_search.prefilter_query — the
// host-side stage that replaces MMseqs2's C++ prefilter (reference chain:
// genomad/mmseqs2.py:76-96, `mmseqs prefilter -k 5 --min-ungapped-score 25
// --max-seqs 10000000`). The device-side alignment runs on the GPU; this stage
// is a sparse integer workload (inverted-index lookups), hence native CPU.
//
// Algorithm:
//   1. each query 5-mer expands into its similar-k-mer list (score vs the
//      query window >= kmer_thr under the substitution matrix — MMseqs2's
//      ``-s`` semantics). The expansion is generated from PRECOMPUTED
//      2-mer x 3-mer product tables built once per threshold: for a query
//      k-mer split into prefix(2)+suffix(3), the similar 5-mers are the
//      pairs (x2, x3) with s2(x2) + s3(x3) >= thr, enumerated from the two
//      score-sorted sub-lists in output-sensitive time. This replaces the
//      per-query-position branch-and-bound DFS (which recomputed the same
//      expansion for every occurrence and dominated the prefilter).
//   2. every expanded k-mer is looked up in the direct offset table over
//      the 20^5 code space; each index entry becomes a (profile, diagonal)
//      hit processed in O(1) against per-profile EPOCH-STAMPED diagonal
//      tables (last_epoch/last_diag, ~2 MB at 227k profiles — cache
//      resident). A hit whose profile's stamped diagonal matches is a
//      double k-mer match (MMseqs2's double-match criterion) and pushes a
//      candidate; the stamp tables replace the per-query radix sort of the
//      full hit vector (~1M keys/query at production DB scale), which
//      dominated the prefilter. Like MMseqs2's QueryMatcher, the table
//      keeps only the LAST diagonal per profile, so interleaved-diagonal
//      hit patterns can miss a double match — the same approximation the
//      reference engine ships with (mmseqs2 prefiltering/QueryMatcher.cpp
//      diagonalPrev). Exact-k-mer mode (no expansion) needs one hit per
//      diagonal, so every first hit is a candidate and no approximation
//      arises;
//   3. candidates are ordered by profile id with a cheap 2-pass LSD radix
//      (a comparison sort of ~10^5 double-hit diagonals cost more than
//      the scan itself; the radix is ~2 ms and turns the scan into an
//      ascending-address sweep of the PSSM — DRAM row-buffer and
//      hardware-prefetcher friendly, measured +35% over insertion-order
//      scanning), then stream through Kadane's maximal-subarray scan
//      with a deep lookahead prefetch. Per-profile best scores live in
//      an epoch-stamped (epoch << 32 | f32 bits) table: non-negative f32
//      scores compare correctly as uint32, so one 8-byte slot per
//      profile carries both the stamp and the running best. When the
//      database's PSSM is integral (real MMseqs2/geNomad profile scores
//      are small integers) the scan reads an int8 copy of the PSSM —
//      20 B per position instead of 80 B, i.e. 4x less random DRAM
//      traffic — with int32 accumulation, which is EXACT (bit-equal to
//      the f32 scan) for integral scores, 16 residues per AVX-512
//      gather (memory-level parallelism a scalar byte loop cannot
//      express on a latency-bound access pattern).
//   4. profiles whose best diagonal reaches min_ungapped_score are
//      emitted SORTED BY SCORE DESCENDING (id ascending on ties) — the
//      prefilter result order MMseqs2 feeds its aligner, which stage 2
//      relies on for --max-rejected semantics.
//
// Plain C ABI for ctypes; no Python headers required.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

constexpr int K = 5;
constexpr int NAA = 20;
constexpr int N2 = NAA * NAA;            // 400
constexpr int N3 = NAA * NAA * NAA;      // 8000
constexpr uint32_t DIAG_BITS = 21;       // diag + offset fits in 21 bits
constexpr uint32_t DIAG_OFF = 1u << 20;  // supports |diag| < 2^20
constexpr int G_MAX = 16;  // queries scanned jointly per group (measured
// sweep on the 227k DB: G=4 -> 50.7, 8 -> 57.4, 16 -> 59.7, 32 -> 47.7
// q/s — cross-query window locality grows to G=16, then group working
// sets and 2-thread work-unit imbalance take over)

// Runtime-tunable approximation knob (parsed per call, a few ns, so
// tools/prefilter_recall.py can toggle it between calls):
//   GENOMAD_PREFILTER_WINDOW (default 16): extension half-window around
//     the first double hit (see step 3 comment at the scan below); 0 =
//     full-diagonal scan. A round-4 PAIR_DIST cap (max query distance
//     between the two hits of a double hit) was REMOVED: measured at
//     227k scale it pruned only 0.2% of candidates (the last-diagonal
//     stamp already bounds pairing), cost ~1% candidate recall, and its
//     qpos field doubled the stamp-table entry — dropping it makes the
//     double-match criterion distance-uncapped exactly like MMseqs2's
//     and shrinks the hot tables to 4 B/profile (L2-resident at 227k).
struct Config {
    int64_t window;
};
Config config() {
    Config c{16};
    if (const char* v = std::getenv("GENOMAD_PREFILTER_WINDOW")) {
        long x = std::atol(v);
        c.window = x <= 0 ? (1ll << 40) : x;
    }
    return c;
}

// --- similar-k-mer product tables (one instance per threshold) -------------

struct ExpTables {
    float thr;
    // l2[c]: target 2-mers similar to query 2-mer c, sorted by score desc.
    std::vector<int32_t> l2_code;
    std::vector<float> l2_score;
    std::vector<int64_t> l2_off;  // N2 + 1
    // l3[c]: target 3-mers similar to query 3-mer c, sorted by score desc.
    std::vector<int32_t> l3_code;
    std::vector<float> l3_score;
    std::vector<int64_t> l3_off;  // N3 + 1
};

// Build the product tables for one (matrix, threshold). Pruning bounds:
// an l2 entry can participate iff s2 >= thr - max possible s3 (3*maxM);
// an l3 entry iff s3 >= thr - max possible s2 (2*maxM) — so every pair
// (x2, x3) with s2+s3 >= thr survives the pruning of both sub-lists.
ExpTables build_tables(const float* subst, float thr) {
    ExpTables t;
    t.thr = thr;
    float maxM = subst[0];
    for (int i = 0; i < NAA * NAA; ++i) maxM = std::max(maxM, subst[i]);
    const float prune2 = thr - 3.0f * maxM;
    const float prune3 = thr - 2.0f * maxM;

    t.l2_off.assign(N2 + 1, 0);
    {
        std::vector<std::pair<float, int32_t>> buf;
        std::vector<int32_t> codes;
        std::vector<float> scores;
        for (int c = 0; c < N2; ++c) {
            int a0 = c / NAA, a1 = c % NAA;
            buf.clear();
            for (int b0 = 0; b0 < NAA; ++b0) {
                float s0 = subst[a0 * NAA + b0];
                for (int b1 = 0; b1 < NAA; ++b1) {
                    float s = s0 + subst[a1 * NAA + b1];
                    if (s >= prune2) buf.emplace_back(s, b0 * NAA + b1);
                }
            }
            std::sort(buf.begin(), buf.end(), [](auto& x, auto& y) {
                return x.first != y.first ? x.first > y.first
                                          : x.second < y.second;
            });
            for (auto& [s, code] : buf) {
                codes.push_back(code);
                scores.push_back(s);
            }
            t.l2_off[c + 1] = static_cast<int64_t>(codes.size());
        }
        t.l2_code = std::move(codes);
        t.l2_score = std::move(scores);
    }

    // l3: 8000 independent lists; parallelize the enumeration.
    unsigned n_workers = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::vector<int32_t>> codes_per(N3);
    std::vector<std::vector<float>> scores_per(N3);
    std::atomic<int> next{0};
    auto worker = [&]() {
        std::vector<std::pair<float, int32_t>> buf;
        for (;;) {
            int c = next.fetch_add(1);
            if (c >= N3) break;
            int a0 = c / N2, a1 = (c / NAA) % NAA, a2 = c % NAA;
            buf.clear();
            for (int b0 = 0; b0 < NAA; ++b0) {
                float s0 = subst[a0 * NAA + b0];
                if (s0 + 2.0f * maxM < prune3) continue;
                for (int b1 = 0; b1 < NAA; ++b1) {
                    float s1 = s0 + subst[a1 * NAA + b1];
                    if (s1 + maxM < prune3) continue;
                    for (int b2 = 0; b2 < NAA; ++b2) {
                        float s = s1 + subst[a2 * NAA + b2];
                        if (s >= prune3)
                            buf.emplace_back(s, (b0 * NAA + b1) * NAA + b2);
                    }
                }
            }
            std::sort(buf.begin(), buf.end(), [](auto& x, auto& y) {
                return x.first != y.first ? x.first > y.first
                                          : x.second < y.second;
            });
            codes_per[c].reserve(buf.size());
            scores_per[c].reserve(buf.size());
            for (auto& [s, code] : buf) {
                codes_per[c].push_back(code);
                scores_per[c].push_back(s);
            }
        }
    };
    std::vector<std::thread> threads;
    for (unsigned i = 1; i < n_workers; ++i) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();

    t.l3_off.assign(N3 + 1, 0);
    int64_t total = 0;
    for (int c = 0; c < N3; ++c) {
        total += static_cast<int64_t>(codes_per[c].size());
        t.l3_off[c + 1] = total;
    }
    t.l3_code.reserve(total);
    t.l3_score.reserve(total);
    for (int c = 0; c < N3; ++c) {
        t.l3_code.insert(t.l3_code.end(), codes_per[c].begin(),
                         codes_per[c].end());
        t.l3_score.insert(t.l3_score.end(), scores_per[c].begin(),
                          scores_per[c].end());
    }
    return t;
}

// Process-lifetime cache: one table set per (threshold, matrix checksum).
const ExpTables* get_tables(const float* subst, float thr) {
    static std::mutex mu;
    static std::map<std::pair<uint64_t, float>, ExpTables> cache;
    uint64_t csum = 0;
    for (int i = 0; i < NAA * NAA; ++i) {
        uint32_t bits;
        std::memcpy(&bits, subst + i, 4);
        csum = csum * 1099511628211ull + bits;
    }
    std::lock_guard<std::mutex> lock(mu);
    auto key = std::make_pair(csum, thr);
    auto it = cache.find(key);
    if (it == cache.end())
        it = cache.emplace(key, build_tables(subst, thr)).first;
    return &it->second;
}

// --- optional stage stats (GENOMAD_PREFILTER_STATS=1) ----------------------

struct Stats {
    std::atomic<int64_t> hits{0};
    std::atomic<int64_t> codes{0};
    std::atomic<int64_t> cands{0};
    std::atomic<int64_t> enum_ns{0};
    std::atomic<int64_t> scan_ns{0};
    std::atomic<int64_t> emit_ns{0};
};
Stats g_stats;
bool stats_enabled() {
    static const bool on = [] {
        const char* v = std::getenv("GENOMAD_PREFILTER_STATS");
        return v && v[0] == '1';
    }();
    return on;
}

inline uint32_t f32_bits(float f) {
    uint32_t u;
    std::memcpy(&u, &f, 4);
    return u;
}
inline float bits_f32(uint32_t u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

// --- per-worker scratch (reused across queries) ----------------------------

struct Scratch {
    // per-profile stamp tables, PACKED to 4 B each so both hot tables
    // (0.9 MB apiece at 227k profiles) stay L2-resident — the per-hit
    // random stamp access is the enum loop's dominant cost:
    //   last[p] = epoch(11b) << 21 | udiag(21b)
    //     — a repeat of the same value is the second hit on that
    //       diagonal (MMseqs2's distance-uncapped double-match
    //       criterion);
    //   cand_mark[p] = same packing
    //     — deduplicates candidate pushes (only the FIRST double hit of a
    //       (profile, diagonal) pushes; without this a true homologous
    //       diagonal with a run of n matches pushes n-1 duplicates);
    //   best[p] = epoch << 32 | f32 bits of the best diagonal score
    //     — Kadane scores are >= 0, whose f32 bit patterns order
    //       correctly as uint32, so stamp + running max share one slot.
    std::vector<uint32_t> last;
    std::vector<uint32_t> cand_mark;
    std::vector<uint64_t> best;  // [p * G_MAX + g], group-epoch stamped
    uint64_t epoch = 0;        // enum-table epoch (per query)
    uint64_t group_epoch = 0;  // best-table epoch (per group)
    // candidate key (profile << DIAG_BITS | udiag) + payload
    // (query-in-group << 24 | first-double-hit qpos)
    std::vector<std::pair<uint64_t, uint32_t>> cand;
    std::vector<int32_t> sel_ids_g[G_MAX];  // per-query threshold passers
    std::vector<std::pair<uint64_t, uint32_t>> cand_tmp;  // radix scratch
    std::vector<std::pair<float, int32_t>> selected;  // (score, profile)
    // per-query gather operands for the SIMD scan (int8 path):
    //   qidx[t] = t*20 + residue  (the within-diagonal byte offset)
    //   qvalid[t] = -1 for a scoring residue, 0 for unknown (score 0)
    std::vector<int32_t> qidx;
    std::vector<int32_t> qvalid;
    std::vector<int32_t> qbias;

    void ensure(int64_t n_profiles) {
        if (static_cast<int64_t>(last.size()) < n_profiles ||
            epoch >= (1u << 11) - 2 - G_MAX ||
            group_epoch >= 0xFFFFFFFEull) {
            last.assign(n_profiles, 0);
            cand_mark.assign(n_profiles, 0);
            best.assign(n_profiles * G_MAX, 0);
            epoch = 0;
            group_epoch = 0;
        }
    }
};

}  // namespace

extern "C" {

// Per-query view for group processing.
struct QueryView {
    const int64_t* codes;
    int64_t n_codes;
    const int8_t* residues;
    int64_t len;
    int32_t* out_profiles;
    float* out_scores;  // may be null
    // per-position integer composition-bias corrections (MMseqs2
    // --comp-bias-corr 1, computed host-side by blosum.comp_bias);
    // null = correction off. Added to diagonal-scan scores; the k-mer
    // expansion threshold drops by the k-window's bias sum (clamped at
    // the slack the tables were built with).
    const int32_t* bias;
};

// Core engine over a GROUP of up to G_MAX queries. Each query's hits run
// through the epoch-stamped enum independently (identical results to
// one-query-at-a-time processing), but the candidates of the whole group
// radix-order and SCAN TOGETHER: background double hits concentrate on
// profile regions with common k-mer composition, so consecutive queries
// touch heavily-overlapping PSSM windows — scanning them adjacently turns
// repeated DRAM window loads into cache hits. Per-(profile, query) bests
// live in a G_MAX-strided stamp table so all group members of a profile
// share one cache line. Writes each query's TOTAL selection count to
// out_counts[g] (min(total, max_out) rows written, score desc, id asc).
static void prefilter_group_impl(
    const int32_t* code_table,
    const int32_t* entry_pairs,  // interleaved [profile, position]
    int64_t n_profiles,
    const QueryView* qs,
    int G,
    const float* pssm,
    const int8_t* pssm8,
    const int64_t* offsets,
    const int32_t* lengths,
    float min_ungapped_score,
    const ExpTables* tables,
    float kmer_thr_nominal,  // un-slacked threshold (tables may be built
                             // lower to absorb positive bias sums)
    int64_t* out_counts,
    int64_t max_out,
    Scratch& scratch) {
    const bool expand = tables != nullptr;
    const bool stats = stats_enabled();
    scratch.ensure(n_profiles);
    uint32_t* last = scratch.last.data();
    uint32_t* cand_mark = scratch.cand_mark.data();
    auto& cand = scratch.cand;
    cand.clear();
    int64_t n_hits = 0, n_exp_codes = 0;
    auto t_enum0 = std::chrono::steady_clock::now();

    // -- 1-2. per-query expansion + index lookups -> stamp-table hits ----
    // (identical per-query semantics; candidates carry their query index
    // in the payload's top byte)
    int64_t qidx_off[G_MAX + 1] = {0};
    for (int g = 0; g < G; ++g)
        qidx_off[g + 1] = qidx_off[g] + qs[g].len + 16;
#if defined(__AVX512F__)
    if (pssm8) {
        scratch.qidx.resize(qidx_off[G]);
        scratch.qvalid.resize(qidx_off[G]);
        scratch.qbias.resize(qidx_off[G]);
        for (int g = 0; g < G; ++g) {
            int32_t* qi = scratch.qidx.data() + qidx_off[g];
            int32_t* qv = scratch.qvalid.data() + qidx_off[g];
            int32_t* qb = scratch.qbias.data() + qidx_off[g];
            for (int64_t t = 0; t < qs[g].len; ++t) {
                const int8_t r = qs[g].residues[t];
                const bool v = r < NAA;
                qi[t] = static_cast<int32_t>(t * NAA + (v ? r : 0));
                qv[t] = v ? -1 : 0;
                qb[t] = (v && qs[g].bias) ? qs[g].bias[t] : 0;
            }
            for (int i = 0; i < 16; ++i) {
                qi[qs[g].len + i] = 0;
                qv[qs[g].len + i] = 0;
                qb[qs[g].len + i] = 0;
            }
        }
    }
#endif
    for (int g = 0; g < G; ++g) {
        const uint64_t epoch = ++scratch.epoch;
        const uint32_t g_tag = static_cast<uint32_t>(g) << 24;
        auto process_range = [&](int32_t b, int32_t e, int64_t q) {
            for (int32_t i = b; i < e; ++i) {
                // the stamp-table access below is the loop's only random
                // memory reference — overlap its latency with the
                // processing of the preceding hits
                if (i + 8 < e)
                    __builtin_prefetch(&last[entry_pairs[2 * (i + 8)]], 1);
                const int32_t p = entry_pairs[2 * i];
                const uint32_t udiag = static_cast<uint32_t>(
                    entry_pairs[2 * i + 1] - static_cast<int32_t>(q) +
                    DIAG_OFF);
                const uint32_t key =
                    (static_cast<uint32_t>(epoch) << DIAG_BITS) | udiag;
                if (last[p] == key) {
                    // second match on this diagonal (no distance cap —
                    // MMseqs2's criterion); push once per (p, diag)
                    if (cand_mark[p] != key) {
                        cand_mark[p] = key;
                        cand.emplace_back(
                            (static_cast<uint64_t>(p) << DIAG_BITS) | udiag,
                            g_tag | static_cast<uint32_t>(q));
                    }
                } else {
                    last[p] = key;
                    if (!expand)
                        cand.emplace_back(
                            (static_cast<uint64_t>(p) << DIAG_BITS) | udiag,
                            g_tag | static_cast<uint32_t>(q));
                }
            }
        };
        struct Pend { int32_t b, e; int64_t q; };
        Pend p1{0, 0, 0}, p2{0, 0, 0};
        bool h1 = false, h2 = false;
        // Two-stage software pipeline over expanded codes: looking up a
        // code's entry range touches a random code_table line AND a random
        // entry-list region; processing the PREVIOUS code's entries while
        // the current code's list streams in overlaps those misses.
        auto push_hits = [&](int64_t code, int64_t q) {
            const int32_t b = code_table[code], e = code_table[code + 1];
            n_hits += e - b;
            ++n_exp_codes;
            __builtin_prefetch(&entry_pairs[2 * b]);
            if (h2) process_range(p2.b, p2.e, p2.q);
            if (h1) {
                const int32_t lim = std::min(p1.e, p1.b + 8);
                for (int32_t i = p1.b; i < lim; ++i)
                    __builtin_prefetch(&last[entry_pairs[2 * i]], 1);
                p2 = p1;
                h2 = true;
            }
            p1 = {b, e, q};
            h1 = true;
        };
        // largest threshold reduction the tables can honor (they were
        // built at nominal - slack when the bias correction is on)
        const float bias_slack = kmer_thr_nominal - (expand ? tables->thr : 0.0f);
        for (int64_t q = 0; q < qs[g].n_codes; ++q) {
            int64_t code = qs[g].codes[q];
            if (code < 0) continue;
            if (!expand) {
                push_hits(code, q);
                continue;
            }
            float thr_eff = kmer_thr_nominal;
            if (qs[g].bias) {
                // bias sum over the k-mer's residue window lowers (or
                // raises) the similarity bar, clamped at the table slack
                int32_t kb = 0;
                for (int t = 0; t < K; ++t) kb += qs[g].bias[q + t];
                float kbf = static_cast<float>(kb);
                if (kbf > bias_slack) kbf = bias_slack;
                thr_eff -= kbf;
            }
            const int32_t c2 = static_cast<int32_t>(code / N3);
            const int32_t c3 = static_cast<int32_t>(code % N3);
            const int64_t b3 = tables->l3_off[c3], e3 = tables->l3_off[c3 + 1];
            if (b3 == e3) continue;
            const float top3 = tables->l3_score[b3];
            for (int64_t i2 = tables->l2_off[c2];
                 i2 < tables->l2_off[c2 + 1]; ++i2) {
                const float s2 = tables->l2_score[i2];
                // l2 sorted desc: once even the best suffix fails, all
                // remaining prefixes fail too
                if (s2 + top3 < thr_eff) break;
                const float need = thr_eff - s2;
                const int64_t base =
                    static_cast<int64_t>(tables->l2_code[i2]) * N3;
                for (int64_t i3 = b3; i3 < e3; ++i3) {
                    if (tables->l3_score[i3] < need) break;
                    const int64_t c = base + tables->l3_code[i3];
                    // overlap the entry-list fetch of the next similar
                    // k-mer with processing of the current one
                    if (i3 + 1 < e3 && tables->l3_score[i3 + 1] >= need)
                        __builtin_prefetch(
                            &code_table[base + tables->l3_code[i3 + 1]]);
                    push_hits(c, q);
                }
            }
        }
        if (h2) process_range(p2.b, p2.e, p2.q);  // drain the pipeline
        if (h1) process_range(p1.b, p1.e, p1.q);
    }
    auto t_enum1 = std::chrono::steady_clock::now();

    // -- 3. radix-order the WHOLE GROUP's candidates by profile id
    // (ascending-address PSSM sweep; stable, so per-query relative order
    // is preserved) and stream them through the windowed diagonal scan.
    //
    // Extension window around the first double hit (query coords). The
    // ungapped score is the maximal subarray CONTAINED in the window — a
    // local-extension approximation of the full-diagonal score. The window
    // exists to gate at min_ungapped_score (25): a homologous region
    // reaches 25 well within ~2*W+K residues of the double hit; the gapped
    // stage (full SW on device) rescores every survivor anyway, so a
    // longer window would only refine candidate ORDER, at ~W-proportional
    // DRAM cost that dominates the whole prefilter at production DB scale.
    // (MMseqs2 likewise caps its prefilter diagonal scores — at the uchar
    // saturation bound of its SIMD scorer.) Exact-k-mer mode (tests, small
    // DBs, the numpy-fallback contract) keeps the full-diagonal scan.
    const int64_t W_cfg = config().window;
    int64_t Wg[G_MAX];
    for (int g = 0; g < G; ++g)
        Wg[g] = expand ? W_cfg
                       : (qs[g].len > DIAG_OFF
                              ? qs[g].len
                              : static_cast<int64_t>(DIAG_OFF));
    const uint64_t group_epoch = ++scratch.group_epoch;
    uint64_t* best_tab = scratch.best.data();  // [p * G_MAX + g]
    for (int g = 0; g < G; ++g) scratch.sel_ids_g[g].clear();
    {
        // order candidates by profile id (2x9-bit LSD radix, stable)
        auto& tmp = scratch.cand_tmp;
        tmp.resize(cand.size());
        uint32_t count[512];
        for (int pass = 0; pass < 2; ++pass) {
            const int shift = DIAG_BITS + 9 * pass;
            std::memset(count, 0, sizeof(count));
            for (auto& c : cand) ++count[(c.first >> shift) & 511];
            uint32_t sum = 0;
            for (auto& x : count) { uint32_t t = x; x = sum; sum += t; }
            for (auto& c : cand) tmp[count[(c.first >> shift) & 511]++] = c;
            std::swap(cand, tmp);
        }
    }
    const size_t n = cand.size();
    // lookahead distance: each candidate's window lines prefetch PF
    // candidates before its scan, deep enough to cover DRAM latency
    constexpr size_t PF = 12;
    constexpr int64_t PF_MAX_BYTES = 2048;  // cap per-candidate prefetch
    auto decode = [&](size_t i, int32_t& p, int32_t& diag, int& g,
                      int64_t& hit_q) {
        const uint64_t key = cand[i].first;
        p = static_cast<int32_t>(key >> DIAG_BITS);
        diag = static_cast<int32_t>((key & ((1u << DIAG_BITS) - 1)) -
                                    DIAG_OFF);
        g = static_cast<int>(cand[i].second >> 24);
        hit_q = cand[i].second & 0xFFFFFF;
    };
    auto window_bounds = [&](int32_t p, int32_t diag, int g, int64_t hit_q,
                             int64_t& q_lo, int64_t& q_hi) {
        q_lo = std::max<int64_t>(diag < 0 ? -diag : 0, hit_q - Wg[g]);
        q_hi = std::min<int64_t>(
            std::min<int64_t>(qs[g].len, lengths[p] - diag),
            hit_q + Wg[g] + K);
    };
    const int64_t elem = pssm8 ? 1 : 4;
    for (size_t i = 0; i < n; ++i) {
        if (i + PF < n) {
            int32_t p2, d2;
            int g2;
            int64_t hq2, lo2, hi2;
            decode(i + PF, p2, d2, g2, hq2);
            window_bounds(p2, d2, g2, hq2, lo2, hi2);
            if (hi2 > lo2) {
                const char* base =
                    (pssm8 ? reinterpret_cast<const char*>(pssm8)
                           : reinterpret_cast<const char*>(pssm)) +
                    (offsets[p2] + d2 + lo2) * NAA * elem;
                const int64_t bytes =
                    std::min<int64_t>((hi2 - lo2) * NAA * elem, PF_MAX_BYTES);
                for (int64_t off = 0; off < bytes; off += 64)
                    __builtin_prefetch(base + off);
            }
        }
        int32_t p, diag;
        int g;
        int64_t hit_q, q_lo, q_hi;
        decode(i, p, diag, g, hit_q);
        window_bounds(p, diag, g, hit_q, q_lo, q_hi);
        float bestf = 0.0f;
        if (q_hi > q_lo) {
            if (pssm8) {
                // int8 rows, int32 accumulation — exact for integral PSSMs
                const int8_t* prof = pssm8 + (offsets[p] + diag) * NAA;
                int32_t running = 0, best = 0;
#if defined(__AVX512F__)
                // 16-wide gathers: address = prof + t*20 + residue
                // (= prof + qidx[t]); masked tail lanes contribute 0,
                // which cannot change a max-subarray, so whole 16-chunks
                // are processed. The dword gather reads up to 3 bytes
                // past a row's score — the int8 buffer is allocated with
                // tail padding (profiledb pssm_i8) so the final rows are
                // safe too.
                const int32_t* qidx = scratch.qidx.data() + qidx_off[g];
                const int32_t* qvalid = scratch.qvalid.data() + qidx_off[g];
                const int32_t* qbias = scratch.qbias.data() + qidx_off[g];
                for (int64_t t0 = q_lo; t0 < q_hi; t0 += 16) {
                    const int rem =
                        static_cast<int>(std::min<int64_t>(16, q_hi - t0));
                    const __mmask16 m =
                        rem >= 16 ? static_cast<__mmask16>(0xFFFF)
                                  : static_cast<__mmask16>((1u << rem) - 1);
                    __m512i vidx = _mm512_loadu_si512(
                        reinterpret_cast<const void*>(qidx + t0));
                    __m512i gg = _mm512_mask_i32gather_epi32(
                        _mm512_setzero_si512(), m, vidx, prof, 1);
                    gg = _mm512_srai_epi32(_mm512_slli_epi32(gg, 24), 24);
                    gg = _mm512_and_si512(
                        gg, _mm512_loadu_si512(
                                reinterpret_cast<const void*>(qvalid + t0)));
                    // composition-bias correction (0 at invalid/off)
                    gg = _mm512_add_epi32(
                        gg, _mm512_loadu_si512(
                                reinterpret_cast<const void*>(qbias + t0)));
                    gg = _mm512_maskz_mov_epi32(m, gg);
                    // Kadane as a max-plus prefix scan: each element is
                    // the affine-max map f(r) = max(r + s, 0), i.e. the
                    // pair (a, b) = (s, 0) under f(r) = max(r + a, b);
                    // maps compose associatively as
                    // (a1+a2, max(b1+a2, b2)), so a 4-step Hillis-Steele
                    // scan replaces the 16-step serial dependency chain
                    // of the scalar loop.
                    const __m512i NEG = _mm512_set1_epi32(-(1 << 28));
                    __m512i A = gg, B = _mm512_setzero_si512();
                    {
                        __m512i As, Bs;
                        As = _mm512_alignr_epi32(A, _mm512_setzero_si512(), 15);
                        Bs = _mm512_alignr_epi32(B, NEG, 15);
                        B = _mm512_max_epi32(_mm512_add_epi32(Bs, A), B);
                        A = _mm512_add_epi32(As, A);
                        As = _mm512_alignr_epi32(A, _mm512_setzero_si512(), 14);
                        Bs = _mm512_alignr_epi32(B, NEG, 14);
                        B = _mm512_max_epi32(_mm512_add_epi32(Bs, A), B);
                        A = _mm512_add_epi32(As, A);
                        As = _mm512_alignr_epi32(A, _mm512_setzero_si512(), 12);
                        Bs = _mm512_alignr_epi32(B, NEG, 12);
                        B = _mm512_max_epi32(_mm512_add_epi32(Bs, A), B);
                        A = _mm512_add_epi32(As, A);
                        As = _mm512_alignr_epi32(A, _mm512_setzero_si512(), 8);
                        Bs = _mm512_alignr_epi32(B, NEG, 8);
                        B = _mm512_max_epi32(_mm512_add_epi32(Bs, A), B);
                        A = _mm512_add_epi32(As, A);
                    }
                    const __m512i vrun = _mm512_max_epi32(
                        _mm512_add_epi32(_mm512_set1_epi32(running), A), B);
                    const int32_t m0 = _mm512_reduce_max_epi32(vrun);
                    if (m0 > best) best = m0;
                    running = _mm_extract_epi32(
                        _mm512_extracti32x4_epi32(vrun, 3), 3);
                }
#else
                const int32_t* qb = qs[g].bias;
                for (int64_t t = q_lo; t < q_hi; ++t) {
                    const int8_t res = qs[g].residues[t];
                    const int32_t s =
                        res < NAA ? prof[t * NAA + res] + (qb ? qb[t] : 0) : 0;
                    running += s;
                    if (running < 0) running = 0;
                    if (running > best) best = running;
                }
#endif
                bestf = static_cast<float>(best);
            } else {
                const float* prof = pssm + (offsets[p] + diag) * NAA;
                const int32_t* qb = qs[g].bias;
                float running = 0.0f, best = 0.0f;
                for (int64_t t = q_lo; t < q_hi; ++t) {
                    // f32 rows are 80 B apart — every step opens a new
                    // cache line past the lookahead's 2 KB cap; stream
                    // ahead to overlap the misses (the exact-k-mer mode's
                    // full-diagonal scans run through here)
                    if (t + 8 < q_hi)
                        __builtin_prefetch(prof + (t + 8) * NAA);
                    const int8_t res = qs[g].residues[t];
                    const float sc =
                        res < NAA
                            ? prof[t * NAA + res] +
                                  (qb ? static_cast<float>(qb[t]) : 0.0f)
                            : 0.0f;
                    running += sc;
                    if (running < 0.0f) running = 0.0f;
                    if (running > best) best = running;
                }
                bestf = best;
            }
        }
        uint64_t* slot = &best_tab[static_cast<int64_t>(p) * G_MAX + g];
        const uint64_t cur = *slot;
        const uint32_t sbits = f32_bits(bestf);
        if ((cur >> 32) != group_epoch) {
            *slot = (group_epoch << 32) | sbits;
            if (bestf >= min_ungapped_score) scratch.sel_ids_g[g].push_back(p);
        } else if (sbits > static_cast<uint32_t>(cur)) {
            *slot = (group_epoch << 32) | sbits;
            if (bits_f32(static_cast<uint32_t>(cur)) < min_ungapped_score &&
                bestf >= min_ungapped_score)
                scratch.sel_ids_g[g].push_back(p);
        }
    }
    auto t_scan1 = std::chrono::steady_clock::now();
    // -- 4. per-query emit: score desc, profile id asc on ties (MMseqs2's
    // prefilter result order, consumed by --max-rejected)
    for (int g = 0; g < G; ++g) {
        auto& selected = scratch.selected;
        selected.clear();
        selected.reserve(scratch.sel_ids_g[g].size());
        for (int32_t p : scratch.sel_ids_g[g])
            selected.emplace_back(
                bits_f32(static_cast<uint32_t>(
                    best_tab[static_cast<int64_t>(p) * G_MAX + g])),
                p);
        std::sort(selected.begin(), selected.end(), [](auto& x, auto& y) {
            return x.first != y.first ? x.first > y.first
                                      : x.second < y.second;
        });
        const int64_t n_out = std::min<int64_t>(
            static_cast<int64_t>(selected.size()), max_out);
        for (int64_t k = 0; k < n_out; ++k) {
            qs[g].out_profiles[k] = selected[k].second;
            if (qs[g].out_scores) qs[g].out_scores[k] = selected[k].first;
        }
        out_counts[g] = static_cast<int64_t>(selected.size());
    }
    if (stats) {
        auto t_end = std::chrono::steady_clock::now();
        g_stats.hits += n_hits;
        g_stats.codes += n_exp_codes;
        g_stats.cands += static_cast<int64_t>(cand.size());
        g_stats.enum_ns +=
            std::chrono::duration_cast<std::chrono::nanoseconds>(t_enum1 -
                                                                 t_enum0)
                .count();
        g_stats.scan_ns +=
            std::chrono::duration_cast<std::chrono::nanoseconds>(t_scan1 -
                                                                 t_enum1)
                .count();
        g_stats.emit_ns +=
            std::chrono::duration_cast<std::chrono::nanoseconds>(t_end -
                                                                 t_scan1)
                .count();
    }
}

int64_t prefilter_query(
    const int32_t* code_table,
    const int32_t* entry_pairs,  // interleaved [profile, position]
    int64_t n_profiles,
    const int64_t* query_codes,
    int64_t n_codes,
    const int8_t* residues,
    int64_t query_length,
    const float* pssm,
    const int8_t* pssm8,
    const int64_t* offsets,
    const int32_t* lengths,
    float min_ungapped_score,
    const float* subst,
    float kmer_thr,
    float kmer_slack,         // tables built at kmer_thr - kmer_slack
    const int32_t* bias,      // per-position comp-bias ints; null = off
    int32_t* out_profiles,
    float* out_scores,
    int64_t max_out) {
    const ExpTables* tables =
        (subst != nullptr && kmer_thr < 1e30f)
            ? get_tables(subst, kmer_thr - kmer_slack)
            : nullptr;
    Scratch scratch;
    QueryView qv{query_codes, n_codes, residues, query_length, out_profiles,
                 out_scores, bias};
    int64_t count = 0;
    prefilter_group_impl(code_table, entry_pairs, n_profiles, &qv, 1, pssm,
                         pssm8, offsets, lengths, min_ungapped_score, tables,
                         kmer_thr, &count, max_out, scratch);
    return count;
}

// Batched, multithreaded entry point: runs the prefilter over n_queries
// concatenated queries (CSR layout) with n_threads workers. Outputs are
// written per query into out_profiles/out_scores[q * max_out_per_query ..]
// with TOTAL (uncapped) selection counts in out_counts[q] — the caller
// clamps and logs any excess as dropped. Replaces the reference's
// `--threads` knob for this stage (genomad/mmseqs2.py:83).
int64_t prefilter_batch(
    const int32_t* code_table,
    const int32_t* entry_pairs,  // interleaved [profile, position]
    int64_t n_profiles,
    const int64_t* query_codes,      // concatenated
    const int64_t* code_offsets,     // (n_queries+1)
    const int8_t* residues,          // concatenated
    const int64_t* residue_offsets,  // (n_queries+1)
    int64_t n_queries,
    const float* pssm,
    const int8_t* pssm8,
    const int64_t* offsets,
    const int32_t* lengths,
    float min_ungapped_score,
    const float* subst,
    float kmer_thr,
    float kmer_slack,         // tables built at kmer_thr - kmer_slack
    const int32_t* bias_all,  // concatenated per-position comp-bias ints
                              // (residue_offsets layout); null = off
    int32_t* out_profiles,  // (n_queries, max_out_per_query)
    float* out_scores,      // (n_queries, max_out_per_query) or nullptr
    int64_t* out_counts,    // (n_queries)
    int64_t max_out_per_query,
    int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    const ExpTables* tables =
        (subst != nullptr && kmer_thr < 1e30f)
            ? get_tables(subst, kmer_thr - kmer_slack)
            : nullptr;
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        Scratch scratch;
        for (;;) {
            const int64_t q0 = next.fetch_add(G_MAX);
            if (q0 >= n_queries) break;
            const int G =
                static_cast<int>(std::min<int64_t>(G_MAX, n_queries - q0));
            QueryView qv[G_MAX];
            for (int g = 0; g < G; ++g) {
                const int64_t q = q0 + g;
                qv[g] = QueryView{
                    query_codes + code_offsets[q],
                    code_offsets[q + 1] - code_offsets[q],
                    residues + residue_offsets[q],
                    residue_offsets[q + 1] - residue_offsets[q],
                    out_profiles + q * max_out_per_query,
                    out_scores ? out_scores + q * max_out_per_query
                               : nullptr,
                    bias_all ? bias_all + residue_offsets[q] : nullptr};
            }
            prefilter_group_impl(code_table, entry_pairs, n_profiles, qv, G,
                                 pssm, pssm8, offsets, lengths,
                                 min_ungapped_score, tables, kmer_thr,
                                 out_counts + q0, max_out_per_query, scratch);
        }
    };
    std::vector<std::thread> threads;
    for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(worker);
    worker();
    for (auto& t : threads) t.join();
    if (stats_enabled() && n_queries > 4) {
        std::fprintf(
            stderr,
            "[prefilter stats] %lld queries (%s scan): %.2f M hits (%.0f/q), "
            "%.2f M expanded codes (%.0f/q), %.0f cand/q; "
            "enum %.1f ms/q, scan %.1f ms/q, emit %.1f ms/q "
            "(thread-summed)\n",
            static_cast<long long>(n_queries), pssm8 ? "int8" : "f32",
            g_stats.hits.load() / 1e6, g_stats.hits.load() / double(n_queries),
            g_stats.codes.load() / 1e6,
            g_stats.codes.load() / double(n_queries),
            g_stats.cands.load() / double(n_queries),
            g_stats.enum_ns.load() / 1e6 / n_queries,
            g_stats.scan_ns.load() / 1e6 / n_queries,
            g_stats.emit_ns.load() / 1e6 / n_queries);
        g_stats.hits = g_stats.codes = g_stats.cands = 0;
        g_stats.enum_ns = g_stats.scan_ns = g_stats.emit_ns = 0;
    }
    return n_queries;
}

}  // extern "C"
