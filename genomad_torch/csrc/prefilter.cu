// The marker search's prefilter on the card: query 5-mers expanded into
// their similar k-mers, looked up in the profile DB's k-mer index, double
// hits on a diagonal made into candidates, each candidate scored by the
// best ungapped segment in a window of its diagonal, and each query's
// profiles at or above min_ungapped_score listed by score descending, id
// ascending. The lists are those of native/prefilter.cpp
// (`prefilter_group_impl`), bit for bit: that file is the plain version and
// the oracle, and it runs the CPU searches. No TPU kernel is replaced: the
// JAX package prefilters on the host (genomad_tpu/ops/protein_search.py,
// `prefilter_query`), and so did the port until this file.
//
// What bounds it on an H100: bytes and atomics. A search group of 128
// queries against the 227,897-profile DB reads about 1.1e8 index entries
// (8 bytes each, in runs) and scans about 2e7 windows of at most 37 PSSM
// rows (a byte a row, a 32-byte sector each): about 7.5 ms at 3.35 TB/s.
// The candidate rules are order rules per (query, profile), so most of the
// work is regrouping the hits by (query, profile): two atomics a hit into
// an L2-resident table of counters, and the buckets' own order restored.
//
// The C++ walks each query's hits in order (query position, then the
// expansion order of the product tables, then the index's entry order) and
// keeps, per profile, the diagonal of the previous hit (`last`) and of the
// previous double hit (`cand_mark`). Those rules depend only on the order of
// the hits of one (query, profile). So here every hit gets its ordinal in
// that walk, the hits are regrouped into one bucket per (query, profile)
// (a count, an exclusive scan, a scatter), each bucket's hits are put back
// in ordinal order (the scatter's atomics leave them in any order), and the
// rules run in that order:
//   - a hit whose diagonal equals the previous hit's is a double hit; it
//     pushes when the previous double hit had another diagonal, or is the
//     first;
//   - in exact-k-mer mode every other hit pushes too;
//   - a push scores the window of `window_bounds` around the pushing hit's
//     query position (Kadane, int32 sums on the int8 PSSM, which are exact
//     in any order; the C++'s sequential f32 loop on an f32 PSSM).
// The bucket's best score decides the selection, which is then compacted in
// id order per query and stably radix-sorted by score descending in one
// block per query. Every f32 expression is the C++'s, with adds, subtracts
// and compares only, so nothing can contract into an FMA.
//
// Kernels (a group runs in slices of queries, so that the buckets'
// counters and the hits' arrays stay bounded; the host side is two C calls,
// each waiting on the stream once or twice):
//   prefilter_count_kernel    a warp per query position: its 5-mer's
//                             expansions (the lanes take 32 prefixes at a
//                             time and binary-search their suffix runs),
//                             those with index entries, their entries;
//   prefilter_emit_kernel     the same walk, writing the expanded codes with
//                             entries in order, each with its first ordinal;
//   prefilter_hits_kernel     per hit (tiles of 1,024 ordinals): count into,
//                             then scatter into, its (query, profile) bucket;
//   prefilter_scan_*_kernel   the exclusive scan of the bucket counts;
//   prefilter_bucket_kernel   a thread per bucket of at most 32 hits: order
//                             (insertion), rules, windows, best;
//   prefilter_big_bucket_kernel a block per larger bucket: a bitonic sort in
//                             shared memory, the rules, the windows in
//                             parallel;
//   prefilter_select_kernel   a block per query: compaction, stable radix
//                             sort, the list at its place in the group's;
//   prefilter_advance_kernel  the group's list position past the slice.
// Every kernel's name holds `prefilter_`, and no other kernel's does.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <vector>

namespace {

constexpr int K = 5;
constexpr int NAA = 20;
constexpr int N3 = NAA * NAA * NAA;
constexpr uint32_t NONE = 0xFFFFFFFFu;  // a bucket with no selected score
constexpr int HIT_TILE = 1024;          // ordinals per block of the hits kernel
constexpr int HIT_THREADS = 256;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 16;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SELECT_THREADS = 1024;  // 32 warps: the radix pass's layout
constexpr int SMALL = 32;             // hits a bucket's thread orders and walks alone
constexpr int BIG_THREADS = 256;      // a block per larger bucket
constexpr int BIG_CAP = 8192;         // hits such a block orders in shared memory (96 KB)
constexpr int BIG_SMEM = BIG_CAP * 12;

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The product tables of native/prefilter.cpp's `build_tables` for one
// threshold (null pointers: exact k-mers).
struct Tables {
    const int64_t* l2_off;
    const int32_t* l2_code;
    const float* l2_score;
    const int64_t* l3_off;
    const int32_t* l3_code;
    const float* l3_score;
};

// Walks the codes the C++ looks up for the k-mer at query position q, in
// its order (`prefilter_group_impl`, the expansion loop), one warp for the
// position: the similar k-mers of the prefix (2) x suffix (3) product, each
// list sorted by score descending, with the same pruning breaks and the
// bias-lowered threshold clamped at the tables' slack; in exact mode the
// code itself. The lanes take 32 prefixes at a time; each counts, by a
// binary search, the suffixes the C++'s inner loop takes before its break;
// a warp scan lays the prefixes' runs end to end, and `batch(c, valid)` is
// called by every lane for each 32 consecutive codes of that order (lane i
// holds the i-th, valid false past the end).
template <class Batch>
__device__ __forceinline__ void expand_warp(int32_t code, int64_t q, const int32_t* bias, const Tables& t,
                                            bool expand, float thr_nominal, float bias_slack, Batch&& batch) {
    const int lane = threadIdx.x & 31;
    if (code < 0) return;
    if (!expand) {
        batch(code, lane == 0);
        return;
    }
    float thr_eff = thr_nominal;
    if (bias != nullptr) {
        int32_t kb = 0;
        for (int i = 0; i < K; ++i) kb += bias[q + i];
        float kbf = static_cast<float>(kb);
        if (kbf > bias_slack) kbf = bias_slack;
        thr_eff -= kbf;
    }
    const int32_t c2 = code / N3;
    const int32_t c3 = code % N3;
    const int64_t b3 = t.l3_off[c3], e3 = t.l3_off[c3 + 1];
    if (b3 == e3) return;
    const float top3 = t.l3_score[b3];
    const int64_t z2 = t.l2_off[c2 + 1];
    for (int64_t base2 = t.l2_off[c2]; base2 < z2; base2 += 32) {
        const int64_t i2 = base2 + lane;
        bool ok = false;
        int32_t n3 = 0, prefix = 0;
        if (i2 < z2) {
            const float s2 = t.l2_score[i2];
            ok = !(s2 + top3 < thr_eff);
            if (ok) {
                const float need = thr_eff - s2;
                int64_t lo = b3, hi = e3;  // the first suffix below need
                while (lo < hi) {
                    const int64_t mid = (lo + hi) / 2;
                    if (t.l3_score[mid] < need) hi = mid;
                    else lo = mid + 1;
                }
                n3 = static_cast<int32_t>(lo - b3);
                prefix = t.l2_code[i2] * N3;
            }
        }
        // the C++'s outer loop stops at its first failing prefix
        const uint32_t fail = __ballot_sync(0xffffffffu, !ok);
        const int first_fail = fail ? __ffs(fail) - 1 : 32;
        if (lane >= first_fail) n3 = 0;
        int32_t inc = n3;
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t u = __shfl_up_sync(0xffffffffu, inc, d);
            if (lane >= d) inc += u;
        }
        const int32_t total = __shfl_sync(0xffffffffu, inc, 31);
        const int32_t excl = inc - n3;
        for (int32_t b = 0; b < total; b += 32) {
            const int32_t idx = b + lane;
            int lo = 0;  // the first lane whose inclusive count passes idx
            for (int step = 16; step > 0; step >>= 1)
                if (__shfl_sync(0xffffffffu, inc, lo + step - 1) <= idx) lo += step;
            const int32_t owner_excl = __shfl_sync(0xffffffffu, excl, lo);
            const int32_t owner_prefix = __shfl_sync(0xffffffffu, prefix, lo);
            const bool valid = idx < total;
            batch(valid ? owner_prefix + t.l3_code[b3 + idx - owner_excl] : 0, valid);
        }
        if (first_fail < 32) return;
    }
}

// The k-mer code at residues r (base-20, first residue highest; -1 when a
// residue is unknown), as ops.profiledb.encode_kmers packs it.
__device__ __forceinline__ int32_t kmer_code(const int8_t* r) {
    int32_t c = 0;
    for (int i = 0; i < K; ++i) {
        const int32_t v = r[i];
        if (v >= NAA) return -1;
        c = c * NAA + v;
    }
    return c;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    return v;
}

constexpr int POS_WARPS = 4;  // positions (warps) a block of the expansion kernels

// One warp per query position: the codes looked up (`prefilter.codes`),
// those with index entries, and their entries (the position's hits), as
// counts[pos], counts[n_pos + pos] and counts[2 n_pos + pos].
__global__ void __launch_bounds__(POS_WARPS * 32) prefilter_count_kernel(
    const int8_t* residues, const int32_t* pos_q, const int32_t* pos_g, const int64_t* roff, const int32_t* bias,
    const int32_t* code_table, Tables t, int expand, float thr_nominal, float bias_slack, int64_t n_pos,
    int64_t* counts) {
    const int64_t pos = blockIdx.x * static_cast<int64_t>(POS_WARPS) + (threadIdx.x >> 5);
    if (pos >= n_pos) return;  // uniform over the warp
    const int64_t r0 = roff[pos_g[pos]];
    const int32_t* qbias = bias != nullptr ? bias + r0 : nullptr;
    const int32_t q = pos_q[pos];
    int64_t lookups = 0, nz = 0, hits = 0;
    expand_warp(kmer_code(residues + r0 + q), q, qbias, t, expand != 0, thr_nominal, bias_slack, [&](int32_t c, bool valid) {
        if (!valid) return;
        const int32_t e = code_table[c + 1] - code_table[c];
        ++lookups;
        nz += e > 0;
        hits += e;
    });
    lookups = warp_sum(lookups);
    nz = warp_sum(nz);
    hits = warp_sum(hits);
    if ((threadIdx.x & 31) == 0) {
        counts[pos] = lookups;
        counts[n_pos + pos] = nz;
        counts[2 * n_pos + pos] = hits;
    }
}

// One warp per position of [p0, p1): its expanded codes with entries, in
// order, from exp_off[pos] - exp_off[p0], each with the ordinal of its first
// hit (counted from the slice's first, hit_off[p0]) and its position.
__global__ void __launch_bounds__(POS_WARPS * 32) prefilter_emit_kernel(
    const int8_t* residues, const int32_t* pos_q, const int32_t* pos_g, const int64_t* roff, const int32_t* bias,
    const int32_t* code_table, Tables t, int expand, float thr_nominal, float bias_slack, int64_t p0, int64_t p1,
    const int64_t* exp_off, const int64_t* hit_off, int32_t* exp_code, uint32_t* exp_hit, int32_t* exp_pos) {
    const int64_t pos = p0 + blockIdx.x * static_cast<int64_t>(POS_WARPS) + (threadIdx.x >> 5);
    if (pos >= p1) return;  // uniform over the warp
    const int lane = threadIdx.x & 31;
    const uint32_t lt = (1u << lane) - 1u;
    const int64_t r0 = roff[pos_g[pos]];
    const int32_t* qbias = bias != nullptr ? bias + r0 : nullptr;
    const int32_t q = pos_q[pos];
    int64_t k = exp_off[pos] - exp_off[p0];
    int64_t h = hit_off[pos] - hit_off[p0];
    expand_warp(kmer_code(residues + r0 + q), q, qbias, t, expand != 0, thr_nominal, bias_slack, [&](int32_t c, bool valid) {
        const int32_t e = valid ? code_table[c + 1] - code_table[c] : 0;
        const uint32_t nz = __ballot_sync(0xffffffffu, e > 0);
        int64_t inc = e;
        for (int d = 1; d < 32; d <<= 1) {
            const int64_t u = __shfl_up_sync(0xffffffffu, inc, d);
            if (lane >= d) inc += u;
        }
        if (e > 0) {
            const int64_t at = k + __popc(nz & lt);
            exp_code[at] = c;
            exp_hit[at] = static_cast<uint32_t>(h + inc - e);
            exp_pos[at] = static_cast<int32_t>(pos);
        }
        k += __popc(nz);
        h += __shfl_sync(0xffffffffu, inc, 31);
    });
}

// Each hit of ordinal h in [0, H) of the slice: the expanded code k that
// holds it (every code holds at least one hit, so a tile of HIT_TILE
// ordinals spans at most HIT_TILE codes, whose first ordinals go to shared
// memory), its index entry (profile p, position), and its bucket
// (query - g0) * P + p. Counting adds one to the bucket; scattering takes a
// slot of it (the counts then exclusive-scanned) and writes the hit's
// ordinal, query position and diagonal there.
__global__ void __launch_bounds__(HIT_THREADS) prefilter_hits_kernel(
    int scatter, const int32_t* exp_code, const uint32_t* exp_hit, const int32_t* exp_pos, int64_t E, int64_t H,
    const int32_t* pos_q, const int32_t* pos_g, int32_t g0, const int32_t* code_table, const int32_t* pairs,
    int64_t P, uint32_t* cnt, uint32_t* out_h, int32_t* out_q, int32_t* out_d) {
    __shared__ uint32_t first[HIT_TILE];
    __shared__ int64_t k0_s;
    const int64_t h0 = static_cast<int64_t>(blockIdx.x) * HIT_TILE;
    if (threadIdx.x == 0) {
        int64_t lo = 0, hi = E - 1;  // the last code whose first ordinal is <= h0
        while (lo < hi) {
            const int64_t mid = (lo + hi + 1) / 2;
            if (exp_hit[mid] <= static_cast<uint64_t>(h0)) lo = mid;
            else hi = mid - 1;
        }
        k0_s = lo;
    }
    __syncthreads();
    const int64_t k0 = k0_s;
    const int n = static_cast<int>(E - k0 < HIT_TILE ? E - k0 : HIT_TILE);
    for (int i = threadIdx.x; i < n; i += HIT_THREADS) first[i] = exp_hit[k0 + i];
    __syncthreads();
    for (int j = 0; j < HIT_TILE / HIT_THREADS; ++j) {
        const int64_t h = h0 + j * HIT_THREADS + threadIdx.x;
        if (h >= H) break;
        int lo = 0, hi = n - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) / 2;
            if (first[mid] <= static_cast<uint64_t>(h)) lo = mid;
            else hi = mid - 1;
        }
        const int64_t k = k0 + lo;
        const int32_t pos = exp_pos[k];
        const int64_t e = static_cast<int64_t>(code_table[exp_code[k]]) + (h - first[lo]);
        const int32_t p = pairs[2 * e];
        const int64_t b = static_cast<int64_t>(pos_g[pos] - g0) * P + p;
        if (!scatter) {
            atomicAdd(&cnt[b], 1u);
        } else {
            const uint32_t slot = atomicAdd(&cnt[b], 1u);
            const int32_t q = pos_q[pos];
            out_h[slot] = static_cast<uint32_t>(h);
            out_q[slot] = q;
            out_d[slot] = pairs[2 * e + 1] - q;
        }
    }
}

// Inclusive sum over the block's threads (blockDim.x a multiple of 32, at
// most 1,024); `warp_sums` holds 32 values. Returns the thread's inclusive
// prefix and writes the block's total to *total.
__device__ __forceinline__ uint32_t block_inclusive_sum(uint32_t v, uint32_t* warp_sums, uint32_t* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        uint32_t w = lane < n_warps ? warp_sums[lane] : 0;
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t u = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += u;
        }
        warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const uint32_t out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
    *total = warp_sums[n_warps - 1];
    __syncthreads();  // warp_sums is reused by the caller's next call
    return out;
}

// The exclusive scan of the bucket counts, in place, in three launches:
// each tile's sum, the scan of those sums in one block, each tile's scan.
__global__ void __launch_bounds__(SCAN_THREADS) prefilter_scan_tiles_kernel(const uint32_t* data, int64_t n,
                                                                            uint32_t* tile_sums) {
    __shared__ uint32_t warp_sums[32];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * SCAN_TILE + static_cast<int64_t>(threadIdx.x) * SCAN_ITEMS;
    uint32_t s = 0;
    for (int i = 0; i < SCAN_ITEMS; ++i)
        if (base + i < n) s += data[base + i];
    uint32_t total;
    block_inclusive_sum(s, warp_sums, &total);
    if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(1024) prefilter_scan_sums_kernel(uint32_t* tile_sums, int64_t n_tiles) {
    __shared__ uint32_t warp_sums[32];
    uint32_t carry = 0;
    for (int64_t b = 0; b < n_tiles; b += blockDim.x) {
        const int64_t i = b + threadIdx.x;
        const uint32_t v = i < n_tiles ? tile_sums[i] : 0;
        uint32_t total;
        const uint32_t inc = block_inclusive_sum(v, warp_sums, &total);
        if (i < n_tiles) tile_sums[i] = carry + inc - v;
        carry += total;
    }
}

__global__ void __launch_bounds__(SCAN_THREADS) prefilter_scan_apply_kernel(uint32_t* data, int64_t n,
                                                                            const uint32_t* tile_sums) {
    __shared__ uint32_t warp_sums[32];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * SCAN_TILE + static_cast<int64_t>(threadIdx.x) * SCAN_ITEMS;
    uint32_t v[SCAN_ITEMS];
    uint32_t s = 0;
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        v[i] = base + i < n ? data[base + i] : 0;
        s += v[i];
    }
    uint32_t total;
    uint32_t run = tile_sums[blockIdx.x] + block_inclusive_sum(s, warp_sums, &total) - s;
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        if (base + i < n) data[base + i] = run;
        run += v[i];
    }
}

// Sorts a bucket's hits [0, n) by ordinal, in place in device memory, with
// their query positions and diagonals: nothing to do when they are sorted,
// insertion for short buckets, else heapsort (n log n, for the rare bucket
// above BIG_CAP hits).
__device__ void sort_bucket(uint32_t* h, int32_t* q, int32_t* d, int64_t n) {
    bool sorted = true;
    for (int64_t i = 1; i < n && sorted; ++i) sorted = h[i - 1] < h[i];
    if (sorted) return;
    if (n <= SMALL) {
        for (int64_t i = 1; i < n; ++i) {
            const uint32_t hv = h[i];
            const int32_t qv = q[i], dv = d[i];
            int64_t j = i - 1;
            while (j >= 0 && h[j] > hv) {
                h[j + 1] = h[j];
                q[j + 1] = q[j];
                d[j + 1] = d[j];
                --j;
            }
            h[j + 1] = hv;
            q[j + 1] = qv;
            d[j + 1] = dv;
        }
        return;
    }
    auto swap = [&](int64_t a, int64_t b) {
        const uint32_t th = h[a];
        h[a] = h[b];
        h[b] = th;
        const int32_t tq = q[a];
        q[a] = q[b];
        q[b] = tq;
        const int32_t td = d[a];
        d[a] = d[b];
        d[b] = td;
    };
    auto sift = [&](int64_t root, int64_t end) {
        for (;;) {
            int64_t child = 2 * root + 1;
            if (child >= end) return;
            if (child + 1 < end && h[child + 1] > h[child]) ++child;
            if (h[root] >= h[child]) return;
            swap(root, child);
            root = child;
        }
    };
    for (int64_t i = n / 2 - 1; i >= 0; --i) sift(i, n);
    for (int64_t end = n - 1; end > 0; --end) {
        swap(0, end);
        sift(0, end);
    }
}

// The best ungapped segment of diagonal d of profile p within the window of
// native/prefilter.cpp's `window_bounds` around query position q (0 when the
// window is empty), as that file's scan computes it.
template <typename T>
__device__ __forceinline__ float window_score(const T* pssm, int64_t prof_off, int32_t plen, int32_t d, int64_t q,
                                              const int8_t* res, const int32_t* qbias, int64_t qlen, int64_t W) {
    const int64_t lo = max64(d < 0 ? -d : 0, q - W);
    const int64_t hi = min64(min64(qlen, plen - d), q + W + K);
    if (hi <= lo) return 0.0f;
    const T* prof = pssm + (prof_off + d + lo) * NAA;  // row lo of the diagonal
    if constexpr (sizeof(T) == 1) {
        int32_t running = 0, best = 0;
        for (int64_t t = lo; t < hi; ++t) {
            const int32_t r = res[t];
            const int32_t s = r < NAA ? static_cast<int32_t>(prof[(t - lo) * NAA + r]) + (qbias != nullptr ? qbias[t] : 0) : 0;
            running += s;
            if (running < 0) running = 0;
            if (running > best) best = running;
        }
        return static_cast<float>(best);
    } else {
        float running = 0.0f, best = 0.0f;
        for (int64_t t = lo; t < hi; ++t) {
            const int32_t r = res[t];
            const float sc = r < NAA ? prof[(t - lo) * NAA + r] + (qbias != nullptr ? static_cast<float>(qbias[t]) : 0.0f)
                                     : 0.0f;
            running += sc;
            if (running < 0.0f) running = 0.0f;
            if (running > best) best = running;
        }
        return best;
    }
}

// The C++'s rules (`process_range`) over a bucket's hits in ordinal order:
// calls push(diagonal, query position) for each candidate it pushes, in
// order, and returns their number.
template <class Push>
__device__ __forceinline__ uint32_t walk_bucket(const int32_t* q, const int32_t* d, int64_t n, bool expand,
                                                Push&& push) {
    // the C++'s stamps start at another query's epoch: no diagonal
    // (|diag| < 2^20) equals INT32_MIN
    int32_t last = INT32_MIN, mark = INT32_MIN;
    uint32_t pushes = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t di = d[i];
        bool is_push;
        if (di == last) {
            is_push = mark != di;
            mark = di;
        } else {
            last = di;
            is_push = !expand;
        }
        if (is_push) {
            push(di, q[i]);
            ++pushes;
        }
    }
    return pushes;
}

// The operands a bucket's windows read.
template <typename T>
struct Scan {
    const int8_t* residues;
    const int64_t* roff;
    const int32_t* bias;
    const T* pssm;
    const int64_t* offsets;
    const int32_t* lengths;
    int64_t window;
    bool expand;

    // the window score of a push of query g on profile p
    __device__ __forceinline__ float score(int32_t g, int32_t p, int32_t d, int64_t q) const {
        const int64_t qlen = roff[g + 1] - roff[g];
        const int64_t W = expand ? window : (qlen > (1 << 20) ? qlen : static_cast<int64_t>(1 << 20));
        return window_score(pssm, offsets[p], lengths[p], d, q, residues + roff[g],
                            bias != nullptr ? bias + roff[g] : nullptr, qlen, W);
    }
};

// A bucket's result: best[b] gets the f32 bits of its maximum when it was
// pushed at least once and reaches min_score (sel_n of its query counts
// it), else NONE.
__device__ __forceinline__ void settle(uint32_t* best, uint32_t* sel_n, int64_t b, int32_t g_local, uint32_t pushes,
                                       float top, float min_score) {
    uint32_t out = NONE;
    if (pushes > 0 && top >= min_score) {
        out = __float_as_uint(top);
        atomicAdd(&sel_n[g_local], 1u);
    }
    best[b] = out;
}

// One thread per (query, profile) bucket of the slice with at most SMALL
// hits: the hits in ordinal order, the rules, a window scored per push,
// the maximum. A larger bucket goes on the `big` list for
// prefilter_big_bucket_kernel. n_cand counts the pushes.
template <typename T>
__global__ void __launch_bounds__(256) prefilter_bucket_kernel(
    const uint32_t* cnt, uint32_t* hit_h, int32_t* hit_q, int32_t* hit_d, int64_t n_buckets, int64_t P, int32_t g0,
    Scan<T> scan, float min_score, uint32_t* best, uint32_t* sel_n, uint32_t* big, uint32_t* big_n,
    unsigned long long* n_cand) {
    __shared__ unsigned long long block_cand;
    if (threadIdx.x == 0) block_cand = 0;
    __syncthreads();
    const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
    uint32_t pushes = 0;
    if (b < n_buckets) {
        const int64_t start = b > 0 ? cnt[b - 1] : 0, n = cnt[b] - start;
        const int32_t g_local = static_cast<int32_t>(b / P);
        if (n > SMALL) {
            big[atomicAdd(big_n, 1u)] = static_cast<uint32_t>(b);
        } else {
            float top = 0.0f;
            if (n > 0) {
                const int32_t g = g_local + g0, p = static_cast<int32_t>(b % P);
                sort_bucket(hit_h + start, hit_q + start, hit_d + start, n);
                pushes = walk_bucket(hit_q + start, hit_d + start, n, scan.expand, [&](int32_t d, int32_t q) {
                    const float s = scan.score(g, p, d, q);
                    top = s > top ? s : top;  // the scores are >= 0: the first push's sets it
                });
            }
            settle(best, sel_n, b, g_local, pushes, top, min_score);
        }
    }
    if (pushes) atomicAdd(&block_cand, static_cast<unsigned long long>(pushes));
    __syncthreads();
    if (threadIdx.x == 0 && block_cand) atomicAdd(n_cand, block_cand);
}

// The buckets of the `big` list, a block each, as many blocks as fit and
// each taking the next bucket: up to BIG_CAP hits are ordered in shared
// memory by a bitonic sort (all comparators ascending, so the padding past
// the bucket never moves), thread 0 walks them and lists its pushes in
// place, and the block scores the pushes' windows and takes their maximum.
// A bucket above BIG_CAP hits is left to thread 0 (sort_bucket in device
// memory): no input needs it but a pathological one.
template <typename T>
__global__ void __launch_bounds__(BIG_THREADS) prefilter_big_bucket_kernel(
    const uint32_t* cnt, uint32_t* hit_h, int32_t* hit_q, int32_t* hit_d, int64_t P, int32_t g0, Scan<T> scan,
    float min_score, uint32_t* best, uint32_t* sel_n, const uint32_t* big, const uint32_t* big_n, uint32_t* big_next,
    unsigned long long* n_cand) {
    extern __shared__ uint32_t big_smem[];  // BIG_SMEM bytes: ordinals, query positions, diagonals
    uint32_t* sh = big_smem;
    int32_t* sq = reinterpret_cast<int32_t*>(big_smem + BIG_CAP);
    int32_t* sd = reinterpret_cast<int32_t*>(big_smem + 2 * BIG_CAP);
    __shared__ uint32_t item, n_push, top_bits;
    const int tid = threadIdx.x;
    for (;;) {
        if (tid == 0) item = atomicAdd(big_next, 1u);
        __syncthreads();
        const uint32_t it = item;
        if (it >= *big_n) return;  // uniform over the block
        const int64_t b = big[it];
        const int64_t start = b > 0 ? cnt[b - 1] : 0, n = cnt[b] - start;
        const int32_t g_local = static_cast<int32_t>(b / P), g = g_local + g0, p = static_cast<int32_t>(b % P);
        if (n <= BIG_CAP) {
            int N = 1;
            while (N < n) N <<= 1;
            for (int i = tid; i < N; i += BIG_THREADS) {
                const bool real = i < n;
                sh[i] = real ? hit_h[start + i] : NONE;
                sq[i] = real ? hit_q[start + i] : 0;
                sd[i] = real ? hit_d[start + i] : 0;
            }
            if (tid == 0) top_bits = 0;
            __syncthreads();
            auto order = [&](int a, int c) {
                if (sh[a] > sh[c]) {
                    const uint32_t th = sh[a];
                    sh[a] = sh[c];
                    sh[c] = th;
                    const int32_t tq = sq[a];
                    sq[a] = sq[c];
                    sq[c] = tq;
                    const int32_t td = sd[a];
                    sd[a] = sd[c];
                    sd[c] = td;
                }
            };
            for (int k = 2; k <= N; k <<= 1) {
                for (int i = tid; i < N / 2; i += BIG_THREADS) {
                    const int half = k / 2, blk = i / half, off = i % half;
                    order(blk * k + off, blk * k + k - 1 - off);
                }
                __syncthreads();
                for (int j = k / 4; j >= 1; j >>= 1) {
                    for (int i = tid; i < N / 2; i += BIG_THREADS) {
                        const int a = (i / j) * 2 * j + i % j;
                        order(a, a + j);
                    }
                    __syncthreads();
                }
            }
            if (tid == 0) {
                uint32_t m = 0;  // pushes, listed in place: m never passes the hit read
                walk_bucket(sq, sd, n, scan.expand, [&](int32_t d, int32_t q) {
                    sd[m] = d;
                    sq[m] = q;
                    ++m;
                });
                n_push = m;
            }
            __syncthreads();
            const uint32_t m = n_push;
            uint32_t local = 0;  // the scores are >= 0, so their bits order as the floats
            for (uint32_t j = tid; j < m; j += BIG_THREADS)
                local = max(local, __float_as_uint(scan.score(g, p, sd[j], sq[j])));
            if (m > 0) atomicMax(&top_bits, local);
            __syncthreads();
            if (tid == 0) {
                settle(best, sel_n, b, g_local, m, __uint_as_float(top_bits), min_score);
                if (m) atomicAdd(n_cand, static_cast<unsigned long long>(m));
            }
        } else if (tid == 0) {
            sort_bucket(hit_h + start, hit_q + start, hit_d + start, n);
            float top = 0.0f;
            const uint32_t m = walk_bucket(hit_q + start, hit_d + start, n, scan.expand, [&](int32_t d, int32_t q) {
                const float s = scan.score(g, p, d, q);
                top = s > top ? s : top;
            });
            settle(best, sel_n, b, g_local, m, top, min_score);
            if (m) atomicAdd(n_cand, static_cast<unsigned long long>(m));
        }
        __syncthreads();  // item, n_push and the shared hits are reused
    }
}

// One block of 1,024 threads per query of the slice: its selected profiles
// compacted in id order (keys ~score bits, so ascending keys are descending
// scores), a stable LSD radix sort of the keys by bytes (a byte all keys
// share is skipped), and the first min(n, max_out) written at the query's
// place in the group's output: after the earlier slices' lists (*out_base)
// and the slice's earlier queries'.
__global__ void __launch_bounds__(SELECT_THREADS) prefilter_select_kernel(
    const uint32_t* best, const uint32_t* sel_n, int32_t Qs, int64_t P, int64_t max_out, uint32_t* keys_a,
    int32_t* ids_a, uint32_t* keys_b, int32_t* ids_b, const unsigned long long* out_base, int32_t* out_ids,
    float* out_scores) {
    __shared__ uint32_t warp_sums[32];
    __shared__ uint32_t bins[256];
    __shared__ uint32_t tile_total[256];
    __shared__ uint32_t warp_bin[32][256];
    __shared__ int64_t out_at;
    __shared__ int uniform;
    const int g = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t n = sel_n[g];
    if (threadIdx.x == 0) {
        int64_t at = static_cast<int64_t>(*out_base);
        for (int j = 0; j < g; ++j) at += min64(sel_n[j], max_out);
        out_at = at;
    }
    if (n == 0) return;  // uniform over the block
    const uint32_t* row = best + static_cast<int64_t>(g) * P;
    uint32_t* keys = keys_a + static_cast<int64_t>(g) * P;
    int32_t* ids = ids_a + static_cast<int64_t>(g) * P;
    uint32_t* keys2 = keys_b + static_cast<int64_t>(g) * P;
    int32_t* ids2 = ids_b + static_cast<int64_t>(g) * P;
    // compaction in id order
    uint32_t filled = 0;
    for (int64_t base = 0; base < P; base += SELECT_THREADS) {
        const int64_t id = base + threadIdx.x;
        const uint32_t bits = id < P ? row[id] : NONE;
        const uint32_t flag = bits != NONE;
        uint32_t total;
        const uint32_t at = filled + block_inclusive_sum(flag, warp_sums, &total) - flag;
        if (flag) {
            keys[at] = ~bits;
            ids[at] = static_cast<int32_t>(id);
        }
        filled += total;
    }
    __syncthreads();
    const uint32_t lt_mask = (1u << lane) - 1u;
    for (int shift = 0; shift < 32; shift += 8) {
        if (threadIdx.x < 256) bins[threadIdx.x] = 0;
        if (threadIdx.x == 0) uniform = 0;
        __syncthreads();
        for (int64_t i = threadIdx.x; i < n; i += SELECT_THREADS) atomicAdd(&bins[(keys[i] >> shift) & 255u], 1u);
        __syncthreads();
        if (threadIdx.x < 256 && bins[threadIdx.x] == n) uniform = 1;
        __syncthreads();
        const bool skip = uniform;
        __syncthreads();  // read before the next pass resets it
        if (skip) continue;  // every key has this byte: the order stands
        if (threadIdx.x == 0) {
            uint32_t run = 0;
            for (int v = 0; v < 256; ++v) {
                const uint32_t c = bins[v];
                bins[v] = run;
                run += c;
            }
        }
        __syncthreads();
        for (int64_t t0 = 0; t0 < n; t0 += SELECT_THREADS) {
            const int64_t i = t0 + threadIdx.x;
            const bool valid = i < n;
            const uint32_t key = valid ? keys[i] : 0u;
            const int32_t id = valid ? ids[i] : 0;
            const uint32_t digit = valid ? (key >> shift) & 255u : 256u;
            for (int v = lane; v < 256; v += 32) warp_bin[warp][v] = 0;
            __syncwarp();
            const uint32_t peers = __match_any_sync(0xffffffffu, digit);
            const uint32_t rank = __popc(peers & lt_mask);
            if (valid && rank == 0) warp_bin[warp][digit] = __popc(peers);
            __syncthreads();
            if (threadIdx.x < 256) {
                uint32_t run = 0;
                for (int w = 0; w < SELECT_THREADS / 32; ++w) {
                    const uint32_t c = warp_bin[w][threadIdx.x];
                    warp_bin[w][threadIdx.x] = run;
                    run += c;
                }
                tile_total[threadIdx.x] = run;
            }
            __syncthreads();
            if (valid) {
                const uint32_t dst = bins[digit] + warp_bin[warp][digit] + rank;
                keys2[dst] = key;
                ids2[dst] = id;
            }
            __syncthreads();
            if (threadIdx.x < 256) bins[threadIdx.x] += tile_total[threadIdx.x];
            __syncthreads();
        }
        uint32_t* tk = keys;
        keys = keys2;
        keys2 = tk;
        int32_t* ti = ids;
        ids = ids2;
        ids2 = ti;
    }
    const int64_t n_out = min64(n, max_out);
    for (int64_t i = threadIdx.x; i < n_out; i += SELECT_THREADS) {
        out_ids[out_at + i] = ids[i];
        out_scores[out_at + i] = __uint_as_float(~keys[i]);
    }
}

// After a slice's selection: its queries' counts into the group's sel_all
// and the output position past its lists.
__global__ void prefilter_advance_kernel(const uint32_t* sel_n, int32_t Qs, int64_t max_out, uint32_t* sel_all,
                                         unsigned long long* out_base) {
    unsigned long long n = 0;
    for (int32_t g = 0; g < Qs; ++g) {
        sel_all[g] = sel_n[g];
        n += min64(sel_n[g], max_out);
    }
    *out_base += n;
}

inline unsigned grid_of(int64_t n, int threads) { return static_cast<unsigned>((n + threads - 1) / threads); }

Tables tables_of(const void* const* t) {
    return Tables{static_cast<const int64_t*>(t[0]), static_cast<const int32_t*>(t[1]),
                  static_cast<const float*>(t[2]), static_cast<const int64_t*>(t[3]),
                  static_cast<const int32_t*>(t[4]), static_cast<const float*>(t[5])};
}

// The device scratch of a group, carved from one arena of `bytes` bytes
// (`base` null: only the size is wanted): a slice's (at most max_E
// expanded codes, max_H hits, max_Qs queries of P buckets each), reused
// from slice to slice, and the group's selected counts (nq) and lists (at
// most out_cap entries).
struct Scratch {
    int32_t* exp_code;
    uint32_t* exp_hit;
    int32_t* exp_pos;
    uint32_t *hit_h, *cnt, *best, *keys_a, *keys_b, *big, *tile_sums, *sel_n, *big_n, *sel_all;  // big_n: count, next
    int32_t *hit_q, *hit_d, *ids_a, *ids_b, *out_ids;
    float* out_scores;
    unsigned long long *n_cand, *out_base;
    int64_t bytes = 0;

    Scratch(char* base, int64_t max_E, int64_t max_H, int64_t max_Qs, int64_t P, int64_t nq, int64_t out_cap) {
        auto take = [&](auto*& ptr, int64_t count) {
            ptr = base != nullptr ? reinterpret_cast<std::remove_reference_t<decltype(ptr)>>(base + bytes) : nullptr;
            bytes += (count * static_cast<int64_t>(sizeof(*ptr)) + 255) / 256 * 256;
        };
        const int64_t nb = max_Qs * P;
        take(exp_code, max_E);
        take(exp_hit, max_E);
        take(exp_pos, max_E);
        take(hit_h, max_H);
        take(hit_q, max_H);
        take(hit_d, max_H);
        take(cnt, nb);
        take(best, nb);
        take(big, nb);
        take(keys_a, nb);
        take(ids_a, nb);
        take(keys_b, nb);
        take(ids_b, nb);
        take(tile_sums, (nb + SCAN_TILE - 1) / SCAN_TILE);
        take(sel_n, max_Qs);
        take(big_n, 2);
        take(sel_all, nq);
        take(n_cand, 1);
        take(out_base, 1);
        take(out_ids, out_cap);
        take(out_scores, out_cap);
    }
};

// Records the first error of a sequence of CUDA calls.
struct Status {
    cudaError_t err = cudaSuccess;
    void operator()(cudaError_t e) {
        if (err == cudaSuccess && e != cudaSuccess) err = e;
    }
    int done() {
        (*this)(cudaGetLastError());
        return static_cast<int>(err);
    }
};

template <typename T>
void launch_buckets(const Scratch& w, int64_t n_buckets, int64_t P, int32_t g0, const Scan<T>& scan, float min_score,
                    int big_grid, cudaStream_t s, Status& st) {
    prefilter_bucket_kernel<T><<<grid_of(n_buckets, 256), 256, 0, s>>>(
        w.cnt, w.hit_h, w.hit_q, w.hit_d, n_buckets, P, g0, scan, min_score, w.best, w.sel_n, w.big, w.big_n,
        w.n_cand);
    st(cudaFuncSetAttribute(prefilter_big_bucket_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, BIG_SMEM));
    prefilter_big_bucket_kernel<T><<<big_grid, BIG_THREADS, BIG_SMEM, s>>>(
        w.cnt, w.hit_h, w.hit_q, w.hit_d, P, g0, scan, min_score, w.best, w.sel_n, w.big, w.big_n, w.big_n + 1,
        w.n_cand);
}

}  // namespace

extern "C" {

// The bytes of the device arena of a group of nq queries whose slices hold
// at most max_E expanded codes, max_H hits and max_Qs queries, with P
// profiles, and whose lists hold at most out_cap entries in all.
int prefilter_arena_bytes(int64_t max_E, int64_t max_H, int64_t max_Qs, int64_t P, int64_t nq, int64_t out_cap,
                          int64_t* bytes) {
    *bytes = Scratch(nullptr, max_E, max_H, max_Qs, P, nq, out_cap).bytes;
    return 0;
}

// A group's per-position counts (codes looked up, those with entries, index
// hits: 3 x n_pos int64 in dev_counts), copied into host_counts. Waits for
// the stream (ctypes releases the GIL for the call).
int prefilter_count_run(const void* residues, const void* pos_q, const void* pos_g, const void* roff, const void* bias,
                        const void* code_table, const void* const* tables, int expand, float thr_nominal,
                        float bias_slack, int64_t n_pos, void* dev_counts, void* host_counts, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Status st;
    if (n_pos > 0) {
        prefilter_count_kernel<<<grid_of(n_pos, POS_WARPS), POS_WARPS * 32, 0, s>>>(
            static_cast<const int8_t*>(residues), static_cast<const int32_t*>(pos_q),
            static_cast<const int32_t*>(pos_g), static_cast<const int64_t*>(roff),
            static_cast<const int32_t*>(bias), static_cast<const int32_t*>(code_table), tables_of(tables), expand,
            thr_nominal, bias_slack, n_pos, static_cast<int64_t*>(dev_counts));
        st(cudaGetLastError());
        st(cudaMemcpyAsync(host_counts, dev_counts, 3 * n_pos * sizeof(int64_t), cudaMemcpyDeviceToHost, s));
    }
    st(cudaStreamSynchronize(s));
    return st.done();
}

// The group's slices, one after another with no wait between them, each:
// its expanded codes, its hits into (query, profile) buckets, the buckets,
// the selection into the group's lists. Then each query's selected count
// (uncapped) into host_sel, the lists (min(count, max_out) entries a
// query, the queries in order) into host_ids / host_scores, and the pushes
// into *host_ncand. slices: 6 int64 a slice: first and end query, first and
// end position, expanded codes E and hits H. Waits for the stream (ctypes
// releases the GIL for the call).
int prefilter_slices_run(const void* residues, const void* pos_q, const void* pos_g, const void* roff,
                         const void* bias, const void* code_table, const void* pairs, const void* const* tables,
                         int expand, float thr_nominal, float bias_slack, const void* pssm8, const void* pssm,
                         const void* offsets, const void* lengths, int64_t P, int64_t window, float min_score,
                         int64_t max_out, const void* exp_off, const void* hit_off, int64_t n_slices,
                         const int64_t* slices, int64_t max_E, int64_t max_H, int64_t max_Qs, int64_t nq,
                         int64_t out_cap, void* arena, int64_t* host_sel, int32_t* host_ids, float* host_scores,
                         int64_t* host_ncand, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Status st;
    const Scratch w(static_cast<char*>(arena), max_E, max_H, max_Qs, P, nq, out_cap);
    const Tables t = tables_of(tables);
    const auto* residues_ = static_cast<const int8_t*>(residues);
    const auto* pos_q_ = static_cast<const int32_t*>(pos_q);
    const auto* pos_g_ = static_cast<const int32_t*>(pos_g);
    const auto* roff_ = static_cast<const int64_t*>(roff);
    const auto* bias_ = static_cast<const int32_t*>(bias);
    const auto* code_table_ = static_cast<const int32_t*>(code_table);
    const Scan<int8_t> scan8{residues_, roff_, bias_, static_cast<const int8_t*>(pssm8),
                             static_cast<const int64_t*>(offsets), static_cast<const int32_t*>(lengths), window,
                             expand != 0};
    const Scan<float> scan32{residues_, roff_, bias_, static_cast<const float*>(pssm), scan8.offsets, scan8.lengths,
                             window, expand != 0};
    int device = 0, n_sm = 0;
    st(cudaGetDevice(&device));
    st(cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device));
    const int big_grid = 2 * (n_sm > 0 ? n_sm : 1);  // two 96 KB blocks an SM
    st(cudaMemsetAsync(w.n_cand, 0, sizeof(unsigned long long), s));
    st(cudaMemsetAsync(w.out_base, 0, sizeof(unsigned long long), s));
    for (int64_t i = 0; i < n_slices; ++i) {
        const int64_t ga = slices[6 * i], gb = slices[6 * i + 1], pa = slices[6 * i + 2], pb = slices[6 * i + 3];
        const int64_t E = slices[6 * i + 4], H = slices[6 * i + 5], Qs = gb - ga, nb = Qs * P;
        const int32_t g0 = static_cast<int32_t>(ga);
        st(cudaMemsetAsync(w.cnt, 0, 4 * nb, s));
        st(cudaMemsetAsync(w.sel_n, 0, 4 * Qs, s));
        st(cudaMemsetAsync(w.big_n, 0, 8, s));
        if (H > 0) {
            prefilter_emit_kernel<<<grid_of(pb - pa, POS_WARPS), POS_WARPS * 32, 0, s>>>(
                residues_, pos_q_, pos_g_, roff_, bias_, code_table_, t, expand, thr_nominal, bias_slack, pa, pb,
                static_cast<const int64_t*>(exp_off), static_cast<const int64_t*>(hit_off), w.exp_code, w.exp_hit,
                w.exp_pos);
            const int64_t n_tiles = (nb + SCAN_TILE - 1) / SCAN_TILE;
            for (int scatter = 0; scatter < 2; ++scatter) {
                if (scatter) {
                    prefilter_scan_tiles_kernel<<<static_cast<unsigned>(n_tiles), SCAN_THREADS, 0, s>>>(w.cnt, nb,
                                                                                                       w.tile_sums);
                    prefilter_scan_sums_kernel<<<1, 1024, 0, s>>>(w.tile_sums, n_tiles);
                    prefilter_scan_apply_kernel<<<static_cast<unsigned>(n_tiles), SCAN_THREADS, 0, s>>>(w.cnt, nb,
                                                                                                        w.tile_sums);
                }
                prefilter_hits_kernel<<<grid_of(H, HIT_TILE), HIT_THREADS, 0, s>>>(
                    scatter, w.exp_code, w.exp_hit, w.exp_pos, E, H, pos_q_, pos_g_, g0, code_table_,
                    static_cast<const int32_t*>(pairs), P, w.cnt, w.hit_h, w.hit_q, w.hit_d);
            }
        }
        if (pssm8 != nullptr) launch_buckets(w, nb, P, g0, scan8, min_score, big_grid, s, st);
        else launch_buckets(w, nb, P, g0, scan32, min_score, big_grid, s, st);
        prefilter_select_kernel<<<static_cast<unsigned>(Qs), SELECT_THREADS, 0, s>>>(
            w.best, w.sel_n, static_cast<int32_t>(Qs), P, max_out, w.keys_a, w.ids_a, w.keys_b, w.ids_b, w.out_base,
            w.out_ids, w.out_scores);
        prefilter_advance_kernel<<<1, 1, 0, s>>>(w.sel_n, static_cast<int32_t>(Qs), max_out, w.sel_all + ga,
                                                 w.out_base);
        st(cudaGetLastError());
    }
    std::vector<uint32_t> sel(nq);
    st(cudaMemcpyAsync(sel.data(), w.sel_all, 4 * nq, cudaMemcpyDeviceToHost, s));
    st(cudaMemcpyAsync(host_ncand, w.n_cand, sizeof(unsigned long long), cudaMemcpyDeviceToHost, s));
    st(cudaStreamSynchronize(s));
    int64_t total = 0;
    for (int64_t g = 0; g < nq; ++g) {
        host_sel[g] = sel[g];
        total += sel[g] < max_out ? sel[g] : max_out;
    }
    if (st.err == cudaSuccess && total > 0) {
        st(cudaMemcpyAsync(host_ids, w.out_ids, 4 * total, cudaMemcpyDeviceToHost, s));
        st(cudaMemcpyAsync(host_scores, w.out_scores, 4 * total, cudaMemcpyDeviceToHost, s));
        st(cudaStreamSynchronize(s));
    }
    return st.done();
}

}  // extern "C"
