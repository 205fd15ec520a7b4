// K1 sw_pairs: batched local Smith-Waterman with affine gaps (open 11,
// extend 1) of residue rows against PSSMs, for pairs named by index into a
// staged query bucket (nq, Lq) int32 and profile bucket (np, Lp, 21).
// Returns each pair's best score and its first end cell (row, column).
//
// Replaces genomad_tpu/ops/sw_pallas.py `sw_forward_pallas` (`_sw_kernel`),
// `sw_forward_pallas_flash` (`_sw_kernel_flash`) and
// `sw_forward_pallas_flash_t` (`_sw_kernel_flash_t`): three TPU tilings of
// one function. The oracle is genomad_tpu/ops/protein_search.py
// `_sw_forward`; every f32 expression below is written in its order with
// round-to-nearest intrinsics (the recurrence has adds, subtracts and maxes
// only, so nothing can contract into an FMA), which makes the kernel
// bit-equal to the plain version (ops/sw.py) on integral and float PSSMs.
//
// Per row i (q = query code of the row, s_j = P[j][q]):
//   f_j  = max(h_prev_j - 11, f_prev_j - 1)              (F starts at -inf)
//   h0_j = max(max(h_prev_{j-1} + s_j, f_j), 0)          (h_prev_{-1} = 0)
//   e_j  = max_{k<j}(h0_k - 11 + k) - (j - 1)            (prefix max, E_0 = -inf)
//   h_j  = max(h0_j, e_j)
// The row's maximum and its first column replace the running best only
// when strictly greater.
//
// What bounds it on an H100: operations. Each cell costs about a dozen f32
// operations of the recurrence (33.5 T lane-ops/s: 132 SMs x 128 lanes x
// 1.98 GHz); the operands are tiny beside that (a pair reads its query row
// and Lp x 21 profile scores once: ~10 KB per pair at Lp = 256 in bf16
// against ~65k cells, so 3.35 TB/s is never the limit). So the design
// spends as few warp instructions per cell as it can, and keeps the long
// chains of dependent shuffles out of the per-cell work.
//
// Design for Lp <= 1024, the register-chunk body (`sw_chunk_kernel`):
// - One warp per pair; the pair reads its operands by index (the gathered
//   (N, Lp, 21) operand of the JAX path never exists). Rows are walked in
//   the oracle's order, so the tie rule below needs no new proof; only the
//   layout of a row's columns across the lanes is new.
// - Lane l holds the contiguous chunk of columns [l*k, l*k + k) in
//   registers, with k = ceil(ncols / 32) chosen per pair from its real
//   length (ncols), up to a compile-time KMAX per bucket: 4, 8, 12, 16, 24
//   and 32 for Lp = 128, 256, 384, 512, 768 and 1024 (the smallest that
//   covers ceil(Lp / 32)). Each k has its own unrolled body up to KMAX = 12;
//   in the wider buckets k is rounded up to a multiple of KMAX / 8, which
//   bounds a kernel to 12 bodies (a short reverse pair there computes up to
//   KMAX / 8 - 1 masked columns per lane). The previous row's H
//   and F of the chunk live in registers; shared memory holds only the
//   pair's staged profile.
// - The staged profile is transposed for conflict-free reads: the score of
//   column l*k + c for query code q sits at Ps[q*32k + c*32 + l], so each of
//   a row's k score loads reads 32 consecutive elements.
// - The diagonal is in-chunk; the chunk's first column takes the left
//   lane's last H of the previous row with one __shfl_up_sync (0 on lane 0).
// - The horizontal gap keeps the closed form, in its expression order:
//   t_j = (h0_j - 11) + j; each lane takes the running max of t over its
//   chunk; one warp scan of the chunk maxima (5 shuffles and maxes, then one
//   shift) gives the max of every earlier lane; e_j = m_j - (j - 1). Max is
//   exact in any order, so this is bit-equal on float PSSMs too (the
//   sequential form max(e_{j-1} - 1, h0_{j-1} - 11) would round otherwise).
// - Columns at or past ncols are masked: their scores are staged as -inf,
//   their t as -inf (kept out of the scan) and their e as -inf, so their H
//   stays 0 and can never be strictly greater than the best (which starts
//   at 0). E flows only rightward, so no real column reads them.
// - The best cell is tracked per lane, with no reduction per row. Each lane
//   keeps (best, i, j) over its own cells: a row replaces it only when the
//   lane's row maximum is strictly greater, and then with the first column
//   of the chunk holding it. After the last row one warp reduction takes
//   the highest value, then the lowest i, then the lowest j. This is the
//   oracle's rule: there a later row replaces the best only when strictly
//   greater and the first column of a row wins, so the oracle returns the
//   cell of highest value with the smallest (i, j); a lane's triple is the
//   smallest (i, j) among its own cells of its highest value, the chunks
//   partition the columns, and the reduction picks the smallest (i, j)
//   among the lanes of the highest value.
// - Cost per row: about 14 instructions per cell of the chunk (one shared
//   load, the recurrence, the running maxima) plus about 20 for the
//   diagonal shuffle, the scan and the query code; the search for the first
//   column runs only in a row that raises a lane's best.
//
// Longer buckets (4096, 32768), the long body (`sw_slab_kernel`): the same
// body over column slabs. One warp per pair walks its columns in slabs of
// 512 (KMAX 16), left to right; each slab stages its profile columns as
// above (with a lane's NCOL loads in flight, since a slab is staged once
// per sweep of the rows) and runs every row with H and F in registers
// (`chunk_pair` with CARRY, a compile-time variant of the chunk body's
// rows). Between slabs a row carries two floats, which lane 0 reads a row
// ahead and writes after the row: the previous slab's H at its last column
// in the row above (lane 0's diagonal) and the running max of t over every
// earlier column (the scan's start at lane 0). Max is exact, so the slabs
// are bit-equal to one pass. With the chunk body's two shuffles rotated
// (lane 0 reads lane 31), lane 0 holds both carries of the next slab at no
// extra shuffle. The carries lie in a global buffer of Lq float2 per warp
// (16 bytes per row per slab; the strip body this replaces moved H and F
// through a global scratch, 16 bytes per cell), so shared memory holds only
// the staged slabs: 5 blocks of 2 warps per SM in bf16. The grid is
// persistent, one warp per buffer slot, and a warp takes its next pair
// from an atomic counter, which balances pairs of unequal length. Every
// slab starts its rows at 0, so a lane merges its slabs' bests by the full
// rule (highest value, lowest row, lowest column), as the final warp
// reduction does. Slabs of 1,024, carries in shared memory beside the
// staged slab (fewer warps per SM) and a static assignment of pairs to
// warps were timed on the card and were slower.
//
// Tuning: WARPS = 2 pairs per block in both bodies, and bf16 profiles are
// staged as bf16. Shared memory, not the block size, bounds the warps per
// SM; 4 or 8 pairs per block and f32 staging (no convert per score load,
// half the warps per SM) were timed on the card and were slower.
//
// Both bodies:
// - Reverse pass (ends != NULL): row t reads q[end_i - t] (code 20 past
//   the prefix), column t reads P[end_j - t] (zero past it): the reversed
//   prefixes of protein_search._sw_rev_cov by index arithmetic.
// - With real lengths (q_len, p_len) the pair stops at them; padding cells
//   score 0 and can never be strictly greater than the running best, and
//   the first-index rule keeps real columns ahead of padding on ties.

#include <algorithm>
#include <cstdint>
#include <limits>

#include "common.cuh"

namespace {

constexpr int WARPS = 2;  // pairs (warps) per block
constexpr int NCOL = 21;
constexpr int PAD = 20;
constexpr float GAP_OPEN = 11.f;
constexpr float GAP_EXTEND = 1.f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -std::numeric_limits<float>::infinity();

// One pair's operands and real extents (both bodies): the profile row
// `pi`, the rows and columns the pair runs, and the reverse pass's reads of
// the reversed prefixes ending at (ei, ej).
struct PairView {
    const int* qrow;
    int pi, Lq, Lp, ei, ej, nrows, ncols;
    bool rev;

    __device__ __forceinline__ int prof_row(int j) const {  // -1 = zero row
        if (!rev) return j;
        const int r = ej - j;
        return (r >= 0 && r < Lp) ? r : -1;
    }
    __device__ __forceinline__ int query_code(int i) const {
        if (!rev) return qrow[i];
        const int r = ei - i;
        return (r >= 0 && r < Lq) ? qrow[r] : PAD;
    }
};

__device__ __forceinline__ PairView pair_view(const int* __restrict__ q, const int* __restrict__ idx,
                                              const int* __restrict__ ends, const int* __restrict__ q_len,
                                              const int* __restrict__ p_len, int pair, int N, int Lq, int Lp) {
    const int qi = idx[pair];
    PairView pv;
    pv.pi = idx[N + pair];
    pv.qrow = q + (size_t)qi * Lq;
    pv.Lq = Lq;
    pv.Lp = Lp;
    pv.rev = ends != nullptr;
    pv.ei = pv.rev ? ends[pair] : 0;
    pv.ej = pv.rev ? ends[N + pair] : 0;
    int nrows = Lq, ncols = Lp;
    if (q_len != nullptr) {
        nrows = min(nrows, q_len[qi]);
        ncols = min(ncols, p_len[pv.pi]);
        if (pv.rev) {
            nrows = min(nrows, pv.ei + 1);
            ncols = min(ncols, pv.ej + 1);
        }
    }
    pv.nrows = max(nrows, 0);
    pv.ncols = max(ncols, 0);
    return pv;
}

// ---------------------------------------------------------------------------
// Register-chunk body (Lp <= 1024) and the slabs of the long body
// ---------------------------------------------------------------------------

// Where a slab of the long body lies in its pair: its first column and the
// per-row carries between slabs, carry[i] = (H of row i - 1 at the previous
// slab's last column, the max of t over the earlier slabs' columns in row
// i). Lane 0 alone reads and writes them, in row order, so each read of
// the previous slab's carry comes before its overwrite in program order.
struct Slab {
    int c0;
    float2* carry;
    bool cin, cout;  // read the previous slab's carries / write this slab's
};

// Stages a slab's profile columns [c0, c0 + 32 K) as the chunk body does
// (the score of column c0 + l K + c for query code q at Ps[q 32 K + c 32 +
// l]; -inf past ncols, 0 on a reverse pass's rows before the profile's
// start), with NCOL loads in flight per lane (32 columns a step): a slab is
// staged once per sweep of the pair's rows, so the loads' latency weighs
// more than in the chunk body, which stages once per pair.
template <typename T, int K>
__device__ __forceinline__ void stage_slab(const PairView& pv, const T* __restrict__ prow, T* __restrict__ Ps,
                                           int lane, int c0) {
    constexpr int LDK = 32 * K;
    for (int t0 = 0; t0 < K * NCOL; t0 += NCOL) {
        T v[NCOL];
        int at[NCOL];
#pragma unroll
        for (int u = 0; u < NCOL; ++u) {
            const int e = lane + 32 * (t0 + u);
            const int j = e / NCOL;
            const int code = e - j * NCOL;
            at[u] = code * LDK + (j % K) * 32 + j / K;
            v[u] = gt::from_float<T>(NEG_INF);
            if (c0 + j < pv.ncols) {
                const int r = pv.prof_row(c0 + j);
                v[u] = r >= 0 ? prow[(size_t)r * NCOL + code] : gt::from_float<T>(0.f);
            }
        }
#pragma unroll
        for (int u = 0; u < NCOL; ++u) Ps[at[u]] = v[u];
    }
}

// One pair (or one slab of it, CARRY) with K columns per lane (32 K >= the
// columns left): stages the profile, runs the rows, and leaves the lane's
// best (value, row, column). CARRY = false is the register-chunk body; its
// carry reads and writes compile out.
template <typename T, int K, bool CARRY>
__device__ __forceinline__ void chunk_pair(const PairView& pv, const T* __restrict__ prow, T* __restrict__ Ps,
                                           int lane, const Slab& sl, float& best, int& best_i, int& best_j) {
    constexpr int LDK = 32 * K;  // staged elements per query code
    const int c0 = CARRY ? sl.c0 : 0;
    __syncwarp();  // the previous pair (or slab) has read its profile
    if constexpr (CARRY) {
        stage_slab<T, K>(pv, prow, Ps, lane, c0);
    } else {
        for (int e = lane; e < LDK * NCOL; e += 32) {
            const int j = e / NCOL;
            const int code = e - j * NCOL;
            T v = gt::from_float<T>(NEG_INF);
            if (j < pv.ncols) {
                const int r = pv.prof_row(j);
                v = r >= 0 ? prow[(size_t)r * NCOL + code] : gt::from_float<T>(0.f);
            }
            Ps[code * LDK + (j % K) * 32 + j / K] = v;
        }
    }
    __syncwarp();

    const int j0 = c0 + lane * K;
    float H[K], Fp[K], colf[K], colm1[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
        const bool real = j0 + c < pv.ncols;
        H[c] = 0.f;
        Fp[c] = NEG_INF;
        colf[c] = real ? (float)(j0 + c) : NEG_INF;                          // masked: t = -inf
        colm1[c] = real ? __fsub_rn((float)(j0 + c), GAP_EXTEND) : -NEG_INF;  // masked: e = -inf
    }
    float lbest = 0.f;
    int li = 0, lc = 0;
    int code = pv.query_code(0);
    // lane 0's carries of the row (0, -inf on the other lanes and in slab 0)
    float2 cur = make_float2(0.f, NEG_INF);
    if constexpr (CARRY) {
        if (sl.cin && lane == 0) cur = sl.carry[0];
    }
    for (int i = 0; i < pv.nrows; ++i) {
        const int next = i + 1 < pv.nrows ? pv.query_code(i + 1) : PAD;
        float2 nxt = make_float2(0.f, NEG_INF);
        if constexpr (CARRY) {
            if (sl.cin && lane == 0 && i + 1 < pv.nrows) nxt = sl.carry[i + 1];  // a row ahead
        }
        const T* s = Ps + code * LDK + lane;
        // CARRY rotates: lane 0 gets lane 31's last H of the row above, the
        // carry of row i - 1 for the next slab
        const float up = CARRY ? __shfl_sync(FULL, H[K - 1], (lane + 31) & 31) : __shfl_up_sync(FULL, H[K - 1], 1);
        float diag = lane == 0 ? cur.x : up;
        float P[K];  // running max of t over the chunk, through column c
        float run = NEG_INF;
#pragma unroll
        for (int c = 0; c < K; ++c) {
            const float hp = H[c];
            const float f = fmaxf(__fsub_rn(hp, GAP_OPEN), __fsub_rn(Fp[c], GAP_EXTEND));
            const float h0 = fmaxf(fmaxf(__fadd_rn(diag, gt::to_float(s[c * 32])), f), 0.f);
            diag = hp;
            Fp[c] = f;
            H[c] = h0;
            run = fmaxf(run, __fadd_rn(__fsub_rn(h0, GAP_OPEN), colf[c]));
            P[c] = run;
        }
        if constexpr (CARRY) run = fmaxf(run, cur.y);  // the earlier slabs' t enter the scan at lane 0
        // inclusive scan of the chunk maxima, then shifted: the max of t over
        // every column of the earlier lanes (lanes below `off` get their own
        // value back, which leaves the max unchanged)
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) run = fmaxf(run, __shfl_up_sync(FULL, run, off));
        // CARRY rotates: lane 0 gets the max of t through the slab's last column
        const float below = CARRY ? __shfl_sync(FULL, run, (lane + 31) & 31) : __shfl_up_sync(FULL, run, 1);
        const float ex = lane == 0 ? cur.y : below;
        if constexpr (CARRY) {
            if (sl.cout && lane == 0) sl.carry[i] = make_float2(up, below);  // after its read: same lane
        }
        float rmax = 0.f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
            const float m = c == 0 ? ex : fmaxf(ex, P[c - 1]);
            H[c] = fmaxf(H[c], __fsub_rn(m, colm1[c]));
            rmax = fmaxf(rmax, H[c]);
        }
        if (rmax > lbest) {  // rare after the first rows: find the first column
            int first = K - 1;
#pragma unroll
            for (int c = K - 1; c >= 0; --c) {
                if (H[c] == rmax) first = c;
            }
            lbest = rmax;
            li = i;
            lc = first;
        }
        code = next;
        cur = nxt;
    }
    best = lbest;
    best_i = li;
    best_j = j0 + lc;
}

// Columns per lane are rounded up to a multiple of this step: one body per k
// up to KMAX = 12, eight bodies above.
__host__ __device__ constexpr int chunk_step(int kmax) { return kmax <= 12 ? 1 : kmax / 8; }

template <typename T, int K, int KMAX, bool CARRY>
__device__ __forceinline__ void chunk_dispatch(int k, const PairView& pv, const T* __restrict__ prow, T* __restrict__ Ps,
                                               int lane, const Slab& sl, float& best, int& best_i, int& best_j) {
    if constexpr (K >= KMAX) {
        chunk_pair<T, KMAX, CARRY>(pv, prow, Ps, lane, sl, best, best_i, best_j);
    } else {
        if (k <= K) {
            chunk_pair<T, K, CARRY>(pv, prow, Ps, lane, sl, best, best_i, best_j);
        } else {
            chunk_dispatch<T, K + chunk_step(KMAX), KMAX, CARRY>(k, pv, prow, Ps, lane, sl, best, best_i, best_j);
        }
    }
}

// highest value, then the lowest row, then the lowest column
__device__ __forceinline__ void take_best(float v, int i, int j, float& best, int& best_i, int& best_j) {
    if (v > best || (v == best && (i < best_i || (i == best_i && j < best_j)))) {
        best = v;
        best_i = i;
        best_j = j;
    }
}

// The warp's best cell by take_best's rule; lane 0 writes it.
__device__ __forceinline__ void write_best(float best, int best_i, int best_j, int lane, int pair,
                                           float* __restrict__ best_out, int* __restrict__ ei_out,
                                           int* __restrict__ ej_out) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        take_best(__shfl_xor_sync(FULL, best, off), __shfl_xor_sync(FULL, best_i, off),
                  __shfl_xor_sync(FULL, best_j, off), best, best_i, best_j);
    }
    if (lane == 0) {
        best_out[pair] = best;
        ei_out[pair] = best_i;
        ej_out[pair] = best_j;
    }
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(WARPS * 32) sw_chunk_kernel(
    const int* __restrict__ q, const T* __restrict__ p, const int* __restrict__ idx,
    const int* __restrict__ ends, const int* __restrict__ q_len, const int* __restrict__ p_len,
    float* __restrict__ best_out, int* __restrict__ ei_out, int* __restrict__ ej_out, int N, int Lq, int Lp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int pair = blockIdx.x * WARPS + warp;
    if (pair >= N) return;
    T* Ps = reinterpret_cast<T*>(smem_raw) + (size_t)warp * NCOL * 32 * KMAX;
    const PairView pv = pair_view(q, idx, ends, q_len, p_len, pair, N, Lq, Lp);

    float best = 0.f;
    int best_i = 0, best_j = 0;
    if (pv.nrows > 0 && pv.ncols > 0) {
        const int k = (pv.ncols + 31) >> 5;
        chunk_dispatch<T, chunk_step(KMAX), KMAX, false>(k, pv, p + (size_t)pv.pi * Lp * NCOL, Ps, lane,
                                                         Slab{0, nullptr, false, false}, best, best_i, best_j);
    }
    write_best(best, best_i, best_j, lane, pair, best_out, ei_out, ej_out);
}

// The long body (Lp > 1024): a pair's columns in slabs of SLAB = 32 KMAX,
// walked left to right, each a run of the register-chunk body over all rows
// with the carries of Slab. A persistent grid: each warp owns Lq float2 of
// carries at carry + 1 + warp * Lq and takes its next pair from the counter
// at carry[0] (zero at launch), so the pairs' unequal costs balance.
template <typename T, int KMAX>
__global__ void __launch_bounds__(WARPS * 32) sw_slab_kernel(
    const int* __restrict__ q, const T* __restrict__ p, const int* __restrict__ idx,
    const int* __restrict__ ends, const int* __restrict__ q_len, const int* __restrict__ p_len,
    float* __restrict__ best_out, int* __restrict__ ei_out, int* __restrict__ ej_out, float2* __restrict__ carry_g,
    int N, int Lq, int Lp) {
    constexpr int SLAB = 32 * KMAX;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    T* Ps = reinterpret_cast<T*>(smem_raw) + (size_t)warp * NCOL * SLAB;
    int* next = reinterpret_cast<int*>(carry_g);
    float2* carry = carry_g + 1 + (size_t)(blockIdx.x * WARPS + warp) * Lq;

    for (;;) {
        int pair = 0;
        if (lane == 0) pair = atomicAdd(next, 1);
        pair = __shfl_sync(FULL, pair, 0);
        if (pair >= N) break;
        const PairView pv = pair_view(q, idx, ends, q_len, p_len, pair, N, Lq, Lp);
        const T* prow = p + (size_t)pv.pi * Lp * NCOL;
        float best = 0.f;
        int best_i = 0, best_j = 0;
        const int nslabs = pv.nrows > 0 ? (pv.ncols + SLAB - 1) / SLAB : 0;
        for (int s = 0; s < nslabs; ++s) {
            // rows start again at 0 in every slab: its best merges by take_best's rule
            const Slab sl{s * SLAB, carry, s > 0, s + 1 < nslabs};
            float b;
            int bi, bj;
            if (sl.cout) {
                chunk_pair<T, KMAX, true>(pv, prow, Ps, lane, sl, b, bi, bj);
            } else {
                const int k = (pv.ncols - sl.c0 + 31) >> 5;
                chunk_dispatch<T, chunk_step(KMAX), KMAX, true>(k, pv, prow, Ps, lane, sl, b, bi, bj);
            }
            take_best(b, bi, bj, best, best_i, best_j);
        }
        write_best(best, best_i, best_j, lane, pair, best_out, ei_out, ej_out);
    }
}

template <typename T, int KMAX>
cudaError_t launch_chunk(const void* q, const void* p, const void* idx, const void* ends, const void* q_len,
                         const void* p_len, void* best, void* ei, void* ej, int N, int Lq, int Lp, cudaStream_t s) {
    auto kernel = sw_chunk_kernel<T, KMAX>;
    // at most 2 x 21 x 1024 f32: 172 KB of the 227 KB a block may use
    const size_t smem = (size_t)WARPS * NCOL * 32 * KMAX * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<(N + WARPS - 1) / WARPS, WARPS * 32, smem, s>>>(
        static_cast<const int*>(q), static_cast<const T*>(p), static_cast<const int*>(idx),
        static_cast<const int*>(ends), static_cast<const int*>(q_len), static_cast<const int*>(p_len),
        static_cast<float*>(best), static_cast<int*>(ei), static_cast<int*>(ej), N, Lq, Lp);
    return cudaGetLastError();
}

// KMAX per bucket: the smallest of 4, 8, 12, 16, 24, 32 that covers ceil(Lp / 32)
template <typename T>
cudaError_t launch_chunk_bucket(const void* q, const void* p, const void* idx, const void* ends, const void* q_len,
                                const void* p_len, void* best, void* ei, void* ej, int N, int Lq, int Lp,
                                cudaStream_t s) {
    const int kneed = (Lp + 31) / 32;
    if (kneed <= 4) return launch_chunk<T, 4>(q, p, idx, ends, q_len, p_len, best, ei, ej, N, Lq, Lp, s);
    if (kneed <= 8) return launch_chunk<T, 8>(q, p, idx, ends, q_len, p_len, best, ei, ej, N, Lq, Lp, s);
    if (kneed <= 12) return launch_chunk<T, 12>(q, p, idx, ends, q_len, p_len, best, ei, ej, N, Lq, Lp, s);
    if (kneed <= 16) return launch_chunk<T, 16>(q, p, idx, ends, q_len, p_len, best, ei, ej, N, Lq, Lp, s);
    if (kneed <= 24) return launch_chunk<T, 24>(q, p, idx, ends, q_len, p_len, best, ei, ej, N, Lq, Lp, s);
    if (kneed <= 32) return launch_chunk<T, 32>(q, p, idx, ends, q_len, p_len, best, ei, ej, N, Lq, Lp, s);
    return cudaErrorInvalidValue;
}

constexpr int CHUNK_MAX_LP = 1024;  // longer buckets take the long body
constexpr int SLAB_KMAX = 16;       // the long body's slabs: 512 columns

// The long body's staged slabs: one per warp.
template <typename T>
constexpr size_t slab_smem() {
    return (size_t)WARPS * NCOL * 32 * SLAB_KMAX * sizeof(T);
}

// The long body's persistent grid: as many warps as fit on the card at
// once (shared memory: the staged slab of each warp), at most one per pair.
// Also lets the kernel take its shared memory, which the launch needs.
template <typename T>
cudaError_t slab_grid(int N, int& warps) {
    auto kernel = sw_slab_kernel<T, SLAB_KMAX>;
    int dev, sms, blocks;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)slab_smem<T>());
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WARPS * 32, slab_smem<T>());
    warps = err == cudaSuccess ? std::min((N + WARPS - 1) / WARPS, std::max(blocks, 1) * sms) * WARPS : 0;
    return err;
}

// Launches the `warps` that sw_carry_warps sized `carry` for: whole blocks,
// at most one warp per pair. (A grid larger than the card holds at once
// would still be right: the counter hands out the pairs.)
template <typename T>
cudaError_t launch_slab(const void* q, const void* p, const void* idx, const void* ends, const void* q_len,
                        const void* p_len, void* best, void* ei, void* ej, void* carry, int warps, int N, int Lq,
                        int Lp, cudaStream_t s) {
    if (carry == nullptr || warps <= 0 || warps % WARPS != 0 || warps > (N + WARPS - 1) / WARPS * WARPS) {
        return cudaErrorInvalidValue;
    }
    cudaError_t err = cudaMemsetAsync(carry, 0, sizeof(int), s);  // the pair counter
    if (err != cudaSuccess) return err;
    sw_slab_kernel<T, SLAB_KMAX><<<warps / WARPS, WARPS * 32, slab_smem<T>(), s>>>(
        static_cast<const int*>(q), static_cast<const T*>(p), static_cast<const int*>(idx),
        static_cast<const int*>(ends), static_cast<const int*>(q_len), static_cast<const int*>(p_len),
        static_cast<float*>(best), static_cast<int*>(ei), static_cast<int*>(ej), static_cast<float2*>(carry), N, Lq,
        Lp);
    return cudaGetLastError();
}

}  // namespace

// Lp > 1024 (the long body): *warps = the warps of its grid; its launch
// takes them with a global buffer of 1 + warps * Lq float2 (a pair counter,
// then each warp's carries). Call it before each such launch, on the
// launch's device. Lp <= 1024: 0.
extern "C" int sw_carry_warps(int N, int Lp, int is_bf16, int* warps) {
    *warps = 0;
    if (Lp <= CHUNK_MAX_LP || N <= 0) return 0;
    const cudaError_t err = is_bf16 ? slab_grid<gt::bf16>(N, *warps) : slab_grid<float>(N, *warps);
    return static_cast<int>(err);
}

// The register-chunk body for Lp <= 1024, else the long body over
// `carry_warps` warps with `carry` their buffer, as sw_carry_warps gave them.
extern "C" int sw_pairs_launch(const void* q, const void* p, const void* idx, const void* ends,
                               const void* q_len, const void* p_len, void* best, void* ei, void* ej,
                               void* carry, int carry_warps, int N, int Lq, int Lp, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (Lp <= CHUNK_MAX_LP) {
        err = is_bf16 ? launch_chunk_bucket<gt::bf16>(q, p, idx, ends, q_len, p_len, best, ei, ej, N, Lq, Lp, s)
                      : launch_chunk_bucket<float>(q, p, idx, ends, q_len, p_len, best, ei, ej, N, Lq, Lp, s);
    } else {
        err = is_bf16 ? launch_slab<gt::bf16>(q, p, idx, ends, q_len, p_len, best, ei, ej, carry, carry_warps, N, Lq,
                                              Lp, s)
                      : launch_slab<float>(q, p, idx, ends, q_len, p_len, best, ei, ej, carry, carry_warps, N, Lq,
                                           Lp, s);
    }
    return static_cast<int>(err);
}
