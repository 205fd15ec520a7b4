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
// 1.98 GHz) and the design spends ~40 warp instructions per strip of 32
// cells; the operands are tiny beside that (a pair reads its query row and
// Lp x 21 profile scores once: ~10 KB per pair at Lp = 256 in bf16 against
// ~65k cells, so 3.35 TB/s is never the limit).
//
// Design (a simple first version that is right; integer DP for integral
// PSSMs, several pairs per warp and TMA staging are later work):
// - One warp per pair; the pair reads its operands by index (the gathered
//   (N, Lp, 21) operand of the JAX path never exists). Lanes walk the
//   profile columns in strips of 32, row by row.
// - Lp <= 1024: the pair's profile is staged transposed (21 x Lp, native
//   dtype) in shared memory with its H and F row carries, so a row reads
//   its 32-column strip of scores without bank conflicts. Longer buckets
//   (4096, 32768) keep H and F in a global scratch the wrapper allocates
//   and read the scores from global memory; a grid-stride loop bounds the
//   scratch by the number of warps.
// - The horizontal gap is the closed form above: a warp inclusive
//   prefix max (__shfl_up_sync) carried across strips, shifted by one.
// - A warp reduction gives the row max and its first index.
// - Reverse pass (ends != NULL): row t reads q[end_i - t] (code 20 past
//   the prefix), column t reads P[end_j - t] (zero past it): the reversed
//   prefixes of protein_search._sw_rev_cov by index arithmetic.
// - With real lengths (q_len, p_len) the pair stops at them; padding cells
//   score 0 and can never be strictly greater than the running best, and
//   the first-index rule keeps real columns ahead of padding on ties.

#include <cstdint>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 2;  // pairs (warps) per block
constexpr int NCOL = 21;
constexpr int PAD = 20;
constexpr float GAP_OPEN = 11.f;
constexpr float GAP_EXTEND = 1.f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, bool STAGED>
__global__ void __launch_bounds__(WARPS * 32) sw_kernel(
    const int* __restrict__ q, const T* __restrict__ p, const int* __restrict__ idx,
    const int* __restrict__ ends, const int* __restrict__ q_len, const int* __restrict__ p_len,
    float* __restrict__ best_out, int* __restrict__ ei_out, int* __restrict__ ej_out,
    float* __restrict__ scratch, int N, int Lq, int Lp, int ld) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int gwarp = blockIdx.x * WARPS + warp;
    const int n_warps = gridDim.x * WARPS;

    float* H;
    float* Fc;
    T* Ps = nullptr;  // staged profile, transposed: Ps[c * ld + j]
    if (STAGED) {
        const size_t per_warp = (size_t)ld * (2 * sizeof(float) + NCOL * sizeof(T));
        unsigned char* base = smem_raw + warp * per_warp;
        H = reinterpret_cast<float*>(base);
        Fc = H + ld;
        Ps = reinterpret_cast<T*>(Fc + ld);
    } else {
        H = scratch + (size_t)gwarp * 2 * ld;
        Fc = H + ld;
    }

    for (int pair = gwarp; pair < N; pair += n_warps) {
        const int qi = idx[pair];
        const int pi = idx[N + pair];
        const int* qrow = q + (size_t)qi * Lq;
        const T* prow = p + (size_t)pi * Lp * NCOL;
        const bool rev = ends != nullptr;
        const int ei = rev ? ends[pair] : 0;
        const int ej = rev ? ends[N + pair] : 0;
        int nrows = Lq, ncols = Lp;
        if (q_len != nullptr) {
            nrows = min(nrows, q_len[qi]);
            ncols = min(ncols, p_len[pi]);
            if (rev) {
                nrows = min(nrows, ei + 1);
                ncols = min(ncols, ej + 1);
            }
        }
        nrows = max(nrows, 0);
        ncols = max(ncols, 0);
        const int nstrips = (ncols + 31) >> 5;
        const int ncols_pad = nstrips << 5;

        // profile row of column j (reverse: end_j - j); -1 = zero row
        auto prof_row = [&](int j) -> int {
            if (!rev) return j;
            const int r = ej - j;
            return (r >= 0 && r < Lp) ? r : -1;
        };
        auto query_code = [&](int i) -> int {
            if (!rev) return qrow[i];
            const int r = ei - i;
            return (r >= 0 && r < Lq) ? qrow[r] : PAD;
        };

        __syncwarp();
        if (STAGED) {
            for (int k = lane; k < ncols_pad * NCOL; k += 32) {
                const int j = k / NCOL;
                const int c = k - j * NCOL;
                const int r = j < ncols ? prof_row(j) : -1;
                Ps[c * ld + j] = r >= 0 ? prow[(size_t)r * NCOL + c] : gt::from_float<T>(0.f);
            }
        }
        for (int j = lane; j < ncols_pad; j += 32) {
            H[j] = 0.f;
            Fc[j] = -CUDART_INF_F;
        }
        __syncwarp();

        float best = 0.f;
        int best_i = 0, best_j = 0;
        int code = nrows > 0 ? query_code(0) : PAD;
        for (int i = 0; i < nrows; ++i) {
            const int next = i + 1 < nrows ? query_code(i + 1) : PAD;
            float carry_h = 0.f;             // h_prev of the column left of the strip
            float carry_m = -CUDART_INF_F;   // running prefix max of t
            float lane_best = -CUDART_INF_F;
            int lane_arg = 0x7fffffff;
            for (int s = 0; s < nstrips; ++s) {
                const int j = (s << 5) + lane;
                const bool valid = j < ncols;
                const float hp = H[j];
                const float fp = Fc[j];
                float sc;
                if (STAGED) {
                    sc = gt::to_float(Ps[code * ld + j]);
                } else {
                    const int r = valid ? prof_row(j) : -1;
                    sc = r >= 0 ? gt::to_float(prow[(size_t)r * NCOL + code]) : 0.f;
                }
                const float up = __shfl_up_sync(FULL, hp, 1);
                const float diag = lane == 0 ? carry_h : up;
                carry_h = __shfl_sync(FULL, hp, 31);
                const float f = fmaxf(__fsub_rn(hp, GAP_OPEN), __fsub_rn(fp, GAP_EXTEND));
                const float h0 = fmaxf(fmaxf(__fadd_rn(diag, sc), f), 0.f);
                const float colf = (float)j;
                // t = h0 - open + ext * col (ext = 1: the product is exact)
                float t = __fadd_rn(__fsub_rn(h0, GAP_OPEN), colf);
#pragma unroll
                for (int off = 1; off < 32; off <<= 1) {
                    // lanes below `off` get their own value back: max is unchanged
                    t = fmaxf(t, __shfl_up_sync(FULL, t, off));
                }
                t = fmaxf(t, carry_m);
                const float prev = __shfl_up_sync(FULL, t, 1);
                const float m = lane == 0 ? carry_m : prev;
                carry_m = __shfl_sync(FULL, t, 31);
                const float e = __fsub_rn(m, __fsub_rn(colf, GAP_EXTEND));
                const float h = fmaxf(h0, e);
                H[j] = h;
                Fc[j] = f;
                if (valid && h > lane_best) {
                    lane_best = h;
                    lane_arg = j;
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_xor_sync(FULL, lane_best, off);
                const int oa = __shfl_xor_sync(FULL, lane_arg, off);
                if (ov > lane_best || (ov == lane_best && oa < lane_arg)) {
                    lane_best = ov;
                    lane_arg = oa;
                }
            }
            if (lane_best > best) {
                best = lane_best;
                best_i = i;
                best_j = lane_arg;
            }
            code = next;
        }
        if (lane == 0) {
            best_out[pair] = best;
            ei_out[pair] = best_i;
            ej_out[pair] = best_j;
        }
    }
}

template <typename T, bool STAGED>
cudaError_t launch(const void* q, const void* p, const void* idx, const void* ends, const void* q_len,
                   const void* p_len, void* best, void* ei, void* ej, void* scratch, int N, int Lq, int Lp,
                   int ld, int n_warps, cudaStream_t s) {
    auto kernel = sw_kernel<T, STAGED>;
    size_t smem = 0;
    int blocks;
    if (STAGED) {
        smem = (size_t)WARPS * ld * (2 * sizeof(float) + NCOL * sizeof(T));
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return err;
        }
        blocks = (N + WARPS - 1) / WARPS;
    } else {
        // the scratch holds n_warps slots: launch no more warps than that
        blocks = n_warps / WARPS;
        if (blocks < 1) return cudaErrorInvalidValue;
    }
    kernel<<<blocks, WARPS * 32, smem, s>>>(
        static_cast<const int*>(q), static_cast<const T*>(p), static_cast<const int*>(idx),
        static_cast<const int*>(ends), static_cast<const int*>(q_len), static_cast<const int*>(p_len),
        static_cast<float*>(best), static_cast<int*>(ei), static_cast<int*>(ej), static_cast<float*>(scratch),
        N, Lq, Lp, ld);
    return cudaGetLastError();
}

}  // namespace

// Stages in shared memory when `scratch` is NULL (Lp <= 1024), else runs
// over `n_warps` global scratch slots of 2 x ld floats each.
extern "C" int sw_pairs_launch(const void* q, const void* p, const void* idx, const void* ends,
                               const void* q_len, const void* p_len, void* best, void* ei, void* ej,
                               void* scratch, int N, int Lq, int Lp, int ld, int is_bf16, int n_warps,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (scratch == nullptr) {
        err = is_bf16 ? launch<gt::bf16, true>(q, p, idx, ends, q_len, p_len, best, ei, ej, scratch, N, Lq, Lp, ld, n_warps, s)
                      : launch<float, true>(q, p, idx, ends, q_len, p_len, best, ei, ej, scratch, N, Lq, Lp, ld, n_warps, s);
    } else {
        err = is_bf16 ? launch<gt::bf16, false>(q, p, idx, ends, q_len, p_len, best, ei, ej, scratch, N, Lq, Lp, ld, n_warps, s)
                      : launch<float, false>(q, p, idx, ends, q_len, p_len, best, ei, ej, scratch, N, Lq, Lp, ld, n_warps, s);
    }
    return static_cast<int>(err);
}
