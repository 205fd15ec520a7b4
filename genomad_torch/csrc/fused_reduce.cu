// K2 fused_reduce and K3 patch_reduce: the IGLOO-kernel operands from one
// pass over the feature map y (B, L, C):
//
//   mpi[b, p]       = sum_{s<S} ( y[b, I[p, s], :] . w_patch[p, s, :] )   (f32)
//   pooled[b, j, :] = max_{r<8} ( y[b, 8j + r, :] @ w_v )                 (f32 max, stored in y's dtype)
//
// for j < L / 8 (MaxPool1D 'valid'). Each slot dot is summed in f32, then
// the slots are added in order s = 0..S-1, as `fused_reduce` does. One
// source, two entry points: the template switch POOLED turns the value
// projection and max-pool on (K2, `fused_reduce_launch`) or off (K3,
// `patch_reduce_launch`, mpi only). The patch reduction is the same code
// with the same share of patches per block in both, so K3's mpi is K2's
// bit for bit.
//
// Replaces genomad_tpu/ops/patch_reduce.py `fused_reduce` (`_kernel_fused`
// through `_fused_values`) and `patch_reduce` (`_kernel` through
// `_slot_values`). Their tile plan (`build_plan`: slot weight tiles and
// one-hot masks) only turned TPU gathers into MXU work; here the 4 rows of
// each patch are gathered directly.
//
// What bounds them on an H100: bytes. At B=128 K2 must read y once (197 MB,
// 0.06 ms at 3.35 TB/s); the value projection is 25 GFLOP (0.03 ms in
// bf16 on the tensor cores) and the patch dots 0.3 GFLOP. K3 reads only the
// rows its patches name (most of them: 8,400 slots over 6,016 positions).
//
// Design: one block per (tile of TR=64 positions, batch row). With POOLED
// the block stages its y rows and w_v in shared memory, runs the
// projection as bf16 tensor-core products (WMMA 16x16x16, f32
// accumulation), stages the f32 products through shared memory and
// max-pools 8 rows per output row. Then (both forms) the block reduces its
// share of the patches (ceil(P / tiles) of them), one warp per patch: the
// gathered rows come from L2, since the blocks of one batch row run
// together and y for one window (1.5 MB in bf16) fits in the 50 MB L2.
//
// Takes f32 (parity runs, projection on the CUDA cores) and bf16
// (production); accumulates in f32.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int POOL = 8;
constexpr int TR = 64;
constexpr int THREADS = 256;

// One warp per patch: lanes split the channels, shuffles sum each slot dot.
template <typename T>
__device__ __forceinline__ void reduce_patches(const T* __restrict__ yb, const int* __restrict__ patches,
                                               const T* __restrict__ wp, float* __restrict__ mpi_b, int S,
                                               int Cc, int p_begin, int p_end) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int p = p_begin + warp; p < p_end; p += THREADS / 32) {
        float total = 0.f;
        for (int s = 0; s < S; ++s) {
            const T* yr = yb + (size_t)patches[p * S + s] * Cc;
            const T* wr = wp + ((size_t)p * S + s) * Cc;
            float part = 0.f;
            for (int c = lane; c < Cc; c += 32) part = fmaf(gt::to_float(yr[c]), gt::to_float(wr[c]), part);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
            total += part;
        }
        if (lane == 0) mpi_b[p] = total;
    }
}

// ---- bf16 tensor-core path (C fixed at the model's 128 channels) ----
constexpr int C = 128;
constexpr int LDY = C + 16;  // 288-byte rows: every fragment pointer stays 32-byte aligned
constexpr int LDV = C + 16;
constexpr int LDO = C + 4;
constexpr int VPR = C / 8;
constexpr size_t SMEM_BF16 = (size_t)(TR * LDY + C * LDV) * sizeof(gt::bf16);
static_assert((size_t)TR * LDO * sizeof(float) <= SMEM_BF16, "f32 staging reuses the operand tiles");
static_assert(THREADS / 32 == (TR / 16) * 2, "8 warps: 4 row blocks x 2 column halves");

// The value projection of one tile of TR rows and its max-pool by 8 (K2).
__device__ __forceinline__ void pool_projection_bf16(const gt::bf16* __restrict__ yb, const gt::bf16* __restrict__ wv,
                                                     gt::bf16* __restrict__ pooled_b, int L, int tile, int n_pool) {
    extern __shared__ __align__(128) unsigned char smem[];
    gt::bf16* ys = reinterpret_cast<gt::bf16*>(smem);
    gt::bf16* vs = ys + TR * LDY;
    float* os = reinterpret_cast<float*>(smem);
    const int r0 = tile * TR;
    for (int i = threadIdx.x; i < TR * VPR; i += THREADS) {
        const int r = i / VPR;
        const int v = i - r * VPR;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < L) val = *reinterpret_cast<const uint4*>(yb + (size_t)(r0 + r) * C + v * 8);
        *reinterpret_cast<uint4*>(ys + r * LDY + v * 8) = val;
    }
    for (int i = threadIdx.x; i < C * VPR; i += THREADS) {
        const int r = i / VPR;
        const int v = i - r * VPR;
        *reinterpret_cast<uint4*>(vs + r * LDV + v * 8) = *reinterpret_cast<const uint4*>(wv + (size_t)r * C + v * 8);
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int rb = warp & 3;    // 16-row block
    const int half = warp >> 2;  // 64-column half
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll 2
    for (int kk = 0; kk < C / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, gt::bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ys + rb * 16 * LDY + kk * 16, LDY);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, gt::bf16, wmma::row_major> bm;
            wmma::load_matrix_sync(bm, vs + kk * 16 * LDV + half * 64 + j * 16, LDV);
            wmma::mma_sync(acc[j], a, bm, acc[j]);
        }
    }
    __syncthreads();  // operand tiles are dead; reuse them as f32 staging
#pragma unroll
    for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(os + rb * 16 * LDO + half * 64 + j * 16, acc[j], LDO, wmma::mem_row_major);
    __syncthreads();

    for (int i = threadIdx.x; i < (TR / POOL) * C; i += THREADS) {
        const int jr = i / C;
        const int c = i - jr * C;
        const int j = tile * (TR / POOL) + jr;
        if (j >= n_pool) break;
        float m = os[jr * POOL * LDO + c];
#pragma unroll
        for (int r = 1; r < POOL; ++r) m = fmaxf(m, os[(jr * POOL + r) * LDO + c]);
        pooled_b[(size_t)j * C + c] = __float2bfloat16(m);
    }
}

template <bool POOLED>
__global__ void __launch_bounds__(THREADS) fused_reduce_bf16(
    const gt::bf16* __restrict__ y, const int* __restrict__ patches, const gt::bf16* __restrict__ wp,
    const gt::bf16* __restrict__ wv, float* __restrict__ mpi, gt::bf16* __restrict__ pooled, int L, int P,
    int S, int Cc, int n_pool, int ppb) {
    const int b = blockIdx.y;
    const int tile = blockIdx.x;
    const int cc = POOLED ? C : Cc;  // the pooled form is built for C = 128
    const gt::bf16* yb = y + (size_t)b * L * cc;
    if constexpr (POOLED) pool_projection_bf16(yb, wv, pooled + (size_t)b * n_pool * C, L, tile, n_pool);
    reduce_patches<gt::bf16>(yb, patches, wp, mpi + (size_t)b * P, S, cc, tile * ppb, min(P, (tile + 1) * ppb));
}

// ---- f32 path (parity runs; pooled: any C with TR * C floats <= 48 KB) ----
template <bool POOLED>
__global__ void __launch_bounds__(THREADS) fused_reduce_f32(
    const float* __restrict__ y, const int* __restrict__ patches, const float* __restrict__ wp,
    const float* __restrict__ wv, float* __restrict__ mpi, float* __restrict__ pooled, int L, int P, int S,
    int Cf, int n_pool, int ppb) {
    const int b = blockIdx.y;
    const int tile = blockIdx.x;
    const float* yb = y + (size_t)b * L * Cf;
    if constexpr (POOLED) {
        extern __shared__ float ysf[];  // TR x Cf
        const int r0 = tile * TR;
        for (int i = threadIdx.x; i < TR * Cf; i += THREADS) {
            const int r = i / Cf;
            ysf[i] = (r0 + r < L) ? yb[(size_t)r0 * Cf + i] : 0.f;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < (TR / POOL) * Cf; i += THREADS) {
            const int jr = i / Cf;
            const int c = i - jr * Cf;
            const int j = tile * (TR / POOL) + jr;
            if (j >= n_pool) break;
            float m = -INFINITY;
            for (int r = 0; r < POOL; ++r) {
                const float* yr = ysf + (jr * POOL + r) * Cf;
                float d = 0.f;
                for (int ci = 0; ci < Cf; ++ci) d = fmaf(yr[ci], wv[(size_t)ci * Cf + c], d);
                m = fmaxf(m, d);
            }
            pooled[((size_t)b * n_pool + j) * Cf + c] = m;
        }
    }
    reduce_patches<float>(yb, patches, wp, mpi + (size_t)b * P, S, Cf, tile * ppb, min(P, (tile + 1) * ppb));
}

}  // namespace

// Both entry points share the grid: one block per (tile of TR rows, batch
// row), each reducing the same ceil(P / tiles) patches.
template <bool POOLED>
static int launch(const void* y, const void* patches, const void* wp, const void* wv, void* mpi, void* pooled, int B,
                  int L, int P, int S, int Cin, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int tiles = (L + TR - 1) / TR;
    const int ppb = (P + tiles - 1) / tiles;
    const int n_pool = L / POOL;
    const dim3 grid(tiles, B);
    if (is_bf16) {
        size_t smem = 0;
        if (POOLED) {
            if (Cin != C) return static_cast<int>(cudaErrorInvalidValue);
            smem = SMEM_BF16;
            cudaError_t err = cudaFuncSetAttribute(fused_reduce_bf16<POOLED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        fused_reduce_bf16<POOLED><<<grid, THREADS, smem, s>>>(
            static_cast<const gt::bf16*>(y), static_cast<const int*>(patches), static_cast<const gt::bf16*>(wp),
            static_cast<const gt::bf16*>(wv), static_cast<float*>(mpi), static_cast<gt::bf16*>(pooled), L, P, S, Cin,
            n_pool, ppb);
    } else {
        const size_t smem = POOLED ? (size_t)TR * Cin * sizeof(float) : 0;
        if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
        fused_reduce_f32<POOLED><<<grid, THREADS, smem, s>>>(
            static_cast<const float*>(y), static_cast<const int*>(patches), static_cast<const float*>(wp),
            static_cast<const float*>(wv), static_cast<float*>(mpi), static_cast<float*>(pooled), L, P, S, Cin,
            n_pool, ppb);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_reduce_launch(const void* y, const void* patches, const void* wp, const void* wv, void* mpi,
                                   void* pooled, int B, int L, int P, int S, int Cin, int is_bf16, void* stream) {
    return launch<true>(y, patches, wp, wv, mpi, pooled, B, L, P, S, Cin, is_bf16, stream);
}

// K3: mpi only (no w_v, no pooled output).
extern "C" int patch_reduce_launch(const void* y, const void* patches, const void* wp, void* mpi, int B, int L, int P,
                                   int S, int Cin, int is_bf16, void* stream) {
    return launch<false>(y, patches, wp, nullptr, mpi, nullptr, B, L, P, S, Cin, is_bf16, stream);
}
