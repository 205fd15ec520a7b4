// K4 causal_conv: the IGLOO conv2/conv3 layers, a width-6 causal
// convolution (B, L, C) -> (B, L, C) plus bias and optional LeakyReLU.
//
//   out[b, t, :] = bias + sum_{k<6} x[b, t-5+k, :] @ W[k]      (x[t<0] = 0)
//
// Replaces genomad_tpu/ops/conv_pallas.py `causal_conv` (`_conv_kernel`).
//
// What bounds it on an H100: operations. At B=128, L=6016, C=128 it is one
// GEMM of M = B*L = 770,048 rows, N = 128, K = 6*128 = 768: 151 GFLOP, 0.153
// ms at 989 TFLOP/s in bf16, against 394 MB of x read and out written (0.118
// ms at 3.35 TB/s). So the tensor cores must stay fed, and W, the same for
// every row, must not be fetched again for every tile. Measured on the card
// at 700 W, tensor cores and memory busy together hold it at its power limit
// with the SM clock near 1.45 GHz (PERF.md, section 6).
//
// Design (bf16, C = 128): a persistent grid of one block per SM. A block
// holds all six taps of W in shared memory for its whole life (196,608 B,
// loaded once) and walks tiles of TM = 64 output rows of one sequence. Two
// consumer warpgroups take alternate tiles, each with its own x buffer of
// the tile's 64 rows plus the 5-row causal halo (17,664 B); a producer warp
// fills the buffers by TMA, one load per tile, as each is freed:
//   196,608 (W) + 2 x 17,664 (x) + 4 x 8 (mbarriers) = 231,968
// of the 232,448 B a block may use. Each tile is 48 `wgmma.mma_async`
// m64n128k16 (6 taps x 8 k steps of 16 channels), f32 accumulators in
// registers (64 per thread), both operands read from shared memory through
// descriptors:
//  - x is stored without swizzle as xs[channel/8][row] in 16-byte cells, so
//    a core matrix (8 rows x 8 channels) is 128 contiguous bytes at any row.
//    The A operand of tap k is the buffer shifted down by k rows: its
//    descriptor starts k * 16 bytes later. (The 128B-swizzled layout repeats
//    every 8 rows and cannot start 1-5 rows in.) The TMA tensor map views x
//    as (8 channels, L, 16 cells, B) with strides (2, 256, 16, 256 L) bytes,
//    so one box (8, 69, 16, 1) lands in that layout; the rows before t = 0
//    and past L are out of bounds and arrive as zeros.
//  - W[k] (C_in x C_out, C_out contiguous) is an MN-major B operand, read
//    with the transpose flag, stored without swizzle in core matrices of 8
//    input x 8 output channels, copied in 16-byte cells as stored in memory.
// Each buffer has a full and an empty mbarrier: the producer waits for
// empty, the TMA completes full, the consumer waits for full and arrives on
// empty as soon as its products are done, before its epilogue. The
// consumers take turns to issue their products, so one's epilogue runs
// while the other's products run. The epilogue works from registers in
// bf16x2 with the JAX rounding points of gt::conv_epilogue, then a quad
// transpose gives each lane 16 contiguous bytes to store; rows past L are
// masked. Each output element is one warpgroup's fixed sequence of
// products: no atomics, a rerun is bit-equal.
//
// Design (f32, parity runs): one block per (tile of TLF positions, batch
// row) on the CUDA cores in full f32, one thread per output channel holding
// TLF accumulators.
//
// Takes f32 (parity) and bf16 (production); accumulates in f32.

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace gt;

constexpr int KS = 6;
constexpr int HALO = KS - 1;

// ---- bf16 path (C fixed at the model's 128 channels) ----
constexpr int C = 128;
constexpr int TM = 64;                    // output rows per tile (one wgmma M)
constexpr int XROWS = TM + HALO;          // 69 rows per x buffer
constexpr int CELL = 16;                  // bytes of 8 bf16 channels
constexpr int KC = C / 8;                 // 16 cells per row
constexpr int W_TAP_BYTES = C * C * 2;    // 32,768
constexpr int W_BYTES = KS * W_TAP_BYTES; // 196,608
constexpr int X_BYTES = KC * XROWS * CELL;  // 17,664
constexpr int CONSUMERS = 2;              // warpgroups, one x buffer each
constexpr int THREADS = CONSUMERS * 128 + 32;  // + a producer warp
constexpr size_t SMEM_BF16 = (size_t)W_BYTES + CONSUMERS * X_BYTES + 4 * 8;  // 231,968
static_assert(SMEM_BF16 <= 232448, "a block may use 227 KB of shared memory");
// W in shared memory: tap k, core matrix (ci/8, co/8), row ci%8 of 16 bytes
constexpr int W_LBO = KC * 128;  // next 8 input channels (K direction)
constexpr int W_SBO = 128;       // next 8 output channels (N direction)
// x in shared memory: cell (channel/8, row) at (channel/8 * XROWS + row) * 16
constexpr int X_LBO = XROWS * CELL;  // next 8 channels (K direction)
constexpr int X_SBO = 8 * CELL;      // next 8 rows (M direction)

// the turn to issue products passes between the two warpgroups (barriers 3, 4)
__device__ __forceinline__ void wait_turn(int wg) { asm volatile("bar.sync %0, 256;\n" ::"r"(wg + 3) : "memory"); }
__device__ __forceinline__ void pass_turn(int wg) { asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory"); }

// gt::conv_epilogue on two columns at once, in bf16x2: the f32 sums rounded
// to bf16, the bias added in bf16 (one rounding of the exact sum, as the
// f32 add of two bf16 values then rounded to bf16 gives), LeakyReLU as
// max(v, v * slope) in bf16, which is where(v >= 0, v, v * slope) for a
// slope in [0, 1], NaN included
__device__ __forceinline__ uint32_t epilogue_bf16x2(float lo, float hi, __nv_bfloat162 bias2, __nv_bfloat162 slope2,
                                                    int leaky) {
    __nv_bfloat162 v = __hadd2(__floats2bfloat162_rn(lo, hi), bias2);
    if (leaky) v = __hmax2_nan(v, __hmul2(v, slope2));
    return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 1) causal_conv_bf16(
    const __grid_constant__ CUtensorMap xmap, const gt::bf16* __restrict__ w, const gt::bf16* __restrict__ bias,
    gt::bf16* __restrict__ out, int L, int tiles, int tiles_per_seq, float slope, int leaky) {
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t ws = smem_addr(smem);
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const uint32_t bars = ws + W_BYTES + CONSUMERS * X_BYTES;  // full[2], then empty[2]

    // W once per block: global cell i = (k*C + ci)*KC + co/8
    for (int i = threadIdx.x; i < KS * C * KC; i += THREADS) {
        const int cc = i % KC;
        const int ci = (i / KC) % C;
        const int k = i / (KC * C);
        cp_async16(ws + k * W_TAP_BYTES + (ci / 8) * W_LBO + cc * W_SBO + (ci % 8) * CELL, w + (size_t)i * 8);
    }
    cp_async_commit();
    if (threadIdx.x == 0) {
        for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // W and the barriers are ready
    const int stride = gridDim.x * CONSUMERS;

    if (wg == CONSUMERS) {
        // producer: one lane loads each warpgroup's tiles in the order the
        // warpgroups take them, each into its buffer once that is empty
        if (t == 0) {
            for (int r = 0;; ++r) {
                const int base = blockIdx.x * CONSUMERS + r * stride;
                if (base >= tiles) break;
                for (int g = 0; g < CONSUMERS && base + g < tiles; ++g) {
                    const int tile = base + g;
                    const int b = tile / tiles_per_seq;
                    const int t0 = (tile - b * tiles_per_seq) * TM;
                    const uint32_t full = bars + 8 * g, empty = bars + 8 * (2 + g);
                    mbar_wait(empty, (r & 1) ^ 1);
                    mbar_expect(full, X_BYTES);
                    asm volatile(
                        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
                        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(ws + W_BYTES + g * X_BYTES),
                        "l"(reinterpret_cast<uint64_t>(&xmap)), "r"(0), "r"(t0 - HALO), "r"(0), "r"(b), "r"(full)
                        : "memory");
                }
            }
        }
        return;
    }

    const uint32_t xs = ws + W_BYTES + wg * X_BYTES;
    const int lane = t % 32;
    const int row_in_tile = (t / 32) * 16 + lane / 4;
    __nv_bfloat162 bias2[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) bias2[j] = *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * j + 2 * (lane % 4));
    const __nv_bfloat162 slope2 = __float2bfloat162_rn(slope);
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    int r = 0;
    for (int tile = blockIdx.x * CONSUMERS + wg; tile < tiles; tile += stride, ++r) {
        mbar_wait(bars + 8 * wg, r & 1);  // the tile's x rows are in
        // the warpgroups take turns to issue a tile's products (warpgroup 0
        // first), so one's run on the tensor cores while the other's
        // epilogue runs, instead of both running at half speed side by side
        if (wg == 1 || tile >= stride) wait_turn(wg);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < KS; ++k) {
#pragma unroll
            for (int kk = 0; kk < C / 16; ++kk) {
                const uint64_t da = desc(xs + 2 * kk * X_LBO + k * CELL, X_LBO, X_SBO);
                const uint64_t db = desc(ws + k * W_TAP_BYTES + 2 * kk * W_LBO, W_LBO, W_SBO);
                wgmma_m64n128k16(d, da, db, k | kk);
            }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // pass the turn when the other warpgroup has a tile to take it for
        if (wg == 0 ? tile + 1 < tiles : tile - 1 + stride < tiles) pass_turn(wg);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wg_barrier(wg);                                 // every warp's products are done:
        if (t == 0) mbar_arrive(bars + 8 * (2 + wg));  // the buffer is free for the next tile

        // epilogue: lane q of a quad holds columns 8j + 2q, +1 of its two
        // rows; a quad transpose gives each lane 8 whole columns (16 bytes)
        // of 4 column blocks, so a warp writes 64 contiguous bytes per row
        const int b = tile / tiles_per_seq;
        const int t0 = (tile - b * tiles_per_seq) * TM;
        const int q = lane % 4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int pos = t0 + row_in_tile + 8 * half;
            gt::bf16* orow = out + ((size_t)b * L + pos) * C;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                uint32_t a[4];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int j = 4 * m + jj;
                    a[jj] = epilogue_bf16x2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1], bias2[j], slope2, leaky);
                }
                quad_transpose(a, q);
                if (pos < L) *reinterpret_cast<uint4*>(orow + 8 * (4 * m + q)) = make_uint4(a[0], a[1], a[2], a[3]);
            }
        }
    }
}

// ---- f32 path (parity runs; any C with (TLF + HALO) * C floats <= 48 KB) ----
constexpr int TLF = 32;
constexpr int THREADS_F32 = 128;

__global__ void __launch_bounds__(THREADS_F32) causal_conv_f32(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int L, int Cf, float slope, int leaky) {
    extern __shared__ float xsf[];  // (TLF + HALO) x Cf
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * TLF;
    const float* xb = x + (size_t)b * L * Cf;
    for (int i = threadIdx.x; i < (TLF + HALO) * Cf; i += THREADS_F32) {
        const int r = i / Cf;
        const int c = i - r * Cf;
        const int t = t0 - HALO + r;
        xsf[i] = (t >= 0 && t < L) ? xb[(size_t)t * Cf + c] : 0.f;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < Cf; c += THREADS_F32) {
        float acc[TLF];
#pragma unroll
        for (int r = 0; r < TLF; ++r) acc[r] = 0.f;
        for (int k = 0; k < KS; ++k) {
            for (int ci = 0; ci < Cf; ++ci) {
                const float wv = w[((size_t)k * Cf + ci) * Cf + c];
#pragma unroll
                for (int r = 0; r < TLF; ++r) acc[r] = fmaf(xsf[(r + k) * Cf + ci], wv, acc[r]);
            }
        }
        const float bc = bias[c];
#pragma unroll
        for (int r = 0; r < TLF; ++r) {
            const int t = t0 + r;
            if (t < L) out[((size_t)b * L + t) * Cf + c] = gt::conv_epilogue<float>(acc[r], bc, slope, leaky);
        }
    }
}

}  // namespace

extern "C" int causal_conv_launch(const void* x, const void* w, const void* bias, void* out, int B, int L,
                                  int Cin, int is_bf16, float slope, int leaky, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        if (Cin != C) return static_cast<int>(cudaErrorInvalidValue);
        const int tiles_per_seq = (L + TM - 1) / TM;
        const long long tiles = (long long)B * tiles_per_seq;
        if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
        int dev = 0, sms = 0;
        CUtensorMap map;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(causal_conv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BF16));
        if (err == cudaSuccess) err = gt::rows_tensor_map(&map, x, B, L, XROWS);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int blocks = static_cast<int>(std::min<long long>(sms, (tiles + CONSUMERS - 1) / CONSUMERS));
        causal_conv_bf16<<<blocks, THREADS, SMEM_BF16, s>>>(
            map, static_cast<const gt::bf16*>(w), static_cast<const gt::bf16*>(bias), static_cast<gt::bf16*>(out),
            L, static_cast<int>(tiles), tiles_per_seq, slope, leaky);
    } else {
        const size_t smem = (size_t)(TLF + HALO) * Cin * sizeof(float);
        if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid((L + TLF - 1) / TLF, B);
        causal_conv_f32<<<grid, THREADS_F32, smem, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
            static_cast<float*>(out), L, Cin, slope, leaky);
    }
    return static_cast<int>(cudaGetLastError());
}
