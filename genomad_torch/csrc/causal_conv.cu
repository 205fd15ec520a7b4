// K4 causal_conv: the IGLOO conv2/conv3 layers, a width-6 causal
// convolution (B, L, C) -> (B, L, C) plus bias and optional LeakyReLU.
//
//   out[b, t, :] = bias + sum_{k<6} x[b, t-5+k, :] @ W[k]      (x[t<0] = 0)
//
// Replaces genomad_tpu/ops/conv_pallas.py `causal_conv` (`_conv_kernel`).
//
// What bounds it on an H100: operations. At B=128, L=6016, C=128 it is
// 2*6*128^2*L*B = 151 GFLOP (0.15 ms at 989 TFLOP/s in bf16) against 394 MB
// of reads and writes (0.12 ms at 3.35 TB/s), so it needs the tensor cores.
//
// Design (bf16): one block per (tile of TL=128 positions, batch row) holds
// the x rows t0-5 .. t0+TL-1 in shared memory (zero rows before t=0 and
// past L), so the 5-row causal halo is read from device memory once per
// tile instead of carried across a sequential grid as on the TPU. The six
// taps run as bf16 tensor-core products (WMMA 16x16x16, f32 accumulation):
// each of the 8 warps owns 16 output rows x all 128 channels, and W[k]
// (32 KB) is streamed through shared memory one tap at a time. The f32
// accumulators are staged through shared memory for a coalesced epilogue
// (bias, LeakyReLU, rounding as in the JAX graph). wgmma/TMA pipelining is
// left for a later change.
//
// Design (f32, parity runs): the same tiling on the CUDA cores in full f32,
// one thread per output channel holding TLF accumulators.
//
// Takes f32 (parity) and bf16 (production); accumulates in f32.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int KS = 6;
constexpr int HALO = KS - 1;

// ---- bf16 tensor-core path (C fixed at the model's 128 channels) ----
constexpr int C = 128;
constexpr int TL = 128;
constexpr int XROWS = TL + HALO;
constexpr int LDX = C + 16;  // 288-byte rows: every fragment pointer stays 32-byte aligned
constexpr int LDW = C + 16;
constexpr int LDO = C + 4;
constexpr int WARPS = TL / 16;
constexpr int THREADS = WARPS * 32;
constexpr int VPR = C / 8;  // 16-byte vectors per row
constexpr size_t SMEM_BF16 = (size_t)(XROWS * LDX + C * LDW) * sizeof(gt::bf16);
static_assert((size_t)TL * LDO * sizeof(float) <= SMEM_BF16, "f32 staging reuses the operand tiles");
static_assert((XROWS * LDX * sizeof(gt::bf16)) % 32 == 0, "W tile stays 32-byte aligned");

__global__ void __launch_bounds__(THREADS) causal_conv_bf16(
    const gt::bf16* __restrict__ x, const gt::bf16* __restrict__ w, const gt::bf16* __restrict__ bias,
    gt::bf16* __restrict__ out, int L, float slope, int leaky) {
    extern __shared__ __align__(128) unsigned char smem[];
    gt::bf16* xs = reinterpret_cast<gt::bf16*>(smem);
    gt::bf16* ws = xs + XROWS * LDX;
    float* os = reinterpret_cast<float*>(smem);

    const int b = blockIdx.y;
    const int t0 = blockIdx.x * TL;
    const gt::bf16* xb = x + (size_t)b * L * C;
    for (int i = threadIdx.x; i < XROWS * VPR; i += THREADS) {
        const int r = i / VPR;
        const int v = i - r * VPR;
        const int t = t0 - HALO + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (t >= 0 && t < L) val = *reinterpret_cast<const uint4*>(xb + (size_t)t * C + v * 8);
        *reinterpret_cast<uint4*>(xs + r * LDX + v * 8) = val;
    }

    const int warp = threadIdx.x >> 5;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C / 16];
#pragma unroll
    for (int j = 0; j < C / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

    for (int k = 0; k < KS; ++k) {
        __syncthreads();  // x tile is in; the previous tap's reads of ws are done
        const gt::bf16* wk = w + (size_t)k * C * C;
        for (int i = threadIdx.x; i < C * VPR; i += THREADS) {
            const int r = i / VPR;
            const int v = i - r * VPR;
            *reinterpret_cast<uint4*>(ws + r * LDW + v * 8) =
                *reinterpret_cast<const uint4*>(wk + (size_t)r * C + v * 8);
        }
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < C / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, gt::bf16, wmma::row_major> a;
            // output rows warp*16.. read x rows (warp*16 + k).. of the tile (tap k)
            wmma::load_matrix_sync(a, xs + (warp * 16 + k) * LDX + kk * 16, LDX);
#pragma unroll
            for (int j = 0; j < C / 16; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, gt::bf16, wmma::row_major> bm;
                wmma::load_matrix_sync(bm, ws + kk * 16 * LDW + j * 16, LDW);
                wmma::mma_sync(acc[j], a, bm, acc[j]);
            }
        }
    }
    __syncthreads();  // operand tiles are dead; reuse them as f32 staging
#pragma unroll
    for (int j = 0; j < C / 16; ++j)
        wmma::store_matrix_sync(os + warp * 16 * LDO + j * 16, acc[j], LDO, wmma::mem_row_major);
    __syncthreads();

    for (int i = threadIdx.x; i < TL * (C / 2); i += THREADS) {
        const int r = i / (C / 2);
        const int c = (i - r * (C / 2)) * 2;
        const int t = t0 + r;
        if (t >= L) break;
        const float v0 = gt::conv_epilogue<gt::bf16>(os[r * LDO + c], gt::to_float(bias[c]), slope, leaky);
        const float v1 = gt::conv_epilogue<gt::bf16>(os[r * LDO + c + 1], gt::to_float(bias[c + 1]), slope, leaky);
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * L + t) * C + c) = __floats2bfloat162_rn(v0, v1);
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
        cudaError_t err = cudaFuncSetAttribute(causal_conv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(SMEM_BF16));
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid((L + TL - 1) / TL, B);
        causal_conv_bf16<<<grid, THREADS, SMEM_BF16, s>>>(
            static_cast<const gt::bf16*>(x), static_cast<const gt::bf16*>(w),
            static_cast<const gt::bf16*>(bias), static_cast<gt::bf16*>(out), L, slope, leaky);
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
