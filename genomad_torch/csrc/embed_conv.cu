// K5 embed_conv: the IGLOO first layer, a width-6 causal convolution over
// one-hot(V) tokens, plus bias and LeakyReLU.
//
//   out[b, t, :] = bias + sum_{k<6} W[k, tok[b, t-5+k], :]
//
// Replaces genomad_tpu/ops/conv_pallas.py `embed_conv` (`_embed_kernel`).
// Positions t-5+k < 0 are causal padding and add nothing; the N token (0)
// is a real row W[k, 0]. The two are kept apart with a -1 sentinel in the
// staged tokens, as `_embed_kernel` does with its halo.
//
// What bounds it on an H100: bytes. Per output element it reads 6 table
// rows and writes one value; the 6 x V x C table (394 KB in bf16, 790 KB in
// f32) stays in L2, so device memory sees the token read and the output
// write (197 MB of bf16 output at B=128, L=6016).
//
// Design: the TPU needed a one-hot matrix product because its gathers are
// slow; here a direct row gather is the natural form. One block per
// (tile of TL positions, batch row) stages its TL+5 tokens in shared
// memory; threads run across channels, so each table-row read and each
// output write is coalesced.
//
// Takes f32 (parity) and bf16 (production); sums in f32.

#include "common.cuh"

namespace {

constexpr int KS = 6;
constexpr int HALO = KS - 1;
constexpr int TL = 32;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) embed_conv_kernel(
    const int* __restrict__ tokens, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ out, int L, int V, int C, float slope, int leaky) {
    __shared__ int tok[TL + HALO];
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * TL;
    for (int i = threadIdx.x; i < TL + HALO; i += THREADS) {
        const int t = t0 - HALO + i;
        tok[i] = (t >= 0 && t < L) ? tokens[(size_t)b * L + t] : -1;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TL * C; idx += THREADS) {
        const int r = idx / C;
        const int c = idx - r * C;
        const int t = t0 + r;
        if (t >= L) break;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
            const int v = tok[r + k];
            if (v >= 0) acc += gt::to_float(w[((size_t)k * V + v) * C + c]);
        }
        const float y = gt::conv_epilogue<T>(acc, gt::to_float(bias[c]), slope, leaky);
        out[((size_t)b * L + t) * C + c] = gt::from_float<T>(y);
    }
}

}  // namespace

extern "C" int embed_conv_launch(const void* tokens, const void* w, const void* bias, void* out,
                                 int B, int L, int V, int C, int is_bf16, float slope, int leaky,
                                 void* stream) {
    const dim3 grid((L + TL - 1) / TL, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        embed_conv_kernel<gt::bf16><<<grid, THREADS, 0, s>>>(
            static_cast<const int*>(tokens), static_cast<const gt::bf16*>(w),
            static_cast<const gt::bf16*>(bias), static_cast<gt::bf16*>(out), L, V, C, slope, leaky);
    } else {
        embed_conv_kernel<float><<<grid, THREADS, 0, s>>>(
            static_cast<const int*>(tokens), static_cast<const float*>(w),
            static_cast<const float*>(bias), static_cast<float*>(out), L, V, C, slope, leaky);
    }
    return static_cast<int>(cudaGetLastError());
}
