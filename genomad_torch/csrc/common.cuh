// Shared device helpers for the genomad_torch kernels.
//
// Every kernel is instantiated for float (f32 parity runs) and
// __nv_bfloat16 (production), always accumulating in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Round an f32 value to T and back (round to nearest even, as PyTorch and
// JAX convert).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// Conv epilogue with the rounding points of the JAX graph
// (genomad_tpu/models/igloo.py: the conv result is produced in the compute
// dtype T, the bias is added in T, LeakyReLU is applied in T). `slope` is
// the LeakyReLU slope already rounded to T by the caller. The caller's store
// to T does the last rounding.
template <typename T>
__device__ __forceinline__ float conv_epilogue(float acc, float bias, float slope, int leaky) {
    float v = round_to<T>(round_to<T>(acc) + bias);
    if (leaky && !(v >= 0.f)) v *= slope;
    return v;
}

}  // namespace gt
