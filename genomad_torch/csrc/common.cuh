// Shared device helpers for the genomad_torch kernels.
//
// Every kernel is instantiated for float (f32 parity runs) and
// __nv_bfloat16 (production), always accumulating in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// conv_epilogue on two channels at once, in bf16x2: the f32 sums rounded
// to bf16, the bias added in bf16 (one rounding of the exact sum, as the
// f32 add of two bf16 values then rounded to bf16 gives), LeakyReLU as
// max(v, v * slope) in bf16, which is where(v >= 0, v, v * slope) for a
// slope in [0, 1], NaN included
__device__ __forceinline__ uint32_t conv_epilogue_bf16x2(float lo, float hi, __nv_bfloat162 bias2,
                                                         __nv_bfloat162 slope2, int leaky) {
    __nv_bfloat162 v = __hadd2(__floats2bfloat162_rn(lo, hi), bias2);
    if (leaky) v = __hmax2_nan(v, __hmul2(v, slope2));
    return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace gt
