// Hopper building blocks shared by the tensor-core kernels (K4 causal_conv,
// K2/K3 fused_reduce): shared-memory addresses and wgmma descriptors,
// cp.async, mbarriers, the m64n128k16 bf16 wgmma, a quad transpose, and the
// TMA tensor map that lands 128-channel bf16 rows in the [channel/8][row]
// cell layout both kernels feed to wgmma as the A operand.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cstdint>

#include "common.cuh"

namespace gt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle: start, leading (K) and stride
// (M/N) byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// the 128 threads of warpgroup wg (named barrier wg + 1)
__device__ __forceinline__ void wg_barrier(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory"); }

// d += A (64 x 16, K-major) @ B (16 x 128, MN-major), or d = A @ B when !accumulate
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// 4x4 transpose of 32-bit words across the 4 lanes of a quad: lane q's
// a[s] becomes lane s's a[q]
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int q) {
#pragma unroll
    for (int bit = 1; bit <= 2; bit <<= 1) {
        const bool upper = q & bit;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (i & bit) continue;
            const uint32_t recv = __shfl_xor_sync(0xffffffffu, upper ? a[i] : a[i + bit], bit);
            if (upper)
                a[i] = recv;
            else
                a[i + bit] = recv;
        }
    }
}

__device__ __forceinline__ void mbar_init(uint32_t a, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t a, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t a) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a) : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t a, int parity) {
    asm volatile(
        "{\n.reg .pred p;\nWAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT_%=;\n}\n" ::"r"(a), "r"(parity) : "memory");
}

// cuTensorMapEncodeTiled, looked up through the runtime so that the
// libraries do not link libcuda
static cudaError_t tensor_map_encoder(PFN_cuTensorMapEncodeTiled_v12000* encode) {
    static PFN_cuTensorMapEncodeTiled_v12000 found_fn = nullptr;
    if (!found_fn) {
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&found_fn),
                                                        cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    }
    *encode = found_fn;
    return cudaSuccess;
}

// The TMA tensor map of a (B, L, 128) bf16 tensor read in boxes of `rows`
// rows of one sequence: it views the tensor as (8 channels, L, 16 cells, B)
// with strides (2, 256, 16, 256 L) bytes, so a box (8, rows, 16, 1) lands in
// shared memory as [channel/8][row] cells of 16 bytes, and rows outside
// [0, L) arrive as zeros. Built for each call.
static cudaError_t rows_tensor_map(CUtensorMap* map, const void* x, int B, int L, int rows) {
    PFN_cuTensorMapEncodeTiled_v12000 encode;
    const cudaError_t err = tensor_map_encoder(&encode);
    if (err != cudaSuccess) return err;
    constexpr int channels = 128;
    cuuint64_t dims[4] = {8, (cuuint64_t)L, channels / 8, (cuuint64_t)B};
    cuuint64_t strides[3] = {channels * 2, 16, (cuuint64_t)L * channels * 2};  // bytes, dims 1-3
    cuuint32_t box[4] = {8, (cuuint32_t)rows, channels / 8, 1};
    cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
                                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same tensor read in boxes of `rows` rows x 64 channels (128-byte box
// rows, one request each) that land with the 128-byte swizzle: row r of a
// box at r * 128 bytes, its 16-byte chunk j at chunk j ^ (r % 8). A tile of
// 128 channels is two boxes, at channels 0 and 64; rows outside [0, L)
// arrive as zeros. Built for each call.
static cudaError_t rows_tensor_map_sw128(CUtensorMap* map, const void* x, int B, int L, int rows) {
    PFN_cuTensorMapEncodeTiled_v12000 encode;
    const cudaError_t err = tensor_map_encoder(&encode);
    if (err != cudaSuccess) return err;
    constexpr int channels = 128;
    cuuint64_t dims[3] = {channels, (cuuint64_t)L, (cuuint64_t)B};
    cuuint64_t strides[2] = {channels * 2, (cuuint64_t)L * channels * 2};  // bytes, dims 1-2
    cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
    cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
                                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace gt
