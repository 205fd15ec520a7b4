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
// `patch_reduce_launch`, mpi only). The patch reduction is the same code in
// both, so K3's mpi is K2's bit for bit.
//
// Replaces genomad_tpu/ops/patch_reduce.py `fused_reduce` (`_kernel_fused`
// through `_fused_values`) and `patch_reduce` (`_kernel` through
// `_slot_values`).
//
// What bounds them on an H100: bytes. At B=128 K2 must read y once (197 MB,
// 0.06 ms at 3.35 TB/s); the value projection is 25 GFLOP (0.03 ms in bf16
// on the tensor cores) and the patch dots 0.3 GFLOP. So y is streamed once,
// and nothing else may cost a pass over it.
//
// Design (bf16, C = 128): a persistent grid of at most one block per SM; a
// block owns whole batch rows (b = blockIdx.x, + gridDim.x, ...) and walks
// each row's tiles of TM = 64 rows (8 pool windows, aligned to the pool).
// Against what held PR 1's kernel (a block per (tile, row), 12,032 blocks):
//  1. w_v is loaded once per block and stays resident in shared memory as
//     the MN-major wgmma B operand, in core matrices of 8 input x 8 output
//     channels without swizzle, as K4 holds each tap of W (it was copied
//     again by every block: ~394 MB of L2 reads per launch).
//  2. A producer warp loads each y tile by TMA into a ring of NS buffers
//     with full/empty mbarriers: two boxes of 64 rows x 64 channels with the
//     128-byte swizzle (hopper.cuh `rows_tensor_map_sw128`; 128-byte box
//     rows, where K4's [channel/8][row] cells make 16-byte ones and 8x the
//     requests). Rows past L arrive as zeros and fall only in windows j >=
//     L / 8, which are never written. Warpgroup 0 issues 8 `wgmma`
//     m64n128k16 per tile from swizzled K-major descriptors (was WMMA with
//     B fragments reloaded by every warp, nothing asynchronous).
//  3. Warpgroup 0 max-pools in registers (was an f32 pass through shared
//     memory and three __syncthreads per tile): in the m64nN accumulator
//     layout lane / 4 walks the 8 rows of one pool window, so three xor
//     shuffles (16, 8, 4) reduce them, each halving what a lane keeps, on
//     bf16x2 pairs (rounding is monotone, so rounding before the max gives
//     the bits of rounding after it); a quad transpose then gives each lane
//     16 contiguous bytes to store.
//  4. The patch dots come from the staged tile, not from a gather of 2-byte
//     loads (was 275 MB of y rows and 275 MB of w_patch from L2 per launch):
//     a slot table built once from the patches (ops/patch_reduce.py
//     `slot_table`, kept by the model) lists each tile's (p, s) slots by
//     position, with w_patch's rows in the same order, cell-major, so that
//     32 neighbouring slots' cells are 512 contiguous bytes. The block
//     copies the index into shared memory once. Warpgroups 1 and 2 take
//     alternate tiles: each thread dots one slot's w_patch row (16 loads of
//     16 bytes, issued a tile ahead) with the y row's cells in shared
//     memory, in f32. The block keeps its row's P S slot dots in shared
//     memory (33.6 KB at 2,100 x 4) and, after the row's last tile, sums
//     each patch's slots in order s = 0..S-1 and stores mpi. w_patch is not
//     reused across batch rows: a block owns one row at a time.
// A buffer is free once the products and its tile's dots are done (empty
// counts two arrivals; one in K3). No atomics: a rerun is bit-equal. With
// B <= 132 every row has its own SM; more rows take a second round.
//
// Design (f32, parity runs; and K3 in bf16 at C != 128): one block per (tile
// of TR positions, batch row); the projection on the CUDA cores in full
// f32; one warp per patch with 2-byte loads.
//
// Takes f32 (parity runs) and bf16 (production); accumulates in f32.

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace gt;

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
constexpr int TM = 64;                     // rows per tile (one wgmma M, 8 pool windows)
constexpr int CELL = 16;                   // bytes of 8 bf16 channels
constexpr int KC = C / 8;                  // 16 cells per row
constexpr int TILE_BYTES = KC * TM * CELL;  // 16,384
constexpr int WV_BYTES = C * C * 2;        // 32,768
constexpr int NS = 6;                      // ring buffers
// warpgroup 0 runs every tile's products and pool, warpgroups 1 and 2 take
// alternate tiles' slot dots, warp 12 is the producer
constexpr int DOTS = 2;
constexpr int PRODUCER = 1 + DOTS;         // its warpgroup index
constexpr int THREADS_TC = PRODUCER * 128 + 32;
constexpr int BARS_BYTES = 2 * NS * 8;     // full[NS], empty[NS]
static_assert(NS % DOTS == 0, "a buffer always serves the same slot-dot warpgroup, which sees each of its phases");
// w_v in shared memory: core matrix (ci/8, co/8), row ci%8 of 16 bytes
constexpr int W_LBO = KC * 128;  // next 8 input channels (K direction)
constexpr int W_SBO = 128;       // next 8 output channels (N direction)
// a y tile in shared memory: two halves of 64 channels, each TM rows of 128
// bytes in the 128-byte swizzle (hopper.cuh `rows_tensor_map_sw128`)
constexpr int HALF_BYTES = TILE_BYTES / 2;

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes in 8-row atoms of 1,024 bytes (the stride offset); the atom is
// 1,024-byte aligned, and a k step of 16 channels starts 32 bytes further
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// the 16-byte cell c (channels 8c..8c+7) of row r of a staged tile, in
// 16-byte units
__device__ __forceinline__ int tile_cell(int c, int r) { return (c / 8) * (HALF_BYTES / 16) + r * 8 + ((c % 8) ^ (r % 8)); }

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
    const __nv_bfloat162 v =
        __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a), *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&v);
}
// 8 channels of a row against 8 of a weight row, each 4 bf16x2 words, in f32
__device__ __forceinline__ float dot8(uint4 y, uint4 w, float acc) {
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        acc = fmaf(__uint_as_float(ys[i] << 16), __uint_as_float(ws[i] << 16), acc);
        acc = fmaf(__uint_as_float(ys[i] & 0xffff0000u), __uint_as_float(ws[i] & 0xffff0000u), acc);
    }
    return acc;
}

// The max over the 8 rows of each of the warp's two pool windows, from the
// m64n128 accumulators (thread t of the warpgroup holds rows 16 (t / 32) +
// t % 32 / 4 + 8 h, columns 8 j + 2 (t % 4) + {0, 1} in d[4 j + 2 h + {0,
// 1}]), stored as bf16 rows of pooled. Each xor step keeps half of what a
// lane holds: after them lane (r2, r1, r0, q) holds window 2 warp + r2,
// column blocks 8 r1 + 4 r0 + {0..3} at columns 2 q, +1; a quad transpose
// gives it column block 8 r1 + 4 r0 + q whole.
__device__ __forceinline__ void pool_store(const float (&d)[64], gt::bf16* __restrict__ pooled_b, int window0,
                                           int n_pool, int lane) {
    const int q = lane & 3;
    const bool r0 = lane & 4, r1 = lane & 8, r2 = lane & 16;
    uint32_t a[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const uint32_t h0 = bf16x2_bits(d[4 * j], d[4 * j + 1]);
        const uint32_t h1 = bf16x2_bits(d[4 * j + 2], d[4 * j + 3]);
        a[j] = max_bf16x2(r2 ? h1 : h0, __shfl_xor_sync(0xffffffffu, r2 ? h0 : h1, 16));
    }
    uint32_t b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = max_bf16x2(r1 ? a[8 + j] : a[j], __shfl_xor_sync(0xffffffffu, r1 ? a[j] : a[8 + j], 8));
    uint32_t c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = max_bf16x2(r0 ? b[4 + j] : b[j], __shfl_xor_sync(0xffffffffu, r0 ? b[j] : b[4 + j], 4));
    quad_transpose(c, q);
    const int window = window0 + (r2 ? 1 : 0);
    const int block = (r1 ? 8 : 0) + (r0 ? 4 : 0) + q;
    if (window < n_pool) *reinterpret_cast<uint4*>(pooled_b + (size_t)window * C + 8 * block) = make_uint4(c[0], c[1], c[2], c[3]);
}

// The w_patch row of slot k of the slot table, 16 loads of 16 bytes in
// flight: the table keeps the rows cell-major in its own slot order (cell c
// of slot k at c * PS + k), so a warp's load of one cell for 32 neighbouring
// slots reads 512 contiguous bytes.
__device__ __forceinline__ void load_slot_w(const uint4* __restrict__ slot_w, int PS, int k, uint4 (&w)[KC]) {
#pragma unroll
    for (int c = 0; c < KC; ++c) w[c] = __ldg(slot_w + (size_t)c * PS + k);
}

// Thread t's first slot of a tile (slot start[tile] + t), if it has one:
// its w_patch cells are loaded a tile ahead, while the tile before is done.
__device__ __forceinline__ void prefetch_slot_w(const int* start, int table_tiles, int tile, int t,
                                                const uint4* __restrict__ slot_w, int PS, uint4 (&w)[KC]) {
    if (tile < table_tiles && start[tile] + t < start[tile + 1]) load_slot_w(slot_w, PS, start[tile] + t, w);
}

// The slot dots of one tile, read from the staged tile: thread t of the
// warpgroup takes the tile's slots start[tile] + t, + 128, ... (the first
// with its w_patch cells already in w), dots each slot's w_patch row with
// the y row's cells in shared memory, in f32, and stores the dot in
// slot_dots[p S + s]. The slots of a tile are ordered by position, so
// neighbouring lanes read the same or neighbouring rows.
__device__ __forceinline__ void tile_slot_dots(const uint4* ys, const int* start, const int* entries, int table_tiles,
                                               int tile, const uint4* __restrict__ slot_w, int PS, float* slot_dots,
                                               int t, uint4 (&w)[KC]) {
    if (tile >= table_tiles) return;
    for (int k = start[tile] + t; k < start[tile + 1]; k += 128) {
        if (k != start[tile] + t) load_slot_w(slot_w, PS, k, w);
        const int row = entries[k] % TM;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c % 4] = dot8(ys[tile_cell(c, row)], w[c], acc[c % 4]);
        slot_dots[entries[k] / TM] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
}

// the 256 threads of the two slot-dot warpgroups (named barrier 4; 1-3 are
// the warpgroups' own)
__device__ __forceinline__ void dots_barrier() { asm volatile("bar.sync 4, 256;\n" ::: "memory"); }

template <bool POOLED>
__global__ void __launch_bounds__(THREADS_TC, 1) fused_reduce_tc(
    const __grid_constant__ CUtensorMap ymap, const gt::bf16* __restrict__ wv, const int* __restrict__ slots,
    const uint4* __restrict__ slot_w, float* __restrict__ mpi, gt::bf16* __restrict__ pooled, int B, int P, int S, int n_pool, int tiles_per_seq,
    int table_tiles) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // the swizzled tiles need 1,024-byte alignment: everything is laid out
    // from the first such address (the launch adds 1 KB for it)
    const uint32_t ws = (smem_addr(smem_raw) + 1023) & ~1023u;
    unsigned char* smem = smem_raw + (ws - smem_addr(smem_raw));
    const uint32_t ring = ws + (POOLED ? WV_BYTES : 0);
    const uint32_t bars = ring + NS * TILE_BYTES;  // full[NS], then empty[NS]
    float* slot_dots = reinterpret_cast<float*>(smem + (bars - ws) + BARS_BYTES);  // P * S, one batch row's
    int* table = reinterpret_cast<int*>(slot_dots + P * S);  // the slot table, for the block's life
    const int* start = table;
    const int* entries = table + table_tiles + 1;  // after the tile offsets
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;

    for (int k = threadIdx.x; k < table_tiles + 1 + P * S; k += THREADS_TC) table[k] = slots[k];

    if constexpr (POOLED) {  // w_v once per block: global cell i = ci * KC + co / 8
        for (int i = threadIdx.x; i < C * KC; i += THREADS_TC) {
            const int cc = i % KC, ci = i / KC;
            cp_async16(ws + (ci / 8) * W_LBO + cc * W_SBO + (ci % 8) * CELL, wv + (size_t)i * 8);
        }
        cp_async_commit();
    }
    if (threadIdx.x == 0) {
        for (int i = 0; i < 2 * NS; ++i) mbar_init(bars + 8 * i, i < NS || !POOLED ? 1 : 2);  // empty: products and dots
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (POOLED) {
        cp_async_wait_all();
        fence_async_shared();
    }
    __syncthreads();  // w_v, the slot table and the barriers are ready

    if (wg == PRODUCER) {
        // one lane loads the block's tiles in order, each into its buffer
        // once that is empty
        if (t == 0) {
            int i = 0;
            for (int b = blockIdx.x; b < B; b += gridDim.x) {
                for (int tile = 0; tile < tiles_per_seq; ++tile, ++i) {
                    const int st = i % NS;
                    const uint32_t full = bars + 8 * st, empty = bars + 8 * (NS + st);
                    mbar_wait(empty, ((i / NS) & 1) ^ 1);
                    mbar_expect(full, TILE_BYTES);
                    for (int h = 0; h < 2; ++h)  // channels 0-63, 64-127
                        asm volatile(
                            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
                            " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(ring + st * TILE_BYTES + h * HALF_BYTES),
                            "l"(reinterpret_cast<uint64_t>(&ymap)), "r"(64 * h), "r"(tile * TM), "r"(b), "r"(full)
                            : "memory");
                }
            }
        }
        return;
    }

    if (wg == 0) {  // the products and the pool of every tile
        if constexpr (POOLED) {
            const int lane = t % 32;
            const int warp = t / 32;
            float d[64];
#pragma unroll
            for (int k = 0; k < 64; ++k) d[k] = 0.f;
            int i = 0;
            for (int b = blockIdx.x; b < B; b += gridDim.x) {
                for (int tile = 0; tile < tiles_per_seq; ++tile, ++i) {
                    const int st = i % NS;
                    const uint32_t xs = ring + st * TILE_BYTES;
                    mbar_wait(bars + 8 * st, (i / NS) & 1);  // the tile's rows are in
                    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
                    for (int kk = 0; kk < C / 16; ++kk)
                        wgmma_m64n128k16(d, desc_sw128(xs + (kk / 4) * HALF_BYTES + (kk % 4) * 32),
                                         desc(ws + 2 * kk * W_LBO, W_LBO, W_SBO), kk);
                    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
                    for (int k = 0; k < 64; ++k) asm volatile("" : "+f"(d[k])::"memory");
                    wg_barrier(0);                                   // every warp's products are done:
                    if (t == 0) mbar_arrive(bars + 8 * (NS + st));  // its part of the buffer's release
                    pool_store(d, pooled + (size_t)b * n_pool * C, tile * (TM / POOL) + 2 * warp, n_pool, lane);
                }
            }
        }
        return;
    }

    // the slot dots: warpgroup 1 + g takes the tiles i = g, g + 2, ... of the
    // block's walk
    const int g = wg - 1;
    uint4 w[KC];  // the w_patch cells of this thread's slot in the warpgroup's next tile
    const int PS = P * S;
    prefetch_slot_w(start, table_tiles, g % tiles_per_seq, t, slot_w, PS, w);
    int i = 0;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        for (int tile = 0; tile < tiles_per_seq; ++tile, ++i) {
            if (i % DOTS != g) continue;
            const int st = i % NS;
            const uint32_t xs = ring + st * TILE_BYTES;
            mbar_wait(bars + 8 * st, (i / NS) & 1);  // the tile's rows are in
            // the tile's slot dots, then the loads for the warpgroup's next
            // tile (i + 2, the same or the next row): a tile period to land
            tile_slot_dots(reinterpret_cast<const uint4*>(smem + (xs - ws)), start, entries, table_tiles, tile, slot_w,
                           PS, slot_dots, t, w);
            prefetch_slot_w(start, table_tiles, (tile + DOTS) % tiles_per_seq, t, slot_w, PS, w);
            wg_barrier(wg);                                  // every warp's dots are done:
            if (t == 0) mbar_arrive(bars + 8 * (NS + st));  // its part of the buffer's release
        }
        // every slot dot of the row is in: sum each patch's slots in order
        dots_barrier();
        for (int p = threadIdx.x - 128; p < P; p += DOTS * 128) {
            float v = slot_dots[p * S];
            for (int s = 1; s < S; ++s) v += slot_dots[p * S + s];
            mpi[(size_t)b * P + p] = v;
        }
        dots_barrier();  // before the next row's dots overwrite them
    }
}

// ---- generic paths: f32 (parity runs; pooled: any C with TR * C floats <=
// 48 KB), and K3 in bf16 at C != 128 ----
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

__global__ void __launch_bounds__(THREADS) patch_reduce_bf16(const gt::bf16* __restrict__ y,
                                                             const int* __restrict__ patches,
                                                             const gt::bf16* __restrict__ wp, float* __restrict__ mpi,
                                                             int L, int P, int S, int Cc, int ppb) {
    const int b = blockIdx.y;
    const int tile = blockIdx.x;
    reduce_patches<gt::bf16>(y + (size_t)b * L * Cc, patches, wp, mpi + (size_t)b * P, S, Cc, tile * ppb,
                             min(P, (tile + 1) * ppb));
}

}  // namespace

template <bool POOLED>
static int launch(const void* y, const void* patches, const void* wp, const void* wv, const void* slots,
                  const void* slot_w, void* mpi, void* pooled, int B, int L, int P, int S, int Cin, int table_tiles, int is_bf16,
                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int tiles = (L + TR - 1) / TR;
    const int ppb = (P + tiles - 1) / tiles;  // patches per tile of a row
    const int n_pool = L / POOL;
    if (is_bf16 && Cin == C) {
        int dev = 0, sms = 0;
        CUtensorMap map;
        const size_t smem = 1024 + (POOLED ? WV_BYTES : 0) + NS * TILE_BYTES + BARS_BYTES +
                            ((size_t)P * S * 2 + table_tiles + 1) * sizeof(int);  // alignment, ..., slot dots, slot table
        if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(fused_reduce_tc<POOLED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
        if (err == cudaSuccess) err = gt::rows_tensor_map_sw128(&map, y, B, L, TM);
        if (err != cudaSuccess) return static_cast<int>(err);
        fused_reduce_tc<POOLED><<<std::min(sms, B), THREADS_TC, smem, s>>>(
            map, static_cast<const gt::bf16*>(wv), static_cast<const int*>(slots), static_cast<const uint4*>(slot_w),
            static_cast<float*>(mpi), static_cast<gt::bf16*>(pooled), B, P, S, n_pool, tiles, table_tiles);
    } else if (is_bf16) {  // K3 at any C
        if (POOLED) return static_cast<int>(cudaErrorInvalidValue);
        patch_reduce_bf16<<<dim3(tiles, B), THREADS, 0, s>>>(static_cast<const gt::bf16*>(y),
                                                             static_cast<const int*>(patches),
                                                             static_cast<const gt::bf16*>(wp), static_cast<float*>(mpi),
                                                             L, P, S, Cin, ppb);
    } else {
        const size_t smem = POOLED ? (size_t)TR * Cin * sizeof(float) : 0;
        if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
        fused_reduce_f32<POOLED><<<dim3(tiles, B), THREADS, smem, s>>>(
            static_cast<const float*>(y), static_cast<const int*>(patches), static_cast<const float*>(wp),
            static_cast<const float*>(wv), static_cast<float*>(mpi), static_cast<float*>(pooled), L, P, S, Cin,
            n_pool, ppb);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_reduce_launch(const void* y, const void* patches, const void* wp, const void* wv,
                                   const void* slots, const void* slot_w, void* mpi, void* pooled, int B, int L, int P,
                                   int S, int Cin, int table_tiles, int is_bf16, void* stream) {
    return launch<true>(y, patches, wp, wv, slots, slot_w, mpi, pooled, B, L, P, S, Cin, table_tiles, is_bf16, stream);
}

// K3: mpi only (no w_v, no pooled output).
extern "C" int patch_reduce_launch(const void* y, const void* patches, const void* wp, const void* slots,
                                   const void* slot_w, void* mpi, int B, int L, int P, int S, int Cin, int table_tiles,
                                   int is_bf16, void* stream) {
    return launch<false>(y, patches, wp, nullptr, slots, slot_w, mpi, nullptr, B, L, P, S, Cin, table_tiles, is_bf16,
                         stream);
}
