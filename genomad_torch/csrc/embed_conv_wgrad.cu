// embed_conv_wgrad: the gradient of conv1's table and bias in the training
// step, the transpose of K5 embed_conv (csrc/embed_conv.cu).
//
//   dW[k, v, :] = sum_{b, t : tok[b, t-5+k] = v} dout[b, t, :]     (k < 6)
//   dbias[:]    = sum_{b, t} dout[b, t, :] = sum_v dW[5, v, :]
//
// It replaces no Pallas kernel: JAX's training step (genomad_tpu/train.py
// around igloo.apply_train) leaves conv1's gradient to XLA, and the port's
// plain form of it (autograd through igloo._causal_embed_conv's gather)
// became a sort-based index_put_ that adds the rows of one index in a serial
// loop: ~1,500 rows for each ordinary token and ~62,000 for the N token at
// the training cell's shapes. Causal positions (t-5+k < 0) read the pad and
// add to no row of dW, as K5 reads a zero row for them.
//
// What bounds it on an H100: bytes. At B=64, L=5997, C=128 in f32 it must
// read dout once (196.5 MB, 0.059 ms at 3.35 TB/s), 1.5 MB of tokens, and
// write 0.8 MB of dW. Every dout row feeds six (tap, token) rows, so what
// has to be kept off device memory is the 6 x V x C accumulator and its
// read-modify-writes (12 x 4 bytes a channel and position).
//
// Design, K5 transposed: a persistent grid in which each block owns one
// 128-byte channel slice (32 f32 channels) and holds that slice of the
// whole accumulator in shared memory, 6 x V x 32 f32 (197,376 B at V = 257),
// a token's six rows together. The blocks of a slice take the units of UNIT
// consecutive positions of one batch row in a fixed stride, through a ring
// of NST stages in shared memory and three warp roles:
// - the producer loads a unit's UNIT + 5 dout rows with one TMA load (rows
//   past L arrive as zeros) once the consumers left its stage, and asks the
//   unit AHEAD units later into L2;
// - the dispatcher reads each unit's tokens two units ahead and writes them
//   into the stage with, for each chunk of 32 positions, its runs (a
//   position whose token is the one before's continues its run) and, for
//   each consumer, the starts of the runs of its tokens;
// - 30 consumer warps take the stages in order, each on its own (the ring's
//   mbarriers, no block-wide barrier). Warp w owns the tokens v with
//   v % 30 == w, all six taps of them, and a lane owns one channel: every
//   accumulator row has one writer, so no atomics, no sort and no serial
//   loop over a hot row. For a run of n positions of token v starting at s
//   it adds dout rows s+p+5-k to row (k, v); the six taps share all but five
//   rows at each end, so a run (the N token's runs, the padding past a
//   contig's end) reads its n + 5 rows once and updates the token's six
//   rows once.
// What holds it: shared memory, 18 wavefronts of 128 bytes a position and
// slice (six dout rows, six accumulator loads and six stores: about twice
// the device memory bound), and the ring's latency, which three stages of
// 9 KB cover only in part (PERF.md, section 6).
//
// The sum over blocks is in a fixed order: each block writes its
// accumulator and its share of dbias (sum_v of its tap-5 rows) to its own
// plane of a (blocks of a slice, 6 V C + C) buffer (26 MB at 33 blocks a
// slice), and a second launch adds the planes in plane order. Every
// addition has a place fixed by the shapes and the SM count, so the result
// is bitwise the same from run to run, which device-memory atomics would not
// give.
//
// Takes f32 only (the trainer's dtype); sums in f32.

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int KS = 6;
constexpr int HALO = KS - 1;
constexpr int SLICE = 32;              // channels of a block: 128 bytes of f32
constexpr int ROW_BYTES = SLICE * 4;
constexpr int THREADS = 1024;          // one block an SM
constexpr int CONSUMERS = THREADS / 32 - 2;  // warps 0..29; warp 30 dispatches, warp 31 loads
constexpr int DISPATCHER = CONSUMERS, PRODUCER = CONSUMERS + 1;
constexpr int UNIT = 64;               // positions a stage, a multiple of 32
constexpr int NST = 3;                 // stages in the ring
constexpr int AHEAD = 4;               // units asked into L2 ahead of the unit loaded
constexpr int ROWS = UNIT + HALO;      // dout rows a unit reads
constexpr int STAGE_BYTES = ROWS * ROW_BYTES + UNIT * 4;
constexpr int CHUNKS = UNIT / 32;
static_assert(CHUNKS == 2, "a consumer reads its two chunks' starts as one uint2");
// a stage's meta: for each consumer and chunk the starts of the runs of its
// tokens, then each chunk's runs (bit i: lane i has lane i-1's token)
constexpr int META = (CONSUMERS + 1) * CHUNKS;
constexpr int PIECES = ROW_BYTES / 16; // 16-byte pieces of a row slice
constexpr int SMEM_LIMIT = 232448;

size_t smem_bytes(int V) { return (size_t)KS * V * ROW_BYTES + NST * (STAGE_BYTES + META * 4 + 2 * 8); }

// xs[k] = the sum of a run's n positions' tap-k rows: position p feeds tap k
// from dout row p+5-k of x, so tap k sums rows 5-k .. n+4-k. Long runs add
// the core 5 .. n-1 once and the five rows at each end per tap.
__device__ __forceinline__ void run_sums(const float* x, int n, float (&xs)[KS]) {
    if (n < KS) {
#pragma unroll
        for (int k = 0; k < KS; ++k) xs[k] = x[(HALO - k) * SLICE];
        for (int p = 1; p < n; ++p) {
#pragma unroll
            for (int k = 0; k < KS; ++k) xs[k] += x[(p + HALO - k) * SLICE];
        }
        return;
    }
    float four[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: the loads run ahead
    int t = HALO;
    for (; t + 4 <= n; t += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) four[q] += x[(t + q) * SLICE];
    }
    for (; t < n; ++t) four[0] += x[t * SLICE];
    const float core = (four[0] + four[1]) + (four[2] + four[3]);
    float left = 0.f, right = 0.f;
    xs[0] = core;
    xs[KS - 1] = core;
#pragma unroll
    for (int k = 1; k < KS; ++k) {
        left += x[(HALO - k) * SLICE];
        xs[k] = left + core;
    }
#pragma unroll
    for (int k = KS - 2; k >= 0; --k) {
        right += x[(n + HALO - 1 - k) * SLICE];
        xs[k] += right;
    }
}

// unit u -> (batch row, unit of the row), advanced without a division
struct Cursor {
    int u, row, chunk;
    __device__ Cursor(int u0, int per_row) : u(u0), row(u0 / per_row), chunk(u0 - u0 / per_row * per_row) {}
    __device__ void advance(int step, int per_row) {
        u += step;
        chunk += step;
        while (chunk >= per_row) {
            chunk -= per_row;
            ++row;
        }
    }
};

__global__ void __launch_bounds__(THREADS, 1) wgrad_kernel(
    const __grid_constant__ CUtensorMap dmap, const int* __restrict__ tok, float* __restrict__ partial, int L, int V,
    int C, int n_slices, int per_slice, int units_per_row, int n_units) {
    extern __shared__ __align__(128) unsigned char smem[];
    float* acc = reinterpret_cast<float*>(smem);  // [V][KS][SLICE]: a token's six rows together
    unsigned char* ring = smem + (size_t)KS * V * ROW_BYTES;  // [NST]: ROWS dout rows, then UNIT tokens
    unsigned* meta = reinterpret_cast<unsigned*>(ring + NST * STAGE_BYTES);  // [NST][META]
    const uint32_t bars = gt::smem_addr(meta + NST * META);  // full[NST], then empty[NST]
    const int slice = blockIdx.x % n_slices, part = blockIdx.x / n_slices;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c0 = slice * SLICE;
    auto full = [&](int s) { return bars + 8 * s; };
    auto empty = [&](int s) { return bars + 8 * (NST + s); };

    for (int i = threadIdx.x; i < KS * V * SLICE / 4; i += THREADS)
        reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (threadIdx.x == 0) {
        for (int s = 0; s < NST; ++s) {
            gt::mbar_init(full(s), 2);  // the producer's expect_tx, the dispatcher's arrival
            gt::mbar_init(empty(s), CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    Cursor at(part, units_per_row);
    if (warp == PRODUCER) {
        // stage i % NST once the consumers released its last unit; the warp
        // runs the loop together, lane 0 starts the TMA
        Cursor ahead(part, units_per_row);
        for (int i = 0; i < AHEAD; ++i) ahead.advance(per_slice, units_per_row);
        for (int i = 0; at.u < n_units; ++i, at.advance(per_slice, units_per_row), ahead.advance(per_slice, units_per_row)) {
            const int s = i % NST;
            const uint32_t dst = gt::smem_addr(ring + s * STAGE_BYTES);
            if (ahead.u < n_units && lane == 0)  // from device memory into L2 while the ring's stages wait
                asm volatile("cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];\n" ::"l"(
                                 reinterpret_cast<uint64_t>(&dmap)),
                             "r"(c0), "r"(ahead.chunk * UNIT), "r"(ahead.row)
                             : "memory");
            gt::mbar_wait(empty(s), ((i / NST) & 1) ^ 1);
            if (lane == 0) {
                gt::mbar_expect(full(s), ROWS * ROW_BYTES);
                asm volatile(
                    "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
                    " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
                    "l"(reinterpret_cast<uint64_t>(&dmap)), "r"(c0), "r"(at.chunk * UNIT), "r"(at.row), "r"(full(s))
                    : "memory");
            }
            __syncwarp();
        }
    } else if (warp == DISPATCHER) {
        // each unit's tokens, read two units ahead, into its stage with each
        // chunk's runs (a lane whose token is the lane before's continues its
        // run) and, for each consumer, the starts of the runs of its tokens,
        // once for all consumers
        auto fetch = [&](const Cursor& c, int (&t)[CHUNKS]) {
#pragma unroll
            for (int r = 0; r < CHUNKS; ++r) {
                const int pos = c.chunk * UNIT + r * 32 + lane;
                t[r] = c.u < n_units && pos < L ? tok[(size_t)c.row * L + pos] : -1;
            }
        };
        int now[CHUNKS], next[CHUNKS], later[CHUNKS];  // units i, i + 1, i + 2
        Cursor ahead = at;
        fetch(ahead, now);
        ahead.advance(per_slice, units_per_row);
        fetch(ahead, next);
        for (int i = 0; at.u < n_units; ++i, at.advance(per_slice, units_per_row)) {
            ahead.advance(per_slice, units_per_row);
            fetch(ahead, later);
            const int s = i % NST;
            int* tk = reinterpret_cast<int*>(ring + s * STAGE_BYTES + ROWS * ROW_BYTES);
            unsigned* m = meta + s * META;
            gt::mbar_wait(empty(s), ((i / NST) & 1) ^ 1);  // the consumers left the stage
            if (lane <= CONSUMERS) *reinterpret_cast<uint2*>(m + lane * CHUNKS) = make_uint2(0u, 0u);
            __syncwarp();
#pragma unroll
            for (int r = 0; r < CHUNKS; ++r) {
                const int v = now[r];
                tk[r * 32 + lane] = v;
                const int before = __shfl_up_sync(0xffffffffu, v, 1);
                const unsigned cont = __ballot_sync(0xffffffffu, lane > 0 && v == before);
                if (v >= 0 && !(cont >> lane & 1)) atomicOr(m + v % CONSUMERS * CHUNKS + r, 1u << lane);
                if (lane == 0) m[CONSUMERS * CHUNKS + r] = cont;
                now[r] = next[r];
                next[r] = later[r];
            }
            __syncwarp();
            if (lane == 0) gt::mbar_arrive(full(s));
        }
    } else {
        for (int i = 0; at.u < n_units; ++i, at.advance(per_slice, units_per_row)) {
            const int s = i % NST;
            gt::mbar_wait(full(s), (i / NST) & 1);  // the unit's rows, tokens and runs are in
            const float* d = reinterpret_cast<const float*>(ring + s * STAGE_BYTES) + lane;
            const int* tk = reinterpret_cast<const int*>(ring + s * STAGE_BYTES + ROWS * ROW_BYTES);
            const unsigned* m = meta + s * META;
            const uint2 own = *reinterpret_cast<const uint2*>(m + warp * CHUNKS);
            const uint2 runs = *reinterpret_cast<const uint2*>(m + CONSUMERS * CHUNKS);
#pragma unroll
            for (int r = 0; r < CHUNKS; ++r) {
                unsigned starts = r ? own.y : own.x;
                const unsigned cont = r ? runs.y : runs.x;
                while (starts) {
                    // the run of token vj at chunk positions j .. j+n-1
                    const int j = __ffs(starts) - 1;
                    starts &= starts - 1;
                    const int vj = tk[r * 32 + j];
                    const unsigned rest = j == 31 ? 0u : ~(cont >> (j + 1));
                    const int n = 1 + (rest ? __ffs(rest) - 1 : 31 - j);
                    float xs[KS], cur[KS];
                    run_sums(d + (r * 32 + j) * SLICE, n, xs);
                    float* a = acc + vj * KS * SLICE + lane;
#pragma unroll
                    for (int k = 0; k < KS; ++k) cur[k] = a[k * SLICE];  // loaded before any is stored
#pragma unroll
                    for (int k = 0; k < KS; ++k) a[k * SLICE] = cur[k] + xs[k];
                }
            }
            __syncwarp();
            if (lane == 0) gt::mbar_arrive(empty(s));  // the stage is free
        }
    }
    __syncthreads();

    // the block's plane: partial[part][k][v][c0 .. c0 + 32) from acc[v][k],
    // then its share of dbias, sum_v acc[v][5], at partial[part][6 V C + c0 ..]
    float* plane = partial + (size_t)part * (KS * V + 1) * C + c0;
    for (int i = threadIdx.x; i < KS * V * PIECES; i += THREADS) {
        const int r = i / PIECES, piece = i - r * PIECES;  // r = k * V + v
        const int k = r / V, v = r - k * V;
        *reinterpret_cast<float4*>(plane + (size_t)r * C + piece * 4) =
            *reinterpret_cast<const float4*>(acc + (v * KS + k) * SLICE + piece * 4);
    }
    if (warp == 0) {  // rows v, v + 1 in two chains, then the chains
        float even = 0.f, odd = 0.f;
        int v = 0;
        for (; v + 1 < V; v += 2) {
            even += acc[(v * KS + HALO) * SLICE + lane];
            odd += acc[((v + 1) * KS + HALO) * SLICE + lane];
        }
        if (v < V) even += acc[(v * KS + HALO) * SLICE + lane];
        plane[(size_t)KS * V * C + lane] = even + odd;
    }
}

// dW and dbias = the planes added in plane order, 16 bytes a thread
__global__ void reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ dw, int n_parts, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float4 s = partial[i];
    for (int p = 1; p < n_parts; ++p) {
        const float4 x = partial[(size_t)p * n + i];
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
    }
    dw[i] = s;
}

// The TMA map of dout (B, L, C) f32 in boxes of ROWS rows x 32 channels of
// one batch row: rows outside [0, L) arrive as zeros.
cudaError_t dout_map(CUtensorMap* dmap, const void* dout, int B, int L, int C) {
    PFN_cuTensorMapEncodeTiled_v12000 encode;
    const cudaError_t err = gt::tensor_map_encoder(&encode);
    if (err != cudaSuccess) return err;
    cuuint64_t ddims[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)B};
    cuuint64_t dstrides[2] = {(cuuint64_t)C * 4, (cuuint64_t)L * C * 4};
    cuuint32_t dbox[3] = {SLICE, ROWS, 1};
    cuuint32_t ones[3] = {1, 1, 1};
    const CUresult res = encode(dmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(dout), ddims, dstrides,
                                dbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// The largest V the accumulator slice fits.
extern "C" int embed_conv_wgrad_max_vocab() {
    return static_cast<int>((SMEM_LIMIT - smem_bytes(0)) / (KS * ROW_BYTES));
}

// tokens (B, L) int32 in [0, V); dout (B, L, C) f32, 16-byte aligned;
// partial (per_slice, 6 V C + C) f32 scratch; out (6 V C + C) f32: dW (6, V,
// C), then dbias (C,). The grid is per_slice blocks for each of the C / 32
// channel slices.
extern "C" int embed_conv_wgrad_launch(const void* tokens, const void* dout, void* partial, void* out, int B, int L,
                                       int V, int C, int per_slice, void* stream) {
    const size_t smem = smem_bytes(V);
    if (V < 1 || C < SLICE || C % SLICE != 0 || smem > SMEM_LIMIT || per_slice < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int units_per_row = (L + UNIT - 1) / UNIT;
    const long long n_units = (long long)B * units_per_row;
    const long long plane = (long long)(KS * V + 1) * C;
    if (n_units < 1 || n_units > INT_MAX / 4 || (long long)B * L > INT_MAX || per_slice * plane > INT_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_slices = C / SLICE;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    CUtensorMap dmap;
    cudaError_t err = dout_map(&dmap, dout, B, L, C);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    wgrad_kernel<<<per_slice * n_slices, THREADS, smem, s>>>(dmap, static_cast<const int*>(tokens),
                                                               static_cast<float*>(partial), L, V, C, n_slices,
                                                               per_slice, units_per_row, static_cast<int>(n_units));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int n = static_cast<int>(plane / 4);
    reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float4*>(partial), static_cast<float4*>(out),
                                                  per_slice, n);
    return static_cast<int>(cudaGetLastError());
}
