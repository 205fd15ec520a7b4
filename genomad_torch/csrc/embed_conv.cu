// K5 embed_conv: the IGLOO first layer, a width-6 causal convolution over
// one-hot(V) tokens, plus bias and LeakyReLU.
//
//   out[b, t, :] = bias + sum_{k<6} W[k, tok[b, t-5+k], :]
//
// Replaces genomad_tpu/ops/conv_pallas.py `embed_conv` (`_embed_kernel`).
// Positions t-5+k < 0 are causal padding and add nothing; the N token (0)
// is a real row W[k, 0]. The staged tokens keep the two apart: a causal
// position points at a zeroed extra row V of each tap, as `_embed_kernel`
// keeps its -1 halo apart from token 0.
//
// What bounds it on an H100: bytes. At B=128, L=6016, C=128 in bf16 device
// memory sees 3 MB of tokens in and 197 MB of output (0.060 ms at 3.35
// TB/s). Each output element is the sum of 6 table values, so what has to
// be kept off device memory and off L2 is the 6 x V x C table (395 KB in
// bf16): read from L2 in 2-byte loads it was 1.18 GB of L2 traffic a call.
//
// Design: a persistent grid in which each block owns one channel slice of
// 128 bytes (64 channels in bf16, 32 in f32) and holds that slice of all six
// taps in shared memory for its whole life: 6 x (V + 1) x 128 bytes
// (198,144 B at V = 257), copied once with 16-byte cp.async, row V of each
// tap zeroed. The grid is the SM count rounded down to a multiple of the
// slice count; block i takes slice i % n_slices. Past the one barrier that
// waits for the table, the 32 warps of a block run on their own: the warps
// of a slice stride over units of WPOS = 16 positions of one batch row, and
// each warp stages its unit's 16 + 5 table row offsets in its own shared
// buffer (loaded into registers two units ahead; __syncwarp only). A
// thread owns 16 bytes of channels (8 bf16 or 4 f32) of 4 consecutive
// positions: per position six 16-byte shared loads, one per tap (the 8
// lanes of a row read its 128 bytes; a warp reads 4 rows in 4 wavefronts, no
// bank conflicts); f32 sums in tap order k = 0..5 (the plain version's
// order, so the result is bit-equal to it); the epilogue with the JAX
// rounding points (bf16x2 in bf16); one 16-byte store (the 8 lanes write a
// full 128-byte segment). The block has 1,024 threads: measured on the card,
// 32 warps an SM took K5 from 0.105 to 0.084 ms against 16. What holds it
// there is the store stream (a fill of the same 197 MB takes 0.062 ms)
// behind each launch's copy of its table slices (26 MB from L2, 0.006-0.012
// ms), not shared memory or ALU (PERF.md, section 6).
//
// The bases form (embed_conv_bases_launch) is the same body with the 4-mer
// tokenizer of igloo's `_tokens_from_bases(_pad_bases(.))` fused into the
// staging (genomad_tpu/models/igloo.py `apply_bases`): token t is the 4-mer
// value of bases t..t+3 plus 1, or 0 when any of them is N (a code >= 4, or
// an index past the row's n bases, which is `_pad_bases`' N padding). It
// reads uint8 bases (0.77 MB at B=128) in place of int32 tokens (3 MB).
//
// Takes f32 (parity) and bf16 (production); sums in f32.

#include <algorithm>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int KS = 6;
constexpr int HALO = KS - 1;
constexpr int ROW_BYTES = 128;           // one channel slice of one table row
constexpr int LANES = ROW_BYTES / 16;    // threads per row slice, 16 bytes each
constexpr int THREADS = 1024;  // 32 warps: one block an SM, at most 64 registers a thread
constexpr int WARPS = THREADS / 32;
constexpr int PPT = 4;                   // consecutive positions per thread
constexpr int WPOS = 32 / LANES * PPT;   // 16 positions per warp and unit
constexpr int WTOK = WPOS + 8;           // staged offsets per warp: WPOS + HALO, padded to 16 bytes
constexpr int SMEM_LIMIT = 232448;
constexpr int N_CODE = 4;                // base codes >= 4 are N

size_t smem_bytes(int V) { return (size_t)KS * (V + 1) * ROW_BYTES + WARPS * WTOK * sizeof(int); }

// The byte offset, within a tap, of the table row that position t of batch
// row `row` reads: its token's row, or the zero row V for the causal
// padding (t < 0; positions t >= L are never stored).
template <bool BASES>
__device__ __forceinline__ int row_offset(const void* __restrict__ in, int row, int t, int L, int n, int V) {
    if (t < 0 || t >= L) return V * ROW_BYTES;
    int token;
    if constexpr (BASES) {
        const uint8_t* bases = static_cast<const uint8_t*>(in) + (size_t)row * n;
        int kmer = 0;
        bool valid = true;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int code = t + j < n ? bases[t + j] : N_CODE;
            valid &= code < N_CODE;
            kmer = kmer * 4 + code;
        }
        token = valid ? kmer + 1 : 0;
    } else {
        token = static_cast<const int*>(in)[(size_t)row * L + t];
    }
    return token * ROW_BYTES;
}

// acc (= or +=) the 16 bytes of one table row slice, in f32
__device__ __forceinline__ void add_row(float (&acc)[4], uint4 v, bool first) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = first ? __uint_as_float(w[i]) : acc[i] + __uint_as_float(w[i]);
}
__device__ __forceinline__ void add_row(float (&acc)[8], uint4 v, bool first) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
        const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
        acc[2 * i] = first ? lo : acc[2 * i] + lo;
        acc[2 * i + 1] = first ? hi : acc[2 * i + 1] + hi;
    }
}

// the bias and LeakyReLU slope as the epilogue takes them: f32 values, or
// bf16x2 pairs
template <typename T>
struct Epilogue;
template <>
struct Epilogue<float> {
    float bias[4];
    float slope;
    int leaky;
    __device__ Epilogue(const float* b, float s, int l) : slope(s), leaky(l) {
#pragma unroll
        for (int i = 0; i < 4; ++i) bias[i] = b[i];
    }
    // gt::conv_epilogue on 16 bytes of output
    __device__ __forceinline__ uint4 operator()(const float (&acc)[4]) const {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(gt::conv_epilogue<float>(acc[i], bias[i], slope, leaky));
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
};
template <>
struct Epilogue<gt::bf16> {
    __nv_bfloat162 bias[4];
    __nv_bfloat162 slope;
    int leaky;
    __device__ Epilogue(const gt::bf16* b, float s, int l) : slope(__float2bfloat162_rn(s)), leaky(l) {
#pragma unroll
        for (int i = 0; i < 4; ++i) bias[i] = __halves2bfloat162(b[2 * i], b[2 * i + 1]);
    }
    __device__ __forceinline__ uint4 operator()(const float (&acc)[8]) const {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = gt::conv_epilogue_bf16x2(acc[2 * i], acc[2 * i + 1], bias[i], slope, leaky);
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
};

template <typename T, bool BASES>
__global__ void __launch_bounds__(THREADS, 1) embed_conv_kernel(
    const void* __restrict__ in, const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ out, int L,
    int n, int V, int C, int n_slices, int units_per_row, int n_units, float slope, int leaky) {
    constexpr int EPT = 16 / sizeof(T);  // channels per thread
    constexpr int SC = ROW_BYTES / sizeof(T);  // channels per slice
    extern __shared__ __align__(16) unsigned char smem[];
    const int tap_bytes = (V + 1) * ROW_BYTES;
    const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
    int* offsets = reinterpret_cast<int*>(smem + KS * tap_bytes) + warp * WTOK;  // this warp's
    const int slice = blockIdx.x % n_slices;
    const int lane = wl % LANES;
    const int q = wl / LANES;  // positions 4q .. 4q+3 of the warp's unit
    const int c0 = slice * SC + lane * EPT;

    // the slice of every tap, 16 bytes a copy; row V of each tap zeroed
    const char* src = reinterpret_cast<const char*>(w) + slice * ROW_BYTES;
    for (int i = threadIdx.x; i < KS * V * LANES; i += THREADS) {
        const int r = i / LANES, cell = i - r * LANES;  // r = k * V + v
        const int k = r / V;
        gt::cp_async16(gt::smem_addr(smem + k * tap_bytes + (r - k * V) * ROW_BYTES + cell * 16),
                       src + (size_t)r * C * sizeof(T) + cell * 16);
    }
    gt::cp_async_commit();
    for (int i = threadIdx.x; i < KS * LANES; i += THREADS)
        *reinterpret_cast<uint4*>(smem + (i / LANES) * tap_bytes + V * ROW_BYTES + (i % LANES) * 16) =
            make_uint4(0, 0, 0, 0);
    const Epilogue<T> epilogue(bias + c0, slope, leaky);

    // the warps of a slice stride over the units of WPOS positions
    const int step = gridDim.x / n_slices * WARPS;
    int unit = blockIdx.x / n_slices * WARPS + warp;
    // lane wl < WPOS + HALO stages position t0 - 5 + wl of a unit
    const bool stager = wl < WPOS + HALO;
    auto stage = [&](int u) {
        if (!stager || u >= n_units) return 0;
        const int row = u / units_per_row;
        return row_offset<BASES>(in, row, (u - row * units_per_row) * WPOS - HALO + wl, L, n, V);
    };
    auto put = [&](int staged) {
        __syncwarp();  // the warp is done with the last unit's offsets
        if (stager) offsets[wl] = staged;
        __syncwarp();
    };
    auto compute = [&](int u) {
        const int row = u / units_per_row;
        const int t = (u - row * units_per_row) * WPOS + PPT * q;  // this thread's first position
        const int4 lo = *reinterpret_cast<const int4*>(offsets + PPT * q);
        const int4 hi = *reinterpret_cast<const int4*>(offsets + PPT * q + 4);
        const int offs[PPT + HALO] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w, offsets[PPT * q + 8]};
        const unsigned char* table = smem + lane * 16;
        T* dst = out + ((size_t)row * L + t) * C + c0;
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
            float acc[EPT];
#pragma unroll
            for (int k = 0; k < KS; ++k)
                add_row(acc, *reinterpret_cast<const uint4*>(table + k * tap_bytes + offs[p + k]), k == 0);
            const uint4 v = epilogue(acc);
            if (t + p < L) *reinterpret_cast<uint4*>(dst + (size_t)p * C) = v;
        }
    };
    // two units a turn, each unit's offsets loaded two units ahead (s0 and
    // s1 are never copied into each other, so no load is waited for early)
    int s0 = stage(unit), s1 = stage(unit + step);
    gt::cp_async_wait_all();
    __syncthreads();  // the table is in place
    while (unit < n_units) {
        put(s0);
        s0 = stage(unit + 2 * step);
        compute(unit);
        unit += step;
        if (unit >= n_units) break;
        put(s1);
        s1 = stage(unit + 2 * step);
        compute(unit);
        unit += step;
    }
}

template <typename T, bool BASES>
int launch(const void* in, const void* w, const void* bias, void* out, int B, int n, int L, int V, int C,
           float slope, int leaky, void* stream) {
    constexpr int SC = ROW_BYTES / sizeof(T);
    const size_t smem = smem_bytes(V);
    if (V < 1 || C < SC || C % SC != 0 || smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    const int n_slices = C / SC;
    const int units_per_row = (L + WPOS - 1) / WPOS;
    const long long n_units = (long long)B * units_per_row;
    if (n_units == 0) return static_cast<int>(cudaSuccess);
    if (n_units > INT_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(embed_conv_kernel<T, BASES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    // blocks per slice: the SMs a slice gets, no more than its units need
    const int per_slice = static_cast<int>(std::min<long long>(std::max(1, sms / n_slices), (n_units + WARPS - 1) / WARPS));
    embed_conv_kernel<T, BASES><<<per_slice * n_slices, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        in, static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(out), L, n, V, C, n_slices,
        units_per_row, static_cast<int>(n_units), slope, leaky);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int embed_conv_launch(const void* tokens, const void* w, const void* bias, void* out, int B, int L, int V,
                                 int C, int is_bf16, float slope, int leaky, void* stream) {
    return is_bf16 ? launch<gt::bf16, false>(tokens, w, bias, out, B, L, L, V, C, slope, leaky, stream)
                   : launch<float, false>(tokens, w, bias, out, B, L, L, V, C, slope, leaky, stream);
}

// The bases form: uint8 codes (B, n) in place of the tokens; out (B, L, C).
extern "C" int embed_conv_bases_launch(const void* bases, const void* w, const void* bias, void* out, int B, int n,
                                       int L, int V, int C, int is_bf16, float slope, int leaky, void* stream) {
    return is_bf16 ? launch<gt::bf16, true>(bases, w, bias, out, B, n, L, V, C, slope, leaky, stream)
                   : launch<float, true>(bases, w, bias, out, B, n, L, V, C, slope, leaky, stream);
}
