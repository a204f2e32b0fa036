// Floors and design variants of kernel I's W = 1 route (row scatter-add of
// single floats, out[idx[n]] += g[n]), for design_studies/scatter_designs.py:
// what the route in arcnerf_torch/csrc/scatter_add_rows.cu was chosen
// against. Not part of the port's kernels: nothing in the package launches
// these.
//
//   0 RED floor, random   n red.global.add.f32 to hashed addresses spread
//                         uniformly over the table, no loads of idx or g:
//                         the rate the L2 atomic unit takes random updates
//   1 RED floor, sorted   the same n updates to ascending addresses (n /
//                         n_table a row), what a destination partition buys
//   2 copy                a copy of n 8-byte pairs (reads n x 8 bytes,
//                         writes n x 8): what one pass of a partition costs
//   3 RED kernel          the package's W = 1 RED kernel, one scalar
//                         atomicAdd an update, whatever route the launcher picks
//   4 partition           the package's partition route (passes 1-4:
//                         buckets of 2^kLogBucket entries, tiles of
//                         kPartThreads threads x kPerThread updates, even
//                         runs of 6-byte updates)
//   5 passes 1-2          its tile histogram and scan alone
//   6 passes 2-3          its scan and staged scatter into bucket order
//                         alone (on the histogram of an earlier call)
//   7 pass 4              its per-bucket sums alone (on the scatter of an
//                         earlier call)
//   8 RED, evict-first    the RED kernel with idx and g read by evict-first
//                         loads (ld.global.cs), so that streaming them
//                         through L2 displaces less of the table
//   9-13 partition at     (log2 bucket, threads, updates a thread) =
//        other sizes      (13, 1024, 16), (14, 1024, 8), (15, 1024, 16),
//                         (14, 512, 16), (14, 512, 32)
//   14 8-byte pairs       the design before: (idx, g bits) pairs in runs of
//                         any length, one 8-byte store an update, a
//                         grid-stride histogram; its sums on 1024 threads
//   15 8-byte, evict-     the same with evict-first loads of idx, g and the
//      first              pairs and evict-first pair stores
//   16 8-byte, sums on    the same with its sums on blocks of 512 threads,
//      512 threads        8 pairs in flight a thread
//
// design_dirty_shared fills the shared memory of every SM with one value,
// so that a card test can show the route reads no slot it did not write.

#include <algorithm>

#include "../arcnerf_torch/csrc/scatter_add_rows.cu"

namespace {

__device__ __forceinline__ uint32_t mix(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7feb352du;
    x ^= x >> 15;
    x *= 0x846ca68bu;
    x ^= x >> 16;
    return x;
}

__global__ void __launch_bounds__(256) red_floor(float* __restrict__ out, uint32_t n_table, int64_t n, int sorted) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const uint64_t hashed = static_cast<uint64_t>(mix(static_cast<uint32_t>(t))) * n_table;
    const uint32_t a = sorted ? static_cast<uint32_t>(t * n_table / n) : static_cast<uint32_t>(hashed >> 32);
    atomicAdd(out + a, 1.f);
}

__global__ void __launch_bounds__(256) red_streaming(float* __restrict__ out, const int* __restrict__ idx,
                                                     const float* __restrict__ g, int64_t n) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t < n) atomicAdd(out + __ldcs(idx + t), __ldcs(g + t));
}

__global__ void __launch_bounds__(256) copy_pairs(const uint2* __restrict__ src, uint2* __restrict__ dst, int64_t n) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t < n) dst[t] = src[t];
}

// ---------------------------------------------- the package's passes alone

int launch_pass(int design, float* out, long long n_table, const int* idx, const float* g, long long n,
                void* scratch, cudaStream_t s) {
    constexpr int kTile = kPartThreads * kPerThread;
    if (!allow_shared_memory<kLogBucket, kPartThreads, kPerThread>()) return static_cast<int>(cudaErrorInvalidValue);
    const int nb = n_buckets<kLogBucket>(n_table);
    const Scratch sc = scratch_layout<kLogBucket, kTile>(scratch, n, nb);
    const bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    const unsigned tiles = static_cast<unsigned>((n + kTile - 1) / kTile);
    if (design == 5) {
        cudaMemsetAsync(sc.totals, 0, nb * sizeof(int), s);
        bucket_histogram<kLogBucket, kPartThreads, kPerThread><<<tiles, kPartThreads, nb * sizeof(int), s>>>(
                idx, n, nb, vec, sc.totals);
        bucket_scan<<<1, 1024, 0, s>>>(sc.totals, nb, sc.base, sc.cursor);
    } else if (design == 6) {
        bucket_scan<<<1, 1024, 0, s>>>(sc.totals, nb, sc.base, sc.cursor);
        bucket_scatter<kLogBucket, kPartThreads, kPerThread>
                <<<tiles, kPartThreads, scatter_smem<kPartThreads, kPerThread>(nb), s>>>(idx, g, n, nb, vec,
                                                                                         sc.cursor, sc.keys2,
                                                                                         sc.vals2);
    } else {
        bucket_accumulate<kLogBucket, kSumThreads, kSumUnroll><<<nb, kSumThreads, sizeof(float) << kLogBucket, s>>>(
                sc.keys2, sc.vals2, sc.base, sc.totals, n_table, out);
    }
    return static_cast<int>(cudaGetLastError());
}

// --------------------------------------- the design before: 8-byte pairs

// totals[b] += the updates of bucket b: groups of 4 indices, 4 in flight.
__global__ void __launch_bounds__(1024) histogram8(const int* __restrict__ idx, int64_t n, int nb,
                                                   int* __restrict__ totals) {
    extern __shared__ int hist[];
    for (int b = threadIdx.x; b < nb; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * 4;
    for (int64_t e0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; e0 < n; e0 += 4 * stride) {
        int key[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) load4(idx, e0 + u * stride, n, true, key[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (key[u][q] >= 0) atomicAdd(hist + (key[u][q] >> kLogBucket), 1);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += blockDim.x)
        if (hist[b] != 0) atomicAdd(totals + b, hist[b]);
}

// The tile into bucket order as (idx, g bits) pairs, runs of any length;
// STREAM: evict-first loads and stores.
template <bool STREAM>
__global__ void __launch_bounds__(1024) scatter8(const int* __restrict__ idx, const float* __restrict__ g, int64_t n,
                                                 int nb, int* __restrict__ cursor, int2* __restrict__ pairs) {
    constexpr int kPer = 16, kTile = 1024 * kPer;
    extern __shared__ int smem[];
    int* count = smem;
    int* start = count + nb;
    int* run = start + nb;
    int2* staged = reinterpret_cast<int2*>(run + nb + (nb & 1));
    for (int b = threadIdx.x; b < nb; b += 1024) count[b] = 0;
    const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
    int key[kPer], rank[kPer];
    float val[kPer];
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u) {
        const int64_t e = tile0 + (static_cast<int64_t>(u) * 1024 + threadIdx.x) * 4;
        if (STREAM && e + 3 < n) {
            const int4 k = __ldcs(reinterpret_cast<const int4*>(idx + e));
            const float4 v = __ldcs(reinterpret_cast<const float4*>(g + e));
            key[4 * u] = k.x, key[4 * u + 1] = k.y, key[4 * u + 2] = k.z, key[4 * u + 3] = k.w;
            val[4 * u] = v.x, val[4 * u + 1] = v.y, val[4 * u + 2] = v.z, val[4 * u + 3] = v.w;
        } else {
            load4(idx, e, n, true, key + 4 * u);
            load4(g, e, n, true, val + 4 * u);
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j)
        if (key[j] >= 0) rank[j] = atomicAdd(count + (key[j] >> kLogBucket), 1);
    __syncthreads();
    block_exclusive_scan(count, start, nb);
    for (int b = threadIdx.x; b < nb; b += 1024)
        if (count[b] != 0) run[b] = atomicAdd(cursor + b, count[b]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j)
        if (key[j] >= 0) staged[start[key[j] >> kLogBucket] + rank[j]] = make_int2(key[j], __float_as_int(val[j]));
    __syncthreads();
    const int n_here = static_cast<int>(min(static_cast<int64_t>(kTile), n - tile0));
    for (int i = threadIdx.x; i < n_here; i += 1024) {
        const int2 p = staged[i];
        const int b = p.x >> kLogBucket;
        int2* dst = pairs + static_cast<int64_t>(run[b]) + (i - start[b]);
        if (STREAM) {
            __stcs(dst, p);
        } else {
            *dst = p;
        }
    }
}

template <int THREADS, int UNROLL, bool STREAM>
__global__ void __launch_bounds__(THREADS) accumulate8(const int2* __restrict__ pairs, const int* __restrict__ base,
                                                       const int* __restrict__ totals, int64_t n_table,
                                                       float* __restrict__ out) {
    extern __shared__ float tile[];
    constexpr int kSize = 1 << kLogBucket;
    for (int j = threadIdx.x; j < kSize; j += THREADS) tile[j] = 0.f;
    __syncthreads();
    const int b = blockIdx.x;
    const int64_t lo = base[b], hi = lo + totals[b];
    for (int64_t j = lo + threadIdx.x; j < hi; j += UNROLL * THREADS) {
        int2 p[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int64_t i = j + u * THREADS;
            p[u] = i < hi ? (STREAM ? __ldcs(pairs + i) : __ldg(pairs + i)) : make_int2(-1, 0);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (p[u].x >= 0) atomicAdd(tile + (p[u].x & (kSize - 1)), __int_as_float(p[u].y));
    }
    __syncthreads();
    const int64_t row0 = static_cast<int64_t>(b) << kLogBucket;
    const int rows = static_cast<int>(min(static_cast<int64_t>(kSize), n_table - row0));
    for (int j = threadIdx.x; j < rows; j += THREADS) {
        const float v = tile[j];
        if (v != 0.f) out[row0 + j] += v;
    }
}

template <int SUM_THREADS, int SUM_UNROLL, bool STREAM>
int partition8(float* out, long long n_table, const int* idx, const float* g, long long n, void* scratch,
               cudaStream_t s) {
    constexpr int kTile = 1024 * 16;
    const int nb = n_buckets<kLogBucket>(n_table);
    auto* pairs = static_cast<int2*>(scratch);
    int* totals = reinterpret_cast<int*>(pairs + n);
    int* base = totals + nb;
    int* cursor = base + nb;
    const size_t smem = (3 * nb + (nb & 1)) * sizeof(int) + kTile * sizeof(int2);
    const size_t tile_smem = sizeof(float) << kLogBucket;
    cudaFuncSetAttribute(scatter8<STREAM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    cudaFuncSetAttribute(accumulate8<SUM_THREADS, SUM_UNROLL, STREAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(tile_smem));
    cudaMemsetAsync(totals, 0, nb * sizeof(int), s);
    const int64_t hist_blocks = std::min<int64_t>((n + 1024 * 16 - 1) / (1024 * 16), 528);
    histogram8<<<static_cast<unsigned>(hist_blocks), 1024, nb * sizeof(int), s>>>(idx, n, nb, totals);
    bucket_scan<<<1, 1024, 0, s>>>(totals, nb, base, cursor);
    scatter8<STREAM><<<static_cast<unsigned>((n + kTile - 1) / kTile), 1024, smem, s>>>(idx, g, n, nb, cursor, pairs);
    accumulate8<SUM_THREADS, SUM_UNROLL, STREAM><<<nb, SUM_THREADS, tile_smem, s>>>(pairs, base, totals, n_table,
                                                                                   out);
    return static_cast<int>(cudaGetLastError());
}

// Every word of the block's shared memory set to `value` (volatile: the
// stores stay though nothing reads them).
__global__ void __launch_bounds__(1024) dirty_shared(float value, int words) {
    extern __shared__ float buf[];
    volatile float* v = buf;
    for (int j = threadIdx.x; j < words; j += blockDim.x) v[j] = value;
}

}  // namespace

// Fills the shared memory of every SM with `value`: blocks of the largest
// shared memory a block may take, a few an SM.
extern "C" int design_dirty_shared(float value, void* stream) {
    int dev = 0, bytes = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err = cudaFuncSetAttribute(dirty_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dirty_shared<<<4 * sms, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(value, bytes / 4);
    return static_cast<int>(cudaGetLastError());
}

// out (n_table,) f32; idx (n,) int32, g (n,) f32, both 16-byte aligned;
// scratch: 16 n bytes (the copy's source and destination, or a partition's
// data and counters).
extern "C" int design_scatter(int design, void* out, long long n_table, const void* idx, const void* g, long long n,
                              void* scratch, void* stream) {
    if (n_table <= 0 || n <= 0 || n_table > (1ll << 31) || n > (1ll << 31) - 1 || design < 0 || design > 16)
        return ARCNERF_BAD_ARGUMENT;
    if (design >= 4 && design != 8 && n_buckets<13>(n_table) > kMaxBuckets) return ARCNERF_BAD_ARGUMENT;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    auto* fout = static_cast<float*>(out);
    const auto* ip = static_cast<const int*>(idx);
    const auto* gp = static_cast<const float*>(g);
    switch (design) {
        case 0:
        case 1: red_floor<<<blocks, 256, 0, s>>>(fout, static_cast<uint32_t>(n_table), n, design); break;
        case 2: {
            auto* u = static_cast<uint2*>(scratch);
            copy_pairs<<<blocks, 256, 0, s>>>(u, u + n, n);
            break;
        }
        case 3: scatter_add_scalar_kernel<<<blocks, 256, 0, s>>>(fout, ip, gp, n); break;
        case 4:
            return scatter_add_partition<kLogBucket, kPartThreads, kPerThread>(fout, n_table, ip, gp, n, scratch, s);
        case 5:
        case 6:
        case 7: return launch_pass(design, fout, n_table, ip, gp, n, scratch, s);
        case 8: red_streaming<<<blocks, 256, 0, s>>>(fout, ip, gp, n); break;
        case 9: return scatter_add_partition<13, 1024, 16>(fout, n_table, ip, gp, n, scratch, s);
        case 10: return scatter_add_partition<14, 1024, 8>(fout, n_table, ip, gp, n, scratch, s);
        case 11: return scatter_add_partition<15, 1024, 16>(fout, n_table, ip, gp, n, scratch, s);
        case 12: return scatter_add_partition<14, 512, 16>(fout, n_table, ip, gp, n, scratch, s);
        case 13: return scatter_add_partition<14, 512, 32>(fout, n_table, ip, gp, n, scratch, s);
        case 14: return partition8<1024, 4, false>(fout, n_table, ip, gp, n, scratch, s);
        case 15: return partition8<1024, 4, true>(fout, n_table, ip, gp, n, scratch, s);
        default: return partition8<512, 8, false>(fout, n_table, ip, gp, n, scratch, s);
    }
    return static_cast<int>(cudaGetLastError());
}
