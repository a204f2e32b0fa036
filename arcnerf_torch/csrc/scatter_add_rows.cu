// Kernel I: row scatter-add in place, out[idx[n], :] += g[n, :] for every
// n, with repeated indices summed.
//
// Replaces case_scatter_ref (scripts/probe_pallas_gather.py), the Pallas
// kernel that scatter-adds rows by an index vector (`o_ref[idx] += g`). It
// computes what that probe compares with, np.add.at: in Pallas interpret
// mode the kernel keeps one update per repeated index instead. It also
// serves the XLA scatter-adds the probes time beside it (probe_scatter.py's
// cases a, d and f, probe_cons_forms.py's scatter tail).
//
// What bounds it on the H100: atomic throughput in L2, and collisions on
// repeated indices (kernel E's scale, 2^25 updates into 2^23 entries, has
// four updates per entry; a (16384, 128) table under 2^20 rows has 64 per
// row). Design by route:
// - W a multiple of 4: one thread per (row, 4-float chunk), one 16-byte
//   vector atomicAdd on float4 (Hopper's global-memory vector atomic), so a
//   warp covers a 512-byte row in one instruction.
// - W = 1, small (n or n_table under the thresholds below): one scalar
//   atomicAdd per update. Neither reads the table back, so the compiler
//   emits reductions (RED), not atomics that return.
// - W = 1, large: a destination partition. At kernel E's scale the RED
//   kernel takes ~0.71 ms, though 2^25 bare REDs to random addresses of the
//   (L2-resident, 32 MB) table take ~0.41 and to sorted addresses ~0.17
//   (design_studies/scatter_designs.py): streaming idx and g through L2
//   beside the table costs the rest, and evict-first loads win back only
//   ~0.04. The partition does no global atomic an update; it moves ~26
//   bytes an update through HBM instead:
//   1. a histogram of buckets, bucket = idx >> kLogBucket (2^14 entries,
//      one 64 KiB shared-memory tile), a block a tile of kPartThreads x
//      kPerThread updates (16-byte loads of indices), each tile's count in
//      a bucket rounded up to even and added into global totals;
//   2. an exclusive scan of the totals: each bucket's start in the scratch;
//   3. a scatter into bucket order: a block takes the same tile (16-byte
//      loads), ranks each update within its bucket by a shared atomic,
//      reserves an even run of each bucket present with one global atomic,
//      stages the tile in shared memory in bucket order, a padding update
//      (value 0) closing each odd run, and writes it out two updates a
//      thread, their 16-bit bucket-local keys in one 4-byte store and their
//      values in one 8-byte store (6 bytes an update, against 8 for whole
//      (idx, g) pairs; the larger the tile, the longer the runs: 16 updates
//      a thread of 1024 measured fastest);
//   4. a block a bucket adds its updates into the shared tile, then adds
//      the tile into out's range with coalesced loads and stores (a
//      read-modify-write: out is accumulated into, and entries no update
//      reached are left as they are).
//   Every size follows from n and n_table: the binding asks
//   arcnerf_scatter_add_rows_scratch_bytes for the scratch (the updates'
//   runs and three counters a bucket) and allocates it, so a CUDA graph can
//   capture the route. The slots of the runs are counted in int32, so the
//   route also needs n plus the padding of every run to fit there.
// Sums land in an order that changes from run to run. Indices must lie in
// [0, n_table): nothing checks them.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// The W = 1 route: the partition from kPartitionMinUpdates updates into a
// table of at least kPartitionMinTable entries (and at most kMaxBuckets
// buckets), the RED kernel below either threshold. Measured
// (design_studies/scatter_designs.py, NVIDIA H100 80GB HBM3, 700 W), from a
// CUDA graph: 2^24 and 2^25 updates into 2^23 entries, partition 0.23 and
// 0.40 ms against the RED kernel's 0.35 and 0.71; into 2^22 entries 0.20
// and 0.37 against 0.21 and 0.41; 2^23 updates into 2^21 entries and
// smaller cases, the RED kernel wins by 0.01-0.03 ms of fixed cost.
constexpr int kLogBucket = 14;
constexpr long long kPartitionMinUpdates = 1ll << 24;
constexpr long long kPartitionMinTable = 1ll << 22;
constexpr int kMaxBuckets = 2048;
constexpr int kPartThreads = 1024;  // a scatter block's threads
constexpr int kPerThread = 16;      // and its updates a thread
constexpr int kSumThreads = 1024;   // a bucket's block
constexpr int kSumUnroll = 4;       // and its pairs in flight a thread

__global__ void __launch_bounds__(256) scatter_add_rows_vec4_kernel(float4* __restrict__ out,
                                                                    const int* __restrict__ idx,
                                                                    const float4* __restrict__ g, int64_t n,
                                                                    int64_t chunks) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n * chunks) return;
    const int64_t row = t / chunks;
    const int64_t c = t - row * chunks;
    atomicAdd(out + static_cast<int64_t>(idx[row]) * chunks + c, g[t]);
}

__global__ void __launch_bounds__(256) scatter_add_scalar_kernel(float* __restrict__ out, const int* __restrict__ idx,
                                                                 const float* __restrict__ g, int64_t n) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n) return;
    atomicAdd(out + idx[t], g[t]);
}

// Exclusive scan of in[0, nb) into out[0, nb) by one block: each thread
// sums a run of consecutive entries, the runs' sums are scanned across
// warps, and each thread writes its run's offsets. Ends with a barrier:
// above blockDim.x entries a thread writes entries other warps read.
__device__ void block_exclusive_scan(const int* in, int* out, int nb) {
    __shared__ int warp_sums[32];
    const int per = (nb + blockDim.x - 1) / blockDim.x;
    const int lo = min(static_cast<int>(threadIdx.x) * per, nb), hi = min(lo + per, nb);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += in[i];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
        int w = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += t;
        }
        warp_sums[lane] = w - v;
    }
    __syncthreads();
    int excl = warp_sums[warp] + incl - sum;
    for (int i = lo; i < hi; ++i) {
        const int c = in[i];
        out[i] = excl;
        excl += c;
    }
    __syncthreads();
}

// Loads the indices of elements e .. e + 3: one 16-byte load where the
// pointer allows and all four lie below n; elements at or past n come out
// as -1.
__device__ __forceinline__ void load4(const int* __restrict__ idx, int64_t e, int64_t n, bool vec, int* key) {
    if (vec && e + 3 < n) {
        const int4 k = __ldg(reinterpret_cast<const int4*>(idx + e));
        key[0] = k.x, key[1] = k.y, key[2] = k.z, key[3] = k.w;
        return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) key[q] = e + q < n ? __ldg(idx + e + q) : -1;
}

// The same for the values (0 at or past n).
__device__ __forceinline__ void load4(const float* __restrict__ g, int64_t e, int64_t n, bool vec, float* val) {
    if (vec && e + 3 < n) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(g + e));
        val[0] = v.x, val[1] = v.y, val[2] = v.z, val[3] = v.w;
        return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) val[q] = e + q < n ? __ldg(g + e + q) : 0.f;
}

template <int LOG>
int n_buckets(long long n_table) {
    return static_cast<int>((n_table + (1 << LOG) - 1) >> LOG);
}

// Where the passes keep their data in the scratch. Each tile rounds its
// run in each bucket up to an even length, so at most n + tiles nb slots
// are taken, kept as two-update units: both updates' bucket-local 16-bit
// keys in one uint32 (keys2), their values in one float2 (vals2). Then the
// totals, bases and cursors of the nb buckets, in slots (int32).
struct Scratch {
    uint32_t* keys2;
    float2* vals2;
    int *totals, *base, *cursor;
};

template <int LOG, int TILE>
Scratch scratch_layout(void* scratch, long long n, int nb) {
    const long long units = (n + (n + TILE - 1) / TILE * nb + 1) / 2;
    auto* keys2 = static_cast<uint32_t*>(scratch);
    auto* vals2 = reinterpret_cast<float2*>(keys2 + (units + 1) / 2 * 2);
    int* totals = reinterpret_cast<int*>(vals2 + units);
    return {keys2, vals2, totals, totals + nb, totals + 2 * nb};
}

template <int LOG, int TILE>
long long scratch_bytes(long long n_table, long long n) {
    const long long nb = n_buckets<LOG>(n_table), units = (n + (n + TILE - 1) / TILE * nb + 1) / 2;
    return 4 * ((units + 1) / 2 * 2) + 8 * units + 12 * nb;
}

// 1. Tile blockIdx.x (THREADS x PER updates, 16-byte loads of indices)
//    counted a bucket in shared memory; totals[b] += the count rounded up
//    to even (totals zeroed by the launcher).
template <int LOG, int THREADS, int PER>
__global__ void __launch_bounds__(THREADS) bucket_histogram(const int* __restrict__ idx, int64_t n, int nb, bool vec,
                                                            int* __restrict__ totals) {
    extern __shared__ int hist[];
    for (int b = threadIdx.x; b < nb; b += THREADS) hist[b] = 0;
    __syncthreads();
    const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * THREADS * PER;
    int key[PER];
#pragma unroll
    for (int u = 0; u < PER / 4; ++u)
        load4(idx, tile0 + (static_cast<int64_t>(u) * THREADS + threadIdx.x) * 4, n, vec, key + 4 * u);
#pragma unroll
    for (int j = 0; j < PER; ++j)
        if (key[j] >= 0) atomicAdd(hist + (key[j] >> LOG), 1);
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += THREADS)
        if (hist[b] != 0) atomicAdd(totals + b, (hist[b] + 1) & ~1);
}

// 2. base[b] = cursor[b] = the slots of the buckets before b.
__global__ void __launch_bounds__(1024) bucket_scan(const int* __restrict__ totals, int nb, int* __restrict__ base,
                                                    int* __restrict__ cursor) {
    block_exclusive_scan(totals, base, nb);
    for (int b = threadIdx.x; b < nb; b += blockDim.x) cursor[b] = base[b];
}

// 3. Tile blockIdx.x into bucket order. Thread t loads elements
//    4 t .. 4 t + 3 of each stretch of 4 THREADS (16-byte loads, the warp's
//    coalesced) and ranks them within their buckets by shared atomics; the
//    block reserves an even run in each bucket present (one global atomic
//    a bucket), stages the tile in shared memory in bucket order with a
//    padding update (key b 2^LOG, value 0) closing each odd run, and writes
//    it out two updates a thread: one 4-byte store of keys, one 8-byte store
//    of values, consecutive addresses along each run.
template <int LOG, int THREADS, int PER>
__global__ void __launch_bounds__(THREADS) bucket_scatter(const int* __restrict__ idx, const float* __restrict__ g,
                                                          int64_t n, int nb, bool vec, int* __restrict__ cursor,
                                                          uint32_t* __restrict__ keys2, float2* __restrict__ vals2) {
    constexpr int kTileHere = THREADS * PER;
    extern __shared__ int smem[];
    int* count = smem;        // [nb] the tile's updates a bucket
    int* even = count + nb;   // [nb] that rounded up to even
    int* start = even + nb;   // [nb] their first slot in the staged tile
    int* run = start + nb;    // [nb] their first slot in the scratch
    int2* staged = reinterpret_cast<int2*>(run + nb);  // [kTileHere + nb], 8-byte aligned (4 nb ints)
    for (int b = threadIdx.x; b < nb; b += THREADS) count[b] = 0;
    const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTileHere;
    int key[PER], rank[PER];
    float val[PER];
#pragma unroll
    for (int u = 0; u < PER / 4; ++u) {
        const int64_t e = tile0 + (static_cast<int64_t>(u) * THREADS + threadIdx.x) * 4;
        load4(idx, e, n, vec, key + 4 * u);
        load4(g, e, n, vec, val + 4 * u);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j)
        if (key[j] >= 0) rank[j] = atomicAdd(count + (key[j] >> LOG), 1);
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += THREADS) even[b] = (count[b] + 1) & ~1;
    __syncthreads();
    block_exclusive_scan(even, start, nb);
    for (int b = threadIdx.x; b < nb; b += THREADS) {
        if (even[b] != 0) run[b] = atomicAdd(cursor + b, even[b]);
        if (count[b] & 1) staged[start[b] + count[b]] = make_int2(b << LOG, 0);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j)
        if (key[j] >= 0) staged[start[key[j] >> LOG] + rank[j]] = make_int2(key[j], __float_as_int(val[j]));
    __syncthreads();
    const int units = (start[nb - 1] + even[nb - 1]) / 2;
    for (int m = threadIdx.x; m < units; m += THREADS) {
        const int2 p0 = staged[2 * m], p1 = staged[2 * m + 1];  // one bucket's: runs are even
        const int b = p0.x >> LOG;
        const int64_t unit = (static_cast<int64_t>(run[b]) + (2 * m - start[b])) / 2;
        keys2[unit] = static_cast<uint32_t>(p0.x & ((1 << LOG) - 1)) |
                      (static_cast<uint32_t>(p1.x & ((1 << LOG) - 1)) << 16);
        vals2[unit] = make_float2(__int_as_float(p0.y), __int_as_float(p1.y));
    }
}

// 4. Bucket blockIdx.x: its updates summed in a shared tile of 2^LOG
//    floats (UNROLL units in flight a thread), then added into
//    out[b 2^LOG, ...). A float atomicAdd on shared memory is a
//    compare-and-swap loop on this card (ATOMS.CAST.SPIN); with ~4 updates
//    an entry it rarely retries. Zero values (the padding) are skipped.
template <int LOG, int THREADS, int UNROLL>
__global__ void __launch_bounds__(THREADS) bucket_accumulate(const uint32_t* __restrict__ keys2,
                                                             const float2* __restrict__ vals2,
                                                             const int* __restrict__ base,
                                                             const int* __restrict__ totals, int64_t n_table,
                                                             float* __restrict__ out) {
    extern __shared__ float tile[];
    constexpr int kSize = 1 << LOG;
    for (int j = threadIdx.x; j < kSize; j += THREADS) tile[j] = 0.f;
    __syncthreads();
    const int b = blockIdx.x;
    const int64_t lo = base[b] / 2, hi = lo + totals[b] / 2;
    for (int64_t j = lo + threadIdx.x; j < hi; j += UNROLL * THREADS) {
        uint32_t k[UNROLL];
        float2 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const bool in = j + u * THREADS < hi;
            k[u] = in ? __ldg(keys2 + j + u * THREADS) : 0u;
            v[u] = in ? __ldg(vals2 + j + u * THREADS) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (v[u].x != 0.f) atomicAdd(tile + (k[u] & 0xffffu), v[u].x);
            if (v[u].y != 0.f) atomicAdd(tile + (k[u] >> 16), v[u].y);
        }
    }
    __syncthreads();
    const int64_t row0 = static_cast<int64_t>(b) << LOG;
    const int rows = static_cast<int>(min(static_cast<int64_t>(kSize), n_table - row0));
    for (int j = threadIdx.x; j < rows; j += THREADS) {
        const float v = tile[j];
        if (v != 0.f) out[row0 + j] += v;  // entries no update reached stay as they are
    }
}

// The route, and that the slots (n and at most one padding update a tile
// and bucket) fit the int32 counters.
bool partition_route(long long n_table, int w, long long n) {
    constexpr long long kTile = kPartThreads * kPerThread;
    const long long nb = n_buckets<kLogBucket>(n_table);
    return w == 1 && n >= kPartitionMinUpdates && n_table >= kPartitionMinTable && nb <= kMaxBuckets &&
           n + (n + kTile - 1) / kTile * nb <= INT32_MAX;
}

template <int THREADS, int PER>
size_t scatter_smem(int nb) {
    return 4 * nb * sizeof(int) + (THREADS * PER + nb) * sizeof(int2);
}

// Lets the scatter and sum kernels take the dynamic shared memory above
// 48 KB that their tiles need (once a process); false if the card refuses.
template <int LOG, int THREADS, int PER>
bool allow_shared_memory() {
    static const bool allowed =
            cudaFuncSetAttribute(bucket_scatter<LOG, THREADS, PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(scatter_smem<THREADS, PER>(kMaxBuckets))) == cudaSuccess &&
            cudaFuncSetAttribute(bucket_accumulate<LOG, kSumThreads, kSumUnroll>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizeof(float) << LOG)) == cudaSuccess;
    return allowed;
}

// The four passes on the stream s.
template <int LOG, int THREADS, int PER>
int scatter_add_partition(float* out, long long n_table, const int* idx, const float* g, long long n, void* scratch,
                          cudaStream_t s) {
    static_assert(LOG <= 16 && PER % 4 == 0, "keys are 16-bit; a thread loads its updates 4 at a time");
    if (!allow_shared_memory<LOG, THREADS, PER>()) return static_cast<int>(cudaErrorInvalidValue);
    const int nb = n_buckets<LOG>(n_table);
    const Scratch sc = scratch_layout<LOG, THREADS * PER>(scratch, n, nb);
    const bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    const cudaError_t err = cudaMemsetAsync(sc.totals, 0, nb * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned tiles = static_cast<unsigned>((n + THREADS * PER - 1) / (THREADS * PER));
    bucket_histogram<LOG, THREADS, PER><<<tiles, THREADS, nb * sizeof(int), s>>>(idx, n, nb, vec, sc.totals);
    bucket_scan<<<1, 1024, 0, s>>>(sc.totals, nb, sc.base, sc.cursor);
    bucket_scatter<LOG, THREADS, PER><<<tiles, THREADS, scatter_smem<THREADS, PER>(nb), s>>>(
            idx, g, n, nb, vec, sc.cursor, sc.keys2, sc.vals2);
    bucket_accumulate<LOG, kSumThreads, kSumUnroll><<<nb, kSumThreads, sizeof(float) << LOG, s>>>(
            sc.keys2, sc.vals2, sc.base, sc.totals, n_table, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch bytes the launcher below needs for these sizes: 0 unless the
// route is the partition.
extern "C" long long arcnerf_scatter_add_rows_scratch_bytes(long long n_table, int w, long long n) {
    return partition_route(n_table, w, n) ? scratch_bytes<kLogBucket, kPartThreads * kPerThread>(n_table, n) : 0;
}

// out (n_table, w) f32, 16-byte aligned when w > 1, accumulated into; idx
// (n,) int32 in [0, n_table); g (n, w) f32. w is 1 or a multiple of 4.
// scratch: arcnerf_scatter_add_rows_scratch_bytes(n_table, w, n) bytes,
// 16-byte aligned, or null where that is 0.
extern "C" int arcnerf_scatter_add_rows(void* out, long long n_table, int w, const void* idx, const void* g,
                                        long long n, void* scratch, long long scratch_bytes_given, void* stream) {
    if (n_table <= 0 || n <= 0 || w <= 0 || (w != 1 && w % 4 != 0)) return ARCNERF_BAD_ARGUMENT;
    const int threads = kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* ip = static_cast<const int*>(idx);
    if (partition_route(n_table, w, n)) {
        const long long need = scratch_bytes<kLogBucket, kPartThreads * kPerThread>(n_table, n);
        if (scratch == nullptr || scratch_bytes_given < need || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
            return ARCNERF_BAD_ARGUMENT;
        return scatter_add_partition<kLogBucket, kPartThreads, kPerThread>(
                static_cast<float*>(out), n_table, ip, static_cast<const float*>(g), n, scratch, s);
    }
    if (w == 1) {
        const int64_t blocks = (n + threads - 1) / threads;
        scatter_add_scalar_kernel<<<static_cast<unsigned int>(blocks), threads, 0, s>>>(
            static_cast<float*>(out), ip, static_cast<const float*>(g), n);
    } else {
        const int64_t chunks = w / 4;
        const int64_t blocks = (n * chunks + threads - 1) / threads;
        scatter_add_rows_vec4_kernel<<<static_cast<unsigned int>(blocks), threads, 0, s>>>(
            static_cast<float4*>(out), ip, static_cast<const float4*>(g), n, chunks);
    }
    return static_cast<int>(cudaGetLastError());
}
