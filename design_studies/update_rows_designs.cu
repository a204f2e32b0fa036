// Floors and design variants of kernel J (lane-packed update rows,
//   out[k, l] = sum over terms t of [l == lane0[k] + term_lane[t]] * vals[k, t],
// t = i * n_feat + f, term_lane[t] = offs[i] + f, summed in t order from 0),
// for design_studies/update_rows_designs.py: what the design in
// arcnerf_torch/csrc/update_rows.cu was chosen against. Not part of the
// port's kernels: nothing in the package launches these.
//
//   0 store floor          K x 512 bytes of zeros, one float4 store a thread
//   1 store floor, stcs    the same with evict-first stores (__stcs)
//   2 bulk-copy floor      a warp a block, persistent: one zeroed 16 KB tile
//                          in shared memory copied to each 32-row tile of
//                          out by cp.async.bulk, two copies in flight
//   3 parent               the first kernel as it was: a warp a row, runtime
//                          loops over the offsets and n_feat
//   4 terms unrolled       3 with the number of terms a template parameter
//                          (1..8) and the term lanes by value
//   5 + stcs               4 with evict-first float4 stores
//   6 warp tile            4 with a warp owning 32 consecutive rows: lane0
//                          and the tile's 32 x n_terms values loaded once,
//                          coalesced, and shuffled to the warp a row
//   7 + stcs               6 with evict-first stores
//   8 + persistent         7 on a persistent grid, the next tile's inputs
//                          loaded before this tile's stores
//   9 shared scatter       a lane owns a row of the tile: it adds its terms
//                          into a zeroed 16 KB tile in shared memory, the
//                          warp copies the tile out with coalesced evict-
//                          first float4 stores, then each lane zeroes the
//                          lanes it wrote; persistent, inputs prefetched
//  10 shared scatter,      9 with the tile written by one cp.async.bulk
//     bulk copy, 2 tiles   (after fence.proxy.async), two tiles a warp:
//                          the lanes build the next tile while the copy
//                          engine drains the last; a tile's written lanes
//                          are zeroed once cp.async.bulk.wait_group.read
//                          says its copy has read it
//  11 the same, 3 tiles    10 with three tiles a warp
//  12 read + store floor   7's loads of lane0 and the values, coalesced,
//                          and a store of zeros made from them: the floor
//                          of the traffic J must move, reads and writes
//  13 blocked              7 on a grid that fills the card once, each warp
//                          owning a run of consecutive tiles
//  14 blocked, prefetched  13 with each warp's inputs (lane0 and values of
//                          its run) prefetched into L2 (evict-last) before
//                          its first tile, so the reads leave HBM in one
//                          burst ahead of the writes
//  15 shared, blocked,     9's shared scatter on 13's grid with 14's
//     prefetched           prefetch
//  16 L2 pass + 7          a first kernel asks L2 for every line of lane0
//                          and the values (evict-last), then 7 runs
//  17 L2 pass + 12         the same before the read + store floor
//  18 read floor           12's loads alone, one float4 a warp stored
//  19 L2 pass alone        16's first kernel
//  20 tile store floor     7's grid and stores of zeros, no loads: a warp
//                          writes its 16 KB tile row by row
//  21 strided store floor  20 with warp w of G = ceil(K / 32) writing rows
//                          w, w + G, w + 2G, ...: the warps resident at
//                          once write one contiguous window, as 0 does
//  22 strided warp tile    7 on 21's rows (lane j loads row w + j G)
//  23 strided shared       9's shared scatter (not persistent) on 21's rows
//  24 runs of 4, floor     12 with each warp writing 4 consecutive tiles,
//                          each tile's loads issued after the last one's
//                          stores
//  25 + loads ahead        24 with the next tile's loads issued before
//                          this tile's stores
//  26 runs of 16, ahead    25 with runs of 16 tiles
//  27 runs of 4, J         7 with 25's runs and loads ahead
//  28 runs of 16, J        7 with 26's runs and loads ahead
//  29 phased floor         a block an SM, reads then writes: each block
//                          first copies its rows' lane0 and values into
//                          shared memory (two cp.async.bulk loads on an
//                          mbarrier), then writes its rows (zeros here), so
//                          the card reads all inputs in one burst before
//                          it writes; more rows than shared memory holds
//                          go in further launches
//  30 phased, shared       29 building the rows by 9's shared scatter, 4
//     scatter              warps a block
//  31 phased, registers    29 building each row in registers from the
//                          shared inputs (a warp a row, broadcast reads),
//                          16 warps a block
//  32 the same, 32 warps   31 with 32 warps a block
//  33 the package's kernel arcnerf_build_update_rows of
//                          arcnerf_torch/csrc/update_rows.cu, built into
//                          this library, on the study's output buffer
//  34 31, 16-byte head     31 with the inputs at a 16-byte offset in shared
//                          memory (the package's) in place of 128
//  35 31, rows unrounded   31 with a block's rows not rounded up to a
//                          multiple of 32 (the package's plan)
//
// Every variant but the floors must equal the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../arcnerf_torch/csrc/common.cuh"

namespace package {
#include "../arcnerf_torch/csrc/update_rows.cu"
}  // namespace package

namespace {

constexpr int kLanes = 128;
constexpr int kTileRows = 32;
constexpr int kTileFloats = kTileRows * kLanes;  // 16 KB
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoRow = -4096;  // lane0 of a row past the end: no term lands in [0, 128)

struct Offsets {
    int v[4];
};

unsigned int blocks_for(int64_t threads_total, int threads) {
    return static_cast<unsigned int>((threads_total + threads - 1) / threads);
}

struct Terms {
    int lane[8];
};

// ------------------------------------------------------------------ floors

template <bool kStcs>
__global__ void __launch_bounds__(256) store_floor(float4* __restrict__ out, int64_t n) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kStcs) {
        __stcs(out + t, z);
    } else {
        out[t] = z;
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_addr(src)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__global__ void __launch_bounds__(32) bulk_floor(int64_t k_rows, float* __restrict__ out) {
    extern __shared__ __align__(128) float smem[];
    const int lane = threadIdx.x;
    float4* z4 = reinterpret_cast<float4*>(smem);
    for (int i = lane; i < kTileFloats / 4; i += 32) z4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    fence_async_shared();
    __syncwarp();
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    if (lane == 0) {
        for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
            const int64_t rows = min(static_cast<int64_t>(kTileRows), k_rows - tile * kTileRows);
            bulk_store(out + tile * kTileFloats, smem, static_cast<uint32_t>(rows * kLanes * 4));
            bulk_commit();
            bulk_wait_read<1>();
        }
        bulk_wait_all();
    }
}

// ------------------------------------------------- the first kernel (3)

__global__ void __launch_bounds__(256) parent_kernel(const int* __restrict__ lane0, const float* __restrict__ vals,
                                                     int64_t k_rows, Offsets offs, int n_off, int n_feat,
                                                     float4* __restrict__ out) {
    const int64_t k = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (k >= k_rows) return;
    const int l0 = lane0[k];
    const float* v = vals + k * (n_off * n_feat);
    const int first = 4 * lane;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n_off; ++i) {
        for (int f = 0; f < n_feat; ++f) {
            const int target = l0 + offs.v[i] + f;
            const float val = v[i * n_feat + f];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], first + c == target ? val : 0.f);
        }
    }
    out[k * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// ------------------------------------------- a warp a row, terms unrolled (4, 5)

template <bool kStcs>
__device__ __forceinline__ void store4(float4* p, const float (&acc)[4]) {
    const float4 q = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (kStcs) {
        __stcs(p, q);
    } else {
        *p = q;
    }
}

template <int NT, bool kStcs>
__global__ void __launch_bounds__(256) row_warp(const int* __restrict__ lane0, const float* __restrict__ vals,
                                                int64_t k_rows, Terms terms, float4* __restrict__ out) {
    const int64_t k = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (k >= k_rows) return;
    const int l0 = lane0[k];
    const float* v = vals + k * NT;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const int d = l0 + terms.lane[t] - 4 * lane;
        const float val = v[t];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], d == c ? val : 0.f);
    }
    store4<kStcs>(out + k * 32 + lane, acc);
}

// ------------------------------------- a warp a 32-row tile, shuffles (6-8)

// The tile's lane0 (lane r holds row r's) and its 32 x NT values as one flat
// block (lane j holds values j, j + 32, ...); zeros past the last row.
template <int NT>
__device__ __forceinline__ void load_flat(const int* __restrict__ lane0, const float* __restrict__ vals,
                                          int64_t k_rows, int64_t tile, int lane, int& l0, float (&v)[NT]) {
    const int64_t row0 = tile * kTileRows;
    const int64_t rows = k_rows - row0;
    l0 = lane < rows ? __ldg(lane0 + row0 + lane) : kNoRow;
    const float* src = vals + row0 * NT;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int e = j * 32 + lane;
        v[j] = e < rows * NT ? __ldg(src + e) : 0.f;
    }
}

// The tile's rows from the shuffled inputs: each lane its float4 of every
// row, stored at dst + r * 32 for the rows r < rows.
template <int NT, bool kStcs>
__device__ __forceinline__ void shuffle_tile(int l0, const float (&v)[NT], const Terms& terms, int lane, int64_t rows,
                                             float4* dst) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
        const int lr = __shfl_sync(kFull, l0, r);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int e = r * NT + t;
            const float val = __shfl_sync(kFull, v[e >> 5], e & 31);
            const int d = lr + terms.lane[t] - 4 * lane;
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], d == c ? val : 0.f);
        }
        if (r < rows) store4<kStcs>(dst + r * 32, acc);
    }
}

template <int NT, bool kStcs, bool kPersistent>
__global__ void __launch_bounds__(256) rows_shuffle(const int* __restrict__ lane0, const float* __restrict__ vals,
                                                    int64_t k_rows, Terms terms, float4* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t stride = kPersistent ? (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5 : n_tiles;
    int64_t tile = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (tile >= n_tiles) return;
    int l0;
    float v[NT];
    load_flat<NT>(lane0, vals, k_rows, tile, lane, l0, v);
    for (; tile < n_tiles; tile += stride) {
        int next_l0 = kNoRow;
        float next_v[NT];
        if (kPersistent && tile + stride < n_tiles) {
            load_flat<NT>(lane0, vals, k_rows, tile + stride, lane, next_l0, next_v);
        }
        shuffle_tile<NT, kStcs>(l0, v, terms, lane, k_rows - tile * kTileRows, out + tile * (kTileFloats / 4) + lane);
        if (kPersistent) {
            l0 = next_l0;
#pragma unroll
            for (int j = 0; j < NT; ++j) v[j] = next_v[j];
        }
    }
}

// ------------------------------------ a lane a row, a shared tile (9-11)

// Row `row`'s lane0 and its NT values (lane-private loads; the warp's NT
// loads of a term cover the tile's values once, from L1); kNoRow past the end.
template <int NT>
__device__ __forceinline__ void load_row(const int* __restrict__ lane0, const float* __restrict__ vals,
                                         int64_t k_rows, int64_t row, int& l0, float (&v)[NT]) {
    if (row < k_rows) {
        l0 = __ldg(lane0 + row);
#pragma unroll
        for (int t = 0; t < NT; ++t) v[t] = __ldg(vals + row * NT + t);
    } else {
        l0 = kNoRow;
#pragma unroll
        for (int t = 0; t < NT; ++t) v[t] = 0.f;
    }
}

// Adds the row's terms into its 128 floats of the shared tile, in t order;
// the floats start at 0, so each lane ends as the plain version's sum.
template <int NT>
__device__ __forceinline__ void scatter_row(float* row, int l0, const float (&v)[NT], const Terms& terms) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const int target = l0 + terms.lane[t];
        if (static_cast<unsigned>(target) < static_cast<unsigned>(kLanes)) row[target] = __fadd_rn(row[target], v[t]);
    }
}

template <int NT>
__device__ __forceinline__ void clear_row(float* row, int l0, const Terms& terms) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const int target = l0 + terms.lane[t];
        if (static_cast<unsigned>(target) < static_cast<unsigned>(kLanes)) row[target] = 0.f;
    }
}

template <int NT>
__global__ void __launch_bounds__(64) rows_shared(const int* __restrict__ lane0, const float* __restrict__ vals,
                                                  int64_t k_rows, Terms terms, float4* __restrict__ out) {
    extern __shared__ __align__(128) float smem[];
    const int lane = threadIdx.x & 31;
    float* tile_buf = smem + (threadIdx.x >> 5) * kTileFloats;
    float4* tile4 = reinterpret_cast<float4*>(tile_buf);
    for (int i = lane; i < kTileFloats / 4; i += 32) tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t stride = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
    int64_t tile = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    int l0;
    float v[NT];
    load_row<NT>(lane0, vals, k_rows, tile * kTileRows + lane, l0, v);
    float* row = tile_buf + lane * kLanes;
    for (; tile < n_tiles; tile += stride) {
        int next_l0;
        float next_v[NT];
        load_row<NT>(lane0, vals, k_rows, (tile + stride) * kTileRows + lane, next_l0, next_v);
        scatter_row<NT>(row, l0, v, terms);
        __syncwarp();
        const int64_t rows = min(static_cast<int64_t>(kTileRows), k_rows - tile * kTileRows);
        float4* dst = out + tile * (kTileFloats / 4) + lane;
        for (int r = 0; r < rows; ++r) __stcs(dst + r * 32, tile4[r * 32 + lane]);
        __syncwarp();
        clear_row<NT>(row, l0, terms);
        l0 = next_l0;
#pragma unroll
        for (int t = 0; t < NT; ++t) v[t] = next_v[t];
    }
}

// A warp a block: kBufs tiles of 16 KB, then kBufs x 32 ints (the lane0 each
// tile's rows were built from, to zero them again).
template <int NT, int kBufs>
__global__ void __launch_bounds__(32) rows_bulk(const int* __restrict__ lane0, const float* __restrict__ vals,
                                                int64_t k_rows, Terms terms, float* __restrict__ out) {
    extern __shared__ __align__(128) float smem[];
    const int lane = threadIdx.x;
    int* held = reinterpret_cast<int*>(smem + kBufs * kTileFloats);
    float4* z4 = reinterpret_cast<float4*>(smem);
    for (int i = lane; i < kBufs * kTileFloats / 4; i += 32) z4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t stride = gridDim.x;
    int64_t tile = blockIdx.x;
    int l0;
    float v[NT];
    load_row<NT>(lane0, vals, k_rows, tile * kTileRows + lane, l0, v);
    for (int it = 0; tile < n_tiles; ++it, tile += stride) {
        const int b = it % kBufs;
        int next_l0;
        float next_v[NT];
        load_row<NT>(lane0, vals, k_rows, (tile + stride) * kTileRows + lane, next_l0, next_v);
        float* row = smem + b * kTileFloats + lane * kLanes;
        if (it >= kBufs) {
            if (lane == 0) bulk_wait_read<kBufs - 1>();
            __syncwarp();
            clear_row<NT>(row, held[b * 32 + lane], terms);
        }
        held[b * 32 + lane] = l0;
        scatter_row<NT>(row, l0, v, terms);
        fence_async_shared();
        __syncwarp();
        if (lane == 0) {
            const int64_t rows = min(static_cast<int64_t>(kTileRows), k_rows - tile * kTileRows);
            bulk_store(out + tile * kTileFloats, smem + b * kTileFloats, static_cast<uint32_t>(rows * kLanes * 4));
            bulk_commit();
        }
        l0 = next_l0;
#pragma unroll
        for (int t = 0; t < NT; ++t) v[t] = next_v[t];
    }
    if (lane == 0) bulk_wait_all();
}

template <int NT>
__global__ void __launch_bounds__(256) read_store_floor(const int* __restrict__ lane0, const float* __restrict__ vals,
                                                        int64_t k_rows, float4* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t tile = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (tile >= n_tiles) return;
    int l0;
    float v[NT];
    load_flat<NT>(lane0, vals, k_rows, tile, lane, l0, v);
    float s = __int_as_float(l0);
#pragma unroll
    for (int j = 0; j < NT; ++j) s += v[j];
    s *= 0.f;
    const float4 q = make_float4(s, s, s, s);
    const int64_t rows = k_rows - tile * kTileRows;
    float4* dst = out + tile * (kTileFloats / 4) + lane;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
        if (r < rows) __stcs(dst + r * 32, q);
    }
}

// Asks L2 for the 128-byte lines of [p, p + bytes), the warp's lanes in turn.
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t bytes, int lane) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uintptr_t base = a & ~static_cast<uintptr_t>(127);
    const int64_t lines = static_cast<int64_t>((a + bytes - base + 127) >> 7);
    for (int64_t i = lane; i < lines; i += 32) {
        asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(base + i * 128));
    }
}

template <int NT, bool kShared, bool kPrefetch>
__global__ void __launch_bounds__(kShared ? 64 : 256)
    rows_blocked(const int* __restrict__ lane0, const float* __restrict__ vals, int64_t k_rows, Terms terms,
                 float4* __restrict__ out, int64_t tiles_per_warp) {
    extern __shared__ __align__(128) float smem[];
    const int lane = threadIdx.x & 31;
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t t0 = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * tiles_per_warp;
    if (t0 >= n_tiles) return;
    const int64_t t1 = min(t0 + tiles_per_warp, n_tiles);
    if (kPrefetch) {
        const int64_t r0 = t0 * kTileRows, r1 = min(t1 * kTileRows, k_rows);
        prefetch_l2(lane0 + r0, (r1 - r0) * 4, lane);
        prefetch_l2(vals + r0 * NT, (r1 - r0) * NT * 4, lane);
    }
    float* tile_buf = smem + (threadIdx.x >> 5) * kTileFloats;
    float4* tile4 = reinterpret_cast<float4*>(tile_buf);
    if (kShared) {
        for (int i = lane; i < kTileFloats / 4; i += 32) tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        __syncwarp();
    }
    for (int64_t tile = t0; tile < t1; ++tile) {
        const int64_t rows = k_rows - tile * kTileRows;
        float4* dst = out + tile * (kTileFloats / 4) + lane;
        int l0;
        float v[NT];
        if (kShared) {
            load_row<NT>(lane0, vals, k_rows, tile * kTileRows + lane, l0, v);
            float* row = tile_buf + lane * kLanes;
            scatter_row<NT>(row, l0, v, terms);
            __syncwarp();
            for (int r = 0; r < rows && r < kTileRows; ++r) __stcs(dst + r * 32, tile4[r * 32 + lane]);
            __syncwarp();
            clear_row<NT>(row, l0, terms);
        } else {
            load_flat<NT>(lane0, vals, k_rows, tile, lane, l0, v);
            shuffle_tile<NT, true>(l0, v, terms, lane, rows, dst);
        }
    }
}

template <int NT>
__global__ void __launch_bounds__(256) read_floor(const int* __restrict__ lane0, const float* __restrict__ vals,
                                                  int64_t k_rows, float4* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t tile = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (tile >= n_tiles) return;
    int l0;
    float v[NT];
    load_flat<NT>(lane0, vals, k_rows, tile, lane, l0, v);
    float s = __int_as_float(l0);
#pragma unroll
    for (int j = 0; j < NT; ++j) s += v[j];
    s *= 0.f;
    out[tile * (kTileFloats / 4) + lane] = make_float4(s, s, s, s);
}

// One 128-byte line a thread: the lines of [a, a + bytes_a), then of
// [b, b + bytes_b), asked of L2 with evict-last priority.
__global__ void __launch_bounds__(256) l2_pass(const char* a, int64_t bytes_a, const char* b, int64_t bytes_b) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const uintptr_t base_a = reinterpret_cast<uintptr_t>(a) & ~static_cast<uintptr_t>(127);
    const int64_t lines_a = static_cast<int64_t>((reinterpret_cast<uintptr_t>(a) + bytes_a - base_a + 127) >> 7);
    const uintptr_t base_b = reinterpret_cast<uintptr_t>(b) & ~static_cast<uintptr_t>(127);
    const int64_t lines_b = static_cast<int64_t>((reinterpret_cast<uintptr_t>(b) + bytes_b - base_b + 127) >> 7);
    uintptr_t p = 0;
    if (i < lines_a) {
        p = base_a + i * 128;
    } else if (i - lines_a < lines_b) {
        p = base_b + (i - lines_a) * 128;
    } else {
        return;
    }
    asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(p));
}

int launch_l2_pass(const int* lane0, const float* vals, int64_t k, int nt, cudaStream_t s) {
    const int64_t lines = (k * 4 + 127) / 128 + (k * nt * 4 + 127) / 128 + 2;
    l2_pass<<<blocks_for(lines, 256), 256, 0, s>>>(reinterpret_cast<const char*>(lane0), k * 4,
                                                   reinterpret_cast<const char*>(vals), k * nt * 4);
    return static_cast<int>(cudaGetLastError());
}

template <bool kStrided>
__global__ void __launch_bounds__(256) tile_store_floor(int64_t k_rows, float4* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (w >= n_tiles) return;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
        const int64_t row = kStrided ? w + r * n_tiles : w * kTileRows + r;
        if (row < k_rows) __stcs(out + row * 32 + lane, z);
    }
}

template <int NT, bool kShared>
__global__ void __launch_bounds__(kShared ? 64 : 256)
    rows_strided(const int* __restrict__ lane0, const float* __restrict__ vals, int64_t k_rows, Terms terms,
                 float4* __restrict__ out) {
    extern __shared__ __align__(128) float smem[];
    const int lane = threadIdx.x & 31;
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (w >= n_tiles) return;
    int l0;
    float v[NT];
    load_row<NT>(lane0, vals, k_rows, w + lane * n_tiles, l0, v);
    if (kShared) {
        float* tile_buf = smem + (threadIdx.x >> 5) * kTileFloats;
        float4* tile4 = reinterpret_cast<float4*>(tile_buf);
        for (int i = lane; i < kTileFloats / 4; i += 32) tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        __syncwarp();
        scatter_row<NT>(tile_buf + lane * kLanes, l0, v, terms);
        __syncwarp();
#pragma unroll 4
        for (int r = 0; r < kTileRows; ++r) {
            const int64_t row = w + r * n_tiles;
            if (row < k_rows) __stcs(out + row * 32 + lane, tile4[r * 32 + lane]);
        }
        return;
    }
    // shuffle_tile's sums, each row's values held by its own lane
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
        const int lr = __shfl_sync(kFull, l0, r);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const float val = __shfl_sync(kFull, v[t], r);
            const int d = lr + terms.lane[t] - 4 * lane;
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], d == c ? val : 0.f);
        }
        const int64_t row = w + r * n_tiles;
        if (row < k_rows) store4<true>(out + row * 32 + lane, acc);
    }
}

// A warp a run of kRun consecutive tiles (not persistent): with kAhead the
// next tile's inputs are loaded before this tile's stores; kFloor stores
// zeros made from the loads instead of the rows.
template <int NT, int kRun, bool kAhead, bool kFloor>
__global__ void __launch_bounds__(256) rows_runs(const int* __restrict__ lane0, const float* __restrict__ vals,
                                                 int64_t k_rows, Terms terms, float4* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t n_tiles = (k_rows + kTileRows - 1) / kTileRows;
    const int64_t t0 = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * kRun;
    if (t0 >= n_tiles) return;
    const int64_t t1 = min(t0 + kRun, n_tiles);
    int l0;
    float v[NT];
    load_flat<NT>(lane0, vals, k_rows, t0, lane, l0, v);
    for (int64_t tile = t0; tile < t1; ++tile) {
        int next_l0 = kNoRow;
        float next_v[NT];
        if (kAhead && tile + 1 < t1) load_flat<NT>(lane0, vals, k_rows, tile + 1, lane, next_l0, next_v);
        const int64_t rows = k_rows - tile * kTileRows;
        float4* dst = out + tile * (kTileFloats / 4) + lane;
        if (kFloor) {
            float s = __int_as_float(l0);
#pragma unroll
            for (int j = 0; j < NT; ++j) s += v[j];
            s *= 0.f;
            const float4 q = make_float4(s, s, s, s);
#pragma unroll
            for (int r = 0; r < kTileRows; ++r) {
                if (r < rows) __stcs(dst + r * 32, q);
            }
        } else {
            shuffle_tile<NT, true>(l0, v, terms, lane, rows, dst);
        }
        if (kAhead) {
            l0 = next_l0;
#pragma unroll
            for (int j = 0; j < NT; ++j) v[j] = next_v[j];
        } else if (tile + 1 < t1) {
            load_flat<NT>(lane0, vals, k_rows, tile + 1, lane, l0, v);
        }
    }
}

template <int NT, int kRun, bool kAhead, bool kFloor>
int launch_runs(const int* lane0, const float* vals, int64_t k, const Terms& terms, float4* out, cudaStream_t s) {
    const int64_t n_warps = ((k + kTileRows - 1) / kTileRows + kRun - 1) / kRun;
    rows_runs<NT, kRun, kAhead, kFloor><<<blocks_for(n_warps * 32, 256), 256, 0, s>>>(lane0, vals, k, terms, out);
    return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
    unsigned done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(phase)
            : "memory");
    } while (!done);
}

// Rows [r0, r0 + rows_per_block) of [row_begin, row_end) a block: their
// lane0 and values copied to shared memory first (the global ranges widened
// to 16 bytes, as cp.async.bulk wants), then the rows written.
template <int NT, int kForm, int kWarps, int kPhasedHead>
__global__ void __launch_bounds__(kWarps * 32, 1)
    rows_phased(const int* __restrict__ lane0, const float* __restrict__ vals, int64_t row_begin, int64_t row_end,
                int rows_per_block, Terms terms, float4* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char sm[];
    const int64_t r0 = row_begin + static_cast<int64_t>(blockIdx.x) * rows_per_block;
    if (r0 >= row_end) return;
    const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_block), row_end - r0));
    uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
    float* tiles = reinterpret_cast<float*>(sm + kPhasedHead);
    const int tile_bytes = kForm == 1 ? kWarps * kTileFloats * 4 : 0;
    const uintptr_t a = reinterpret_cast<uintptr_t>(lane0 + r0), a_lo = a & ~static_cast<uintptr_t>(15),
                    a_hi = (a + rows * 4 + 15) & ~static_cast<uintptr_t>(15);
    const uintptr_t b = reinterpret_cast<uintptr_t>(vals + r0 * NT), b_lo = b & ~static_cast<uintptr_t>(15),
                    b_hi = (b + static_cast<uintptr_t>(rows) * NT * 4 + 15) & ~static_cast<uintptr_t>(15);
    unsigned char* slab_a = sm + kPhasedHead + tile_bytes;
    unsigned char* slab_b = slab_a + (a_hi - a_lo);
    const int* s_l0 = reinterpret_cast<const int*>(slab_a + (a - a_lo));
    const float* s_v = reinterpret_cast<const float*>(slab_b + (b - b_lo));
    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(bar, static_cast<unsigned>((a_hi - a_lo) + (b_hi - b_lo)));
        bulk_load(slab_a, reinterpret_cast<const void*>(a_lo), static_cast<unsigned>(a_hi - a_lo), bar);
        bulk_load(slab_b, reinterpret_cast<const void*>(b_lo), static_cast<unsigned>(b_hi - b_lo), bar);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (kForm == 1) {
        float4* z4 = reinterpret_cast<float4*>(tiles);
        for (int i = threadIdx.x; i < kWarps * kTileFloats / 4; i += kWarps * 32) {
            z4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    mbar_wait(bar, 0);
    __syncthreads();
    if (kForm == 1) {
        float* tile_buf = tiles + warp * kTileFloats;
        float4* tile4 = reinterpret_cast<float4*>(tile_buf);
        float* row = tile_buf + lane * kLanes;
        const int n_tiles = (rows + kTileRows - 1) / kTileRows;
        for (int t = warp; t < n_tiles; t += kWarps) {
            const int local = t * kTileRows + lane;
            const int n_here = min(kTileRows, rows - t * kTileRows);
            int l0 = kNoRow;
            float v[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j) v[j] = 0.f;
            if (local < rows) {
                l0 = s_l0[local];
#pragma unroll
                for (int j = 0; j < NT; ++j) v[j] = s_v[local * NT + j];
            }
            scatter_row<NT>(row, l0, v, terms);
            __syncwarp();
            float4* dst = out + (r0 + t * kTileRows) * 32 + lane;
            for (int r = 0; r < n_here; ++r) __stcs(dst + r * 32, tile4[r * 32 + lane]);
            __syncwarp();
            clear_row<NT>(row, l0, terms);
        }
    } else {
        for (int i = warp; i < rows; i += kWarps) {
            const int l0 = s_l0[i];
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            if (kForm == 0) {
                acc[0] = acc[1] = acc[2] = acc[3] = __int_as_float(l0) * 0.f;
            } else {
#pragma unroll
                for (int t = 0; t < NT; ++t) {
                    const float val = s_v[i * NT + t];
                    const int d = l0 + terms.lane[t] - 4 * lane;
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], d == c ? val : 0.f);
                }
            }
            store4<true>(out + (r0 + i) * 32 + lane, acc);
        }
    }
}

// kPhasedHead: the bytes before the tiles and inputs in shared memory (the
// mbarrier first); kRound: a block's rows rounded up to a multiple of 32
template <int NT, int kForm, int kWarps, int kPhasedHead = 128, bool kRound = true>
int launch_phased(const int* lane0, const float* vals, int64_t k, const Terms& terms, float4* out, cudaStream_t s) {
    auto kernel = rows_phased<NT, kForm, kWarps, kPhasedHead>;
    int device = 0, n_sm = 0, most = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int fixed = kPhasedHead + (kForm == 1 ? kWarps * kTileFloats * 4 : 0) + 64;
    const int64_t per_row = 4 + 4 * NT;
    const int64_t max_rows = ((most - fixed) / per_row) & ~static_cast<int64_t>(31);
    const int64_t round_rows = max_rows * n_sm;
    for (int64_t begin = 0; begin < k; begin += round_rows) {
        const int64_t n = min(round_rows, k - begin);
        const int64_t even = (n + n_sm - 1) / n_sm;
        const int64_t per_block = kRound ? (even + 31) & ~static_cast<int64_t>(31) : even;
        const int grid = static_cast<int>((n + per_block - 1) / per_block);
        const int smem = static_cast<int>(fixed + per_block * per_row);
        kernel<<<grid, kWarps * 32, smem, s>>>(lane0, vals, begin, begin + n, static_cast<int>(per_block), terms, out);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// ------------------------------------------------------------- launching

template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, int smem, int64_t want, int* grid) {
    int device = 0, n_sm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t most = static_cast<int64_t>(per_sm) * n_sm;
    *grid = static_cast<int>(want < most ? want : most);
    return 0;
}

// A grid that fills the card once: each warp a run of tiles_per_warp tiles.
template <int NT, bool kShared, bool kPrefetch>
int launch_blocked(const int* lane0, const float* vals, int64_t k, const Terms& terms, float4* out, cudaStream_t s) {
    const int threads = kShared ? 64 : 256, warps = threads / 32;
    const int smem = kShared ? warps * kTileFloats * 4 : 0;
    const int64_t n_tiles = (k + kTileRows - 1) / kTileRows;
    int cap = 0;
    const int err = persistent_grid(rows_blocked<NT, kShared, kPrefetch>, threads, smem, INT32_MAX, &cap);
    if (err) return err;
    const int64_t most_warps = static_cast<int64_t>(cap) * warps;
    const int64_t per_warp = (n_tiles + most_warps - 1) / most_warps;
    const int64_t n_warps = (n_tiles + per_warp - 1) / per_warp;
    const unsigned int grid = static_cast<unsigned int>((n_warps + warps - 1) / warps);
    rows_blocked<NT, kShared, kPrefetch><<<grid, threads, smem, s>>>(lane0, vals, k, terms, out, per_warp);
    return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_nt(int design, const int* lane0, const float* vals, int64_t k, const Terms& terms, float* out,
              cudaStream_t s) {
    const int64_t n_tiles = (k + kTileRows - 1) / kTileRows;
    float4* out4 = reinterpret_cast<float4*>(out);
    int grid = 0, err = 0;
    switch (design) {
        case 4:
            row_warp<NT, false><<<blocks_for(k * 32, 256), 256, 0, s>>>(lane0, vals, k, terms, out4);
            break;
        case 5:
            row_warp<NT, true><<<blocks_for(k * 32, 256), 256, 0, s>>>(lane0, vals, k, terms, out4);
            break;
        case 6:
            rows_shuffle<NT, false, false><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(lane0, vals, k, terms, out4);
            break;
        case 7:
            rows_shuffle<NT, true, false><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(lane0, vals, k, terms, out4);
            break;
        case 8:
            err = persistent_grid(rows_shuffle<NT, true, true>, 256, 0, (n_tiles + 7) / 8, &grid);
            if (err) return err;
            rows_shuffle<NT, true, true><<<grid, 256, 0, s>>>(lane0, vals, k, terms, out4);
            break;
        case 9: {
            const int smem = 2 * kTileFloats * 4;
            err = persistent_grid(rows_shared<NT>, 64, smem, (n_tiles + 1) / 2, &grid);
            if (err) return err;
            rows_shared<NT><<<grid, 64, smem, s>>>(lane0, vals, k, terms, out4);
            break;
        }
        case 10: {
            const int smem = 2 * (kTileFloats + 32) * 4;
            err = persistent_grid(rows_bulk<NT, 2>, 32, smem, n_tiles, &grid);
            if (err) return err;
            rows_bulk<NT, 2><<<grid, 32, smem, s>>>(lane0, vals, k, terms, out);
            break;
        }
        case 11: {
            const int smem = 3 * (kTileFloats + 32) * 4;
            err = persistent_grid(rows_bulk<NT, 3>, 32, smem, n_tiles, &grid);
            if (err) return err;
            rows_bulk<NT, 3><<<grid, 32, smem, s>>>(lane0, vals, k, terms, out);
            break;
        }
        case 12:
            read_store_floor<NT><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(lane0, vals, k, out4);
            break;
        case 13: return launch_blocked<NT, false, false>(lane0, vals, k, terms, out4, s);
        case 14: return launch_blocked<NT, false, true>(lane0, vals, k, terms, out4, s);
        case 15: return launch_blocked<NT, true, true>(lane0, vals, k, terms, out4, s);
        case 16:
            err = launch_l2_pass(lane0, vals, k, NT, s);
            if (err) return err;
            rows_shuffle<NT, true, false><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(lane0, vals, k, terms, out4);
            break;
        case 17:
            err = launch_l2_pass(lane0, vals, k, NT, s);
            if (err) return err;
            read_store_floor<NT><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(lane0, vals, k, out4);
            break;
        case 18:
            read_floor<NT><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(lane0, vals, k, out4);
            break;
        case 19: return launch_l2_pass(lane0, vals, k, NT, s);
        case 20:
            tile_store_floor<false><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(k, out4);
            break;
        case 21:
            tile_store_floor<true><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(k, out4);
            break;
        case 22:
            rows_strided<NT, false><<<blocks_for(n_tiles * 32, 256), 256, 0, s>>>(lane0, vals, k, terms, out4);
            break;
        case 24: return launch_runs<NT, 4, false, true>(lane0, vals, k, terms, out4, s);
        case 25: return launch_runs<NT, 4, true, true>(lane0, vals, k, terms, out4, s);
        case 26: return launch_runs<NT, 16, true, true>(lane0, vals, k, terms, out4, s);
        case 27: return launch_runs<NT, 4, true, false>(lane0, vals, k, terms, out4, s);
        case 28: return launch_runs<NT, 16, true, false>(lane0, vals, k, terms, out4, s);
        case 29: return launch_phased<NT, 0, 16>(lane0, vals, k, terms, out4, s);
        case 30: return launch_phased<NT, 1, 4>(lane0, vals, k, terms, out4, s);
        case 31: return launch_phased<NT, 2, 16>(lane0, vals, k, terms, out4, s);
        case 32: return launch_phased<NT, 2, 32>(lane0, vals, k, terms, out4, s);
        case 34: return launch_phased<NT, 2, 16, 16>(lane0, vals, k, terms, out4, s);
        case 35: return launch_phased<NT, 2, 16, 128, false>(lane0, vals, k, terms, out4, s);
        case 23: {
            const int smem = 2 * kTileFloats * 4;
            err = cudaFuncSetAttribute(rows_strided<NT, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err) return err;
            rows_strided<NT, true><<<blocks_for(n_tiles * 32, 64), 64, smem, s>>>(lane0, vals, k, terms, out4);
            break;
        }
        default:
            return 100000;
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lane0 (k,) int32; vals (k, n_off * n_feat) f32; offs (n_off,) host ints,
// n_off in 1..4 and n_off * n_feat <= 8; out (k, 128) f32, 16-byte aligned.
extern "C" int design_update_rows(int design, const void* lane0, const void* vals, long long k, const int* offs,
                                  int n_off, int n_feat, void* out, void* stream) {
    const int n_terms = n_off * n_feat;
    if (k <= 0 || n_off < 1 || n_off > 4 || n_feat < 1 || n_terms > 8) return 100000;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* l0 = static_cast<const int*>(lane0);
    const float* v = static_cast<const float*>(vals);
    float* o = static_cast<float*>(out);
    const int64_t n_tiles = (k + kTileRows - 1) / kTileRows;
    if (design == 0 || design == 1) {
        const int64_t n = k * 32;
        if (design == 0) {
            store_floor<false><<<blocks_for(n, 256), 256, 0, s>>>(reinterpret_cast<float4*>(o), n);
        } else {
            store_floor<true><<<blocks_for(n, 256), 256, 0, s>>>(reinterpret_cast<float4*>(o), n);
        }
        return static_cast<int>(cudaGetLastError());
    }
    if (design == 2) {
        int grid = 0;
        const int err = persistent_grid(bulk_floor, 32, kTileFloats * 4, n_tiles, &grid);
        if (err) return err;
        bulk_floor<<<grid, 32, kTileFloats * 4, s>>>(k, o);
        return static_cast<int>(cudaGetLastError());
    }
    if (design == 33) return package::arcnerf_build_update_rows(lane0, vals, k, offs, n_off, n_feat, out, stream);
    if (design == 3) {
        Offsets o4 = {{0, 0, 0, 0}};
        for (int i = 0; i < n_off; ++i) o4.v[i] = offs[i];
        parent_kernel<<<blocks_for(k * 32, 256), 256, 0, s>>>(l0, v, k, o4, n_off, n_feat,
                                                               reinterpret_cast<float4*>(o));
        return static_cast<int>(cudaGetLastError());
    }
    Terms terms = {{0, 0, 0, 0, 0, 0, 0, 0}};
    for (int i = 0; i < n_off; ++i)
        for (int f = 0; f < n_feat; ++f) terms.lane[i * n_feat + f] = offs[i] + f;
    switch (n_terms) {
        case 1: return launch_nt<1>(design, l0, v, k, terms, o, s);
        case 2: return launch_nt<2>(design, l0, v, k, terms, o, s);
        case 3: return launch_nt<3>(design, l0, v, k, terms, o, s);
        case 4: return launch_nt<4>(design, l0, v, k, terms, o, s);
        case 5: return launch_nt<5>(design, l0, v, k, terms, o, s);
        case 6: return launch_nt<6>(design, l0, v, k, terms, o, s);
        case 7: return launch_nt<7>(design, l0, v, k, terms, o, s);
        default: return launch_nt<8>(design, l0, v, k, terms, o, s);
    }
}
