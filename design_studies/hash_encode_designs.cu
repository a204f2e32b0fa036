// Design variants of kernel B (hash-grid encode), for
// design_studies/hash_encode_designs.py: the designs the kernel in
// arcnerf_torch/csrc/hash_encode.cu was chosen against. Not part of the
// port's kernels: nothing in the package launches these. F = 2, the
// recipe's width; the corners come from the package's hash_grid.cuh.
//
//   0 thread a (point, level)  the earlier kernel: the level fastest, a warp
//                              on 2 points x 16 levels, two scalar 4-byte
//                              loads a corner, a 64-bit divide a thread
//   1 bf16 copy                the level-major kernel of variant 3 reading
//                              a bf16 copy of the table, (L, T, 2) in half
//                              the bytes: one 4-byte load a corner
//   2 direct stores            the level-major kernel of variant 3 with
//                              each lane storing its 8 bytes straight to
//                              the output row, no shared-memory tile
//   3 a float2 a corner        the package's level-major kernel with one
//                              float2 load a corner
//   4 two levels a warp        variant 3 on blocks of 8 warps, warp w on
//                              levels w and 15 - w, so that every warp has
//                              one coarse and one fine level (16 levels)
//   5 two points a lane        variant 3 on 64 points a block, each lane on
//                              points lane and lane + 32 of its warp's
//                              level, both points' loads in flight together
//   6 pair loads               the package's level-major kernel with one or
//                              two float4 loads for each pair of z-neighbour
//                              corners whose entries sit side by side
//   7 pair loads, 32 registers variant 6 held to 32 registers (4 blocks of
//                              512 threads an SM, the occupancy of variant 3)

#include "../arcnerf_torch/csrc/hash_encode.cu"  // its kPoints, kWarps, load_entry

namespace {

// The 2 values of entries e0 and e1, corners p and p + 4 (the z-neighbours).
// Where e1 = e0 + 1 (every dense level, and the quad and pair hashes but at
// the table's end), both lie in one 16-byte slot when e0 is even, and in two
// neighbouring slots when it is odd: one or two float4 loads for both
// corners. Needs the table 16-byte aligned (torch's allocations are).
__device__ __forceinline__ void load_pair(const float* __restrict__ tab, uint32_t e0, uint32_t e1, float (&v0)[2],
                                          float (&v1)[2]) {
    if (e1 != e0 + 1) {
        load_entry<2>(tab, e0, v0);
        load_entry<2>(tab, e1, v1);
        return;
    }
    const float4* slots = reinterpret_cast<const float4*>(tab) + (e0 >> 1);
    const float4 a = __ldg(slots);
    if (e0 & 1u) {
        const float4 b = __ldg(slots + 1);
        v0[0] = a.z, v0[1] = a.w, v1[0] = b.x, v1[1] = b.y;
    } else {
        v0[0] = a.x, v0[1] = a.y, v1[0] = a.z, v1[1] = a.w;
    }
}

struct Args {
    const float* xyz;
    int64_t n_pts;
    int n_levels;
    uint32_t table_size;
    const int* res;
    float mn0, mn1, mn2, len0, len1, len2;
    int variant, read_bf16;
    float* out;
};

__global__ void __launch_bounds__(256) thread_per_pair(Args a, const float* __restrict__ table) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= a.n_pts * a.n_levels) return;
    const int64_t b = idx / a.n_levels;
    const int l = static_cast<int>(idx - b * a.n_levels);
    uint32_t entry[8];
    float w[8];
    hash_grid::corners(a.xyz[3 * b + 0], a.xyz[3 * b + 1], a.xyz[3 * b + 2], a.res[l], a.mn0, a.mn1, a.mn2, a.len0,
                       a.len1, a.len2, a.table_size, a.variant, entry, w);
    const float* tab = table + static_cast<int64_t>(l) * a.table_size * 2;
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float* e = tab + static_cast<int64_t>(entry[c]) * 2;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            const float v = a.read_bf16 ? round_bf16(e[f]) : e[f];
            acc[f] = __fadd_rn(acc[f], __fmul_rn(v, w[c]));
        }
    }
    float* o = a.out + b * (static_cast<int64_t>(a.n_levels) * 2) + l * 2;
    o[0] = acc[0];
    o[1] = acc[1];
}

// one (point, level) of a level-major block: lane's point, warp's level
template <bool kBf16>
__device__ __forceinline__ float2 encode_one(const Args& a, const void* table, float3 n, int l) {
    uint32_t entry[8];
    float w[8];
    hash_grid::corners(n, a.res[l], a.table_size, a.variant, entry, w);
    float v[8][2];
    if constexpr (kBf16) {
        const __nv_bfloat162* tab = static_cast<const __nv_bfloat162*>(table) + static_cast<int64_t>(l) * a.table_size;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float2 t = __bfloat1622float2(__ldg(tab + entry[c]));
            v[c][0] = t.x;
            v[c][1] = t.y;
        }
    } else {
        const float2* tab = static_cast<const float2*>(table) + static_cast<int64_t>(l) * a.table_size;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float2 t = __ldg(tab + entry[c]);
            v[c][0] = a.read_bf16 ? round_bf16(t.x) : t.x;
            v[c][1] = a.read_bf16 ? round_bf16(t.y) : t.y;
        }
    }
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int f = 0; f < 2; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(v[c][f], w[c]));
    }
    return make_float2(acc[0], acc[1]);
}

template <bool kBf16, bool kTile>
__global__ void __launch_bounds__(kPoints * kWarps) level_major(Args a, const void* __restrict__ table) {
    constexpr int kStride = kWarps * 2 + 1;
    __shared__ float3 norm[kPoints];
    __shared__ float tile[kPoints * kStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPoints;
    const int n_here = static_cast<int>(min(static_cast<int64_t>(kPoints), a.n_pts - p0));
    if (static_cast<int>(threadIdx.x) < n_here) {
        const float* p = a.xyz + 3 * (p0 + threadIdx.x);
        norm[threadIdx.x] = hash_grid::normalize(p[0], p[1], p[2], a.mn0, a.mn1, a.mn2, a.len0, a.len1, a.len2);
    }
    __syncthreads();
    const int row = a.n_levels * 2;
    for (int l0 = 0; l0 < a.n_levels; l0 += kWarps) {
        const int chunk = min(kWarps, a.n_levels - l0);
        if (warp < chunk && lane < n_here) {
            const float2 v = encode_one<kBf16>(a, table, norm[lane], l0 + warp);
            if (kTile) {
                tile[lane * kStride + warp * 2] = v.x;
                tile[lane * kStride + warp * 2 + 1] = v.y;
            } else {
                *reinterpret_cast<float2*>(a.out + (p0 + lane) * row + (l0 + warp) * 2) = v;
            }
        }
        if (!kTile) continue;
        __syncthreads();
        const int cols = chunk * 2;
        float* dst = a.out + p0 * row + l0 * 2;
        for (int i = threadIdx.x; i < n_here * cols; i += blockDim.x) {
            const int r = i / cols, c = i - r * cols;
            dst[static_cast<int64_t>(r) * row + c] = tile[r * kStride + c];
        }
        __syncthreads();
    }
}

// the package's arithmetic: one (point, level), its corners loaded a pair
// of z-neighbours at a time (kPairs) or one at a time
template <bool kPairs>
__device__ __forceinline__ void encode_pairs(const Args& a, const float* __restrict__ table, float3 n, int l,
                                             float (&acc)[2]) {
    uint32_t entry[8];
    float w[8];
    hash_grid::corners(n, a.res[l], a.table_size, a.variant, entry, w);
    const float* tab = table + static_cast<int64_t>(l) * a.table_size * 2;
    float v[8][2];
    if constexpr (kPairs) {
#pragma unroll
        for (int c = 0; c < 4; ++c) load_pair(tab, entry[c], entry[c + 4], v[c], v[c + 4]);
    } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) load_entry<2>(tab, entry[c], v[c]);
    }
    acc[0] = acc[1] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            const float e = a.read_bf16 ? round_bf16(v[c][f]) : v[c][f];
            acc[f] = __fadd_rn(acc[f], __fmul_rn(e, w[c]));
        }
    }
}

// designs 3, 6 and 7: the package's kernel for F = 2, 16 levels
template <bool kPairs, int kMinBlocks>
__global__ void __launch_bounds__(kPoints * kWarps, kMinBlocks) level_major_pkg(Args a,
                                                                               const float* __restrict__ table) {
    constexpr int kStride = kWarps * 2 + 1;
    __shared__ float3 norm[kPoints];
    __shared__ float tile[kPoints * kStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPoints;
    const int n_here = static_cast<int>(min(static_cast<int64_t>(kPoints), a.n_pts - p0));
    if (static_cast<int>(threadIdx.x) < n_here) {
        const float* p = a.xyz + 3 * (p0 + threadIdx.x);
        norm[threadIdx.x] = hash_grid::normalize(p[0], p[1], p[2], a.mn0, a.mn1, a.mn2, a.len0, a.len1, a.len2);
    }
    __syncthreads();
    if (lane < n_here) {
        float acc[2];
        encode_pairs<kPairs>(a, table, norm[lane], warp, acc);
        tile[lane * kStride + warp * 2] = acc[0];
        tile[lane * kStride + warp * 2 + 1] = acc[1];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_here * 32; i += blockDim.x) {
        const int r = i >> 5, c = i & 31;
        a.out[(p0 + r) * 32 + c] = tile[r * kStride + c];
    }
}

// design 4: 32 points, 8 warps, warp w on levels w and 15 - w
__global__ void __launch_bounds__(256) two_levels_a_warp(Args a, const float* __restrict__ table) {
    constexpr int kStride = 16 * 2 + 1;
    __shared__ float3 norm[kPoints];
    __shared__ float tile[kPoints * kStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPoints;
    const int n_here = static_cast<int>(min(static_cast<int64_t>(kPoints), a.n_pts - p0));
    if (static_cast<int>(threadIdx.x) < n_here) {
        const float* p = a.xyz + 3 * (p0 + threadIdx.x);
        norm[threadIdx.x] = hash_grid::normalize(p[0], p[1], p[2], a.mn0, a.mn1, a.mn2, a.len0, a.len1, a.len2);
    }
    __syncthreads();
    if (lane < n_here) {
        float lo[2], hi[2];
        encode_pairs<false>(a, table, norm[lane], warp, lo);
        encode_pairs<false>(a, table, norm[lane], 15 - warp, hi);
        tile[lane * kStride + warp * 2] = lo[0];
        tile[lane * kStride + warp * 2 + 1] = lo[1];
        tile[lane * kStride + (15 - warp) * 2] = hi[0];
        tile[lane * kStride + (15 - warp) * 2 + 1] = hi[1];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_here * 32; i += blockDim.x) {
        const int r = i >> 5, c = i & 31;
        a.out[(p0 + r) * 32 + c] = tile[r * kStride + c];
    }
}

// design 5: 64 points, 16 warps, each lane on two points of its warp's level
__global__ void __launch_bounds__(512) two_points_a_lane(Args a, const float* __restrict__ table) {
    constexpr int kStride = 16 * 2 + 1, kPts = 2 * kPoints;
    __shared__ float3 norm[kPts];
    __shared__ float tile[kPts * kStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPts;
    const int n_here = static_cast<int>(min(static_cast<int64_t>(kPts), a.n_pts - p0));
    if (static_cast<int>(threadIdx.x) < n_here) {
        const float* p = a.xyz + 3 * (p0 + threadIdx.x);
        norm[threadIdx.x] = hash_grid::normalize(p[0], p[1], p[2], a.mn0, a.mn1, a.mn2, a.len0, a.len1, a.len2);
    }
    __syncthreads();
    if (lane < n_here) {
        const bool second = lane + kPoints < n_here;
        float x[2], y[2];
        encode_pairs<false>(a, table, norm[lane], warp, x);
        if (second) encode_pairs<false>(a, table, norm[lane + kPoints], warp, y);
        tile[lane * kStride + warp * 2] = x[0];
        tile[lane * kStride + warp * 2 + 1] = x[1];
        if (second) {
            tile[(lane + kPoints) * kStride + warp * 2] = y[0];
            tile[(lane + kPoints) * kStride + warp * 2 + 1] = y[1];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_here * 32; i += blockDim.x) {
        const int r = i >> 5, c = i & 31;
        a.out[(p0 + r) * 32 + c] = tile[r * kStride + c];
    }
}

}  // namespace

// design: 0 thread a (point, level), 1 bf16 copy (table (L, T, 2) bf16),
// 2 direct stores, 3 a float2 a corner, 4 two levels a warp, 5 two points a
// lane, 6 pair loads, 7 pair loads at 32 registers (3-7: 16 levels); the
// rest as arcnerf_hash_encode_fwd with F = 2.
extern "C" int design_hash_encode(int design, const void* xyz, long long n_pts, const void* table, int n_levels,
                                  int log2_table, const void* res, float mn0, float mn1, float mn2, float len0,
                                  float len1, float len2, int variant, int read_bf16, void* out, void* stream) {
    if (n_pts <= 0 || n_levels <= 0 || log2_table < 1 || log2_table > 30 || design < 0 || design > 7)
        return ARCNERF_BAD_ARGUMENT;
    const Args a{static_cast<const float*>(xyz), n_pts, n_levels, 1u << log2_table, static_cast<const int*>(res),
                 mn0, mn1, mn2, len0, len1, len2, variant, read_bf16, static_cast<float*>(out)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>((n_pts + kPoints - 1) / kPoints);
    const int threads = kPoints * min(n_levels, kWarps);
    switch (design) {
        case 0:
            thread_per_pair<<<static_cast<unsigned>((n_pts * n_levels + 255) / 256), 256, 0, s>>>(
                a, static_cast<const float*>(table));
            break;
        case 1: level_major<true, true><<<blocks, threads, 0, s>>>(a, table); break;
        case 2: level_major<false, false><<<blocks, threads, 0, s>>>(a, table); break;
        case 3:
        case 4:
        case 5:
        case 6:
        case 7:
            if (n_levels != 16) return ARCNERF_BAD_ARGUMENT;
            if (design == 3) {
                level_major_pkg<false, 1><<<blocks, 512, 0, s>>>(a, static_cast<const float*>(table));
            } else if (design == 6) {
                level_major_pkg<true, 1><<<blocks, 512, 0, s>>>(a, static_cast<const float*>(table));
            } else if (design == 7) {
                level_major_pkg<true, 4><<<blocks, 512, 0, s>>>(a, static_cast<const float*>(table));
            } else if (design == 4) {
                two_levels_a_warp<<<blocks, 256, 0, s>>>(a, static_cast<const float*>(table));
            } else {
                two_points_a_lane<<<static_cast<unsigned>((n_pts + 63) / 64), 512, 0, s>>>(
                    a, static_cast<const float*>(table));
            }
            break;
        default: return ARCNERF_BAD_ARGUMENT;
    }
    return static_cast<int>(cudaGetLastError());
}
